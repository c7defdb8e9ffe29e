"""DSM (column-store) replica with order-preserving dictionary encoding (§5.2, §7.1).

Each column is stored as fixed-width integer codes plus a sorted dictionary
(real value -> code is order-preserving: code order == value order). Range
predicates on values therefore become range predicates on codes without
decoding - the optimization that makes DSM scans fast and update application
hard, which is exactly the tension the paper's update-application unit
resolves.

The replica lives on the analytical island's device: ``codes``, ``valid``
and ``dictionary`` are tensors on ``device`` (the GPU unless a caller asks
for the CPU). A small host copy of a dictionary is made on demand for the
control steps that binary-search it (``host_dictionary``). Tensors of a
column are never written in place once the column is installed: update
application builds new tensors and swaps the column (Phase 2), so a snapshot
may alias them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.schema import VALUE_BYTES
from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass
class EncodedColumn:
    """Dictionary-encoded column.

    codes:      (n,) int32 - index into `dictionary`
    dictionary: (k,) int32 - sorted distinct values (order-preserving)
    valid:      (n,) bool  - row validity (deletes mark rows invalid)
    version:    int        - bumped by every update application (Phase-2 swap)
    """

    codes: torch.Tensor
    dictionary: torch.Tensor
    valid: torch.Tensor
    version: int = 0
    # host copy of `dictionary` for searchsorted control steps (lazy)
    _host_dict: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def host_dictionary(self) -> np.ndarray:
        """The dictionary as host numpy (one device-to-host copy, cached;
        callers must treat it as read-only)."""
        if self._host_dict is None:
            self._host_dict = self.dictionary.cpu().numpy()
        return self._host_dict

    # -- properties priced by the cost model ------------------------------
    @property
    def n_rows(self) -> int:
        return int(self.codes.shape[0])

    @property
    def dict_size(self) -> int:
        return int(self.dictionary.shape[0])

    @property
    def bit_width(self) -> int:
        """Fixed-length code width the paper's compression would use."""
        return max(1, math.ceil(math.log2(max(self.dict_size, 2))))

    @property
    def encoded_bytes(self) -> float:
        return self.n_rows * self.bit_width / 8.0

    @property
    def raw_bytes(self) -> float:
        return self.n_rows * VALUE_BYTES


def column_from_numpy(codes, dictionary, valid, version: int = 0,
                      device=None) -> EncodedColumn:
    """Carry one column's state (host arrays, e.g. taken with `np.asarray`
    from another implementation's column) onto `device`."""
    dev = resolve_device(device)
    host_dict = np.ascontiguousarray(np.asarray(dictionary), dtype=np.int32)
    return EncodedColumn(
        codes=torch.from_numpy(np.ascontiguousarray(
            np.asarray(codes), dtype=np.int32)).to(dev),
        dictionary=torch.from_numpy(host_dict).to(dev),
        valid=torch.from_numpy(np.ascontiguousarray(
            np.asarray(valid), dtype=bool)).to(dev),
        version=int(version), _host_dict=host_dict)


def column_to_numpy(col: EncodedColumn):
    """(codes, dictionary, valid, version) as host numpy."""
    return (col.codes.cpu().numpy(), col.dictionary.cpu().numpy(),
            col.valid.cpu().numpy(), col.version)


def encode_column(values: np.ndarray, device=None) -> EncodedColumn:
    """Build the sorted dictionary and encode (order-preserving).

    The unique/inverse pass runs on the host (set-up, once per column);
    the encoded column then lives on `device`."""
    values = np.asarray(values)
    dictionary, codes = np.unique(values, return_inverse=True)
    return column_from_numpy(codes.reshape(-1), dictionary,
                             np.ones(values.shape[0], dtype=bool), 0, device)


def decode_column(col: EncodedColumn) -> torch.Tensor:
    """Decode codes back to real values (gather through the dictionary)."""
    return col.dictionary[col.codes.long()]


def value_range_to_code_range(col: EncodedColumn, lo: int, hi: int):
    """Map a value-range predicate to a code-range predicate (no decode).

    Returns (code_lo, code_hi) such that  lo <= value <= hi  <=>
    code_lo <= code < code_hi. This is the order-preserving-dictionary
    fast path used by the analytical engine's scans.
    """
    dictionary = col.host_dictionary()
    code_lo = int(np.searchsorted(dictionary, lo, side="left"))
    code_hi = int(np.searchsorted(dictionary, hi, side="right"))
    return code_lo, code_hi


@dataclasses.dataclass
class DSMReplica:
    """The analytical island's replica: one EncodedColumn per table column."""

    columns: dict[int, EncodedColumn]

    @classmethod
    def from_table(cls, table: np.ndarray, device=None) -> "DSMReplica":
        dev = resolve_device(device)
        return cls(columns={j: encode_column(table[:, j], dev)
                            for j in range(table.shape[1])})

    def to_table(self) -> np.ndarray:
        cols = [decode_column(self.columns[j]).cpu().numpy()
                for j in sorted(self.columns)]
        return np.stack(cols, axis=1)

    @property
    def n_rows(self) -> int:
        return next(iter(self.columns.values())).n_rows

    @property
    def n_cols(self) -> int:
        return len(self.columns)

    @property
    def encoded_bytes(self) -> float:
        return sum(c.encoded_bytes for c in self.columns.values())


def replica_from_numpy(columns: dict, device=None) -> DSMReplica:
    """``{col_id: (codes, dictionary, valid, version)}`` of host arrays ->
    a replica on `device` (see `column_from_numpy`)."""
    dev = resolve_device(device)
    return DSMReplica(columns={
        int(c): column_from_numpy(codes, dictionary, valid, version, dev)
        for c, (codes, dictionary, valid, version) in columns.items()})
