"""Update application (§5.2): NSM->DSM conversion under dictionary encoding.

Two algorithms, both functionally exact:

* `apply_updates_naive` - the paper's *initial* algorithm: decompress the
  whole column, apply updates, sort the updated column to rebuild the
  dictionary (O((n+m)log(n+m))), recompress with per-entry binary search.
  Kept as the costed baseline and as the oracle for property tests.

* `apply_updates` - the paper's *optimized* two-stage algorithm:
    1. sort only the <=1024 pending update values into an *update
       dictionary* (sort unit; kernels/bitonic_sort),
    2. linear-merge old + update dictionaries (merge unit) and build the
       old_code -> new_code index,
    3. re-encode the column through the index (sequential pass, no random
       dictionary lookups) and scatter the update values' new codes at
       their rows.

The shipped entries are host records; the column lives on the analytical
island's device. Stage 3 runs there as plain tensor indexing: the re-encode
gather builds a NEW codes tensor and validity is cloned, so the scatters
below write in place only into tensors this call made - the old column (and
any snapshot aliasing it) is never touched. Islands stacked on one device
(`hopper@N`) apply exactly this way, to the whole column: the stacked
view of the next pinned read reshapes the result, so a per-island stage 3
would only split the column and concatenate it back.

Phase 2 of the consistency contract (§6): the function returns a *new*
EncodedColumn with `version+1`; the caller atomically swaps the replica
pointer, so analytics never observe a half-applied column.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.backend import ShardedBackend, get_backend
from repro_torch.core.dsm import EncodedColumn
from repro_torch.core.hwmodel import CostLog
from repro_torch.core.schema import VALUE_BYTES
from repro_torch.kernels.common import from_host

# software (CPU) costs for the same steps, for the MI baseline
CPU_CYCLES_PER_CMP = 8.0
CPU_CYCLES_PER_LOOKUP = 30.0   # random dictionary access (cache-missing)
CPU_CYCLES_PER_SCAN_ITEM = 3.0
# Soft partitioning (§5.1, [49,51,62]): columns are partitioned so the
# dictionary/hash-table working set stays bounded; an update batch touches
# only the partitions containing its rows, so (de)compression cost scales
# with the partition, not the whole column.
PARTITION_ROWS = 4096


def _split_ops(updates: np.ndarray):
    mods = updates[updates["op"] == 1]
    ins = updates[updates["op"] == 2]
    dels = updates[updates["op"] == 3]
    return mods, ins, dels


def _sorted_write_ops(mods: np.ndarray, ins: np.ndarray) -> np.ndarray:
    """Modify+insert entries in commit order - the scatter order of the
    Phase-1 write set."""
    write_ops = np.concatenate([mods, ins]) if len(ins) else mods
    if len(write_ops):
        order = np.argsort(write_ops["commit_id"], kind="stable")
        write_ops = write_ops[order]
    return write_ops


def _last_write_per_row(rows: np.ndarray) -> np.ndarray:
    """Positions of the LAST occurrence of each row id in a commit-ordered
    row array. A sequential (or numpy) scatter lets the last write to a row
    win; a scatter on the GPU with duplicate indices has no order, so only
    these positions are scattered."""
    if len(rows) < 2:
        return np.arange(len(rows))
    _, first_in_reversed = np.unique(rows[::-1], return_index=True)
    return np.sort(len(rows) - 1 - first_in_reversed)


def _grow(codes: torch.Tensor, valid: torch.Tensor, top: int):
    """Extend (codes, valid) to `top` rows (new rows: code 0, invalid)."""
    pad = top - codes.shape[0]
    if pad <= 0:
        return codes, valid
    return (torch.cat([codes, codes.new_zeros(pad)]),
            torch.cat([valid, valid.new_zeros(pad)]))


def _apply_row_ops(codes: torch.Tensor, valid: torch.Tensor, new_dict,
                   mods: np.ndarray, ins: np.ndarray, dels: np.ndarray,
                   encode=None, write_set=None):
    """Scatter modify/insert/delete row ops in commit order.

    `codes` / `valid` are tensors owned by the caller (written in place,
    and returned - possibly grown by inserts). `encode` maps update values
    to their codes in `new_dict`; defaults to binary search. `write_set`,
    when given, is a ``(write_ops, write_codes)`` pair: the commit-ordered
    write set (`_sorted_write_ops(mods, ins)`) with its pre-encoded codes.
    All writes land first (the last write to a row wins), then deletes
    clear validity.
    """
    dev = codes.device
    if encode is None:
        encode = lambda v: torch.searchsorted(  # noqa: E731
            new_dict, from_host(v).to(dev, new_dict.dtype))
    if len(ins):
        # Inserts append rows; their per-column values arrive as entries with
        # row >= n. Extend the tensors to cover the max inserted row id.
        codes, valid = _grow(codes, valid, int(ins["row"].max()) + 1)
    if write_set is not None:
        write_ops, write_codes = write_set
    else:
        write_ops, write_codes = _sorted_write_ops(mods, ins), None
    if len(write_ops):
        new_codes_for_writes = (write_codes if write_codes is not None
                                else encode(write_ops["value"]))
        last = _last_write_per_row(write_ops["row"])
        rows = from_host(write_ops["row"][last]).to(dev)
        if len(last) != len(write_ops):
            new_codes_for_writes = new_codes_for_writes[
                from_host(last).to(dev)]
        codes[rows] = new_codes_for_writes.to(codes.dtype)
        valid[rows] = True
    if len(dels):
        valid[from_host(dels["row"]).to(dev)] = False
    return codes, valid


def _merge_dictionary_stages_batch(be, per_column):
    """Stages 1-2 of the optimized application for every column of a ship
    batch at once: per column, sort+dedupe the pending update values,
    linear-merge the sorted dictionaries, and build the encoder over the
    merged dictionary.

    `per_column` is a list of (old_dict, write_vals); returns a list of
    (update_dict, new_dict, encode, old_to_new) in the same order. The
    old->new index is a positional byproduct of the merge - both
    dictionaries are sorted and every old value survives into the merged
    one, so each old entry's new code is its position there. The whole
    pipeline lives on the backend (`ExecutionBackend.apply_stages_batch`):
    the accelerator backend fuses sort + merge into ONE launch per batch.
    """
    return be.apply_stages_batch(per_column)


def _merge_dictionary_stages(be, old_dict, write_vals):
    """Single-column stages 1-2: a batch of one (see the batch docstring)."""
    return _merge_dictionary_stages_batch(be, [(old_dict, write_vals)])[0]


def precompute_apply_stages(columns, buffers, backend=None) -> dict:
    """Precompute stages 1-2 for every column of a ship batch in one
    batched dispatch.

    `columns` maps col_id -> current EncodedColumn, `buffers` maps
    col_id -> that column's shipped update entries (shipping.ship_updates
    output). Returns {col_id: staged} to pass as `apply_updates(...,
    staged=...)`. With a ShardedBackend the stages run on the inner
    backend (the dictionary is replicated). Purely a batching
    hint: results are bit-identical to each apply computing its own stages,
    because every batched op is exact and item-independent.
    """
    be = get_backend(backend)
    inner = be.inner if isinstance(be, ShardedBackend) else be
    ids = list(buffers.keys())
    per_column = []
    for cid in ids:
        mods, ins, _ = _split_ops(buffers[cid])
        per_column.append((columns[cid].dictionary,
                           np.concatenate([mods["value"], ins["value"]])))
    return dict(zip(ids, _merge_dictionary_stages_batch(inner, per_column)))


def _optimized_apply_cost(cost: CostLog, on_pim: bool, m: int, n: int,
                          k_old: int, k_new: int, n_update_dict: int,
                          bit_width: int, phase: str = "apply") -> None:
    """Cost events for the optimized two-stage application."""
    # timeline metadata: applied-update count on this node's Phase-2 swap
    cost.annotate_add(n_applied=int(m))
    # soft partitioning: updates touch at most m partitions
    n_eff = min(n, max(1, min(m, n // PARTITION_ROWS + 1)) * PARTITION_ROWS)
    enc_eff = n_eff * bit_width / 8.0
    if on_pim:
        cost.add(phase=phase, island="ana", resource="sorter", items=m)
        cost.add(phase=phase, island="ana", resource="merge",
                 items=k_old + n_update_dict,
                 bytes_local=(k_old + k_new) * VALUE_BYTES)
        # index-based re-encode: one sequential pass (index fits in SRAM)
        cost.add(phase=phase, island="ana", resource="copy",
                 bytes_local=2 * enc_eff)
        cost.add(phase=phase, island="ana", resource="hash",
                 items=m, bytes_local=m * 16)
    else:
        cost.add(
            phase=phase, island="txn", resource="cpu",
            cycles=m * np.log2(max(m, 2)) * CPU_CYCLES_PER_CMP        # sort updates
            + (k_old + k_new) * CPU_CYCLES_PER_SCAN_ITEM              # dict merge
            + n_eff * 8.0                                             # unpack+reindex+pack
            + m * CPU_CYCLES_PER_LOOKUP,                              # encode updates
            bytes_offchip=2 * enc_eff + (k_old + k_new) * VALUE_BYTES + m * 16,
        )


def apply_updates(
    col: EncodedColumn,
    updates: np.ndarray,
    cost: CostLog | None = None,
    on_pim: bool = True,
    backend=None,
    staged=None,
    phase: str = "apply",
) -> EncodedColumn:
    """Optimized two-stage update application (the paper's contribution).

    Stages 1-2 run on the selected execution backend: the HopperBackend
    dispatches the sort and the dictionary merge to kernels/bitonic_sort
    and kernels/merge_runs (fused per ship batch); the TorchBackend keeps
    the plain unique path. Stage 3 is plain tensor indexing on the
    column's device.

    `staged`, when given, is this column's precomputed stages 1-2 entry
    from `precompute_apply_stages`; it MUST have been computed from this
    column's current dictionary and these updates' write values. A
    ShardedBackend runs stages 1-2 on its inner backend and stage 3 on the
    whole column, which its islands share on one device.
    """
    be = get_backend(backend)
    n, k_old = col.n_rows, col.dict_size
    mods, ins, dels = _split_ops(updates)
    write_vals = np.concatenate([mods["value"], ins["value"]])
    m = len(updates)

    # Stages 1-2: update-dictionary sort + dictionary merge + old->new index.
    update_dict, new_dict, encode, old_to_new = (
        staged if staged is not None
        else _merge_dictionary_stages(be, col.dictionary, write_vals))

    # Encode the write set's values against the new dictionary (the batch's
    # values cross to the device once).
    write_ops = _sorted_write_ops(mods, ins)
    write_codes = encode(write_ops["value"])

    # Stage 3: sequential re-encode through the index + scatter update
    # codes. The gather makes a new tensor and validity is cloned, so the
    # in-place scatters never reach the old column.
    new_codes = torch.index_select(old_to_new.to(torch.int32), 0, col.codes)
    new_codes, valid = _apply_row_ops(new_codes, col.valid.clone(), new_dict,
                                      mods, ins, dels, encode=encode,
                                      write_set=(write_ops, write_codes))

    if cost is not None and m:
        _optimized_apply_cost(cost, on_pim, m, n, k_old, len(new_dict),
                              len(update_dict), col.bit_width, phase=phase)

    return EncodedColumn(codes=new_codes, dictionary=new_dict, valid=valid,
                         version=col.version + 1)


def apply_updates_naive(
    col: EncodedColumn,
    updates: np.ndarray,
    cost: CostLog | None = None,
    phase: str = "apply",
) -> EncodedColumn:
    """The paper's initial algorithm (§5.2), costed as CPU software.

    decompress -> apply -> full sort to rebuild dictionary -> recompress.
    Used as the functional oracle and as the MI baseline's cost generator
    (62.6% of update-application cycles go to (de)compression, Fig. 3).
    """
    dev = col.device
    n = col.n_rows
    mods, ins, dels = _split_ops(updates)
    m = len(updates)

    # Step 1: decompress (n random dictionary lookups) - a new tensor.
    values = col.dictionary[col.codes.long()]
    valid = col.valid.clone()
    # Step 2: apply updates (last-writer-wins).
    if len(ins):
        values, valid = _grow(values, valid, int(ins["row"].max()) + 1)
    write_ops = _sorted_write_ops(mods, ins)
    if len(write_ops):
        last = _last_write_per_row(write_ops["row"])
        rows = from_host(write_ops["row"][last]).to(dev)
        values[rows] = from_host(write_ops["value"][last]).to(
            dev, values.dtype)
        valid[rows] = True
    if len(dels):
        valid[from_host(dels["row"]).to(dev)] = False
    # Step 3: rebuild dictionary by sorting the updated column.
    new_dict = torch.unique(values)
    # Step 4: recompress via per-entry binary search (logarithmic).
    new_codes = torch.searchsorted(new_dict, values).to(torch.int32)

    if cost is not None and m:
        cost.annotate_add(n_applied=int(m))
        n_tot = int(values.shape[0])
        n_eff = min(n_tot,
                    max(1, min(m, n_tot // PARTITION_ROWS + 1)) * PARTITION_ROWS)
        # per-partition (de)compression: decompress + full sort + recompress.
        # SIMD-friendly in-cache sort: ~1 cycle/item/pass, log2(P) passes.
        logp = np.log2(max(PARTITION_ROWS, 2))
        cost.add(
            phase=phase, island="txn", resource="cpu",
            cycles=n_eff * 3.0                                       # decompress
            + m * CPU_CYCLES_PER_SCAN_ITEM                           # apply
            + n_eff * logp * 1.0                                     # sort passes
            + n_eff * 3.0,                                           # recompress
            bytes_offchip=(
                n_eff * VALUE_BYTES * 2           # decode read+write
                + n_eff * VALUE_BYTES * 2.0       # sort passes (out-of-cache)
                + n_eff * VALUE_BYTES * 1.5       # binary-search traffic
            ),
        )

    return EncodedColumn(codes=new_codes,
                         dictionary=new_dict.to(col.dictionary.dtype),
                         valid=valid, version=col.version + 1)
