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

The delta-store plane (`apply_updates_delta`) leaves the column alone: a
batch that only modifies or deletes existing rows collapses to one overlay
entry per row and merges into the column's sorted `ColumnDelta` (on the
merge unit on the accelerator backend); `compaction_entries` later folds
the overlay back through `apply_updates`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.backend import (HopperBackend, ShardedBackend,
                                      get_backend)
from repro_torch.core.dsm import ColumnDelta, EncodedColumn
from repro_torch.core.hwmodel import CostLog
from repro_torch.core.nsm import UPDATE_DTYPE
from repro_torch.core.schema import VALUE_BYTES
from repro_torch.kernels.common import from_host
from repro_torch.kernels.merge_runs import merge_sorted_runs

# software (CPU) costs for the same steps, for the MI baseline
CPU_CYCLES_PER_CMP = 8.0
CPU_CYCLES_PER_LOOKUP = 30.0   # random dictionary access (cache-missing)
CPU_CYCLES_PER_SCAN_ITEM = 3.0
# One delta-overlay entry: row id (8) + value (4) + cid (8) + valid/pad (4)
DELTA_ENTRY_BYTES = 24
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


# ---------------------------------------------------------------------------
# Delta-store update plane: append-only overlay + background compaction
# ---------------------------------------------------------------------------

def delta_eligible(updates: np.ndarray, n_base: int) -> bool:
    """A batch can ride the delta overlay iff it only modifies/deletes
    EXISTING base rows. Inserts (op 2) and writes past the base row count
    would change the column length, which the overlay algebra does not
    model - those batches fall back to compact-then-eager-apply."""
    if len(updates) == 0:
        return True
    if np.any(updates["op"] == 2):
        return False
    return int(updates["row"].max()) < n_base


def _base_values(col: EncodedColumn, rows: np.ndarray) -> np.ndarray:
    """The column's raw values at host row ids, gathered on its device
    (one small device-to-host copy, never the column)."""
    idx = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64)).to(
        col.device)
    return col.dictionary[col.codes[idx].long()].cpu().numpy().astype(
        np.int32)


def apply_updates_delta(
    col: EncodedColumn,
    delta: ColumnDelta,
    updates: np.ndarray,
    cost: CostLog | None = None,
    on_pim: bool = True,
    backend=None,
) -> ColumnDelta:
    """Append a shipped update batch to the column's delta overlay.

    Instead of the two-stage rebuild (`apply_updates`), the batch collapses
    to one overlay entry per touched row (last-writer-wins, reproducing
    `_apply_row_ops`' writes-then-deletes batch semantics) and merges into
    the sorted overlay keyed by row id - on the merge unit
    (kernels/merge_runs) on the accelerator backend. Work is O(m + d),
    never O(n): the base column is untouched (delete-only rows read their
    current value with one small gather on the device). Scans see the
    batch through the query-time correction (engine.run_query_group_dsm)
    and compaction later folds the overlay into the base
    (`compaction_entries` -> `apply_updates`).

    Requires `delta_eligible(updates, delta.n_base)`; raises ValueError
    otherwise. Returns the NEW overlay (the caller swaps the pointer).
    """
    if not delta_eligible(updates, delta.n_base):
        raise ValueError(
            "update batch has inserts or rows past the overlay's base row "
            "count; compact the overlay and use the eager apply instead")
    m = len(updates)
    if m == 0:
        return delta
    be = get_backend(backend)
    inner = be.inner if isinstance(be, ShardedBackend) else be

    mods = updates[updates["op"] == 1]
    dels = updates[updates["op"] == 3]
    # commit order within the batch (ship buffers are commit-ordered per
    # column already; sort defensively, as _sorted_write_ops does)
    if len(mods):
        mods = mods[np.argsort(mods["commit_id"], kind="stable")]
    if len(dels):
        dels = dels[np.argsort(dels["commit_id"], kind="stable")]

    rows_b = np.unique(np.concatenate([mods["row"], dels["row"]])
                       ).astype(np.int64)
    d_batch = len(rows_b)
    if d_batch == 0:  # read-only batch: state-neutral, still priced below
        new = ColumnDelta(rows=delta.rows, values=delta.values,
                          valid=delta.valid, cids=delta.cids,
                          n_base=delta.n_base,
                          n_entries=delta.n_entries + m)
        _delta_append_cost(cost, on_pim, m, delta.n_overlay, 0,
                           new.n_overlay)
        return new

    # Per-row batch state, matching the eager batch semantics exactly:
    # ALL writes land in commit order (last one wins), then deletes clear
    # validity - a written+deleted row keeps its written value.
    has_w = np.zeros(d_batch, dtype=bool)
    last_val = np.zeros(d_batch, dtype=np.int32)
    if len(mods):
        wi = np.searchsorted(rows_b, mods["row"].astype(np.int64))
        has_w[wi] = True
        last_val[wi] = mods["value"]          # in-order scatter: last wins
    has_d = np.zeros(d_batch, dtype=bool)
    if len(dels):
        has_d[np.searchsorted(rows_b, dels["row"].astype(np.int64))] = True
    valid_b = has_w & ~has_d
    # delete-only rows carry the row's CURRENT effective value (the eager
    # path keeps a deleted row's code, and f-selected aggregates still read
    # it) - the overlay's value if the row is overlayed, else the base's
    value_b = last_val.copy()
    carry = ~has_w
    if carry.any():
        rows_c = rows_b[carry]
        vals_c = _base_values(col, rows_c)
        if delta.n_overlay:
            oi = np.searchsorted(delta.rows, rows_c)
            oic = np.minimum(oi, delta.n_overlay - 1)
            hit = delta.rows[oic] == rows_c
            vals_c = np.where(hit, delta.values[oic], vals_c)
        value_b[carry] = vals_c
    cid_b = np.zeros(d_batch, dtype=np.int64)
    touch = np.concatenate([mods, dels]) if len(dels) else mods
    if len(touch):
        touch = touch[np.argsort(touch["commit_id"], kind="stable")]
        cid_b[np.searchsorted(rows_b, touch["row"].astype(np.int64))] = \
            touch["commit_id"]                # in-order scatter: latest wins

    # Merge old overlay + batch rows (a sorted-run merge on the merge unit
    # when both runs exist); normalize to keep-LAST per key with the batch
    # winning, whatever the merge's tie order (a stable host lexsort).
    d_old = delta.n_overlay
    if d_old == 0:
        keys_sorted, sel = rows_b, np.arange(d_batch, dtype=np.int64)
    else:
        if isinstance(inner, HopperBackend):
            merged_keys, src = merge_sorted_runs([delta.rows, rows_b],
                                                 device=inner.device)
            keys = merged_keys.cpu().numpy()
            src = src.cpu().numpy().astype(np.int64)
        else:
            keys = np.concatenate([delta.rows, rows_b])
            src = np.arange(d_old + d_batch, dtype=np.int64)
        order = np.lexsort((src, keys))
        keys_sorted, sel = keys[order], src[order]
        keep = np.append(keys_sorted[1:] != keys_sorted[:-1], True)
        keys_sorted, sel = keys_sorted[keep], sel[keep]
    cat_vals = np.concatenate([delta.values, value_b])
    cat_valid = np.concatenate([delta.valid, valid_b])
    cat_cids = np.concatenate([delta.cids, cid_b])
    new = ColumnDelta(rows=keys_sorted.astype(np.int64),
                      values=cat_vals[sel], valid=cat_valid[sel],
                      cids=cat_cids[sel], n_base=delta.n_base,
                      n_entries=delta.n_entries + m)
    _delta_append_cost(cost, on_pim, m, d_old, d_batch, new.n_overlay)
    return new


def _delta_append_cost(cost: CostLog | None, on_pim: bool, m: int,
                       d_old: int, d_batch: int, d_new: int) -> None:
    """Cost events for one overlay append: collapse the batch to per-row
    state (sorter), write the collapsed run into the overlay's run list
    (copy unit), and the amortized run-list bookkeeping (merge unit). No
    O(n) re-encode term and no O(d_old) overlay rewrite: appends stay
    O(batch). The deferred work is paid by every scan's correction pass
    and by compaction."""
    if cost is None or m == 0:
        return
    cost.annotate_add(n_applied=int(m))
    if on_pim:
        cost.add(phase="apply", island="ana", resource="sorter", items=m)
        cost.add(phase="apply", island="ana", resource="merge",
                 items=d_batch, bytes_local=d_batch * DELTA_ENTRY_BYTES)
        cost.add(phase="apply", island="ana", resource="copy",
                 bytes_local=2 * d_batch * DELTA_ENTRY_BYTES)
    else:
        cost.add(
            phase="apply", island="txn", resource="cpu",
            cycles=m * np.log2(max(m, 2)) * CPU_CYCLES_PER_CMP
            + m * CPU_CYCLES_PER_SCAN_ITEM
            + m * CPU_CYCLES_PER_LOOKUP,
            bytes_offchip=2 * d_batch * DELTA_ENTRY_BYTES,
        )


def compaction_entries(delta: ColumnDelta, col_id: int = 0) -> np.ndarray:
    """Synthesize the update batch that folds an overlay into the base.

    One write per overlay row (every row carries a defined value, see
    `ColumnDelta.values`, so a deleted row's last value lands in the base
    codes as the eager path would have left it) plus a delete for each
    invalid row, stamped with the overlay's commit ids and sorted back into
    commit order. Through `apply_updates` this reproduces the eager end
    state, modulo a possibly SMALLER dictionary (the eager path keeps
    overwritten values in its dictionary; both are sorted supersets of the
    live values, so every value range maps to the same rows and answers
    are unchanged)."""
    d = delta.n_overlay
    writes = np.zeros(d, dtype=UPDATE_DTYPE)
    writes["commit_id"] = delta.cids
    writes["op"] = 1
    writes["value"] = delta.values
    writes["row"] = delta.rows
    writes["col"] = col_id
    invalid = ~delta.valid
    dels = np.zeros(int(invalid.sum()), dtype=UPDATE_DTYPE)
    dels["commit_id"] = delta.cids[invalid]
    dels["op"] = 3
    dels["value"] = delta.values[invalid]
    dels["row"] = delta.rows[invalid]
    dels["col"] = col_id
    cat = np.concatenate([writes, dels])
    # stable: a row's delete sorts after its equal-cid write, reproducing
    # the eager writes-then-deletes batch order
    return cat[np.argsort(cat["commit_id"], kind="stable")]
