"""Elastic island lifecycle: online resharding, checkpoint/restore, replay.

Polynesia fixes its analytical island count at session start; the island
architecture (§3/§4) has no such constraint - the analytical side scales
independently of the transactional side, which is what cloud-native HTAP
deployments (PolarDB-IMCI, PAPERS.md) exercise: add or remove read
replicas under load, recover them from shipped logs. This module gives
`HTAPSession` (MI family) the three lifecycle capabilities:

* **Online resharding** - `resize_islands(session, n)` at a round
  boundary: the pending update backlog is flushed through the *old* plane,
  live delta overlays are compacted (a resized partition needs a folded
  base), the stacked views / consistency plane swap to the new island
  count in one all-or-none `ConsistencyManager.rebind_backend` pass, and
  on the mesh placement every column is re-placed at once on the new
  island devices (`MeshBackend.place_shards`), so the next pin adopts
  resident islands. The rebalance is priced as a ``reshard`` node on the
  fixed-function lane (the copy units repartition the replica); queries
  wait for it (``_vis_node``) but the next round's transactions do not.
  Answer-neutral by construction: the replica columns are untouched, only
  their partition changes, and the island reduction is exact.

* **Checkpoint / restore** - `checkpoint_session` serializes the complete
  session state (base columns + dictionaries, delta overlays, the pending
  ship backlog in the per-thread update logs, counters and commit
  positions, and the full CostLog with its timeline tags) into
  `repro_torch.checkpoint.save_checkpoint`'s atomic-commit layout
  (``step_<N>/{manifest.json,arrays.npz}`` + ``LATEST``; the session
  metadata rides *inside* arrays.npz as a JSON blob, so the commit stays
  atomic). The keys and the metadata are the JAX package's, so either
  package restores the other's checkpoint (given a spec of its own
  backends). `restore_session` rebuilds the session on the target's device
  - optionally onto a *different* spec: backend, island count, placement
  (the elastic-restart path) - and continues bit-identically.

* **Crash-recovery replay** - `SessionCrash` + the session's
  ``crash_after_ships`` limit (set by a caller; no environment variable
  arms it) kill a session mid-propagation (before ship batch N leaves);
  `run_with_recovery` restores the last committed checkpoint and replays
  the update stream's tail from the checkpointed commit position, landing
  on the same answers as the crash-free run.

The entry points take devices as `HTAPSession` does: ``device`` for the
session (None: the GPU), ``devices`` for mesh islands (a list may repeat a
device, e.g. ``["cuda:0"] * 4``). A resize keeps the replica where it is:
its new backend lives on the session's device (on the mesh, island 0's).

Pricing caveat: a resized session's timeline prices every node at its
emission-time island count (``meta["islands"]``, see
`timeline._node_model`); the whole-run phase-bucket model has no per-node
granularity and prices at the session's final count.
"""

from __future__ import annotations

import dataclasses
import itertools
import json

import numpy as np

from repro_torch.checkpoint import latest_step, load_arrays, save_checkpoint
from repro_torch.core import dsm
from repro_torch.core.backend import BACKENDS, ExecutionBackend, get_backend
from repro_torch.core.consistency import _Version
from repro_torch.core.hwmodel import CostEvent, HardwareParams, TimelineTag
from repro_torch.core.nsm import UPDATE_DTYPE, make_entries
from repro_torch.core.schema import VALUE_BYTES
from repro_torch.distributed import current_island_mesh, install_island_mesh
from repro_torch.kernels.common import resolve_device

# Bump when the serialized layout changes incompatibly; restore refuses
# mismatched formats instead of mis-deserializing.
CHECKPOINT_FORMAT = 1


class SessionCrash(RuntimeError):
    """Injected fault: the session's 'process' died mid-propagation.

    Raised by `maybe_crash` when a session's cumulative ship-batch count
    reaches its ``crash_after_ships`` limit (set by a test harness or
    `run_with_recovery`). The session is unusable afterwards - call
    `HTAPSession.abort()` and recover from the last committed checkpoint
    (`run_with_recovery`).
    """


def maybe_crash(session) -> None:
    """Fault-injection hook, called before every ship batch leaves.

    With ``crash_after_ships = N``, exactly N batches ship successfully
    and the (N+1)-th raises `SessionCrash` - after the triggering txn
    chunk executed into the row store/logs but before the batch drains, so
    the crash lands *between* a checkpoint and the next visibility point,
    the window replay must cover.
    """
    limit = session.crash_after_ships
    if limit is not None and session._ship_i >= limit:
        raise SessionCrash(
            f"injected crash: ship batch #{session._ship_i} reached the "
            f"crash_after_ships limit ({limit}); recover from the last "
            "committed checkpoint")


# ---------------------------------------------------------------------------
# Online resharding
# ---------------------------------------------------------------------------

def resize_islands(session, n_islands: int, placement: str | None = None,
                   devices=None) -> str | None:
    """Repartition the session's analytical islands to ``n_islands``.

    MI family only, between query batches (no pinned snapshot handles).
    ``devices`` lists the new mesh islands' devices (None: the installed
    island devices, else ``cuda:0 ..``); island 0's must be the session's
    device, where the replica lives. Sequence: resolve the new backend
    first (unknown placements, too few devices and a backend on another
    device fail before any state moves), flush the pending update backlog
    through the OLD propagation plane, compact every live delta overlay
    (the overlay algebra is relative to the base the old partition
    applied; a folded base reshards cleanly), then swap -
    `ConsistencyManager.rebind_backend` invalidates every old-partition
    view all-or-none, the session's backend, island count and hardware
    scaling follow, and a mesh target installs its island devices and
    re-places every column's shards there (Phase-2 residency) so the next
    pin adopts them.

    The rebalance is priced as one ``reshard`` timeline node on the
    fixed-function lane: the copy units read and rewrite every base
    column (+ dictionary) to the new partition. Queries wait on it (it
    becomes every column's visibility node); the next round's transactions
    do not (background rebalance, like compaction).

    Returns the reshard node's name, or None for a no-op resize (same
    count, placement and devices). Answers are bit-identical across any
    resize schedule - the partition is not observable in query results.
    """
    session._check_open()
    if session.spec.kind != "multi_instance":
        raise ValueError(
            f"resize_islands is a multiple-instance mechanism (analytical "
            f"islands to repartition); {session.spec.name!r} is kind "
            f"{session.spec.kind!r}")
    n_islands = int(n_islands)
    if n_islands < 1:
        raise ValueError(f"n_islands must be >= 1, got {n_islands}")
    old_islands = session.islands
    old_placement = session.be.placement
    if placement is None:
        placement = old_placement
    if n_islands == old_islands and placement == old_placement and (
            devices is None or tuple(resolve_device(d) for d in devices)
            == getattr(session.be, "devices", None)):
        return None
    if session.cons._handles:
        raise RuntimeError(
            "resize_islands with pinned query handles in flight; resizes "
            "happen between query batches")

    # 1. resolve the new backend (fail fast: unknown placement, too few
    #    mesh devices, another device, ad-hoc instances)
    inner_name = getattr(session.be, "inner", session.be).name
    if isinstance(session.spec.backend, ExecutionBackend) \
            or inner_name not in BACKENDS:
        raise ValueError(
            f"resize_islands re-resolves the backend by registered name, "
            f"but the session runs an ad-hoc backend instance "
            f"({inner_name!r}); build the session from a backend spec "
            f"string (one of {sorted(BACKENDS)})")
    new_be = get_backend(inner_name, device=session.device,
                         n_shards=n_islands, placement=placement,
                         devices=devices)

    # 2. drain the old plane: ship the backlog, fold live overlays
    session.flush_updates()
    reshard_node = f"r{session.round}:reshard{len(session.resizes)}"
    compact_nodes: list[str] = []
    if session.delta_enabled:
        for col_id in sorted(session._deltas):
            delta = session._deltas[col_id]
            if not delta.n_overlay:
                continue
            deps = ((session._vis_node[col_id],)
                    if col_id in session._vis_node else ())
            compact_nodes.append(session._compact_column(
                col_id, delta, deps=deps, ship_node=reshard_node))

    # 3. price the rebalance: the copy engines of the NEW island set pull
    #    the complete replica (codes + dictionary) into the new partition -
    #    read + write, vault-local (the islands' stacks)
    moved = 0.0
    for col in session.replica.columns.values():
        moved += 2 * (col.encoded_bytes + col.dict_size * VALUE_BYTES)
    deps = tuple(dict.fromkeys(
        list(session._vis_node.values()) + compact_nodes))
    with session.cost.tagged(reshard_node, "reshard", round=session.round,
                             deps=deps, islands=n_islands,
                             n_from=old_islands, n_to=n_islands,
                             placement=placement):
        session.cost.add(phase="reshard", island="ana", resource="copy",
                         bytes_local=moved)

    # 4. the all-or-none swap: consistency plane, backend, island scaling
    session.cons.rebind_backend(new_be)
    session.be = new_be
    session.device = new_be.device
    session.islands = new_be.n_shards
    hw = session.spec.hw
    if session.islands > 1 and hw.n_ana_islands == 1:
        hw = dataclasses.replace(hw, n_ana_islands=session.islands)
    session.hw = hw

    # 5. island devices: install the mesh's (keeping the pre-session ones
    #    for finish()/abort() to restore) and re-place every column's
    #    shards on them now, or release them when leaving the mesh
    if new_be.placement == "mesh":
        if not session.mesh:
            session._prev_mesh = current_island_mesh()
        install_island_mesh(new_be.devices)
        session.mesh = True
        for col_id, col in session.replica.columns.items():
            session.cons._resident[col_id] = new_be.place_shards(
                dsm.shard_column(col, session.islands))
    elif session.mesh:
        session._release_mesh()
        session.mesh = False
        session._prev_mesh = None

    # 6. visibility: every column's next pin waits for the rebalance
    for col_id in session.replica.columns:
        session._vis_node[col_id] = reshard_node
    session.resizes.append({"round": session.round, "from": old_islands,
                            "to": session.islands,
                            "placement": placement, "node": reshard_node})
    return reshard_node


# ---------------------------------------------------------------------------
# Checkpoint / restore
# ---------------------------------------------------------------------------

def _json_default(o):
    """json.dumps fallback: numpy scalars in tag metadata -> python."""
    if hasattr(o, "item"):
        return o.item()
    raise TypeError(f"checkpoint metadata is not JSON-serializable: "
                    f"{type(o).__name__} {o!r}")


def _spec_meta(spec) -> dict:
    """SystemSpec -> JSON-safe dict (hw expands to its field dict)."""
    if isinstance(spec.backend, ExecutionBackend):
        raise ValueError(
            "cannot checkpoint a session whose spec carries an ad-hoc "
            "backend *instance*; build the spec from a backend name "
            "(e.g. backend='hopper@4/mesh') so restore can re-resolve it")
    return dataclasses.asdict(spec)


def _spec_from_meta(d: dict):
    from repro_torch.core.session import SystemSpec
    d = dict(d)
    d["hw"] = HardwareParams(**d["hw"])
    return SystemSpec(**d)


def checkpoint_session(session, ckpt_dir: str, step: int | None = None) -> int:
    """Serialize a live MI session into the atomic checkpoint layout.

    Everything the session needs to continue bit-identically goes into one
    `save_checkpoint` tree (single ``arrays.npz`` + manifest, committed
    atomically by the ``LATEST`` rename - a crash mid-save leaves the
    previous committed step authoritative):

    * row-store data + the per-thread update logs (the pending ship
      backlog, field-split from the structured dtype),
    * every DSM base column (codes int32, dictionary int32, valid bool,
      copied off the device) + its version,
    * live delta overlays (rows/values/valid/cids + capacity counters),
    * the session metadata blob (spec, round/commit positions, results so
      far, visibility nodes, resize trail, and the full CostLog - events
      and timeline tags - as JSON inside the npz, keeping commit atomic).

    ``step`` defaults to the current round. Returns the step written.
    """
    session._check_open()
    if session.spec.kind != "multi_instance":
        raise ValueError(
            f"checkpoint/restore targets the multiple-instance family; "
            f"{session.spec.name!r} is kind {session.spec.kind!r}")
    if session.cons._handles:
        raise RuntimeError(
            "checkpoint with pinned query handles in flight; checkpoint "
            "between query batches")
    if step is None:
        step = session.round
    tree: dict = {"store/data": session.store.data}
    for log in session.store.logs:
        pending = (np.concatenate(log.entries) if log.entries
                   else np.empty(0, dtype=UPDATE_DTYPE))
        for field in UPDATE_DTYPE.names:
            tree[f"log{log.thread_id}/{field}"] = np.ascontiguousarray(
                pending[field])
    col_versions = {}
    for c, col in session.replica.columns.items():
        # tensors as they are: the writer copies them to the host once
        tree[f"col{c}/codes"] = col.codes
        tree[f"col{c}/dictionary"] = col.dictionary
        tree[f"col{c}/valid"] = col.valid
        col_versions[c] = int(col.version)
    delta_meta = {}
    for c, d in session._deltas.items():
        tree[f"delta{c}/rows"] = np.asarray(d.rows)
        tree[f"delta{c}/values"] = np.asarray(d.values)
        tree[f"delta{c}/valid"] = np.asarray(d.valid)
        tree[f"delta{c}/cids"] = np.asarray(d.cids)
        delta_meta[c] = {"n_base": int(d.n_base),
                         "n_entries": int(d.n_entries)}
    meta = {
        "format": CHECKPOINT_FORMAT,
        "spec": _spec_meta(session.spec),
        "round": session.round,
        "txn_i": session._txn_i,
        "ana_i": session._ana_i,
        "snap_i": session._snap_i,
        "ship_i": session._ship_i,
        "n_txn": session.n_txn,
        "n_ana": session.n_ana,
        "results": list(session.results),
        "prev_txn": session._prev_txn,
        "vis_node": {str(c): n for c, n in session._vis_node.items()},
        "round_prop": list(session._round_prop),
        "prev_round_prop": list(session._prev_round_prop),
        "applications": session.applications,
        "delta_appends": session.delta_appends,
        "compactions": session.compactions,
        "resizes": [dict(r) for r in session.resizes],
        # snapshot-chain state: which columns are clean (their head
        # snapshot still answers the next pin without a copy). With no
        # pinned handles each chain holds at most its head, and a clean
        # head's content equals the current base column - so restore can
        # reseed it from the restored base. Without this, a restored
        # delta-plane session re-snapshots columns the uninterrupted run
        # would share, and the modeled copy traffic drifts.
        "chains": {str(c): {"dirty": bool(ch.dirty),
                            "head": ch.head is not None}
                   for c, ch in session.cons.chains.items()},
        "col_versions": {str(c): v for c, v in col_versions.items()},
        "delta_meta": {str(c): m for c, m in delta_meta.items()},
        "n_threads": session.store.n_threads,
        "cost": {
            "events": [dataclasses.asdict(e) for e in session.cost.events],
            "tags": [dataclasses.asdict(t)
                     for t in session.cost.tags.values()],
        },
    }
    blob = json.dumps(meta, default=_json_default).encode("utf-8")
    tree["meta"] = np.frombuffer(blob, dtype=np.uint8)
    save_checkpoint(ckpt_dir, step, tree, wait=True)
    return step


def restore_session(ckpt_dir: str, spec=None, step: int | None = None,
                    device=None, devices=None):
    """Rebuild an `HTAPSession` from a committed checkpoint.

    ``step=None`` restores the last *committed* step (``latest_step`` -
    an interrupted save never wins). ``spec=None`` re-resolves the
    checkpointed spec (a checkpoint of the JAX package names its own
    backends, which `get_backend` refuses: pass a spec of this package's);
    passing a spec restores onto a *different* target (backend, island
    count, placement - the elastic-restart path; the timing/async flags
    may differ too). The session lives on ``device`` (None: the GPU), its
    mesh islands on ``devices``. The restored session continues exactly
    where the checkpoint left off: same pending backlog, same commit
    positions, same CostLog (tags and all), so driving it with the
    remaining workload reproduces the uninterrupted run's answers - and,
    when the plane matches, its modeled throughput - bit for bit.

    Cross-plane restriction: a checkpoint carrying live delta overlays
    cannot restore onto an eager-plane target (the eager scan path would
    silently ignore the overlays); compact or flush before checkpointing,
    or restore with ``delta_store=True``.
    """
    from repro_torch.core.session import HTAPSession, _resolve_delta
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {ckpt_dir!r}")
    arrays = load_arrays(ckpt_dir, step)
    meta = json.loads(bytes(arrays["meta"]).decode("utf-8"))
    if meta.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(
            f"checkpoint format {meta.get('format')!r} does not match "
            f"this build's {CHECKPOINT_FORMAT} - re-checkpoint from a "
            "matching session")
    if spec is None:
        spec = _spec_from_meta(meta["spec"])
    if spec.kind != "multi_instance":
        raise ValueError(
            f"restore targets the multiple-instance family; the requested "
            f"spec {spec.name!r} is kind {spec.kind!r}")
    # refused before the session (and its replica) is built
    live = sum(len(arrays[f"delta{c}/rows"]) for c in meta["delta_meta"])
    if live and not _resolve_delta(spec)[0]:
        raise ValueError(
            f"checkpoint carries {live} live delta-overlay rows but the "
            "restore target runs the eager update plane; restore with "
            "delta_store=True, or flush + compact before checkpointing")
    session = HTAPSession(spec, arrays["store/data"], device=device,
                          devices=devices)
    try:
        _restore_state(session, arrays, meta)
    except BaseException:
        session.abort()       # releases the mesh devices it installed
        raise
    return session


def _restore_state(session, arrays: dict, meta: dict) -> None:
    if session.store.n_threads != meta["n_threads"]:
        raise ValueError(
            f"checkpoint has {meta['n_threads']} txn threads, the restore "
            f"target has {session.store.n_threads}")

    # pending ship backlog: per-thread logs, re-assembled from the
    # field-split arrays (one contiguous entry batch per thread)
    for log in session.store.logs:
        pref = f"log{log.thread_id}/"
        entries = make_entries(arrays[pref + "commit_id"],
                               arrays[pref + "op"],
                               arrays[pref + "value"],
                               arrays[pref + "row"],
                               arrays[pref + "col"])
        log.entries = [entries] if len(entries) else []

    # DSM base columns onto the session's device, swapped in place - the
    # ConsistencyManager shares this dict, and its fresh chains (dirty, no
    # versions) re-snapshot on the first pinned read, under the TARGET
    # backend's partition
    versions = {int(c): int(v) for c, v in meta["col_versions"].items()}
    for c in list(session.replica.columns):
        key = f"col{c}/"
        session.replica.columns[c] = dsm.column_from_numpy(
            arrays[key + "codes"], arrays[key + "dictionary"],
            arrays[key + "valid"], versions[c], session.device)

    # delta overlays (host numpy, as the session keeps them)
    session._deltas = {}
    for c_str, dm in meta["delta_meta"].items():
        c = int(c_str)
        key = f"delta{c}/"
        session._deltas[c] = dsm.ColumnDelta(
            rows=arrays[key + "rows"], values=arrays[key + "values"],
            valid=arrays[key + "valid"], cids=arrays[key + "cids"],
            n_base=int(dm["n_base"]), n_entries=int(dm["n_entries"]))

    # snapshot-chain state: reseed clean heads so the next pin shares the
    # snapshot exactly like the uninterrupted session would (a clean
    # head's content == the current base column; dirty chains re-snapshot
    # on the next pin either way, at the same modeled cost)
    for c_str, info in meta.get("chains", {}).items():
        chain = session.cons.chains[int(c_str)]
        chain.dirty = bool(info["dirty"])
        if info["head"] and not chain.dirty:
            chain.versions = [_Version(
                version_id=next(session.cons._version_ids),
                column=session.replica.columns[int(c_str)])]

    # positions / counters / node-graph cursors
    session.round = int(meta["round"])
    session._txn_i = int(meta["txn_i"])
    session._ana_i = int(meta["ana_i"])
    session._snap_i = int(meta["snap_i"])
    session._ship_i = int(meta["ship_i"])
    session.n_txn = int(meta["n_txn"])
    session.n_ana = int(meta["n_ana"])
    session.results = [int(a) for a in meta["results"]]
    session._prev_txn = meta["prev_txn"]
    session._vis_node = {int(c): n for c, n in meta["vis_node"].items()}
    session._round_prop = list(meta["round_prop"])
    session._prev_round_prop = tuple(meta["prev_round_prop"])
    session.applications = int(meta["applications"])
    session.delta_appends = int(meta["delta_appends"])
    session.compactions = int(meta["compactions"])
    session.resizes = [dict(r) for r in meta["resizes"]]

    # the CostLog, mutated in place (the ConsistencyManager holds a
    # reference): replayed events + tags continue the original node graph,
    # and the seq counter resumes past the checkpointed maximum
    cost = session.cost
    cost.events = [CostEvent(**e) for e in meta["cost"]["events"]]
    cost.tags = {}
    max_seq = -1
    for t in meta["cost"]["tags"]:
        tag = TimelineTag(node=t["node"], kind=t["kind"], round=t["round"],
                          seq=int(t["seq"]), deps=tuple(t["deps"]),
                          sync_deps=tuple(t["sync_deps"]),
                          meta=dict(t["meta"]))
        cost.tags[tag.node] = tag
        max_seq = max(max_seq, tag.seq)
    cost._seq = itertools.count(max_seq + 1)
    cost._active_tag = None


# ---------------------------------------------------------------------------
# Crash-recovery replay
# ---------------------------------------------------------------------------

def run_with_recovery(spec, table, stream, queries, n_rounds: int,
                      ckpt_dir: str, *, crash_after_ships: int | None = None,
                      every: int = 1, restore_spec=None, device=None,
                      devices=None, restore_devices=None):
    """Uniform rounds with round-boundary checkpoints + crash replay.

    Drives ``(stream, queries)`` split into ``n_rounds`` through an
    `HTAPSession` on ``device`` (mesh islands on ``devices``),
    checkpointing after every ``every``-th round. When the armed fault
    (``crash_after_ships``) raises `SessionCrash`, the dead session is
    aborted and a fresh one restores from the last committed checkpoint -
    onto ``restore_spec`` and ``restore_devices`` when given (elastic
    restart; without a ``restore_spec`` the restored session keeps
    ``devices`` unless ``restore_devices`` says otherwise) - and replays
    the remaining rounds: the shipped-update replay is re-executing the
    stream's tail from the checkpointed commit position, which rebuilds the
    same ship batches from the same backlog. A crash before the first
    committed checkpoint cold-restarts from round 0.

    Returns ``(RunResult, recovered)``; the result's answers match the
    crash-free run bit for bit.
    """
    from repro_torch.core.session import HTAPSession
    from repro_torch.core.workload import split_queries, split_stream
    chunks = list(split_stream(stream, n_rounds))
    qchunks = list(split_queries(list(queries), n_rounds))
    session = HTAPSession(spec, table, device=device, devices=devices)
    session.crash_after_ships = crash_after_ships
    try:
        return _drive_rounds(session, chunks, qchunks, 0,
                             ckpt_dir, every), False
    except SessionCrash:
        session.abort()
    if restore_devices is None and restore_spec is None:
        restore_devices = devices
    step = latest_step(ckpt_dir)
    if step is None:
        # died before anything committed: cold restart from the start
        session = HTAPSession(restore_spec or spec, table, device=device,
                              devices=restore_devices)
    else:
        session = restore_session(ckpt_dir, spec=restore_spec,
                                  device=device, devices=restore_devices)
    # the injected fault died with the crashed "process"
    session.crash_after_ships = None
    return _drive_rounds(session, chunks, qchunks,
                         0 if step is None else step, None, every), True


def _drive_rounds(session, chunks, qchunks, start: int,
                  ckpt_dir: str | None, every: int):
    """Rounds ``start..n-1``; checkpoints at boundaries when ckpt_dir set.

    A checkpoint written after round r's query batch gets ``step = r + 1``
    == the number of completed rounds == the round index replay resumes
    from; the final round is never checkpointed (nothing left to replay).
    """
    for r in range(start, len(chunks)):
        if r:
            session.advance_round()
        session.execute(chunks[r])
        session.query_batch(qchunks[r])
        if ckpt_dir is not None and (r + 1) % every == 0 \
                and r + 1 < len(chunks):
            session.checkpoint(ckpt_dir, step=r + 1)
    return session.finish()
