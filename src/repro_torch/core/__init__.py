"""Polynesia core (PyTorch port): the paper's primary contribution.

An HTAP system as two *islands* - a transactional island on the host (NSM
row store, per-thread update logs) and an analytical island whose
dictionary-encoded DSM replica lives on the GPU - connected by update
propagation (shipping + application), a column-grain snapshot consistency
mechanism, and an analytical engine whose scans, merges, sorts and
snapshot copies run as hand-written CUDA kernels.

The public surface mirrors the paper's sections:
  §4 islands            -> htap.py + session.py (system compositions)
                           + elastic.py (resize, checkpoint, crash replay)
  §5 update propagation -> shipping.py + application.py
  §6 consistency        -> consistency.py (+ mvcc.py / snapshot.py baselines)
  §7 analytical engine  -> engine.py + placement.py + scheduler.py
  §8 methodology        -> hwmodel.py (the paper's HMC cost/energy model)
                           + timeline.py (its round-by-round event replay)
"""

from repro_torch.core.schema import TableSchema, gen_table, gen_update_stream  # noqa: F401
from repro_torch.core.dsm import (EncodedColumn, encode_column, decode_column,  # noqa: F401
                                  DSMReplica)
from repro_torch.core.nsm import RowStore, UpdateLog, UPDATE_DTYPE  # noqa: F401
from repro_torch.core.shipping import merge_logs, ship_updates, FINAL_LOG_CAPACITY  # noqa: F401
from repro_torch.core.application import apply_updates, apply_updates_naive  # noqa: F401
from repro_torch.core.consistency import ConsistencyManager  # noqa: F401
from repro_torch.core.hwmodel import HardwareModel, HMC_PARAMS, CostLog  # noqa: F401
from repro_torch.core.session import HTAPSession, SystemSpec  # noqa: F401
from repro_torch.core import elastic  # noqa: F401
from repro_torch.core.workload import split_queries, split_stream  # noqa: F401
