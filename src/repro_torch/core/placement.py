"""Data placement strategies (§7.1) and the vault-group abstraction.

Strategy 1 ("Local")  — whole column + dictionary in one vault.
Strategy 2 ("Remote") — column partitioned across ALL vaults in the cube.
Strategy 3 ("Hybrid") — column partitioned across a *vault group* (4 vaults),
                        dictionary REPLICATED in every vault of the group
                        (cheap because most columns have <=32 distinct
                        values, ~2 KB, per Krueger et al. [43]).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hwmodel import HardwareParams

STRATEGY_LOCAL = 1
STRATEGY_REMOTE = 2
STRATEGY_HYBRID = 3


@dataclasses.dataclass(frozen=True)
class Placement:
    strategy: int
    n_vaults: int                 # total vaults (n_vaults * n_stacks)
    group_size: int = 4
    replicate_dictionary: bool = True  # Strategy 3's local dictionary copies

    # -- topology ----------------------------------------------------------
    @property
    def n_groups(self) -> int:
        if self.strategy == STRATEGY_LOCAL:
            return self.n_vaults
        if self.strategy == STRATEGY_REMOTE:
            return 1
        return max(1, self.n_vaults // self.group_size)

    @property
    def vaults_per_group(self) -> int:
        if self.strategy == STRATEGY_LOCAL:
            return 1
        if self.strategy == STRATEGY_REMOTE:
            return self.n_vaults
        return self.group_size

    def column_group(self, col_id: int) -> int:
        """Round-robin column -> group ownership."""
        return col_id % self.n_groups

    def column_vaults(self, col_id: int) -> np.ndarray:
        g = self.column_group(col_id)
        v = self.vaults_per_group
        return np.arange(g * v, (g + 1) * v) % self.n_vaults

    # -- derived bandwidth/compute available to one query -------------------
    def query_bandwidth(self, hw: HardwareParams) -> float:
        return self.vaults_per_group * hw.vault_bw

    def query_pim_cores(self, hw: HardwareParams) -> int:
        return self.vaults_per_group * hw.pim_cores_per_vault

    # -- update-application traffic model (the §7.1 trade-off) -------------
    def update_application_traffic(self, col_bytes: float, dict_bytes: float):
        """Returns (local_bytes, remote_bytes) for one column update pass.

        Strategy 2's gather/scatter: the column partitions must be gathered
        to one place and scattered back (2x remote for the non-local
        (v-1)/v fraction), plus dictionary access is remote for all but one
        vault. Strategy 3 with replicated dictionaries keeps everything
        inside the group, and the per-vault partition is updated in place
        (remote only for the merge coordination, negligible).
        """
        v = self.vaults_per_group
        if self.strategy == STRATEGY_LOCAL:
            return 2.0 * col_bytes, 0.0
        if self.strategy == STRATEGY_REMOTE:
            remote_frac = (v - 1) / v
            remote = 2.0 * col_bytes * remote_frac + dict_bytes * (v - 1)
            return 2.0 * col_bytes * (1 - remote_frac), remote
        # Hybrid: partitions updated in place; dictionary local (replicated).
        if self.replicate_dictionary:
            return 2.0 * col_bytes, dict_bytes * (v - 1) * 0.0  # broadcast once, amortized
        remote_frac = (v - 1) / v
        return 2.0 * col_bytes * (1 - remote_frac), 2.0 * col_bytes * remote_frac

    def dictionary_storage(self, dict_bytes: float) -> float:
        """Total dictionary storage (the Strategy-2-replication blowup)."""
        if self.strategy == STRATEGY_HYBRID and self.replicate_dictionary:
            return dict_bytes * self.vaults_per_group
        if self.strategy == STRATEGY_REMOTE and self.replicate_dictionary:
            return dict_bytes * self.n_vaults
        return dict_bytes


def local(n_vaults: int) -> Placement:
    return Placement(STRATEGY_LOCAL, n_vaults)


def remote(n_vaults: int) -> Placement:
    return Placement(STRATEGY_REMOTE, n_vaults)


def hybrid(n_vaults: int, group_size: int = 4) -> Placement:
    return Placement(STRATEGY_HYBRID, n_vaults, group_size=group_size)
