"""``FLConfig`` — the port's copy of ``repro.config.FLConfig``: the same
fields, defaults and validation, so one configuration means the same run in
both packages. Options the port has not reached yet (faults, sampled
participation) keep their fields; the engines raise
``NotImplementedError`` when a run asks for them.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FLConfig:
    """FedP2P / FedAvg protocol parameters (paper §3.1, Algo 1 & 2)."""

    num_clients: int = 100           # N
    num_clusters: int = 10           # L (FedP2P local P2P networks)
    devices_per_cluster: int = 10    # Q
    participation: int = 10          # P for FedAvg (=|Z|); FedP2P uses L*Q
    rounds: int = 100                # T
    local_epochs: int = 20           # E (paper §4.2)
    batch_size: int = 10             # O
    lr: float = 0.01                 # eta
    straggler_rate: float = 0.0      # fraction of selected devices that drop
    sync_period: int = 1             # global sync every k rounds (1 = paper)
    seed: int = 0
    # any registered protocol name; validated at dispatch — unknown names
    # raise
    algorithm: str = "fedp2p"
    # §5: upgrade the algorithm to its "_topo" hop-aware variant
    topology_aware: bool = False
    # the lossy wire format of exchanged updates (a repro_torch.compression
    # name: none | bf16 | int8 | topk)
    codec: str = "none"
    # which mixing lowering the engines run (dense | sparse | auto):
    # "dense" = the [D, D] mixing-matrix form (the fed_mix kernel),
    # "sparse" = the protocol's structured MixingSpec (the fed_mix_segment
    # kernel; raises for spec-less protocols), "auto" = sparse exactly
    # where a spec exists.
    mix_path: str = "auto"
    # --- sampled participation (not ported yet) ---
    num_enrolled: int = 0
    participants_per_round: int = 0
    participation_strategy: str = "uniform"
    participation_rate: float = 1.0
    # --- fault tolerance / store (not ported yet) ---
    store_read_retries: int = 2
    store_read_backoff: float = 0.05
    prefetch_timeout: float = 0.0

    def __post_init__(self):
        if self.num_enrolled < 0:
            raise ValueError(
                f"FLConfig: num_enrolled must be >= 0 (0 = resident mode), "
                f"got {self.num_enrolled}")
        if self.participants_per_round < 0:
            raise ValueError(
                f"FLConfig: participants_per_round must be >= 0 (0 = the "
                f"protocol's own participant count), got "
                f"{self.participants_per_round}")
        if (self.num_enrolled and self.participants_per_round
                and self.participants_per_round > self.num_enrolled):
            raise ValueError(
                f"FLConfig: participants_per_round="
                f"{self.participants_per_round} active clients exceed the "
                f"num_enrolled={self.num_enrolled} enrolled population; a "
                "sampled round needs K <= D")
        if not (0.0 < self.participation_rate <= 1.0):
            raise ValueError(
                f"FLConfig: participation_rate must lie in (0, 1], got "
                f"{self.participation_rate}")
        if self.store_read_retries < 0:
            raise ValueError(
                f"FLConfig: store_read_retries must be >= 0, got "
                f"{self.store_read_retries}")
        if self.store_read_backoff < 0:
            raise ValueError(
                f"FLConfig: store_read_backoff must be >= 0, got "
                f"{self.store_read_backoff}")
        if self.prefetch_timeout < 0:
            raise ValueError(
                f"FLConfig: prefetch_timeout must be >= 0 (0 = wait "
                f"forever), got {self.prefetch_timeout}")

    @property
    def enrolled(self) -> int:
        """D — the client population a state store holds: ``num_enrolled``
        when sampled participation is on, else ``num_clients``."""
        return self.num_enrolled or self.num_clients
