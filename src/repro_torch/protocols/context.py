"""RoundContext — the single per-round record every Protocol method reads
(the counterpart of ``repro.protocols.context``).

  tensor fields
    * ``survive``      — [D] 0/1 straggler mask (f32),
    * ``counts``       — [D] per-client data weights |D_i|,
    * ``cluster_ids``  — [D] cluster assignment (int),
    * ``matching``     — 0-d int64 index of this mix's random matching
      (``gossip_async``), or None,
    * ``fault_drop``   — [D] 0/1 injected-dropout mask of a fault plan
      (already folded into ``survive``; carried separately so protocols
      and cost models can tell injected dropouts from stragglers), or
      None without a plan,
    * ``active_ids``   — [K] enrolled-client ids behind the rows of the
      sampled engine's window, or None on the resident engine (row i IS
      client i).

  plain fields
    * ``round_index``    — the round counter ``t``,
    * ``num_clusters``   — L, the segment count behind ``cluster_ids``,
    * ``do_global_sync`` — whether this round runs the server/global step,
    * ``topology``       — an optional ``core.topology.Topology`` for
      hop-aware protocols (partitioners, cost models),
    * ``num_enrolled``   — D, the enrolled population a sampled window was
      drawn from (0 on the resident engine, where the window is the
      population).

The JAX record's ``key`` has no counterpart: the port's round randomness is
drawn up front into an explicit record (``protocols.engine.RoundDraws``),
and the one stochastic protocol draw, ``gossip_async``'s matching, arrives
already drawn as ``matching`` — a device tensor, so the round loop never
reads it back. Its mesh and codec fields arrive with the mesh slice
(ROADMAP module item 13).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.topology import Topology


@dataclass(frozen=True)
class RoundContext:
    survive: torch.Tensor         # [D] 0/1 straggler mask
    counts: torch.Tensor          # [D] per-client data weights |D_i|
    cluster_ids: torch.Tensor     # [D] cluster assignment
    matching: Optional[torch.Tensor] = None   # 0-d int64 matching index
    fault_drop: Optional[torch.Tensor] = None  # [D] injected dropouts
    active_ids: Optional[torch.Tensor] = None  # [K] window's client ids
    round_index: int = 0
    num_clusters: int = 1
    do_global_sync: bool = True
    topology: Optional[Topology] = None
    num_enrolled: int = 0


def make_context(*, round_index=0, survive=None, counts=None,
                 cluster_ids=None, matching=None,
                 num_clusters: Optional[int] = None,
                 do_global_sync: bool = True,
                 topology: Optional[Topology] = None, fault_drop=None,
                 num_clients: Optional[int] = None, active_ids=None,
                 num_enrolled: int = 0) -> RoundContext:
    """Build a RoundContext, defaulting every unspecified field.

    D is inferred from (in order) ``survive``, ``counts``, ``cluster_ids``,
    or ``num_clients`` (default 1); defaults are made on the device of the
    given tensors (else the CPU). ``num_clusters`` defaults to
    ``max(cluster_ids) + 1``, which reads the ids back to the host —
    engines pass it explicitly."""
    given = [a for a in (survive, counts, cluster_ids) if a is not None]
    device = given[0].device if given else torch.device("cpu")
    D = num_clients
    if D is None:
        D = int(given[0].shape[0]) if given else 1
    if survive is None:
        survive = torch.ones((D,), dtype=torch.float32, device=device)
    if counts is None:
        counts = torch.ones((D,), dtype=torch.float32, device=device)
    if cluster_ids is None:
        cluster_ids = torch.zeros((D,), dtype=torch.int32, device=device)
    if num_clusters is None:
        num_clusters = (int(cluster_ids.max()) + 1
                        if cluster_ids.numel() else 1)
    return RoundContext(survive=survive, counts=counts,
                        cluster_ids=cluster_ids, matching=matching,
                        fault_drop=fault_drop, active_ids=active_ids,
                        round_index=int(round_index),
                        num_clusters=int(num_clusters),
                        do_global_sync=bool(do_global_sync),
                        topology=topology, num_enrolled=int(num_enrolled))
