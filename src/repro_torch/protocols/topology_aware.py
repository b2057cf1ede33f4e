"""TopologyAwareFedP2P — the paper's §5 extension on the Protocol interface
(the counterpart of ``repro.protocols.topology_aware``).

Identical aggregation semantics to FedP2P (by the principle of deferred
decisions any data-independent assignment is distributionally identical to
the random one), but cluster formation groups the sampled devices by hop
distance on a ``core.topology.Topology`` lattice, and the cost model prices
each cluster's Allreduce by its slowest ring link instead of a uniform B_d.
The topology reaches the cost model through ``ctx.topology``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import FLConfig
from repro_torch.core.comm_model import CommParams, optimal_L
from repro_torch.core.topology import (
    Topology, cluster_comm_time, grid_cluster_assignment,
)
from repro_torch.protocols.context import RoundContext
from repro_torch.protocols.fedp2p import FedP2P


class TopologyAwareFedP2P(FedP2P):
    name = "fedp2p_topo"
    needs_topology = True

    def partition(self, gen: torch.Generator, fl: FLConfig,
                  topology: Optional[Topology] = None):
        """``topology.grid_cluster_assignment`` on the device: sample L*Q
        devices uniformly, sort them by row-major region key, cut into L
        contiguous clusters — small intra-cluster hop counts. Region keys
        tie often (100 devices on 64 regions), so the sort is stable, as
        ``jnp.argsort`` is: ties keep their selection order. Without a
        topology: FedP2P's random partition."""
        if topology is None:
            return super().partition(gen, fl)
        L, Q = fl.num_clusters, fl.devices_per_cluster
        sel = self.select_participants(gen, fl)
        region = torch.as_tensor(
            topology.coords[:, 0] * 1024 + topology.coords[:, 1],
            device=sel.device)
        order = torch.argsort(region[sel], stable=True)
        ids = torch.zeros((L * Q,), dtype=torch.int32, device=sel.device)
        ids[order] = torch.arange(L, dtype=torch.int32,
                                  device=sel.device).repeat_interleave(Q)
        return sel, ids

    # mixing_matrix / mixing_spec (the cluster-segment sparse path) inherit
    # from FedP2P

    def comm_time(self, p: CommParams, P: int, *, L: Optional[float] = None,
                  ctx: Optional[RoundContext] = None) -> float:
        """Server term from the analytic model + the slowest-cluster ring
        Allreduce on the hop-aware partition (replaces the uniform
        P M / (L B_d) + 2 M / B_d device terms)."""
        topology = ctx.topology if ctx is not None else None
        if topology is None:
            return super().comm_time(p, P, L=L)
        # the lattice has n distinct devices; price a round over min(P, n)
        # of them (duplicated nodes would fake inf-bandwidth self-links)
        n = topology.hops.shape[0]
        P = min(P, n)
        L_int = max(1, min(int(round(L if L is not None else optimal_L(p, P))),
                           P))
        sel = np.arange(P)
        ids = grid_cluster_assignment(topology, sel, L_int)
        intra = max(cluster_comm_time(topology, sel[ids == c], p.wire_bytes)
                    for c in range(L_int))
        server = (1.0 + p.alpha) * L_int * p.wire_bytes / p.server_bw
        return server + intra
