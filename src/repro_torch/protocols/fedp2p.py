"""FedP2P (paper Algo 2) on the Protocol interface.

Phase 1 partitions the round's L*Q participants into L local P2P networks;
phase 2 is a data-weighted Allreduce within each network; phase 3 (when
``ctx.do_global_sync``) is the thin server step: an unweighted mean over
the per-cluster models. Dead clusters (all members straggled) fall back to
the mean of their members' old params, never to zeros. ``ctx.counts``
weights the within-cluster stage on every lowering; on a mesh of ranks
(``psum_mix``) the stages are all-reduces within each cluster's process
group, then over every rank.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import FLConfig
from repro_torch.core.comm_model import CommParams, h_fedp2p, min_h_fedp2p
from repro_torch.core.partition import random_partition
from repro_torch.core.topology import Topology
from repro_torch.protocols.base import Protocol
from repro_torch.protocols.context import RoundContext
from repro_torch.protocols.spec import SegmentSpec


class FedP2P(Protocol):
    name = "fedp2p"

    def num_participants(self, fl: FLConfig) -> int:
        return fl.num_clusters * fl.devices_per_cluster

    def num_clusters(self, fl: FLConfig) -> int:
        return fl.num_clusters

    def partition(self, gen: torch.Generator, fl: FLConfig,
                  topology: Optional[Topology] = None):
        return random_partition(gen, fl.num_clients, fl.num_clusters,
                                fl.devices_per_cluster)

    def mesh_cluster_ids(self, num_clients_dev: int,
                         fl: FLConfig) -> np.ndarray:
        """L equal contiguous clusters over the D-wide axis; needs L | D."""
        L = fl.num_clusters
        if num_clients_dev % L:
            raise ValueError(f"fedp2p: {num_clients_dev} clients do not "
                             f"split into L={L} equal clusters")
        return np.repeat(np.arange(L, dtype=np.int32), num_clients_dev // L)

    def mixing_spec(self, ctx: RoundContext) -> SegmentSpec:
        """Cluster-segment structure: within-cluster data-weighted
        averaging is a block-diagonal operator whose rows agree inside each
        cluster (one segment per local P2P network); the phase-3 server
        step collapses everything to ONE segment. Dead clusters fall back
        to the mean of their members' OLD params via ``w_old``. The same
        operations, in the same order, as the JAX package's, so
        ``to_dense`` reproduces its ``mixing_matrix`` bit for bit."""
        f32 = torch.float32
        L = ctx.num_clusters
        D = ctx.survive.shape[0]
        dev = ctx.survive.device
        s = ctx.survive.to(f32)
        w = s * ctx.counts.to(f32)
        C = F.one_hot(ctx.cluster_ids.long(), L).to(f32)            # [D, L]
        denom = torch.clamp_min(C.T @ w, 1e-12)                      # [L]
        alive = (C.T @ s > 0).to(f32)                                # [L]
        # gamma_j = w_j / denom_{c(j)} — within-cluster data weights
        gamma = w * (C @ (alive / denom))                            # [D]
        if ctx.do_global_sync:
            n_alive = torch.clamp_min(torch.sum(alive), 1.0)
            all_dead = (torch.sum(alive) == 0).to(f32)
            return SegmentSpec(
                cluster_ids=torch.zeros((D,), dtype=torch.int32, device=dev),
                w_new=gamma / n_alive,
                w_old=all_dead * torch.full((D,), 1.0 / D, dtype=f32,
                                            device=dev),
                num_segments=1)
        sizes = torch.clamp_min(C.T @ torch.ones((D,), dtype=f32, device=dev),
                                1.0)                                 # [L]
        dead = C @ (1.0 - alive)                                     # [D]
        return SegmentSpec(
            cluster_ids=ctx.cluster_ids.to(torch.int32),
            w_new=gamma,
            w_old=dead * (C @ (1.0 / sizes)),
            num_segments=L)

    def mixing_matrix(self, ctx: RoundContext):
        """The dense form is the cluster-segment spec, densified (exact —
        see SegmentSpec.to_dense)."""
        return self.mixing_spec(ctx).to_dense()

    def mesh_partitions(self, num_clients: int, cluster_ids) -> tuple:
        return (self._groups_from_ids(cluster_ids),)

    def psum_mix(self, f_new, f_old, ctx: RoundContext):
        """The grouped hierarchy: a data-weighted all-reduce within each
        cluster (with the dead cluster's all-reduced old-params mean),
        then on sync rounds a global all-reduce of the cluster models for
        the server step (with the everyone-dead fallback) — the literal
        traffic pattern of the paper. The per-cluster weights come from
        the [D] vectors every rank holds, without a collective."""
        f32 = torch.float32
        info = ctx.mesh_info
        groups = self._groups_from_ids(ctx.cluster_ids)
        D = self.static_num_clients(ctx)
        mine = next(g for g in groups if info.rank in g)
        q = len(mine)
        s_all = ctx.survive.to(f32)
        w_all = s_all * ctx.counts.to(f32)
        denom = w_all[mine].sum()
        alive = (s_all[mine].sum() > 0).to(f32)
        n_alive = torch.stack([s_all[g].sum() > 0 for g in groups]
                              ).to(f32).sum()
        keep_old = (n_alive == 0).to(f32)
        sync = ctx.do_global_sync

        def local_fn(x_new, x_old, s, c):
            w = s.to(f32) * c.to(f32)
            gamma = alive * torch.where(
                denom > 0, w / torch.clamp_min(denom, 1e-12),
                torch.zeros((), dtype=f32, device=w.device))
            cl = info.psum(gamma[:, None] * x_new, groups)
            cl_old = info.psum(x_old / q, groups)
            cl = torch.where(alive > 0, cl, cl_old)
            if not sync:
                return cl
            g = info.psum(cl * (alive / q)) / torch.clamp_min(n_alive, 1.0)
            return g + keep_old * info.psum(x_old / D)

        return self._shard_mix(local_fn, f_new, f_old, ctx)

    def comm_time(self, p: CommParams, P: int, *, L: Optional[float] = None,
                  ctx: Optional[RoundContext] = None) -> float:
        if L is None:
            return min_h_fedp2p(p, P)       # at the closed-form optimal L*
        return h_fedp2p(p, P, L)

    def wire_model(self, D: int, L: int, *, do_global_sync: bool = True):
        """L within-cluster rings of q = D/L devices (two copies: the
        weighted cluster-local allreduce + the dead-cluster old-params
        fallback), plus — on sync rounds — one global ring, again two
        copies."""
        q = D // L
        entries = ((q, L, 2.0),)
        if do_global_sync:
            entries += ((D, 1, 2.0),)
        return entries
