"""FedAvg (paper Algo 1) on the Protocol interface.

One logical cluster = everyone; the server gathers every surviving update
and broadcasts the data-weighted average. ``ctx.do_global_sync`` is
ignored — FedAvg has no cluster-local stage.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.comm_model import CommParams, h_fedavg
from repro_torch.protocols.base import Protocol
from repro_torch.protocols.context import RoundContext
from repro_torch.protocols.spec import SegmentSpec


class FedAvg(Protocol):
    """P = ``fl.participation`` clients, one cluster (the base class's
    defaults)."""

    name = "fedavg"

    def mixing_spec(self, ctx: RoundContext) -> SegmentSpec:
        """The whole round is one rank-1 term — a single segment: every
        output row is the |D_i|-weighted average of the surviving updates
        (everyone-straggled rounds keep the mean of the old params)."""
        f32 = torch.float32
        D = ctx.survive.shape[0]
        dev = ctx.survive.device
        s = ctx.survive.to(f32)
        w = s * ctx.counts.to(f32)
        total = torch.sum(w)
        coef = torch.where(total > 0, w / torch.clamp_min(total, 1e-12),
                           torch.zeros((), dtype=f32, device=dev))
        all_dead = (total == 0).to(f32)
        return SegmentSpec(
            cluster_ids=torch.zeros((D,), dtype=torch.int32, device=dev),
            w_new=coef,
            w_old=all_dead * torch.full((D,), 1.0 / D, dtype=f32, device=dev),
            num_segments=1)

    def mixing_matrix(self, ctx: RoundContext):
        # the dense form IS the spec, densified (exact — see to_dense)
        return self.mixing_spec(ctx).to_dense()

    def comm_time(self, p: CommParams, P: int, *, L: Optional[float] = None,
                  ctx: Optional[RoundContext] = None) -> float:
        return h_fedavg(p, P)

    def wire_model(self, D: int, L: int, *, do_global_sync: bool = True):
        """One global ring over all D clients, two model copies: the
        |D_i|-weighted new-model allreduce plus the old-params dead-round
        fallback."""
        return ((D, 1, 2.0),)
