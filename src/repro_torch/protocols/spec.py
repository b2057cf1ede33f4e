"""MixingSpec — the structured form of a protocol's mixing operator (the
counterpart of ``repro.protocols.spec``).

FedAvg/FedP2P rows agree within a cluster: their dense ``(M_new, M_old)``
pair is block-diagonal with rank-1 blocks (the global-sync server term is
the L=1 case). ``SegmentSpec`` carries that structure in O(D) memory so the
round runs in O(D·P) through the ``fed_mix_segment`` kernel instead of the
O(D²·P) dense contraction; ``to_dense()`` rebuilds ``(M_new, M_old)``
exactly (elementwise products with exact 0/1 membership).

``MatchingSpec`` (the gossip family) arrives with the gossip slice
(ROADMAP), as does the codec seam of ``apply_spec_flat``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import ops as kernel_ops


@dataclass(frozen=True)
class SegmentSpec:
    """Block-diagonal / rank-1 mixing structure (FedAvg, FedP2P)."""
    cluster_ids: torch.Tensor     # [D] int32 output/segment assignment
    w_new: torch.Tensor           # [D] f32 per-source new-model weight
    w_old: torch.Tensor           # [D] f32 per-source old-model weight
    num_segments: int = 1         # L

    def to_dense(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(M_new, M_old) [D, D] — exact reconstruction of the oracle form:
        M[i, j] = [c(i) = c(j)] * w_j."""
        same = (self.cluster_ids[:, None]
                == self.cluster_ids[None, :]).to(torch.float32)
        return (same * self.w_new.to(torch.float32)[None, :],
                same * self.w_old.to(torch.float32)[None, :])


def mix_flat_spec(spec, flat_new, flat_old):
    """One structured mixing pass on packed [D, sum(sizes)] buffers."""
    if isinstance(spec, SegmentSpec):
        return kernel_ops.fed_mix_segment(
            spec.cluster_ids, spec.w_new, spec.w_old, flat_new, flat_old,
            num_segments=spec.num_segments)
    raise TypeError(f"not a ported MixingSpec: {type(spec).__name__!r}")


def apply_spec_flat(spec, flat_new, flat_old, *, codec=None):
    """Structured mixing on packed buffers. The quantized-exchange
    ``codec`` seam is not ported yet (ROADMAP module item 9)."""
    if codec is not None:
        raise NotImplementedError(
            "apply_spec_flat: codecs are not ported yet (ROADMAP module "
            "item 9, compression)")
    return mix_flat_spec(spec, flat_new, flat_old)
