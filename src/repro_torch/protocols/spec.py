"""MixingSpec — the structured form of a protocol's mixing operator (the
counterpart of ``repro.protocols.spec``).

Every ported protocol's dense ``(M_new, M_old)`` pair has O(D²) entries
but O(D) structure, which ``Protocol.mixing_spec(ctx)`` returns as one of
two records so the round runs in O(D·P) instead of the O(D²·P) dense
contraction; ``to_dense()`` rebuilds ``(M_new, M_old)`` exactly.

* ``SegmentSpec`` — cluster-segment form (FedAvg, FedP2P; the global-sync
  server term is the L=1 case), through the ``fed_mix_segment`` kernel:

      out_i = sum_{j: c(j)=c(i)} (w_new_j f_new_j + w_old_j f_old_j)

* ``MatchingSpec`` — permutation form (gossip, gossip_async), through the
  ``fed_mix_matching`` kernel: ``perms`` [S, D] stage partner maps
  (``perm[i] == i`` for byes); stragglers contribute their OLD row, then
  each stage averages every row with its partner. S=2 is the static ring
  gossip (even pairs then odd pairs), S=1 the per-round random matching of
  ``gossip_async``.

``apply_spec_flat`` drives the kernels on packed [D, sum(sizes)] buffers,
with the same quantized-exchange ``codec`` seam as the dense path
(``kernels.ops.fed_mix_flat``): the round DELTA goes through the lossy
wire, and the decoded reconstruction is mixed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import compression
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


@dataclass(frozen=True)
class MatchingSpec:
    """Pairwise-matching mixing structure (gossip family)."""
    perms: torch.Tensor           # [S, D] int32 stage partner maps
    survive: torch.Tensor         # [D] 0/1 straggler mask

    def to_dense(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(M_new, M_old) [D, D]: each stage is W_s = (I + P_s) / 2 (exactly
        1.0 on the diagonal for byes), composed left to right; stragglers
        factor as M_new = W·diag(s), M_old = W·diag(1-s). All entries are
        small dyadic rationals, so the composition is exact in f32."""
        D = self.perms.shape[-1]
        eye = torch.eye(D, dtype=torch.float32, device=self.perms.device)
        W = None
        for i in range(self.perms.shape[0]):
            W_s = 0.5 * (eye + F.one_hot(self.perms[i].long(), D).to(
                torch.float32))
            W = W_s if W is None else W_s @ W
        s = self.survive.to(torch.float32)
        return W * s[None, :], W * (1.0 - s)[None, :]


def mix_flat_spec(spec, flat_new, flat_old):
    """One structured mixing pass on packed [D, sum(sizes)] buffers."""
    if isinstance(spec, SegmentSpec):
        return kernel_ops.fed_mix_segment(
            spec.cluster_ids, spec.w_new, spec.w_old, flat_new, flat_old,
            num_segments=spec.num_segments)
    if isinstance(spec, MatchingSpec):
        return kernel_ops.fed_mix_matching(spec.perms, spec.survive,
                                           flat_new, flat_old)
    raise TypeError(f"not a MixingSpec: {type(spec).__name__!r}")


def apply_spec_flat(spec, flat_new, flat_old, *, codec=None,
                    codec_state=None, u=None):
    """Structured mixing on packed buffers with the same quantized-exchange
    seam as ``kernels.ops.fed_mix_flat``: the round DELTA goes through the
    lossy wire (``ops.wire_flat``), the reconstruction is mixed through
    the spec's kernel (the int8 record is decoded first: the fused
    ``fed_mix_q`` contraction is the dense path's). With ``codec`` the
    call returns ``(flat, new_codec_state)``."""
    codec_given = codec is not None
    codec = None if not codec_given else compression.active(codec)
    if codec is None:
        out = mix_flat_spec(spec, flat_new, flat_old)
        return (out, codec_state) if codec_given else out
    enc, d_shape, base, new_state = kernel_ops.wire_flat(
        codec, flat_new, flat_old, codec_state, u=u)
    x_hat = (base + codec.decode(enc, d_shape)).to(flat_new.dtype)
    return mix_flat_spec(spec, x_hat, flat_old), new_state
