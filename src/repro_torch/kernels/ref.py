"""Plain PyTorch versions of the port's kernels (the counterpart of
``repro.kernels.ref``).

Each function computes what its CUDA kernel computes, with stock tensor
ops: the wrappers take it for CPU tensors, the CPU tests hold it against
the JAX package, and ``chip_smoke.py`` holds each kernel against it on the
card. It is not used on the main path when a card is present. On CUDA its
matmuls need TF32 off (``backend.use_full_f32``), as the reference is full
f32.
"""
from __future__ import annotations

import torch


def fed_mix_ref(m_new: torch.Tensor, m_old: torch.Tensor,
                x_new: torch.Tensor, x_old: torch.Tensor) -> torch.Tensor:
    """m_new, m_old: [D, D]; x_new, x_old: [D, P] -> [D, P].

    The dense mixing operator f_out = M_new @ f_new + M_old @ f_old on
    flat-packed client params (f32 accumulate, cast back to x_new.dtype).
    """
    f32 = torch.float32
    out = m_new.to(f32) @ x_new.to(f32)
    out = out + m_old.to(f32) @ x_old.to(f32)
    return out.to(x_new.dtype)


def fed_mix_segment_ref(cluster_ids: torch.Tensor, w_new: torch.Tensor,
                        w_old: torch.Tensor, x_new: torch.Tensor,
                        x_old: torch.Tensor, *, num_segments: int
                        ) -> torch.Tensor:
    """cluster_ids: [D] int; w_new, w_old: [D]; x_new, x_old: [D, P];
    num_segments: L -> [D, P].

    Per-cluster sums of the weighted rows, gathered back to every member
    row —

        out_i = sum_{j: c(j)=c(i)} (w_new_j x_new_j + w_old_j x_old_j)

    — f32 accumulate, cast back to x_new.dtype.
    """
    f32 = torch.float32
    ids = cluster_ids.long()
    y = (w_new.to(f32)[:, None] * x_new.to(f32)
         + w_old.to(f32)[:, None] * x_old.to(f32))
    seg = y.new_zeros((num_segments, y.shape[1])).index_add_(0, ids, y)
    return seg[ids].to(x_new.dtype)
