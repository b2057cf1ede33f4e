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


def fed_mix_matching_ref(perms: torch.Tensor, survive: torch.Tensor,
                         x_new: torch.Tensor, x_old: torch.Tensor
                         ) -> torch.Tensor:
    """perms: [S, D] int stage partner indices (perm[i] = i for byes);
    survive: [D] 0/1; x_new, x_old: [D, P] -> [D, P].

    Stragglers contribute their OLD row, then each stage averages every
    row with its partner row —

        eff = s·x_new + (1-s)·x_old;  eff = ½(eff + eff[perm_s])  per stage

    — f32 accumulate, cast back to x_new.dtype.
    """
    f32 = torch.float32
    s = survive.to(f32)[:, None]
    eff = s * x_new.to(f32) + (1.0 - s) * x_old.to(f32)
    for i in range(perms.shape[0]):
        eff = 0.5 * (eff + eff[perms[i].long()])
    return eff.to(x_new.dtype)


def fed_mix_q_ref(m_new: torch.Tensor, m_old: torch.Tensor,
                  q_new: torch.Tensor, scales: torch.Tensor,
                  x_old: torch.Tensor, *, chunk: int = 256,
                  out_dtype=None) -> torch.Tensor:
    """m_new, m_old: [D, D]; q_new: int8 [D, Pq] (Pq a multiple of chunk);
    scales: f32 [D, Pq/chunk]; x_old: [D, P], P <= Pq -> [D, P].

    Dequantize the int8 record (one absmax scale per chunk), then the
    dense f32 mix; the output is ``out_dtype`` or x_old's dtype.
    """
    f32 = torch.float32
    d, n = q_new.shape[0], x_old.shape[1]
    v = q_new.to(f32).reshape(d, -1, chunk)
    xn = (v * scales.to(f32)[..., None]).reshape(d, -1)[:, :n]
    out = m_new.to(f32) @ xn
    out = out + m_old.to(f32) @ x_old.to(f32)
    return out.to(x_old.dtype if out_dtype is None else out_dtype)


def fed_aggregate_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [N, D]; w: [N] -> [D]: out[d] = sum_n w[n] x[n, d], f32
    accumulate, cast back to x.dtype."""
    f32 = torch.float32
    return torch.einsum("n,nd->d", w.to(f32), x.to(f32)).to(x.dtype)
