"""``fed_mix_q`` — the fused dense mixing kernel of the int8 wire

    O = M_new @ dequant(Q_new, scales) + M_old @ X_old

with [D, D] mixing matrices, the ``Int8Codec`` record of X_new (int8
values [D, Pq], Pq a multiple of ``chunk``, one f32 absmax scale per
chunk: [D, Pq/chunk]) and the [D, P <= Pq] round-start buffer X_old,
accumulated in full f32. ``ops.fed_mix_flat`` calls it on
``mix_path="dense"`` with the int8 codec. The kernel is
``csrc/fed_mix_q.cu`` (``fed_mix.cu``'s split-f32 tensor-core design with
Q staged as int8 and widened in the fragment load: at a chunk that is a
multiple of 32 the scale folds into M_new, else the load dequantizes;
replacing the Pallas ``repro.kernels.fed_mix_q.fed_mix_q``); CPU tensors
take ``ref.fed_mix_q_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, ref

_DTYPES = (torch.float32, torch.bfloat16)


def _check(m_new, m_old, q_new, scales, x_old, chunk, out_dtype) -> str:
    name = "fed_mix_q"
    if q_new.dim() != 2 or x_old.dim() != 2:
        raise ValueError(f"{name}: q_new and x_old must be 2-D, got shapes "
                         f"{tuple(q_new.shape)} and {tuple(x_old.shape)}")
    if q_new.dtype != torch.int8:
        raise ValueError(f"{name}: q_new must be int8, got {q_new.dtype}")
    if x_old.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"{name}: x_old and out_dtype must be float32 or "
                         f"bfloat16, got {x_old.dtype} and {out_dtype}")
    if chunk < 1:
        raise ValueError(f"{name}: chunk must be >= 1, got {chunk}")
    d, pq = q_new.shape
    p = x_old.shape[1]
    # the JAX kernel's layout checks (repro/kernels/fed_mix_q.py:92-96)
    if pq % chunk:
        raise ValueError(f"q_new columns ({pq}) not a multiple of chunk "
                         f"({chunk})")
    if pq < p:
        raise ValueError(f"q_new covers {pq} params < x_old's {p}")
    if x_old.shape[0] != d:
        raise ValueError(f"{name}: x_old has {x_old.shape[0]} rows, q_new "
                         f"{d}")
    if tuple(scales.shape) != (d, pq // chunk):
        raise ValueError(f"{name}: scales must be [D, Pq/chunk]=[{d}, "
                         f"{pq // chunk}], got shape {tuple(scales.shape)}")
    if not scales.is_floating_point():
        raise ValueError(f"{name}: scales must be floating point")
    for arg, m in (("m_new", m_new), ("m_old", m_old)):
        if tuple(m.shape) != (d, d):
            raise ValueError(f"{name}: {arg} must be [D, D]=[{d}, {d}], got "
                             f"shape {tuple(m.shape)}")
        if not m.is_floating_point():
            raise ValueError(f"{name}: {arg} must be floating point")
    device = backend.kernel_device(name, m_new, m_old, q_new, scales, x_old)
    backend.check_contiguous(name, m_new=m_new, m_old=m_old, q_new=q_new,
                             scales=scales, x_old=x_old)
    return device


def fed_mix_q(m_new: torch.Tensor, m_old: torch.Tensor, q_new: torch.Tensor,
              scales: torch.Tensor, x_old: torch.Tensor, *, chunk: int = 256,
              out_dtype=None) -> torch.Tensor:
    """m_new, m_old [D, D]; q_new int8 [D, Pq] (Pq % chunk == 0); scales
    [D, Pq/chunk]; x_old [D, P] f32 or bf16 with P <= Pq, all contiguous
    -> [D, P] in ``out_dtype`` (default x_old.dtype), full f32
    accumulation.

    CPU tensors: the plain version. CUDA tensors: the hand-written kernel
    (``fed_mix_q.launches`` counts its launches)."""
    out_dtype = x_old.dtype if out_dtype is None else out_dtype
    if _check(m_new, m_old, q_new, scales, x_old, chunk, out_dtype) == "cpu":
        return ref.fed_mix_q_ref(m_new, m_old, q_new, scales, x_old,
                                 chunk=chunk, out_dtype=out_dtype)
    d, pq = q_new.shape
    p = x_old.shape[1]
    out = torch.empty((d, p), dtype=out_dtype, device=x_old.device)
    if out.numel() == 0:
        return out
    mn = m_new.to(torch.float32)
    mo = m_old.to(torch.float32)
    sc = scales.to(torch.float32)
    redo_bytes = backend.c_function(
        "fed_mix_q", "fed_mix_q_redo_bytes", [ctypes.c_int, ctypes.c_longlong],
        restype=ctypes.c_longlong)
    # the product's per-warp flags for its redo pass (a tile whose result
    # held an inf or NaN, taken again on the full split)
    redo = torch.empty(redo_bytes(d, p), dtype=torch.uint8,
                       device=x_old.device)
    launch = backend.c_function(
        "fed_mix_q", "fed_mix_q_launch",
        [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p])
    rc = launch(mn.data_ptr(), mo.data_ptr(), q_new.data_ptr(),
                sc.data_ptr(), x_old.data_ptr(), out.data_ptr(),
                redo.data_ptr(), d, p, pq,
                chunk, int(x_old.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16),
                backend.stream_ptr(x_old.device))
    backend.raise_on_error("fed_mix_q", rc)
    fed_mix_q.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
fed_mix_q.launches = 0
