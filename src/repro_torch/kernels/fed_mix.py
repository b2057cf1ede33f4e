"""``fed_mix`` — the fused dense mixing kernel

    O = M_new @ X_new + M_old @ X_old

with [D, D] mixing matrices and packed [D, P] client buffers, accumulated
in full f32 and stored in X_new's dtype. It implements
``mix_path="dense"`` and is the form every ``SegmentSpec`` is held against
(``SegmentSpec.to_dense``). The kernel is ``csrc/fed_mix.cu`` (split-f32
products on the TF32 tensor cores, X streamed once through a cp.async
ring, replacing the Pallas ``repro.kernels.fed_mix.fed_mix``); CPU
tensors take ``ref.fed_mix_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, ref

_DTYPES = (torch.float32, torch.bfloat16)


def _check(m_new, m_old, x_new, x_old) -> str:
    name = "fed_mix"
    if x_new.dim() != 2:
        raise ValueError(f"{name}: x_new must be [D, P], got shape "
                         f"{tuple(x_new.shape)}")
    if x_new.shape != x_old.shape:
        raise ValueError(f"{name}: x_new {tuple(x_new.shape)} and x_old "
                         f"{tuple(x_old.shape)} differ in shape")
    if x_new.dtype != x_old.dtype:
        raise ValueError(f"{name}: x_new ({x_new.dtype}) and x_old "
                         f"({x_old.dtype}) differ in dtype")
    if x_new.dtype not in _DTYPES:
        raise ValueError(f"{name}: x dtype must be float32 or bfloat16, got "
                         f"{x_new.dtype}")
    d = x_new.shape[0]
    for arg, m in (("m_new", m_new), ("m_old", m_old)):
        if tuple(m.shape) != (d, d):
            raise ValueError(f"{name}: {arg} must be [D, D]=[{d}, {d}], got "
                             f"shape {tuple(m.shape)}")
        if not m.is_floating_point():
            raise ValueError(f"{name}: {arg} must be floating point")
    device = backend.kernel_device(name, m_new, m_old, x_new, x_old)
    backend.check_contiguous(name, m_new=m_new, m_old=m_old, x_new=x_new,
                             x_old=x_old)
    return device


def fed_mix(m_new: torch.Tensor, m_old: torch.Tensor, x_new: torch.Tensor,
            x_old: torch.Tensor) -> torch.Tensor:
    """m_new, m_old [D, D]; x_new, x_old [D, P] f32 or bf16, contiguous
    -> [D, P] in x_new.dtype, full f32 accumulation.

    CPU tensors: the plain version. CUDA tensors: the hand-written kernel
    (``fed_mix.launches`` counts its launches)."""
    if _check(m_new, m_old, x_new, x_old) == "cpu":
        return ref.fed_mix_ref(m_new, m_old, x_new, x_old)
    d, p = x_new.shape
    out = torch.empty_like(x_new)
    if out.numel() == 0:
        return out
    mn = m_new.to(torch.float32)
    mo = m_old.to(torch.float32)
    redo_bytes = backend.c_function(
        "fed_mix", "fed_mix_redo_bytes", [ctypes.c_int, ctypes.c_longlong],
        restype=ctypes.c_longlong)
    # the product's per-warp flags for its redo pass (a tile whose result
    # held an inf or NaN, taken again on the full split)
    redo = torch.empty(redo_bytes(d, p), dtype=torch.uint8,
                       device=x_new.device)
    launch = backend.c_function(
        "fed_mix", "fed_mix_launch",
        [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_void_p])
    rc = launch(mn.data_ptr(), mo.data_ptr(), x_new.data_ptr(),
                x_old.data_ptr(), out.data_ptr(), redo.data_ptr(), d, p,
                int(x_new.dtype == torch.bfloat16),
                backend.stream_ptr(x_new.device))
    backend.raise_on_error("fed_mix", rc)
    fed_mix.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
fed_mix.launches = 0
