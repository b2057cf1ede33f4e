"""``fed_aggregate`` — the paper's ``Aggregate(·)`` operator

    out[j] = sum_n w[n] x[n, j]

over N stacked replicas of a packed [N, D] parameter buffer, accumulated
in f32 and stored in x's dtype (``ops.fed_aggregate`` /
``ops.fed_aggregate_tree``). The kernel is ``csrc/fed_aggregate.cu`` (a
column-parallel pass that walks the N rows in order, replacing the Pallas
``repro.kernels.fed_aggregate.fed_aggregate``); CPU tensors take
``ref.fed_aggregate_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, ref

_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, w) -> str:
    name = "fed_aggregate"
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [N, D], got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x dtype must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if tuple(w.shape) != (x.shape[0],):
        raise ValueError(f"{name}: w must be [N]=[{x.shape[0]}], got shape "
                         f"{tuple(w.shape)}")
    if not w.is_floating_point():
        raise ValueError(f"{name}: w must be floating point")
    device = backend.kernel_device(name, x, w)
    backend.check_contiguous(name, x=x, w=w)
    return device


def fed_aggregate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [N, D] f32 or bf16, contiguous; w [N] -> [D] in x.dtype, f32
    accumulation.

    CPU tensors: the plain version. CUDA tensors: the hand-written kernel
    (``fed_aggregate.launches`` counts its launches)."""
    if _check(x, w) == "cpu":
        return ref.fed_aggregate_ref(x, w)
    n, d = x.shape
    out = torch.empty((d,), dtype=x.dtype, device=x.device)
    if d == 0:
        return out
    wf = w.to(torch.float32)
    launch = backend.c_function(
        "fed_aggregate", "fed_aggregate_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_void_p])
    rc = launch(x.data_ptr(), wf.data_ptr(), out.data_ptr(), n, d,
                int(x.dtype == torch.bfloat16), backend.stream_ptr(x.device))
    backend.raise_on_error("fed_aggregate", rc)
    fed_aggregate.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
fed_aggregate.launches = 0
