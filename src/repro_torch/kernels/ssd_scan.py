"""``ssd_scan`` — the Mamba-2 chunked SSD scan

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t,   y_t = h_t · C_t

with the contract of ``ssd_chunked`` (``models/ssm.py`` in the JAX
package): x [b, S, h, p], dt [b, S, h] (post-softplus), A [h] (< 0), B/C
[b, S, n], a chunk that divides S and an optional initial state
[b, h, p, n] -> (y [b, S, h, p] in x's dtype, final state [b, h, p, n]
f32). The kernel is ``csrc/ssd_scan.cu``, replacing the Pallas
``repro.kernels.ssd_scan.ssd_scan``: three launches on the caller's
stream, the chunk-local states over a (b, h, chunk) grid, the short
recurrence of the [p, n] state across chunks, and the output over a
(b, h, chunk, 64-row tile) grid, every product split-f32 on the tensor
cores. The chunk states live in a [b, h, S/chunk, p, n] f32 workspace
that the wrapper takes from PyTorch's caching allocator. CPU tensors take
``ref.ssd_chunked``. The mixer's x, B and C are slices of its conv
output: the kernel reads them by strides, so nothing is copied.

Gradients. On CUDA tensors that need one, the call goes through
``_SSDScan`` (a ``torch.autograd.Function``): the forward keeps its chunk
workspace (each chunk's incoming state, 6.5 MB a layer at Hymba's B 2 x
2048) for the backward, ``ssd_scan_bwd`` (``csrc/ssd_scan_bwd.cu``, its
products split-f32 on the tensor cores), which gives the gradients of x,
dt, A, B, C and the initial state (f32 only). Its W∘L workspace holds a
64 x 64 f32 tile per head and tile pair of each chunk (79 MB at Hymba's
B 2 x 2048, chunk 128, 50 heads).
Without a gradient the kernel launches as it does for serving. CPU tensors
differentiate through ``ref.ssd_chunked``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import backend, ref

_DTYPES = (torch.float32, torch.bfloat16)
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 1024, 64, 256


def _check(x, dt, A, B, C, chunk, initial_state) -> str:
    name = "ssd_scan"
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [b, S, h, p], got "
                         f"{tuple(x.shape)}")
    b, s, h, p = x.shape
    if tuple(dt.shape) != (b, s, h):
        raise ValueError(f"{name}: dt must be [b, S, h]={[b, s, h]}, got "
                         f"{tuple(dt.shape)}")
    if tuple(A.shape) != (h,):
        raise ValueError(f"{name}: A must be [h]=[{h}], got "
                         f"{tuple(A.shape)}")
    if B.dim() != 3 or B.shape != C.shape or tuple(B.shape[:2]) != (b, s):
        raise ValueError(f"{name}: B {tuple(B.shape)} and C "
                         f"{tuple(C.shape)} must both be [b={b}, S={s}, n]")
    if not (x.dtype == B.dtype == C.dtype) or x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x, B, C must share one dtype, float32 or "
                         f"bfloat16; got {x.dtype}, {B.dtype}, {C.dtype}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"{name}: chunk {chunk} must divide S={s}")
    tensors = (x, dt, A, B, C)
    if initial_state is not None:
        if tuple(initial_state.shape) != (b, h, p, B.shape[2]):
            raise ValueError(
                f"{name}: initial_state must be [b, h, p, n]="
                f"{[b, h, p, B.shape[2]]}, got "
                f"{tuple(initial_state.shape)}")
        tensors += (initial_state,)
    return backend.kernel_device(name, *tensors)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [b, S, h, p] in x's dtype, final_state [b, h, p, n] f32); see the
    module docstring. ``initial_state=None`` starts from zeros.

    CPU tensors: the plain version. CUDA tensors: the hand-written kernel
    (``ssd_scan.launches`` counts its calls: one call is three
    launches of its passes); on the card the last
    stride of x, B and C must be 1, chunk <= 1024, p <= 64, n <= 256.
    Non-finite values come out as the JAX kernel gives them: an inf or NaN
    in x·dt, B or C makes the earlier rows of its chunk NaN, as the
    reference's 0 above the diagonal times inf does. When a gradient is
    needed the call is differentiable through ``ssd_scan_bwd`` (f32
    only)."""
    chunk = int(chunk)
    if _check(x, dt, A, B, C, chunk, initial_state) == "cpu":
        return ref.ssd_chunked(x, dt, A, B, C, chunk,
                               initial_state=initial_state)
    inputs = (x, dt, A, B, C) + (() if initial_state is None
                                 else (initial_state,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _SSDScan.apply(x, dt, A, B, C, initial_state, chunk)
    y, final, _ = _launch(x, dt, A, B, C, chunk, initial_state)
    return y, final


def _launch(x, dt, A, B, C, chunk, initial_state):
    """The forward kernel on CUDA tensors -> (y, final state, the chunk
    workspace: each chunk's incoming state [b, h, S/chunk, p, n] f32)."""
    b, s, h, p = x.shape
    n = B.shape[2]
    if chunk > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"ssd_scan: chunk {chunk} (<= {MAX_CHUNK}), p {p} "
                         f"(<= {MAX_HEAD_DIM}) or n {n} (<= {MAX_STATE}) "
                         "is outside what the kernel takes")
    for arg, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: {arg}'s last stride must be 1, got "
                             f"strides {tuple(t.stride())}")
    f32 = torch.float32
    dt = dt.to(f32)
    A = A.to(f32).contiguous()
    init = (None if initial_state is None
            else initial_state.to(f32).contiguous())
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((b, h, p, n), dtype=f32, device=x.device)
    # the chunk states (then each chunk's incoming state) and a at each
    # chunk's last row, written and read by the kernel's three passes
    ws = torch.empty((b, h, s // chunk, p, n), dtype=f32, device=x.device)
    if y.numel() == 0 or final.numel() == 0:       # nothing to scan
        return y, (final.zero_() if init is None else final.copy_(init)), \
            ws.zero_()
    alast = torch.empty((b, h, s // chunk), dtype=f32, device=x.device)
    # per 64-source tile and group of state columns: the columns where x·dt
    # (or B) is not finite, from pass 1 for pass 3
    flags = torch.empty((b, h, s // chunk, -(-chunk // 64), 4),
                        dtype=torch.int64, device=x.device)
    strides = (ctypes.c_longlong * 10)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2])
    launch = backend.c_function(
        "ssd_scan", "ssd_scan_launch",
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    rc = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), None if init is None else init.data_ptr(),
                y.data_ptr(), final.data_ptr(), ws.data_ptr(),
                alast.data_ptr(), flags.data_ptr(), strides, b, s, h, p, n,
                chunk, int(x.dtype == torch.bfloat16),
                backend.stream_ptr(x.device))
    backend.raise_on_error("ssd_scan", rc)
    ssd_scan.launches += 1
    return y, final, ws


#: calls that launched the kernel since the last reset (CPU calls do not
#: count)
ssd_scan.launches = 0


class _SSDScan(torch.autograd.Function):
    """The kernel with its hand-written backward, for CUDA tensors that
    need a gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state, chunk):
        if x.dtype != torch.float32 or B.dtype != torch.float32:
            raise ValueError("ssd_scan_bwd: the backward kernel takes f32 "
                             f"x, B and C, got {x.dtype}")
        y, final, ws = _launch(x, dt, A, B, C, chunk, initial_state)
        ctx.save_for_backward(x, dt, A, B, C, ws)
        ctx.chunk = chunk
        ctx.has_init = initial_state is not None
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C, ws = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC, dinit = ssd_scan_bwd(
            x, dt, A, B, C, ws, dy, dfinal, chunk=ctx.chunk,
            with_initial_state=ctx.has_init)
        return (dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC, dinit, None)


def ssd_scan_bwd(x, dt, A, B, C, ws, dy, dfinal=None, *, chunk: int,
                 with_initial_state: bool = False):
    """The backward kernel, on the card: from the forward's inputs, its
    chunk workspace ``ws`` (each chunk's incoming state), y's cotangent
    ``dy`` and the final state's (``dfinal``, None for zero) ->
    (dx, d(dt), dA, dB, dC, d(initial_state) or None), f32
    (``ssd_scan_bwd.launches`` counts its calls: one call is eight
    launches). Non-finite values come out where the plain version's
    autograd gives them."""
    name = "ssd_scan_bwd"
    tensors = (x, dt, A, B, C, ws, dy) + (() if dfinal is None
                                          else (dfinal,))
    if backend.kernel_device(name, *tensors) != "cuda":
        raise ValueError(f"{name}: runs on CUDA tensors only (CPU tensors "
                         "differentiate through ref.ssd_chunked)")
    f32 = torch.float32
    if any(t.dtype != f32 for t in (x, B, C, dy)):
        raise ValueError(f"{name}: x, B, C and dy must be float32")
    b, s, h, p = x.shape
    n = B.shape[2]
    chunk = int(chunk)
    nc = s // chunk
    dt = dt.to(f32)
    A = A.to(f32).contiguous()
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    if dfinal is not None:
        dfinal = dfinal.to(f32).contiguous()
    dev = x.device

    def empty(*shape):
        return torch.empty(shape, dtype=f32, device=dev)

    dx, ddt, dA = empty(b, s, h, p), empty(b, s, h), empty(h)
    dB, dC = empty(b, s, n), empty(b, s, n)
    dinit = empty(b, h, p, n) if with_initial_state else None
    if x.numel() == 0 or B.numel() == 0:
        return (dx.zero_(), ddt.zero_(), dA.zero_(), dB.zero_(), dC.zero_(),
                None if dfinal is None or dinit is None else dinit.copy_(
                    dfinal))
    # workspaces: the chunks' a, the state cotangents, the carry blocks'
    # parts of the decays' cotangents, each chunk's part of dA, each head's
    # part of dB and dC (the chunk states' terms), da's row terms, its
    # column sums per row tile and its last-row terms; W∘L per head and
    # tile pair; G = C·Bᵀ per tile pair (shared by the heads); dB and dC
    # per tile pair (the head sum's products); and the masks of non-finite
    # values (the kernel writes every word of every workspace)
    tiles = -(-chunk // 64)
    pairs = tiles * (tiles + 1) // 2
    carry_blocks = -(-(p * n) // 256)
    acum, dst = empty(b, h, s), empty(b, h, nc, p, n)
    dalast = empty(b, h, nc, carry_blocks)
    dAp, dBp, dCp = empty(b, h, nc), empty(b, h, s, n), empty(b, h, s, n)
    da_row, colsum, ddd = empty(b, h, s), empty(b, h, tiles, s), empty(b, h, s)
    wl = empty(b, h, nc, pairs, 64 * 64)
    gf = empty(b, nc, pairs, 64 * 64)
    dBq, dCq = empty(b, tiles, s, n), empty(b, tiles, s, n)
    i64 = torch.int64
    fl_dy = torch.empty((b, h, nc, tiles), dtype=i64, device=dev)
    fl_B = torch.empty((b, nc, tiles, 4), dtype=i64, device=dev)
    fl_C = torch.empty_like(fl_B)
    rowbits = torch.empty((b, s, h), dtype=torch.uint8, device=dev)
    rowflag = torch.empty((b, s), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * 32)(*[
        None if t is None else t.data_ptr() for t in (
            x, dt, A, B, C, dy, dfinal, ws, acum, dst, dalast, dinit, dx,
            ddt, dAp, dBp, dCp, da_row, colsum, ddd, wl, gf, dBq, dCq,
            fl_dy, fl_B, fl_C, rowbits, rowflag, dA, dB, dC)])
    strides = (ctypes.c_longlong * 13)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
        *dy.stride()[:3])
    launch = backend.c_function(
        "ssd_scan_bwd", "ssd_scan_bwd_launch",
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    rc = launch(ptrs, strides, b, s, h, p, n, chunk,
                backend.stream_ptr(dev))
    backend.raise_on_error(name, rc)
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dinit


#: backward kernel launches since the last reset
ssd_scan_bwd.launches = 0
