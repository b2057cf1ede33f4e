"""``flash_attention`` — causal attention forward with an optional sliding
window, pinned meta tokens and GQA:

    o[b, h, i] = softmax_j(q[b, h, i] · k[b, h // G, j] / √hd) v[b, h // G, j]

over the keys j a query i sees: j <= i and, when ``window > 0``,
``i - j < window`` or ``j < num_meta``. f32 scores and accumulation, the
output in q's dtype. The kernel is ``csrc/flash_attention.cu`` (an
online-softmax pass over cp.async double-buffered 64-row K/V tiles, both
products split-f32 on the TF32 tensor cores, between two small launches
that give the rows a skipped key tile's inf or NaN in V reaches their
NaN; at head_dim > 128 one block per 128-column slice of O, each over
the full scores; replacing the Pallas
``repro.kernels.flash_attention.flash_attention``); CPU tensors take
``ref.flash_attention_ref``. The model calls it through ``ops`` for
self-attention over positions 0..S-1 (prefill and the cache-free
forward), with q, k, v as ``[B, S, H, hd]`` projections viewed as
``[B, H, S, hd]``: the kernel reads and writes by strides, so no transpose
is copied.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, ref

_DTYPES = (torch.float32, torch.bfloat16)
#: columns of V's non-finite mask per 16-byte entry, and the kernel's O
#: slice at head_dim > 128
_SLICE = 128


def _check(q, k, v, window, num_meta) -> str:
    name = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be [B, H, S, hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be [B={b}, Hkv, T, "
                         f"hd={hd}]")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"{name}: Hq={hq} is not a multiple of "
                         f"Hkv={k.shape[1]}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"{name}: q, k, v must share one dtype, float32 or "
                         f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0 or num_meta < 0:
        raise ValueError(f"{name}: window ({window}) and num_meta "
                         f"({num_meta}) must be >= 0")
    return backend.kernel_device(name, q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, num_meta: int = 0) -> torch.Tensor:
    """q [B, Hq, Sq, hd]; k, v [B, Hkv, T, hd] (Hq a multiple of Hkv), f32
    or bf16 -> [B, Hq, Sq, hd] in q's dtype, with q's memory layout.
    Positions run 0..Sq-1 and 0..T-1.

    CPU tensors: the plain version. CUDA tensors: the hand-written kernel
    (``flash_attention.launches`` counts its calls: one call is three
    launches: V's non-finite flags, the attention, and the NaN the
    skipped tiles add); on the card the
    head_dim stride must be 1, other strides are free; any head_dim.
    Non-finite values come out as the plain version gives them: an inf or
    NaN in V at a key masked for a row makes that row NaN in its column,
    as 0 · inf does in the reference."""
    window, num_meta = int(window), int(num_meta)
    if _check(q, k, v, window, num_meta) == "cpu":
        return ref.flash_attention_ref(q, k, v, window=window,
                                       num_meta=num_meta)
    b, hq, sq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {arg}'s head_dim stride must "
                             f"be 1, got strides {tuple(t.stride())}")
    out = torch.empty_like(q)          # keeps q's layout (a dense view)
    if out.numel() == 0 or tk == 0:
        return out.zero_()
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (q, k, v, out) for s in t.stride()[:3]])
    # per 64-key tile and 128-column slice, the bitmask of V's columns
    # that hold an inf or NaN
    vflags = torch.empty((b, hkv, -(-tk // 64), 4 * -(-hd // _SLICE)),
                         dtype=torch.int32, device=q.device)
    launch = backend.c_function(
        "flash_attention", "flash_attention_launch",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p])
    rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                strides, vflags.data_ptr(), b, hq, hq // hkv, sq, tk, hd,
                hd ** -0.5, window, num_meta, int(q.dtype == torch.bfloat16),
                backend.stream_ptr(q.device))
    backend.raise_on_error("flash_attention", rc)
    flash_attention.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
flash_attention.launches = 0
