"""``flash_attention`` — causal attention forward with an optional sliding
window, pinned meta tokens and GQA:

    o[b, h, i] = softmax_j(q[b, h, i] · k[b, h // G, j] / √hd) v[b, h // G, j]

over the keys j a query i sees: j <= i and, when ``window > 0``,
``i - j < window`` or ``j < num_meta``. v's head_dim vd may differ from
q's and k's hd (MLA: q/k 192, v 128); the scale stays ``hd ** -0.5``. f32
scores and accumulation, the output in q's dtype. The kernel is
``csrc/flash_attention.cu`` (replacing the Pallas
``repro.kernels.flash_attention.flash_attention``): three launches, V's
non-finite flags, the attention, and the NaN that a skipped key tile's
inf or NaN in V gives the rows that do not see it. Both products are
split-f32 on the TF32 tensor cores. The attention by shape:

* vd = hd <= 64 (Hymba, musicgen): an online-softmax pass of 4 warps over
  cp.async double-buffered 64-row K/V tiles on ``mma.sync``;
* vd = hd in (64, 128] (DBRX, nemotron, yi, chameleon, qwen2; zero-padded
  to 128): ``flash_fwd_kernel_wgmma128``, a 128-row query tile per block
  on Hopper's warpgroup products (``wgmma``): two consumer warpgroups, each
  owning 64 of its rows and all of O's 128 columns (no exchange of
  scores), both reading one ring of K and Vᵀ stages landed by bulk copies
  from "images" that a fourth launch splits once into TF32 hi and lo
  stages, so that each K/V stage serves 128 query rows;
* vd != hd with vd <= 128 and hd <= 256 (DeepSeek-V2's MLA at (192,
  128)): ``flash_fwd_kernel_wgmma``, a 64-row query tile per block on
  Hopper's warpgroup products (``wgmma``), a producer warpgroup feeding a
  consumer one. Q stays in shared memory for the block's life; K and V
  pass through a ring of 32 KB stages (224 KB with Q, one block an SM),
  each split once into TF32 hi/lo parts as the producer stores it, V
  transposed (tf32 ``wgmma`` reads only K-major operands) in the key
  order of P's register fragments; one mbarrier wait a stage. What bounds
  it: operations (6.9e11 flops at DeepSeek's prefill, 4.2 ms at the
  split-f32 rate);
* vd = hd in (128, 256] (gemma-2b's 256; others zero-padded to 256):
  ``flash_fwd_kernel_wgmma256``, the same source at 256 on 64-row query
  tiles: the scores once per (query tile, key tile), two consumer
  warpgroups each owning 128 of O's columns and the k8 steps of S over
  them (the two partials summed through shared memory, so both run the
  same softmax), Q resident and split by its consumers, K and Vᵀ landed
  by each warpgroup's first thread into its own ring (``forward_route``);
* vd > 128 at vd != hd, or hd > 256: one block per 128-column slice of O
  (over vd), each over the full scores (over hd), on ``mma.sync``.

CPU tensors take ``ref.flash_attention_ref``. The model calls it through ``ops`` for
self-attention over positions 0..S-1 (prefill and the cache-free
forward), with q, k, v as ``[B, S, H, hd]`` projections viewed as
``[B, H, S, hd]``: the kernel reads and writes by strides, so no transpose
is copied.

Gradients. On CUDA tensors that need one, the call goes through
``_FlashAttention`` (a ``torch.autograd.Function``): the forward kernel
also writes each row's log-sum-exp, and the backward is a hand-written
kernel, f32 or bf16, Sq <= T:

* vd = hd <= 64: ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``,
  the FlashAttention-2 backward that the JAX package's custom VJP writes
  in jnp, its products split-f32 on the tensor cores);
* vd = hd in (64, 128] and (128, 256] (DBRX's and qwen2's 128, gemma-2b's
  256; zero-padded to 128 or 256): ``flash_attention_bwd_128`` and
  ``flash_attention_bwd_256`` (``csrc/flash_attention_bwd_256.cu`` at
  either head width), the same two passes on ``wgmma``, S and dP once in
  each: a prep launch splits every operand once into images of the
  passes' shared-memory stages, which each consumer warpgroup's first
  thread lands by bulk copies; the dK/dV pass keeps a key tile's dK and
  dV in the two warpgroups' registers, the dQ pass splits dQ's columns
  between them (``flash_attention_bwd`` hands these shapes over,
  ``bwd_route``);
* vd != hd with vd <= 128 and hd <= 192 (MLA; the forward is then
  ``flash_fwd_kernel_wgmma``): ``flash_attention_bwd_vd``
  (``csrc/flash_attention_bwd_vd.cu``, the same two passes on Hopper's
  warpgroup products: a producer warpgroup splits each operand once into
  a ring of shared-memory stages; the dK/dV pass keeps a key tile's K and
  V resident and its dK and dV in two consumer warpgroups' registers, the
  dQ pass a query tile's Q and dO).

Other shapes raise (hd = vd > 256; hd > 192 or vd > 128 at vd != hd).
Without a gradient the kernel launches as it does for serving: no
log-sum-exp is written. CPU tensors differentiate through
``ref.flash_attention_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, ref

_DTYPES = (torch.float32, torch.bfloat16)
#: the backward kernels' largest head_dim at vd = hd, and q's/k's and v's
#: at vd != hd
MAX_BWD_HEAD_DIM = 256
MAX_BWD_VD_DIMS = (192, 128)
#: columns of V's non-finite mask per 16-byte entry, and the wide kernel's
#: O slice
_SLICE = 128


def _image_tile(hd: int) -> int:
    """Bytes of one 64-row tile's image at head_dim ``hd`` (the wgmma
    kernels at vd = hd in (64, 256]: ``flash_fwd_kernel_wgmma128`` and
    ``_wgmma256``, ``flash_attention_bwd_128`` and ``_256``): a 16 KB stage
    of TF32 hi and lo atoms per 32 columns of the padded width, 128 or
    256."""
    return (128 if hd <= 128 else 256) // 32 * 16384


def _check(q, k, v, window, num_meta) -> str:
    name = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be [B, H, S, hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, hd = q.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != hd
            or v.shape[3] == 0):
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be [B={b}, Hkv, T, "
                         f"hd={hd}] and [B={b}, Hkv, T, vd]")
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
    """q [B, Hq, Sq, hd]; k [B, Hkv, T, hd]; v [B, Hkv, T, vd] (Hq a
    multiple of Hkv; vd = hd or v's own head_dim), f32 or bf16 ->
    [B, Hq, Sq, vd] in q's dtype, with q's memory layout (its dims in q's
    order of strides). Positions run 0..Sq-1 and 0..T-1.

    CPU tensors: the plain version. CUDA tensors: the hand-written kernel
    (``flash_attention.launches`` counts its calls: one call is three
    launches: V's non-finite flags, the attention, and the NaN the
    skipped tiles add; four at vd = hd in (64, 256], K's and Vᵀ's images
    before the attention); on the card the
    head_dim stride must be 1, other strides are free; any head_dim.
    Non-finite values come out as the plain version gives them: an inf or
    NaN in V at a key masked for a row makes that row NaN in its column,
    as 0 · inf does in the reference. When a gradient is needed the call
    is differentiable through ``flash_attention_bwd`` (vd = hd <= 64),
    ``flash_attention_bwd_128`` (vd = hd in (64, 128]),
    ``flash_attention_bwd_256`` (vd = hd in (128, 256]) or
    ``flash_attention_bwd_vd`` (vd != hd, vd <= 128, hd <= 192), Sq <= T;
    other shapes raise."""
    window, num_meta = int(window), int(num_meta)
    if _check(q, k, v, window, num_meta) == "cpu":
        return ref.flash_attention_ref(q, k, v, window=window,
                                       num_meta=num_meta)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, window, num_meta)
    return _launch(q, k, v, window, num_meta, lse=None)


def _launch(q, k, v, window, num_meta, *, lse):
    """The forward kernel on CUDA tensors; ``lse`` (or None) receives each
    row's log-sum-exp of the scaled scores."""
    b, hq, sq, hd = q.shape
    hkv, tk, vd = k.shape[1], k.shape[2], v.shape[3]
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {arg}'s head_dim stride must "
                             f"be 1, got strides {tuple(t.stride())}")
    out = _empty_out(q, vd)
    if out.numel() == 0 or tk == 0:
        return out.zero_()
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (q, k, v, out) for s in t.stride()[:3]])
    # per 64-key tile and 128-column slice, the bitmask of V's columns
    # that hold an inf or NaN
    vflags = torch.empty((b, hkv, -(-tk // 64), 4 * -(-vd // _SLICE)),
                         dtype=torch.int32, device=q.device)
    # flash_fwd_kernel_wgmma128's and _wgmma256's images of K and Vᵀ: per
    # 64-key tile four or eight 16 KB stages of TF32 hi and lo atoms each
    images = None
    if forward_route(hd, vd) in ("wgmma128", "wgmma256"):
        images = torch.empty(2 * b * hkv * -(-tk // 64) * _image_tile(hd),
                             dtype=torch.uint8, device=q.device)
    launch = backend.c_function(
        "flash_attention", "flash_attention_launch",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p])
    rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                strides, vflags.data_ptr(),
                None if images is None else images.data_ptr(),
                None if lse is None else lse.data_ptr(), b, hq, hq // hkv, sq,
                tk, hd, vd, hd ** -0.5, window, num_meta,
                int(q.dtype == torch.bfloat16), backend.stream_ptr(q.device))
    backend.raise_on_error("flash_attention", rc)
    flash_attention.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
flash_attention.launches = 0


def forward_route(hd: int, vd: int) -> str:
    """The attention kernel of ``csrc/flash_attention.cu`` (its
    ``launch_hd``) that takes q/k's head_dim ``hd`` and v's ``vd``: "mma"
    (``flash_fwd_kernel``, vd = hd <= 64), "wgmma128" (vd = hd in (64,
    128]), "wgmma256" (vd = hd in (128, 256]), "wgmma" (vd != hd, vd <=
    128, hd <= 256) or "wide" (the rest)."""
    if vd == hd:
        return ("mma" if hd <= 64 else "wgmma128" if hd <= 128
                else "wgmma256" if hd <= 256 else "wide")
    return "wgmma" if vd <= _SLICE and hd <= 256 else "wide"


def _empty_out(q, vd):
    """The output [B, Hq, Sq, vd], laid out as q is: its first three dims
    in q's order of strides, vd innermost (the model's [B, S, H, hd] views
    give a [B, S, H, vd] tensor viewed as [B, H, S, vd]; at vd = hd and a
    dense q, q's own layout)."""
    order = sorted(range(3), key=lambda i: -q.stride(i))
    out = torch.empty([q.shape[i] for i in order] + [vd], dtype=q.dtype,
                      device=q.device)
    return out.permute(*[order.index(i) for i in range(3)], 3)


class _FlashAttention(torch.autograd.Function):
    """The kernel with its hand-written backward, for CUDA tensors that
    need a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window, num_meta):
        b, hq, sq, hd = q.shape
        _check_bwd(q, k, v)
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
        out = _launch(q, k, v, window, num_meta, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.num_meta = window, num_meta
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd if v.shape[3] == q.shape[3]
               else flash_attention_bwd_vd)
        dq, dk, dv = bwd(q, k, v, out, dout, lse, window=ctx.window,
                         num_meta=ctx.num_meta)
        return dq, dk, dv, None, None


def _check_bwd(q, k, v) -> None:
    name = "flash_attention_bwd"
    hd, vd = q.shape[3], v.shape[3]
    if vd == hd and hd > MAX_BWD_HEAD_DIM:
        raise ValueError(
            f"{name}: head_dim {hd} > {MAX_BWD_HEAD_DIM}: the backward "
            f"kernel takes head_dim <= {MAX_BWD_HEAD_DIM} at vd = hd")
    if vd != hd and (hd > MAX_BWD_VD_DIMS[0] or vd > MAX_BWD_VD_DIMS[1]):
        raise ValueError(
            f"{name}: q/k head_dim {hd} and v's {vd}: the backward kernel "
            f"at vd != hd takes hd <= {MAX_BWD_VD_DIMS[0]} and vd <= "
            f"{MAX_BWD_VD_DIMS[1]}")
    if q.shape[2] > k.shape[2]:
        raise ValueError(f"{name}: Sq={q.shape[2]} > T={k.shape[2]}: every "
                         "query row must see a key")


def _check_bwd_args(name, q, k, v, out, dout, lse):
    """The backward's device rule and dO's shape; -> dO with head_dim
    stride 1."""
    _check_bwd(q, k, v)
    if backend.kernel_device(name, q, k, v, out, dout, lse) != "cuda":
        raise ValueError(f"{name}: runs on CUDA tensors only (CPU tensors "
                         "differentiate through ref.flash_attention_ref)")
    if dout.dtype != q.dtype or dout.shape != out.shape:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} {dout.dtype} "
                         f"must match out {tuple(out.shape)} {q.dtype}")
    return dout if dout.stride(3) == 1 else dout.contiguous()



def flash_attention_bwd(q, k, v, out, dout, lse, *, window: int = 0,
                        num_meta: int = 0):
    """The backward kernel at vd = hd: (dq like q, dk like k, dv like v)
    from the forward's inputs, its output ``out``, the output's cotangent
    ``dout`` and the rows' log-sum-exp ``lse`` [B, Hq, Sq] f32, all on the
    card. hd <= 64: ``csrc/flash_attention_bwd.cu``
    (``flash_attention_bwd.launches`` counts its calls: one call is four
    launches: delta = rowsum(dO ∘ O) with the tiles' masks of non-finite
    columns, dK and dV per query head, their sum over the GQA group, dQ);
    64 < hd <= 128: ``flash_attention_bwd_128``; 128 < hd <= 256:
    ``flash_attention_bwd_256``. Non-finite values come out where the
    plain version's autograd gives them."""
    name = "flash_attention_bwd"
    if v.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: v's head_dim {v.shape[3]} != q's "
                         f"{q.shape[3]}: flash_attention_bwd_vd takes it")
    _check_bwd(q, k, v)
    route = bwd_route(q.shape[3], v.shape[3])
    if route != name:
        wide = {"flash_attention_bwd_128": flash_attention_bwd_128,
                "flash_attention_bwd_256": flash_attention_bwd_256}[route]
        return wide(q, k, v, out, dout, lse, window=window,
                    num_meta=num_meta)
    dout = _check_bwd_args(name, q, k, v, out, dout, lse)
    b, hq, sq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or tk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    f32, dev = torch.float32, q.device
    delta = torch.empty((b, hq, sq), dtype=f32, device=dev)
    # dK and dV of each query head (summed over the GQA group by the
    # kernel's third launch), at head_dim rounded up to 32 or 64
    hd_pad = 32 if hd <= 32 else 64
    dkp = torch.empty((b, hq, tk, hd_pad), dtype=f32, device=dev)
    dvp = torch.empty_like(dkp)
    # per 64-row tile: the bitmask of the columns where q, dO (query heads)
    # and k (kv heads) hold an inf or NaN, in 4 words
    qflags = torch.empty((b, hq, -(-sq // 64), 4), dtype=torch.int32,
                         device=dev)
    dflags = torch.empty_like(qflags)
    kflags = torch.empty((b, hkv, -(-tk // 64), 4), dtype=torch.int32,
                         device=dev)
    lse = lse.contiguous()
    strides = (ctypes.c_longlong * 24)(
        *[s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]])
    launch = backend.c_function(
        "flash_attention_bwd", "flash_attention_bwd_launch",
        [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p])
    rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), delta.data_ptr(), dkp.data_ptr(),
                dvp.data_ptr(), qflags.data_ptr(), dflags.data_ptr(),
                kflags.data_ptr(), strides, b, hq, hq // hkv, sq, tk, hd,
                hd ** -0.5, int(window), int(num_meta),
                int(q.dtype == torch.bfloat16), backend.stream_ptr(dev))
    backend.raise_on_error(name, rc)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


#: backward kernel launches since the last reset
flash_attention_bwd.launches = 0


def bwd_route(hd: int, vd: int) -> str:
    """The backward kernel (its wrapper's name) that takes q/k's head_dim
    ``hd`` and v's ``vd``; raises for shapes none takes."""
    if vd == hd and hd <= 64:
        return "flash_attention_bwd"
    if vd == hd and hd <= 128:
        return "flash_attention_bwd_128"
    if vd == hd and hd <= MAX_BWD_HEAD_DIM:
        return "flash_attention_bwd_256"
    if vd != hd and hd <= MAX_BWD_VD_DIMS[0] and vd <= MAX_BWD_VD_DIMS[1]:
        return "flash_attention_bwd_vd"
    raise ValueError(f"flash_attention_bwd: no backward kernel takes hd {hd}"
                     f" with vd {vd}")


def flash_attention_bwd_128(q, k, v, out, dout, lse, *, window: int = 0,
                            num_meta: int = 0):
    """The backward kernel at vd = hd in (64, 128] (DBRX's and qwen2's 128;
    others zero-padded to 128), ``csrc/flash_attention_bwd_256.cu`` at head
    width 128: (dq like q, dk like k, dv like v) as ``flash_attention_bwd``
    gives them, all on the card (``flash_attention_bwd_128.launches``
    counts its calls: one call is four launches at GQA group 1, five above
    it, as ``flash_attention_bwd_256``'s). Non-finite values come out where
    the plain version's autograd gives them."""
    return _bwd_wgmma(flash_attention_bwd_128, 128, q, k, v, out, dout, lse,
                      window, num_meta)


#: backward kernel launches at vd = hd in (64, 128] since the last reset
flash_attention_bwd_128.launches = 0


def flash_attention_bwd_256(q, k, v, out, dout, lse, *, window: int = 0,
                            num_meta: int = 0):
    """The backward kernel at vd = hd in (128, 256] (gemma-2b's 256; others
    zero-padded to 256), ``csrc/flash_attention_bwd_256.cu``: (dq like q,
    dk like k, dv like v) as ``flash_attention_bwd`` gives them, all on the
    card (``flash_attention_bwd_256.launches`` counts its calls: one call
    is four launches at GQA group 1, five above it: delta with the tiles'
    masks of non-finite columns, the operands' images (each split once
    into the TF32 hi and lo stages the passes land by bulk copy), dK and
    dV per query head on wgmma, their sum over the group, dQ on wgmma).
    Non-finite values come out where the plain version's autograd gives
    them."""
    return _bwd_wgmma(flash_attention_bwd_256, 256, q, k, v, out, dout, lse,
                      window, num_meta)


#: backward kernel launches at vd = hd in (128, 256] since the last reset
flash_attention_bwd_256.launches = 0


def _bwd_wgmma(wrapper, width, q, k, v, out, dout, lse, window, num_meta):
    """``flash_attention_bwd_256.cu`` at head width ``width`` (128 or 256),
    the route of ``wrapper`` (whose launches it counts): its workspaces and
    its launch."""
    name = wrapper.__name__
    if bwd_route(q.shape[3], v.shape[3]) != name:
        raise ValueError(f"{name}: takes vd = hd in ({width // 2}, {width}],"
                         f" got hd {q.shape[3]} and vd {v.shape[3]}")
    dout = _check_bwd_args(name, q, k, v, out, dout, lse)
    b, hq, sq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or tk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    f32, dev = torch.float32, q.device
    n_qt, n_kt = -(-sq // 64), -(-tk // 64)
    delta = torch.empty((b, hq, sq), dtype=f32, device=dev)
    qflags = torch.empty((b, hq, n_qt, 8), dtype=torch.int32, device=dev)
    dflags = torch.empty_like(qflags)
    kflags = torch.empty((b, hkv, n_kt, 8), dtype=torch.int32, device=dev)
    # above GQA group 1, dK and dV of each query head at the padded width
    dkp = dvp = None
    if hq != hkv:
        dkp = torch.empty((b, hq, tk, width), dtype=f32, device=dev)
        dvp = torch.empty_like(dkp)
    # the images of Q, dO, Qᵀ, dOᵀ (per query head) and K, V, Kᵀ (per kv
    # head), in one buffer
    tile = _image_tile(hd)
    q_img, k_img = b * hq * n_qt * tile, b * hkv * n_kt * tile
    images = torch.empty(4 * q_img + 3 * k_img, dtype=torch.uint8, device=dev)
    base = images.data_ptr()
    ptrs = (ctypes.c_void_p * 7)(*[base + i * q_img for i in range(4)],
                                 *[base + 4 * q_img + i * k_img
                                   for i in range(3)])
    lse = lse.contiguous()
    strides = (ctypes.c_longlong * 24)(
        *[s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]])
    launch = backend.c_function(
        "flash_attention_bwd_256", "flash_attention_bwd_256_launch",
        [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p])
    rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), delta.data_ptr(),
                None if dkp is None else dkp.data_ptr(),
                None if dvp is None else dvp.data_ptr(), qflags.data_ptr(),
                dflags.data_ptr(), kflags.data_ptr(), ptrs, strides, b, hq,
                hq // hkv, sq, tk, hd, hd ** -0.5, int(window), int(num_meta),
                int(q.dtype == torch.bfloat16), backend.stream_ptr(dev))
    backend.raise_on_error(name, rc)
    wrapper.launches += 1
    return dq, dk, dv


def flash_attention_bwd_vd(q, k, v, out, dout, lse, *, window: int = 0,
                           num_meta: int = 0):
    """The backward kernel at v's own head_dim (vd != hd, vd <= 128, hd <=
    192; MLA's (192, 128)): (dq like q, dk like k, dv like v) from the
    forward's inputs, its output ``out`` [B, Hq, Sq, vd], the output's
    cotangent ``dout`` and the rows' log-sum-exp ``lse`` [B, Hq, Sq] f32,
    all on the card (``flash_attention_bwd_vd.launches`` counts its calls:
    one call is three launches at GQA group 1, four above it: delta with
    the tiles' masks of non-finite columns, dK and dV per query head (the
    wgmma pass), their sum over the group, dQ (the wgmma pass)).
    Non-finite values come out where the plain version's autograd gives
    them."""
    name = "flash_attention_bwd_vd"
    if v.shape[3] == q.shape[3]:
        raise ValueError(f"{name}: vd = hd = {q.shape[3]}: "
                         "flash_attention_bwd takes it")
    dout = _check_bwd_args(name, q, k, v, out, dout, lse)
    b, hq, sq, hd = q.shape
    hkv, tk, vd = k.shape[1], k.shape[2], v.shape[3]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or tk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    f32, dev = torch.float32, q.device
    delta = torch.empty((b, hq, sq), dtype=f32, device=dev)
    # per 64-row tile, 8 words: the bitmask of the columns (up to 256)
    # where q, dO (query heads) and k (kv heads) hold an inf or NaN
    qflags = torch.empty((b, hq, -(-sq // 64), 8), dtype=torch.int32,
                         device=dev)
    dflags = torch.empty_like(qflags)
    kflags = torch.empty((b, hkv, -(-tk // 64), 8), dtype=torch.int32,
                         device=dev)
    # above GQA group 1, dK and dV of each query head at the kernel's
    # padded widths (summed over the group by its third launch)
    dkp = dvp = None
    if hq != hkv:
        hd_pad, vd_pad = _bwd_vd_widths(hd, vd)
        dkp = torch.empty((b, hq, tk, hd_pad), dtype=f32, device=dev)
        dvp = torch.empty((b, hq, tk, vd_pad), dtype=f32, device=dev)
    lse = lse.contiguous()
    strides = (ctypes.c_longlong * 24)(
        *[s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]])
    launch = backend.c_function(
        name, "flash_attention_bwd_vd_launch",
        [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p])
    rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), delta.data_ptr(),
                None if dkp is None else dkp.data_ptr(),
                None if dvp is None else dvp.data_ptr(), qflags.data_ptr(),
                dflags.data_ptr(), kflags.data_ptr(), strides, b, hq,
                hq // hkv, sq, tk, hd, vd, hd ** -0.5, int(window),
                int(num_meta), int(q.dtype == torch.bfloat16),
                backend.stream_ptr(dev))
    backend.raise_on_error(name, rc)
    flash_attention_bwd_vd.launches += 1
    return dq, dk, dv


#: backward kernel launches at vd != hd since the last reset
flash_attention_bwd_vd.launches = 0


def _bwd_vd_widths(hd, vd):
    """(HD, VD): the widths ``csrc/flash_attention_bwd_vd.cu``'s
    ``launch_dims`` runs (hd, vd) at."""
    return (64, 64) if max(hd, vd) <= 64 else (192, 128)
