"""Tests of the port's CUDA kernels; they need a card (marker ``cuda``) and
skip themselves elsewhere. Run them on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

* the device rule: a CUDA tensor launches the kernel (its launch counter
  rises) and never takes the plain version;
* each kernel against its plain version on the card over ragged shapes,
  f32 and bf16 (tolerance: f32 1e-5 — the kernel and the plain version
  sum in other orders, and ``fed_mix`` takes each f32 product as three
  TF32 tensor-core products; bf16 3e-2 — one rounding step of O(1)
  outputs). ``fed_mix`` also over its tile edges (D around 16-row tiles
  and 128-row blocks, P = 0..3 mod 4: rows off 16-byte alignment) and at
  the main path's D = 100, P = 246,590.
  ``fed_mix_q`` over both its routes (the scale folded into M_new at a
  chunk that is a multiple of 32, dequantized in the fragment load at
  another) and a record viewed at an odd byte offset;
* a diverged client: inf, -inf, NaN and +-the largest finite value in X of
  ``fed_mix`` and ``fed_mix_q`` (and non-finite int8 scales) give inf and
  NaN where the plain version does, the finite outputs at the usual
  tolerance (the kernels' fast split sends such a tile to the full split);
  ``fed_mix_matching`` is held bit for bit: each of its operations is one
  rounding in the plain version's order. Its rounding-tree route (S <= 3)
  at the main shape (P = 2 mod 4: every other row 8-byte aligned), below
  one tile and with non-involutive stages, its stage loop (S = 4) and its
  large-D device-memory path (one launch per stage, D = 1000 and up);
* the wrapper guards hold on CUDA tensors too; a bad cluster id is flagged
  on the card and raised by ``check_cluster_ids``;
* with cuDNN's algorithms pinned, FL runs at the Table-1 participation
  repeat bit for bit;
* the LM kernels: ``flash_attention`` over the JAX kernel tests' sweep,
  ragged S, odd head dims, the meta-token term, the model's strided
  [B, S, H, hd] layout and odd row strides (tolerance f32 2e-5: an online
  softmax over split-f32 tensor-core products against a one-shot one;
  bf16 3e-2); ``ssd_scan`` over the JAX sweep, Hymba's and
  mamba2-130m's shapes, one chunk (nc = 1, up to 1024 rows), small
  chunks and chunks that are not multiples of its 64-row tiles, n = 8 and
  24 (its k8 steps of n), an initial state and strided inputs (tolerance
  f32 rtol 1e-4 and an atol of 5e-4 of the output's
  largest value: the cumsum of dt·A, which reaches ~100 over a chunk, is
  taken in another order, exp of its differences carries ~1e-5 of
  relative error in either order, and a chunk sums hundreds of such
  terms). Both with inf and NaN in skipped tiles and in visited ones
  (flash: in V at keys above the diagonal, outside the window and inside
  the diagonal tile, in K and in Q; the SSD: in x, dt, B and C at row 100
  of a 128-row chunk, whose 64-row tile the output pass skips for rows
  0-63, and at row 30): inf and NaN where the plain version has them, the
  finite outputs at the usual tolerance. ``flash_attention`` at head_dim
  160, 192, 256 (gemma-2b's MQA shape included) and 512, and its
  non-finite cases at 256; at hd = vd in (128, 256] the forward
  ``flash_fwd_kernel_wgmma256`` and the backward ``flash_attention_bwd_256``
  at their 64-row tiles' edges (S one below and above a multiple of 64,
  GQA 6/2, MQA 8/1, a window with meta tokens, hd 129 and 192, f32 and
  bf16), with an inf or NaN in q, k, v and dO in tiles they skip and
  visit, two calls bit for bit, and the routes by the launched kernels'
  names (hd 129, 192, 256 on the wgmma kernel; 257, 512 and (320, 256) on
  the wide one); the same at hd = vd in (64, 128] for
  ``flash_fwd_kernel_wgmma128`` (128-row query tiles) and
  ``flash_attention_bwd_128`` (S one below and above multiples of 64 and
  128, GQA groups 1, 6, 7 and 8, windows with meta tokens, hd 65, 100 and
  127, odd row strides), the routes naming no hd-128 instantiation of the
  ``mma.sync`` kernels;
* the FL paths of the topology-aware protocol, fault plans and the
  paper's ``Aggregate(·)`` launch their kernels (``fed_mix_segment`` /
  ``fed_mix``, ``fed_aggregate``) and agree with the CPU;
* the backward kernels against the plain version's autograd on the card:
  ``flash_attention_bwd`` (dq, dk, dv) at Hymba's training layers (window
  and full, meta tokens, GQA), qwen2-1.5b's head_dim 128, MQA, a ragged S
  and head_dim 32, and at head_dim 256 (gemma-2b's MQA training shape; a
  ragged S, GQA, a window and meta tokens; 160 and 200, padded to 256:
  ``flash_attention_bwd_256``), f32 at the forward's 2e-5 and bf16 at
  3e-2;
  ``ssd_scan_bwd`` (dx, d(dt), dA, dB, dC and the initial state's) at
  Hymba's and mamba2-130m's shapes and ragged chunks, with and without an
  initial state and the final state's cotangent, at the forward's
  tolerance scaled to each gradient's largest |value|. Both with an inf or
  NaN in each input (flash: q, k, v, dO at Hymba's window layer; the SSD:
  x, dt, B, C, dY at Hymba's and mamba2-130m's shapes, in tiles the passes
  skip and inside the diagonal tile): inf and NaN where the plain
  version's autograd has them (flash also at head_dim 256, whose masks of
  non-finite columns take 8 words). A CUDA tensor that
  needs a gradient goes through the backward kernel (its counter rises);
  two backward calls give the same bits (at 256 too); the serving path
  (no gradient) writes no log-sum-exp and gives the bits it gave, and the
  forward's log-sum-exp at 256 (what the backward reads) is the plain
  one; the backward raises above head_dim 256 and for a bf16 SSD;
* ``flash_attention`` with v's head_dim apart from q's and k's (MLA) at
  DeepSeek-V2's prefill (192, 128) of 512 and 2048 tokens, DBRX's GQA
  48/8 prefill at 128, the reduced config's (24, 16), and
  (64, 32), (96, 128), (320, 256) with GQA, a window and meta tokens, f32
  and bf16, and with inf and NaN at (192, 128); the wgmma forward's
  log-sum-exp against the plain one; its backward
  ``flash_attention_bwd_vd`` (dq, dk, dv) against the plain version's
  autograd at DeepSeek-V2's training shape (128 heads, 2048 positions,
  (192, 128)), the reduced config's (24, 16), (64, 32) and (96, 128)
  with GQA, a window and meta tokens and a ragged S, f32 and bf16, at the
  edges of its wgmma passes (tiles cut by S, n_q < n_k, a window's keys
  across two key tiles, GQA 2 and 4), with an inf or NaN in each input,
  and two calls bit for bit; the backward
  raises past hd 192 or vd 128 (no fallback); reduced
  deepseek-v2 and dbrx route every MoE layer alike on the card and on
  the CPU, and train on the card as on the CPU (the step-1 loss and
  every gradient leaf, 3 AdamW steps, the routing);
* sampled participation: the resident store's in-place ``index_copy_``
  scatter against the CPU; ``SampledEngine`` rounds pipelined at depths 2
  and 3 against the serial loop bit for bit with cuDNN pinned, on both
  store tiers (fedp2p, and gossip with the topk wire's residuals); a
  round on the card against the CPU with the same draws, the cold tier's
  rows (pinned buffers, non-blocking copies) equal to the resident
  tier's; the cold tier's gather, scatter and fetch-thread prefetch on
  the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.compression import Int8Codec
from repro_torch.kernels import backend, ref
from repro_torch.kernels.fed_aggregate import fed_aggregate
from repro_torch.kernels.fed_mix import fed_mix
from repro_torch.kernels.fed_mix_q import fed_mix_q
from repro_torch.kernels.fed_mix_sparse import (
    check_cluster_ids, fed_mix_matching, fed_mix_segment,
)
from repro_torch.kernels.flash_attention import (
    bwd_route, flash_attention, flash_attention_bwd, flash_attention_bwd_128,
    flash_attention_bwd_256, flash_attention_bwd_vd, forward_route,
)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
from repro_torch.protocols.async_gossip import matching_perm_stack
from repro_torch.protocols.gossip import _phase_perm_stack

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    backend.use_full_f32()
    return torch.Generator(device="cuda").manual_seed(0)


def _segment_args(gen, d, p, L, dtype):
    kw = dict(device="cuda", generator=gen)
    ids = torch.randint(0, L, (d,), dtype=torch.int32, **kw)
    w_new = torch.rand(d, **kw) / d
    w_old = torch.rand(d, **kw) / d
    return (ids, w_new, w_old, torch.randn((d, p), **kw).to(dtype),
            torch.randn((d, p), **kw).to(dtype))


def _dense_args(gen, d, p, dtype):
    kw = dict(device="cuda", generator=gen)
    mn, mo = torch.rand((d, d), **kw), torch.rand((d, d), **kw)
    tot = (mn + mo).sum(dim=1, keepdim=True)
    return (mn / tot, mo / tot, torch.randn((d, p), **kw).to(dtype),
            torch.randn((d, p), **kw).to(dtype))


def _matching_args(gen, d, p, stages, dtype):
    kw = dict(device="cuda", generator=gen)
    if stages == 2:
        perms = torch.from_numpy(_phase_perm_stack(d))
    else:
        stack = torch.from_numpy(matching_perm_stack(d))
        perms = stack[torch.randint(0, stack.shape[0], (stages,))]
    survive = (torch.rand(d, **kw) > 0.3).float()
    return (perms.cuda().contiguous(), survive,
            torch.randn((d, p), **kw).to(dtype),
            torch.randn((d, p), **kw).to(dtype))


def _quant_args(gen, d, p, chunk, x_dtype):
    mn, mo, xn, xo = _dense_args(gen, d, p, torch.float32)
    enc = Int8Codec(chunk=chunk).encode(
        xn, u=torch.rand((d, Int8Codec(chunk=chunk).padded(p)),
                         device="cuda", generator=gen))
    return mn, mo, enc.values, enc.scales, xo.to(x_dtype)


def test_cuda_tensor_launches_kernel_not_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain version")

    for name in ("fed_mix_segment_ref", "fed_mix_ref",
                 "fed_mix_matching_ref", "fed_mix_q_ref",
                 "fed_aggregate_ref", "flash_attention_ref", "ssd_chunked"):
        monkeypatch.setattr(ref, name, refuse)
    n0 = fed_mix_segment.launches
    out = fed_mix_segment(*_segment_args(cuda, 6, 9, 3, torch.float32),
                          num_segments=3)
    torch.cuda.synchronize()
    assert fed_mix_segment.launches == n0 + 1 and out.is_cuda
    n0 = fed_mix.launches
    out = fed_mix(*_dense_args(cuda, 6, 9, torch.float32))
    torch.cuda.synchronize()
    assert fed_mix.launches == n0 + 1 and out.is_cuda
    n0 = fed_mix_matching.launches
    out = fed_mix_matching(*_matching_args(cuda, 6, 9, 2, torch.float32))
    torch.cuda.synchronize()
    assert fed_mix_matching.launches == n0 + 1 and out.is_cuda
    n0 = fed_mix_q.launches
    out = fed_mix_q(*_quant_args(cuda, 6, 9, 64, torch.float32), chunk=64)
    torch.cuda.synchronize()
    assert fed_mix_q.launches == n0 + 1 and out.is_cuda
    n0 = fed_aggregate.launches
    out = fed_aggregate(torch.randn((6, 9), device="cuda"),
                        torch.rand(6, device="cuda"))
    torch.cuda.synchronize()
    assert fed_aggregate.launches == n0 + 1 and out.is_cuda
    n0 = flash_attention.launches
    out = flash_attention(*_attention_args(cuda, 1, 2, 1, 9, 16,
                                           torch.float32))
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1 and out.is_cuda
    n0 = ssd_scan.launches
    y, st = ssd_scan(*_ssd_args(cuda, 1, 8, 2, 4, 3, torch.float32), chunk=4)
    torch.cuda.synchronize()
    assert ssd_scan.launches == n0 + 1 and y.is_cuda and st.is_cuda


@pytest.mark.parametrize("d,p,L", [(1, 1, 1), (7, 130, 3), (37, 1000, 37),
                                   (37, 1001, 5), (100, 4099, 10),
                                   (1000, 130, 1000), (2048, 257, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_mix_segment_matches_plain_on_card(cuda, d, p, L, dtype):
    args = _segment_args(cuda, d, p, L, dtype)
    got = fed_mix_segment(*args, num_segments=L)
    want = ref.fed_mix_segment_ref(*args, num_segments=L)
    assert got.dtype == dtype and got.shape == (d, p)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("d,p", [(1, 1), (7, 130), (37, 1000), (100, 4099),
                                 (300, 513)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_mix_matches_plain_on_card(cuda, d, p, dtype):
    args = _dense_args(cuda, d, p, dtype)
    got = fed_mix(*args)
    want = ref.fed_mix_ref(*args)
    assert got.dtype == dtype and got.shape == (d, p)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


# the tile edges of the tensor-core kernel: D around its 16-row tiles and
# its 128-row block (300: three row blocks, K in chunks), P = 0..3 mod 4
# (every other f32 row off 16-byte alignment; bf16 rows 2-byte aligned)
@pytest.mark.parametrize("d", [16, 100, 112, 113, 128, 300])
@pytest.mark.parametrize("p", [4096, 4097, 4098, 4099])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_mix_tile_edges_on_card(cuda, d, p, dtype):
    args = _dense_args(cuda, d, p, dtype)
    got = fed_mix(*args)
    want = ref.fed_mix_ref(*args)
    assert got.dtype == dtype and got.shape == (d, p)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_mix_main_shape_on_card(cuda, dtype):
    args = _dense_args(cuda, 100, 246_590, dtype)
    got = fed_mix(*args)
    want = ref.fed_mix_ref(*args)
    assert got.dtype == dtype and got.shape == (100, 246_590)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("d,p,stages", [(1, 1, 1), (2, 5, 2), (9, 1001, 2),
                                        (17, 513, 2), (100, 4099, 1),
                                        (100, 4099, 2), (37, 130, 3),
                                        (5, 64, 0),
                                        (2048, 999, 2), (4096, 257, 1),
                                        (1000, 130, 3),
                                        (100, 246_590, 2),  # the main shape
                                        (100, 63, 2),       # below one tile
                                        (37, 130, 4), (100, 4099, 4),
                                        (300, 1001, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_mix_matching_bitwise_on_card(cuda, d, p, stages, dtype):
    """Bit for bit with the plain version, on the rounding-tree route
    (S <= 3), the stage loop (S = 4) and the device-memory path (D = 1000
    and up: one launch per stage)."""
    if stages >= 3:
        pick = [0, 3, 1, 2][:stages]
        perms = torch.from_numpy(matching_perm_stack(d)[pick]).cuda()
        _, survive, xn, xo = _matching_args(cuda, d, p, 1, dtype)
        args = (perms.contiguous(), survive, xn, xo)
    elif stages == 0:
        _, survive, xn, xo = _matching_args(cuda, d, p, 1, dtype)
        args = (torch.zeros((0, d), dtype=torch.int32, device="cuda"),
                survive, xn, xo)
    else:
        args = _matching_args(cuda, d, p, stages, dtype)
    got = fed_mix_matching(*args)
    want = ref.fed_mix_matching_ref(*args)
    assert got.dtype == dtype and got.shape == (d, p)
    assert torch.equal(got, want)


# + the kernel's two routes for Q: the scale folded into M_new (a chunk
# that is a multiple of 32: 192, 256) and dequantized in the fragment load
# (16, 48); D = 300 takes three row blocks and K in chunks of M
@pytest.mark.parametrize("d,p,chunk", [(6, 700, 256), (16, 4096, 256),
                                       (17, 513, 128), (1, 129, 64),
                                       (40, 300, 128), (100, 4099, 256),
                                       (7, 130, 6), (100, 4099, 16),
                                       (100, 4099, 192), (37, 1000, 192),
                                       (300, 513, 256), (300, 513, 48)])
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_fed_mix_q_matches_plain_on_card(cuda, d, p, chunk, x_dtype,
                                         out_dtype):
    args = _quant_args(cuda, d, p, chunk, x_dtype)
    got = fed_mix_q(*args, chunk=chunk, out_dtype=out_dtype)
    want = ref.fed_mix_q_ref(*args, chunk=chunk, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (d, p)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOL[out_dtype], atol=TOL[out_dtype])


def _place_non_finite(x):
    """inf, -inf, NaN, +-FLT_MAX (for bf16: +-its largest finite value) in
    columns of their own, and inf and -inf in one column (NaN there)."""
    big = torch.finfo(x.dtype).max
    d = x.shape[0]
    x[3 % d, 5] = float("inf")
    x[7 % d, 11] = float("-inf")
    x[1 % d, 17] = float("nan")
    x[2 % d, 23] = big
    x[5 % d, 29] = -big
    x[0, 31] = float("inf")
    x[d - 1, 31] = float("-inf")
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_mix_non_finite_on_card(cuda, dtype):
    """A diverged client: non-finite values and the f32 maximum in X give
    inf and NaN where the plain version does, and the finite outputs hold
    the usual tolerance."""
    mn, mo, xn, xo = _dense_args(cuda, 100, 4099, dtype)
    _place_non_finite(xn)
    _place_non_finite(xo[:, 40:])
    got = fed_mix(mn, mo, xn, xo)
    want = ref.fed_mix_ref(mn, mo, xn, xo)
    assert not bool(torch.isfinite(want).all())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype], equal_nan=True)


@pytest.mark.parametrize("chunk", [256, 48])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_fed_mix_q_non_finite_on_card(cuda, chunk, x_dtype):
    """The same for the int8 wire: non-finite values in X_old, and
    non-finite scales (a record whose absmax overflowed)."""
    mn, mo, q, sc, xo = _quant_args(cuda, 100, 4099, chunk, x_dtype)
    _place_non_finite(xo)
    sc[4, 2] = float("inf")
    sc[9, 3] = float("nan")
    got = fed_mix_q(mn, mo, q, sc, xo, chunk=chunk, out_dtype=torch.float32)
    want = ref.fed_mix_q_ref(mn, mo, q, sc, xo, chunk=chunk,
                             out_dtype=torch.float32)
    assert not bool(torch.isfinite(want).all())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                               equal_nan=True)


def test_fed_mix_q_unaligned_record_on_card(cuda):
    """An int8 record whose rows are not 4-byte aligned takes the
    one-byte-a-load path and is still right."""
    d, p, chunk = 5, 72, 6
    mn, mo, q, sc, xo = _quant_args(cuda, d, p, chunk, torch.float32)
    base = torch.zeros(d * q.shape[1] + 1, dtype=torch.int8, device="cuda")
    qv = base[1:].view(d, q.shape[1])
    qv.copy_(q)
    got = fed_mix_q(mn, mo, qv, sc, xo, chunk=chunk)
    want = ref.fed_mix_q_ref(mn, mo, q, sc, xo, chunk=chunk)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,d", [(1, 1), (3, 1000), (8, 4096), (1, 17),
                                 (16, 513), (100, 4099), (13, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_aggregate_matches_plain_on_card(cuda, n, d, dtype):
    x = torch.randn((n, d), device="cuda", generator=cuda).to(dtype)
    w = torch.rand(n, device="cuda", generator=cuda)
    w = w / w.sum()
    got = fed_aggregate(x, w)
    want = ref.fed_aggregate_ref(x, w)
    assert got.dtype == dtype and got.shape == (d,)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_fed_mix_segment_unaligned_view_on_card(cuda):
    """A contiguous view 4 bytes off an 8-byte boundary takes the
    one-column-a-thread path and is still right."""
    d, p = 9, 64
    base = torch.randn(2, d * p + 1, device="cuda", generator=cuda)
    xn, xo = base[0, 1:].view(d, p), base[1, 1:].view(d, p)
    ids, wn, wo, _, _ = _segment_args(cuda, d, p, 3, torch.float32)
    got = fed_mix_segment(ids, wn, wo, xn, xo, num_segments=3)
    want = ref.fed_mix_segment_ref(ids, wn, wo, xn, xo, num_segments=3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,p,L", [(6, 12, 3), (6, 13, 3), (1000, 130, 1000)])
def test_bad_cluster_ids_flagged_on_card(cuda, d, p, L):
    """A bad id is not read back at the launch: its row comes out NaN, the
    other rows are right, and ``check_cluster_ids`` raises once."""
    ids, wn, wo, xn, xo = _segment_args(cuda, d, p, L, torch.float32)
    check_cluster_ids()
    bad = ids.clone()
    bad[0], bad[-1] = L, -1
    got = fed_mix_segment(bad, wn, wo, xn, xo, num_segments=L)
    keep = torch.ones(d, dtype=torch.bool, device="cuda")
    keep[0] = keep[-1] = False
    want = ref.fed_mix_segment_ref(ids, wn * keep, wo * keep, xn, xo,
                                   num_segments=L)
    assert torch.isnan(got[0]).all() and torch.isnan(got[-1]).all()
    torch.testing.assert_close(got[1:-1], want[1:-1], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="outside \\[0, num_segments\\)"):
        check_cluster_ids(torch.device("cuda"))
    check_cluster_ids()      # the flag was cleared


@pytest.mark.parametrize("algo", ["fedp2p", "gossip_async"])
def test_table1_participation_repeats_on_card(cuda, algo, monkeypatch):
    """With cuDNN's convolution algorithms pinned (``deterministic`` on,
    ``benchmark`` off), two runs of CNN-FEMNIST at full width and the
    Table-1 participation (10 of 100) give the same losses bit for bit:
    nothing else in the port's round (its kernels, the draws) varies
    between runs. With cuDNN's defaults they did not repeat."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    from repro_torch.config import FLConfig
    from repro_torch.configs.paper_models import CNN_FEMNIST
    from repro_torch.core.simulator import Simulator
    from repro_torch.data.federated import pseudo_femnist_federated
    data = pseudo_femnist_federated(100, num_classes=62, seed=0)
    fl = FLConfig(lr=0.05, num_clusters=5, devices_per_cluster=2,
                  participation=10)
    runs = [Simulator(CNN_FEMNIST, data, fl).run(rounds=2, algorithm=algo)
            for _ in range(2)]
    assert runs[0].train_loss == runs[1].train_loss
    assert runs[0].acc == runs[1].acc


def test_guards_on_card(cuda):
    ids, wn, wo, xn, xo = _segment_args(cuda, 6, 12, 3, torch.float32)
    with pytest.raises(ValueError, match="must be contiguous"):
        fed_mix_segment(ids, wn, wo, xn[:, ::2], xo[:, ::2], num_segments=3)
    with pytest.raises(ValueError, match="several devices"):
        fed_mix_segment(ids, wn, wo, xn, xo.cpu(), num_segments=3)
    perms, survive, xn, xo = _matching_args(cuda, 6, 12, 2, torch.float32)
    with pytest.raises(ValueError, match="several devices"):
        fed_mix_matching(perms.cpu(), survive, xn, xo)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        fed_mix_q(*_quant_args(cuda, 6, 12, 64, torch.float32), chunk=48)
    with pytest.raises(ValueError, match="must be contiguous"):
        fed_aggregate(xn[:, ::2], survive)


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_mix_matching_non_involutive_on_card(cuda, stages, dtype):
    """Stages that are not matchings (a cyclic shift, random permutations,
    a map that is no permutation): still bit for bit."""
    d, p = 100, 4099
    g = torch.Generator().manual_seed(stages)
    rows = [torch.roll(torch.arange(d), 7), torch.randperm(d, generator=g),
            torch.randint(0, d, (d,), generator=g),
            torch.randperm(d, generator=g)]
    perms = torch.stack(rows[:stages]).to(torch.int32).cuda()
    _, survive, xn, xo = _matching_args(cuda, d, p, 1, dtype)
    got = fed_mix_matching(perms, survive, xn, xo)
    want = ref.fed_mix_matching_ref(perms, survive, xn, xo)
    assert torch.equal(got, want)


def test_fed_mix_matching_bad_partner_is_nan_on_card(cuda):
    """Partner indices are not read back on the card: a row whose partner
    lies outside [0, D) comes out NaN and the other rows are right."""
    perms, survive, xn, xo = _matching_args(cuda, 8, 40, 1, torch.float32)
    bad = perms.clone()
    bad[0, 3] = 8
    got = fed_mix_matching(bad, survive, xn, xo)
    want = ref.fed_mix_matching_ref(perms, survive, xn, xo)
    assert torch.isnan(got[3]).all()
    keep = [i for i in range(8) if i != 3]
    assert torch.equal(got[keep], want[keep])


# ---------------------------------------------------------------------------
# the LM kernels
# ---------------------------------------------------------------------------

def _attention_args(gen, b, hq, hkv, s, hd, dtype, model_layout=False):
    """q [b, hq, s, hd], k/v [b, hkv, s, hd]; with ``model_layout`` they are
    [b, s, h, hd] tensors viewed as [b, h, s, hd], as the model hands them
    over."""
    kw = dict(device="cuda", generator=gen)
    out = []
    for h in (hq, hkv, hkv):
        if model_layout:
            t = (torch.randn((b, s, h, hd), **kw) * 0.5).transpose(1, 2)
        else:
            t = torch.randn((b, h, s, hd), **kw) * 0.5
        out.append(t.to(dtype))
    return out


def _ssd_args(gen, b, s, h, p, n, dtype, strided=False):
    kw = dict(device="cuda", generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), **kw))
    A = -torch.exp(torch.randn(h, **kw) * 0.3)
    if strided:          # x, B, C as slices of one [b, s, h*p + 2n] tensor
        u = torch.randn((b, s, h * p + 2 * n), **kw) * 0.5
        x = u[..., :h * p].unflatten(-1, (h, p))
        B, C = u[..., h * p:h * p + n], u[..., h * p + n:]
    else:
        x = torch.randn((b, s, h, p), **kw) * 0.5
        B = torch.randn((b, s, n), **kw) * 0.5
        C = torch.randn((b, s, n), **kw) * 0.5
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype)


@pytest.mark.parametrize("b,hq,hkv,s,hd,window,num_meta,model_layout", [
    (2, 4, 2, 256, 64, 0, 0, False),        # the JAX kernel tests' sweep
    (2, 4, 2, 256, 64, 96, 0, False),
    (1, 2, 1, 512, 128, 0, 0, False),
    (1, 2, 1, 512, 128, 96, 0, False),
    (2, 3, 3, 128, 32, 0, 0, False),
    (2, 3, 3, 128, 32, 96, 0, False),
    (2, 4, 2, 200, 64, 0, 0, False),        # ragged last query tile
    (2, 4, 2, 200, 64, 64, 8, True),
    (1, 5, 5, 1, 48, 0, 0, False),          # one row, odd head dim
    (1, 2, 1, 77, 16, 32, 5, True),
    (2, 25, 5, 300, 64, 128, 16, True),     # Hymba's heads, window + meta
    (1, 25, 5, 1100, 64, 1024, 128, True),  # past Hymba's own window
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_on_card(cuda, b, hq, hkv, s, hd,
                                               window, num_meta,
                                               model_layout, dtype):
    q, k, v = _attention_args(cuda, b, hq, hkv, s, hd, dtype, model_layout)
    got = flash_attention(q, k, v, window=window, num_meta=num_meta)
    want = ref.flash_attention_ref(q, k, v, window=window, num_meta=num_meta)
    assert got.dtype == dtype and got.shape == q.shape
    assert got.stride() == q.stride()
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("hd", [16, 48, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dims_unaligned_rows_on_card(cuda, hd, dtype):
    """q, k, v as [b, s, h, hd] slices of [b, s, h, hd + 1] tensors: the
    row stride h·(hd + 1) is odd, so rows start off every 16-, 8- and
    (bf16) 4-byte boundary."""
    kw = dict(device="cuda", generator=cuda)
    q, k, v = [(torch.randn((1, 150, h, hd + 1), **kw) * 0.5).to(dtype)
               [..., :hd].transpose(1, 2) for h in (3, 1, 1)]
    assert q.stride(2) % 2 == 1
    got = flash_attention(q, k, v, window=64, num_meta=4)
    want = ref.flash_attention_ref(q, k, v, window=64, num_meta=4)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _close_scaled(got, want):
    """The SSD tolerance: rtol 1e-4, atol 5e-4 of |want|'s largest value."""
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=5e-4 * float(want.abs().max()))


@pytest.mark.parametrize("b,s,h,p,n,chunk,strided", [
    (2, 128, 3, 16, 32, 32, False),         # the JAX kernel tests' sweep
    (1, 256, 2, 64, 128, 64, False),
    (2, 64, 1, 8, 16, 16, False),
    (2, 256, 50, 64, 16, 128, True),        # Hymba's SSM heads
    (1, 512, 24, 64, 128, 256, True),       # mamba2-130m's
    (2, 100, 4, 16, 16, 20, True),          # a small chunk the mixer picks
    (1, 78, 3, 64, 200, 26, False),         # n over several tiles, ragged
    (1, 7, 2, 5, 3, 7, False),
    (1, 2048, 24, 64, 128, 256, True),      # mamba2-130m's, b reduced
    (1, 256, 3, 64, 16, 256, False),        # one chunk (nc = 1)
    (1, 1024, 2, 32, 24, 1024, True),       # one chunk of the largest size
    (2, 192, 3, 64, 8, 96, True),           # n = 8; chunk not a multiple of 64
    (1, 300, 5, 48, 24, 100, False),        # n = 24 (three k8 steps)
])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_matches_plain_on_card(cuda, b, s, h, p, n, chunk, strided,
                                        with_state):
    args = _ssd_args(cuda, b, s, h, p, n, torch.float32, strided)
    init = (torch.randn((b, h, p, n), device="cuda", generator=cuda)
            if with_state else None)
    y, st = ssd_scan(*args, chunk=chunk, initial_state=init)
    y_ref, st_ref = ref.ssd_chunked(*args, chunk, initial_state=init)
    assert y.dtype == torch.float32 and y.shape == (b, s, h, p)
    assert st.dtype == torch.float32 and st.shape == (b, h, p, n)
    _close_scaled(y, y_ref)
    _close_scaled(st, st_ref)


def _finite_scale(t):
    """The largest |value| among t's finite entries (1 where it has none:
    an inf in B reaches every head and every later chunk)."""
    fin = t[torch.isfinite(t)]
    return float(fin.abs().max()) if fin.numel() else 1.0


def _compare_non_finite(got, want, tol):
    """NaN where the plain version has NaN, the same infinities, the
    finite outputs within ``tol`` (rtol and atol)."""
    g, w = got.float(), want.float()
    assert not bool(torch.isfinite(w).all())
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    assert torch.equal(torch.isposinf(g), torch.isposinf(w))
    assert torch.equal(torch.isneginf(g), torch.isneginf(w))
    fin = torch.isfinite(w)
    torch.testing.assert_close(g[fin], w[fin], rtol=tol[0], atol=tol[1])


# (window, num_meta): a causal full layer, and a window layer with meta
# tokens whose last query tile skips 3 key tiles past the window (a window
# of 96 also leaves warps of visited tiles with no key to see)
@pytest.mark.parametrize("window,num_meta", [(0, 0), (96, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_non_finite_on_card(cuda, window, num_meta, dtype):
    """inf and NaN in V at keys in tiles the kernel skips for some rows
    (the last key, above every earlier query tile's diagonal; key 100,
    outside the window of rows 196 on: masked in a visited tile, in the
    tile of warps 2-3 of query tile 3 that see none of it, and in a tile
    query tiles 4-6 skip; key 70) and inside visited tiles (key 5, a meta
    token), in K (masked for most rows) and in Q: the plain version's inf
    and NaN."""
    b, hq, hkv, s, hd = 2, 6, 2, 448, 64
    q, k, v = _attention_args(cuda, b, hq, hkv, s, hd, dtype,
                              model_layout=True)
    v[0, 1, s - 1, 3] = float("inf")
    v[1, 0, s - 1, 7] = float("nan")
    v[0, 0, 100, 11] = float("-inf")
    v[1, 1, 70, 13] = float("inf")
    v[0, 0, 5, 17] = float("nan")
    k[0, 1, 300, 2] = float("inf")
    q[1, 4, 200, 9] = float("inf")
    got = flash_attention(q, k, v, window=window, num_meta=num_meta)
    want = ref.flash_attention_ref(q, k, v, window=window, num_meta=num_meta)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    _compare_non_finite(got, want, (tol, tol))


@pytest.mark.parametrize("shape", [(1, 512, 4, 64, 16, 128),    # Hymba's
                                   (1, 512, 2, 64, 128, 256)])  # mamba2's
@pytest.mark.parametrize("name", ["x", "dt", "B", "C"])
@pytest.mark.parametrize("row", [100, 30])
@pytest.mark.parametrize("val", [float("inf"), float("nan")])
def test_ssd_scan_non_finite_on_card(cuda, shape, name, row, val):
    """An inf or NaN in x, dt, B or C at row 100 of the first chunk (a
    source tile the output pass skips for rows 0-63) or row 30 (inside
    the diagonal tile): the plain version's inf and NaN, in the chunk's
    earlier rows and, through the state, in the later chunks."""
    b, s, h, p, n, chunk = shape
    args = list(_ssd_args(cuda, b, s, h, p, n, torch.float32, strided=True))
    x, dt, _, B, C = args
    {"x": lambda: x.__setitem__((0, row, 1, 3), val),
     "dt": lambda: dt.__setitem__((0, row, 1), val),
     "B": lambda: B.__setitem__((0, row, 5), val),
     "C": lambda: C.__setitem__((0, row, 5), val)}[name]()
    y, st = ssd_scan(*args, chunk=chunk)
    y_ref, st_ref = ref.ssd_chunked(*args, chunk)
    _compare_non_finite(y, y_ref, (1e-4, 5e-4 * _finite_scale(y_ref)))
    if name != "C":
        _compare_non_finite(st, st_ref, (1e-4, 5e-4 * _finite_scale(st_ref)))


def test_ssd_scan_bf16_on_card(cuda):
    args = _ssd_args(cuda, 2, 256, 5, 64, 16, torch.bfloat16, strided=True)
    y, st = ssd_scan(*args, chunk=128)
    y_ref, st_ref = ref.ssd_chunked(*args, 128)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=3e-2,
                               atol=3e-2)
    _close_scaled(st, st_ref)


def test_lm_kernel_guards_on_card(cuda):
    q, k, v = _attention_args(cuda, 1, 2, 1, 9, 16, torch.float32)
    with pytest.raises(ValueError, match="head_dim stride"):
        flash_attention(q[..., ::2], k[..., ::2], v[..., ::2])
    with pytest.raises(ValueError, match="several devices"):
        flash_attention(q, k.cpu(), v)
    args = _ssd_args(cuda, 1, 8, 2, 4, 3, torch.float32)
    with pytest.raises(ValueError, match="must divide"):
        ssd_scan(*args, chunk=3)
    with pytest.raises(ValueError, match="outside what the kernel takes"):
        ssd_scan(*_ssd_args(cuda, 1, 8, 1, 65, 3, torch.float32), chunk=8)


# ---------------------------------------------------------------------------
# flash_attention at head_dim > 128 (the kernel's 128-column O slices)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hq,hkv,s,hd,window,num_meta", [
    (1, 8, 1, 2048, 256, 0, 0),           # gemma-2b: MQA, hd 256
    (2, 4, 2, 300, 256, 96, 16),          # GQA, window + meta, ragged S
    (2, 4, 1, 200, 160, 0, 0),            # MQA, a 32-column last slice
    (2, 4, 2, 333, 160, 64, 5),
    (2, 6, 2, 256, 192, 0, 0),            # GQA, a 64-column last slice
    (1, 3, 1, 150, 192, 96, 8),
    (1, 2, 1, 333, 512, 0, 0),            # four slices
    (1, 4, 2, 200, 512, 64, 4),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_wide_head_dims_on_card(cuda, b, hq, hkv, s, hd,
                                                window, num_meta, dtype):
    """hd 160, 192, 256 and 512 (the Pallas kernel takes any hd): causal
    and window with meta tokens, GQA and MQA, in the model's strided
    layout; the launch counter rises by one a call."""
    q, k, v = _attention_args(cuda, b, hq, hkv, s, hd, dtype,
                              model_layout=True)
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=window, num_meta=num_meta)
    assert flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, window=window, num_meta=num_meta)
    assert got.dtype == dtype and got.shape == q.shape
    assert got.stride() == q.stride()
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("window,num_meta", [(0, 0), (96, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_wide_non_finite_on_card(cuda, window, num_meta,
                                                 dtype):
    """At hd 256: inf and NaN in V at keys the kernel skips for some rows
    and in visited tiles, in both 128-column slices (columns 3 and 200,
    11 and 140), in K (column 250) and in Q (column 129): the plain
    version's inf and NaN."""
    b, hq, hkv, s, hd = 2, 6, 2, 448, 256
    q, k, v = _attention_args(cuda, b, hq, hkv, s, hd, dtype,
                              model_layout=True)
    v[0, 1, s - 1, 3] = float("inf")
    v[1, 0, s - 1, 200] = float("nan")
    v[0, 0, 100, 11] = float("-inf")
    v[1, 1, 70, 140] = float("inf")
    v[0, 0, 5, 17] = float("nan")
    k[0, 1, 300, 250] = float("inf")
    q[1, 4, 200, 129] = float("inf")
    got = flash_attention(q, k, v, window=window, num_meta=num_meta)
    want = ref.flash_attention_ref(q, k, v, window=window, num_meta=num_meta)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    _compare_non_finite(got, want, (tol, tol))


# ---------------------------------------------------------------------------
# the FL paths of module items 7 and 10 launch their kernels
# ---------------------------------------------------------------------------

def _small_fl():
    from repro_torch.config import FLConfig
    from repro_torch.configs.paper_models import PaperNetConfig
    from repro_torch.data.federated import pseudo_femnist_federated
    net = PaperNetConfig(name="cnn-small", kind="cnn", image_size=28,
                         channels=1, hidden=8, num_classes=10)
    data = pseudo_femnist_federated(12, per_client=20, num_classes=10,
                                    seed=1)
    return net, data, dict(num_clients=12, num_clusters=2,
                           devices_per_cluster=4, participation=4,
                           local_epochs=1, lr=0.05, straggler_rate=0.25)


def test_cluster_then_global_launches_fed_aggregate_on_card(cuda):
    from repro_torch.core import aggregation
    x = {"w": torch.randn((6, 40, 3), device="cuda", generator=cuda),
         "b": torch.randn((6, 5), device="cuda", generator=cuda)}
    counts = torch.tensor([3.0, 1, 4, 1, 5, 9], device="cuda")
    mask = torch.tensor([1.0, 0, 1, 1, 1, 0], device="cuda")
    ids = torch.tensor([0, 1, 1, 2, 2, 0], dtype=torch.int32, device="cuda")
    before = fed_aggregate.launches
    got = aggregation.cluster_then_global(x, counts, ids, 3, mask)
    avg = aggregation.weighted_average(x, counts, mask)
    assert fed_aggregate.launches == before + 2
    cpu = {k: v.cpu() for k, v in x.items()}
    want = aggregation.cluster_then_global(cpu, counts.cpu(), ids.cpu(), 3,
                                           mask.cpu())
    want_avg = aggregation.weighted_average(cpu, counts.cpu(), mask.cpu())
    for k in x:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(avg[k].cpu(), want_avg[k], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("mix_path,kernel", [("auto", fed_mix_segment),
                                             ("dense", fed_mix)])
def test_fedp2p_topo_and_faulted_runs_launch_mix_kernels_on_card(
        cuda, mix_path, kernel):
    """fedp2p_topo (through ``topology_aware=True``) and a faulted fedp2p
    run, each two rounds: one mix kernel launch a round; the faulted
    run's counters follow the plan and its carry stays finite."""
    from repro_torch.config import FLConfig
    from repro_torch.core.simulator import Simulator
    from repro_torch.faults import make_plan
    net, data, kw = _small_fl()
    sim = Simulator(net, data, FLConfig(topology_aware=True,
                                        mix_path=mix_path, **kw))
    before = kernel.launches
    hist = sim.run(rounds=2)
    assert kernel.launches == before + 2
    assert sim.engine("fedp2p").proto.name == "fedp2p_topo"
    assert all(torch.isfinite(torch.tensor(hist.train_loss)))
    plan = make_plan(8, 2, seed=5, drop_rate=0.25, corrupt_rate=0.4)
    sim = Simulator(net, data, FLConfig(mix_path=mix_path, **kw),
                    faults=plan)
    before = kernel.launches
    hist = sim.run(rounds=2, algorithm="fedp2p")
    assert kernel.launches == before + 2
    drop, flag, _ = plan.dense_arrays(2, 8)
    assert hist.dropped == drop.sum(axis=1).astype(int).tolist()
    assert all(r >= int(f.sum()) for r, f in zip(hist.rejected_rows, flag))
    assert all(torch.isfinite(torch.tensor(hist.train_loss + hist.acc)))


# ---------------------------------------------------------------------------
# the backward kernels
# ---------------------------------------------------------------------------

def _qkv_model_layout(gen, b, hq, hkv, s, hd, dtype):
    """q, k, v as the model hands them over: [B, S, H, hd] viewed as
    [B, H, S, hd]."""
    return [(torch.randn((b, s, h, hd), device="cuda", generator=gen) * 0.5)
            .to(dtype).transpose(1, 2) for h in (hq, hkv, hkv)]


def _flash_grads(fn, q, k, v, dout, window, num_meta):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves, window=window, num_meta=num_meta)
    out.backward(dout)
    torch.cuda.synchronize()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("b,hq,hkv,s,hd,window,num_meta", [
    (2, 25, 5, 2048, 64, 1024, 128),    # Hymba's window layer
    (2, 25, 5, 2048, 64, 0, 128),       # Hymba's full layer
    (1, 12, 2, 1024, 128, 0, 0),        # qwen2-1.5b's heads
    (2, 8, 1, 512, 64, 0, 0),           # MQA
    (2, 4, 2, 200, 64, 64, 8),          # ragged S
    (2, 4, 2, 128, 32, 64, 8),          # reduced Hymba's head_dim
    (1, 3, 3, 100, 48, 32, 0),          # an odd head_dim, MHA
    (1, 24, 24, 1500, 64, 0, 0),       # musicgen-medium's training shape
    (1, 8, 1, 2048, 256, 0, 0),         # gemma-2b's training shape (MQA)
    (2, 4, 2, 300, 256, 96, 16),        # hd 256: GQA, window + meta, ragged
    (1, 2, 1, 70, 256, 0, 0),           # hd 256: one row past two tiles
    (1, 4, 2, 130, 160, 48, 5),         # hd 160, padded to 256
    (2, 2, 2, 97, 200, 0, 0),           # hd 200, padded to 256
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_matches_plain_autograd_on_card(
        cuda, b, hq, hkv, s, hd, window, num_meta, dtype):
    q, k, v = _qkv_model_layout(cuda, b, hq, hkv, s, hd, dtype)
    dout = torch.randn((b, hq, s, hd), device="cuda", generator=cuda).to(dtype)
    # hd <= 64: flash_attention_bwd's own kernel; above: the wgmma ones at
    # 128 and 256
    kernel = {"flash_attention_bwd": flash_attention_bwd,
              "flash_attention_bwd_128": flash_attention_bwd_128,
              "flash_attention_bwd_256": flash_attention_bwd_256}[
        bwd_route(hd, hd)]
    before = kernel.launches
    got = _flash_grads(flash_attention, q, k, v, dout, window, num_meta)
    assert kernel.launches == before + 1
    want = _flash_grads(ref.flash_attention_ref, q, k, v, dout, window,
                        num_meta)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol,
                                   msg=name)


# (tensor, (b, head, row, column)) of Hymba's window layer (B 1, 25/5
# heads of 64, 2048 positions, window 1024, 128 meta tokens): a query row
# whose keys past the diagonal and before its window lie in tiles the dK
# pass skips, keys whose later and much later rows the dQ pass skips (one a
# meta token), a key inside visited tiles, and dO rows whose masked keys
# the dV pass skips
FLASH_BWD_SITES = [("q", (0, 7, 1500, 5)), ("k", (0, 2, 600, 9)),
                   ("k", (0, 1, 50, 3)), ("v", (0, 3, 1200, 20)),
                   ("dO", (0, 12, 40, 7)), ("dO", (0, 4, 1900, 60))]


@pytest.mark.parametrize("tensor,index", FLASH_BWD_SITES,
                         ids=[f"{t}_row{i[2]}" for t, i in FLASH_BWD_SITES])
@pytest.mark.parametrize("val", [float("inf"), -float("inf"), float("nan")],
                         ids=["inf", "-inf", "nan"])
def test_flash_attention_bwd_non_finite_on_card(cuda, tensor, index, val):
    """An inf or NaN in q, k, v or dO: dq, dk and dv hold NaN and inf where
    the plain version's autograd does (its softmax backward sums p·dP over
    masked keys too, and 0 · inf in the tiles the kernel skips), the
    finite values at the f32 tolerance."""
    b, hq, hkv, s, hd, window, meta = 1, 25, 5, 2048, 64, 1024, 128
    q, k, v = _qkv_model_layout(cuda, b, hq, hkv, s, hd, torch.float32)
    dout = torch.randn((b, hq, s, hd), device="cuda", generator=cuda)
    {"q": q, "k": k, "v": v, "dO": dout}[tensor][index] = val
    got = _flash_grads(flash_attention, q, k, v, dout, window, meta)
    want = _flash_grads(ref.flash_attention_ref, q, k, v, dout, window, meta)
    assert not all(bool(torch.isfinite(w).all()) for w in want)
    for g, w in zip(got, want):     # dv stays finite for an inf in v
        if bool(torch.isfinite(w).all()):
            torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
        else:
            _compare_non_finite(g, w, (2e-5, 2e-5))


# (tensor, (b, head, row, column)) at head_dim 256 (B 1, GQA 4/2, 448
# positions, window 96, 16 meta tokens): columns past 128 (the upper
# words of the 8-word masks) in tiles the passes skip and visit
FLASH_BWD_256_SITES = [("q", (0, 1, 300, 200)), ("k", (0, 1, 100, 130)),
                       ("k", (0, 0, 5, 250)), ("v", (0, 1, 200, 140)),
                       ("dO", (0, 2, 40, 255)), ("dO", (0, 3, 400, 7))]


@pytest.mark.parametrize("tensor,index", FLASH_BWD_256_SITES,
                         ids=[f"{t}_row{i[2]}_col{i[3]}"
                              for t, i in FLASH_BWD_256_SITES])
@pytest.mark.parametrize("val", [float("inf"), float("nan")],
                         ids=["inf", "nan"])
def test_flash_attention_bwd_256_non_finite_on_card(cuda, tensor, index, val):
    """At head_dim 256 (flash_attention_bwd_256, 8-word masks): an inf or
    NaN in q, k, v or dO gives dq, dk and dv the plain autograd's NaN and
    inf, the finite values at the f32 tolerance."""
    b, hq, hkv, s, hd, window, meta = 1, 4, 2, 448, 256, 96, 16
    q, k, v = _qkv_model_layout(cuda, b, hq, hkv, s, hd, torch.float32)
    dout = torch.randn((b, hq, s, hd), device="cuda", generator=cuda)
    {"q": q, "k": k, "v": v, "dO": dout}[tensor][index] = val
    got = _flash_grads(flash_attention, q, k, v, dout, window, meta)
    want = _flash_grads(ref.flash_attention_ref, q, k, v, dout, window, meta)
    assert not all(bool(torch.isfinite(w).all()) for w in want)
    for g, w in zip(got, want):
        if bool(torch.isfinite(w).all()):
            torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
        else:
            _compare_non_finite(g, w, (2e-5, 2e-5))


# hd = vd = 256 on flash_fwd_kernel_wgmma256 and flash_attention_bwd_256
# (64-row tiles): S one below and one above a multiple of 64, a tile and a
# row, GQA 6/2 and MQA 8/1, a window with meta tokens, hd 129 and 192
# (zero-padded to 256)
EDGES_256 = [
    (1, 2, 1, 63, 256, 0, 0), (1, 2, 1, 65, 256, 0, 0),
    (2, 6, 2, 127, 256, 0, 0), (2, 6, 2, 129, 256, 0, 0),
    (1, 8, 1, 191, 256, 0, 0), (1, 8, 1, 193, 256, 0, 0),
    (1, 6, 2, 320, 256, 70, 9), (2, 8, 1, 257, 256, 64, 64),
    (1, 4, 2, 150, 129, 0, 0), (1, 4, 1, 200, 192, 48, 5),
]


@pytest.mark.parametrize("b,hq,hkv,s,hd,window,num_meta", EDGES_256)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_256_edges_on_card(cuda, b, hq, hkv, s, hd, window,
                                           num_meta, dtype):
    """The forward and its backward at the redesigned kernels' tile edges:
    o, dq, dk and dv against the plain version and its autograd at the
    forward's tolerances; each call goes through the wgmma kernels."""
    q, k, v = _qkv_model_layout(cuda, b, hq, hkv, s, hd, dtype)
    dout = torch.randn((b, hq, s, hd), device="cuda", generator=cuda).to(dtype)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    got = flash_attention(q, k, v, window=window, num_meta=num_meta)
    want = ref.flash_attention_ref(q, k, v, window=window, num_meta=num_meta)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    before = flash_attention_bwd_256.launches
    got = _flash_grads(flash_attention, q, k, v, dout, window, num_meta)
    assert flash_attention_bwd_256.launches == before + 1
    want = _flash_grads(ref.flash_attention_ref, q, k, v, dout, window,
                        num_meta)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol,
                                   msg=name)


# (tensor, (b, head, row, column)) at head_dim 256, B 1, GQA 6/2, 320
# positions, window 70, 9 meta tokens: in tiles the forward and both
# backward passes skip for some rows (a key past the window, a query row
# whose early keys lie outside it, dO rows) and inside visited ones
NON_FINITE_256 = [("q", (0, 5, 300, 250)), ("k", (0, 1, 90, 131)),
                  ("k", (0, 0, 3, 7)), ("v", (0, 1, 100, 255)),
                  ("v", (0, 0, 319, 64)), ("dO", (0, 4, 10, 128)),
                  ("dO", (0, 2, 250, 3))]


@pytest.mark.parametrize("tensor,index", NON_FINITE_256,
                         ids=[f"{t}_row{i[2]}_col{i[3]}"
                              for t, i in NON_FINITE_256])
@pytest.mark.parametrize("val", [float("inf"), -float("inf"), float("nan")],
                         ids=["inf", "-inf", "nan"])
def test_flash_attention_256_non_finite_on_card(cuda, tensor, index, val):
    """An inf or NaN in q, k, v or dO at head_dim 256: o and the
    gradients hold the plain version's NaN and inf, the finite values at
    the f32 tolerance."""
    b, hq, hkv, s, hd, window, meta = 1, 6, 2, 320, 256, 70, 9
    q, k, v = _qkv_model_layout(cuda, b, hq, hkv, s, hd, torch.float32)
    dout = torch.randn((b, hq, s, hd), device="cuda", generator=cuda)
    {"q": q, "k": k, "v": v, "dO": dout}[tensor][index] = val
    outs = [flash_attention(q, k, v, window=window, num_meta=meta)]
    wants = [ref.flash_attention_ref(q, k, v, window=window, num_meta=meta)]
    outs += _flash_grads(flash_attention, q, k, v, dout, window, meta)
    wants += _flash_grads(ref.flash_attention_ref, q, k, v, dout, window,
                          meta)
    assert not all(bool(torch.isfinite(w).all()) for w in wants)
    for g, w in zip(outs, wants):
        if bool(torch.isfinite(w).all()):
            torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
        else:
            _compare_non_finite(g, w, (2e-5, 2e-5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_256_repeats_bit_for_bit_on_card(cuda, dtype):
    """Two calls of the forward and of the backward at 256 give the same
    bits (no float atomics; the GQA sum in head order)."""
    from repro_torch.kernels.flash_attention import _launch
    q, k, v = _qkv_model_layout(cuda, 2, 6, 2, 333, 256, dtype)
    lse = torch.empty((2, 6, 333), device="cuda")
    out = _launch(q, k, v, 0, 0, lse=lse)
    assert torch.equal(out, _launch(q, k, v, 0, 0, lse=lse))
    dout = torch.randn_like(out)
    r1, r2 = [flash_attention_bwd_256(q, k, v, out, dout, lse)
              for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(r1, r2))


@pytest.mark.parametrize("hd,vd", [(129, 129), (192, 192), (256, 256),
                                   (257, 257), (512, 512), (320, 256)])
def test_flash_attention_forward_routes_on_card(cuda, hd, vd):
    """vd = hd in (128, 256] runs flash_fwd_kernel_wgmma256 (the scores
    once per tile pair); hd 257 and 512, and (320, 256), stay on the wide
    kernel's 128-column slices: the launched kernels' names, as
    ``forward_route`` says, and the output against the plain version."""
    from torch.profiler import ProfilerActivity, profile
    g = cuda
    q = torch.randn((1, 2, 130, hd), device="cuda", generator=g) * 0.5
    k = torch.randn((1, 1, 130, hd), device="cuda", generator=g) * 0.5
    v = torch.randn((1, 1, 130, vd), device="cuda", generator=g) * 0.5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages())
    route = forward_route(hd, vd)
    assert route == ("wgmma256" if vd == hd <= 256 else "wide")
    assert ("flash_fwd_kernel_wgmma256" in names) == (route == "wgmma256")
    assert ("flash_fwd_kernel_wide" in names) == (route == "wide")
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v),
                               rtol=2e-5, atol=2e-5)


# hd = vd in (64, 128] on flash_fwd_kernel_wgmma128 (128-row query tiles,
# two warpgroups on their 64-row halves) and flash_attention_bwd_128
# (64-row tiles): S one below and above multiples of 64 and 128, GQA
# groups 1, 6, 7 and 8, windows with meta tokens, hd 65, 100 and 127
# (zero-padded to 128)
EDGES_128 = [
    (1, 2, 2, 63, 128, 0, 0), (1, 2, 2, 65, 128, 0, 0),
    (2, 6, 1, 127, 128, 0, 0), (2, 6, 1, 129, 128, 0, 0),
    (1, 7, 1, 191, 128, 0, 0), (1, 8, 1, 193, 128, 0, 0),
    (1, 16, 2, 257, 128, 70, 9), (2, 12, 2, 320, 128, 64, 64),
    (1, 14, 2, 200, 128, 100, 5), (1, 4, 2, 150, 65, 0, 0),
    (1, 6, 1, 200, 100, 48, 5), (1, 8, 1, 130, 127, 0, 0),
]


@pytest.mark.parametrize("b,hq,hkv,s,hd,window,num_meta", EDGES_128)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_128_edges_on_card(cuda, b, hq, hkv, s, hd, window,
                                           num_meta, dtype):
    """The forward and its backward at the hd-128 kernels' tile edges: o,
    dq, dk and dv against the plain version and its autograd at the
    forward's tolerances; each call goes through the wgmma kernels."""
    q, k, v = _qkv_model_layout(cuda, b, hq, hkv, s, hd, dtype)
    dout = torch.randn((b, hq, s, hd), device="cuda", generator=cuda).to(dtype)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    got = flash_attention(q, k, v, window=window, num_meta=num_meta)
    want = ref.flash_attention_ref(q, k, v, window=window, num_meta=num_meta)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    before = flash_attention_bwd_128.launches
    got = _flash_grads(flash_attention, q, k, v, dout, window, num_meta)
    assert flash_attention_bwd_128.launches == before + 1
    want = _flash_grads(ref.flash_attention_ref, q, k, v, dout, window,
                        num_meta)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol,
                                   msg=name)


@pytest.mark.parametrize("hd", [96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_128_unaligned_rows_on_card(cuda, hd, dtype):
    """q, k, v and dO as [b, s, h, hd] slices of [b, s, h, hd + 1]
    tensors (odd row strides: the images' loads element by element), GQA
    7/1, a window with meta tokens: o, dq, dk and dv against the plain
    version."""
    kw = dict(device="cuda", generator=cuda)
    q, k, v, dout = [(torch.randn((1, 150, h, hd + 1), **kw) * 0.5).to(dtype)
                     [..., :hd].transpose(1, 2) for h in (7, 1, 1, 7)]
    assert q.stride(2) % 2 == 1 and dout.stride(2) % 2 == 1
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    got = flash_attention(q, k, v, window=64, num_meta=4)
    want = ref.flash_attention_ref(q, k, v, window=64, num_meta=4)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    got = _flash_grads(flash_attention, q, k, v, dout, 64, 4)
    want = _flash_grads(ref.flash_attention_ref, q, k, v, dout, 64, 4)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol,
                                   msg=name)


# (tensor, (b, head, row, column)) at head_dim 128, B 1, GQA 14/2 (group
# 7), 320 positions, window 70, 9 meta tokens: in tiles the forward and
# both backward passes skip for some rows (a key past the window, the last
# key, a query row whose early keys lie outside the window, dO rows) and
# inside visited ones
NON_FINITE_128 = [("q", (0, 13, 300, 120)), ("k", (0, 1, 90, 65)),
                  ("k", (0, 0, 3, 7)), ("v", (0, 1, 100, 127)),
                  ("v", (0, 0, 319, 64)), ("dO", (0, 4, 10, 100)),
                  ("dO", (0, 9, 250, 3))]


@pytest.mark.parametrize("tensor,index", NON_FINITE_128,
                         ids=[f"{t}_row{i[2]}_col{i[3]}"
                              for t, i in NON_FINITE_128])
@pytest.mark.parametrize("val", [float("inf"), -float("inf"), float("nan")],
                         ids=["inf", "-inf", "nan"])
def test_flash_attention_128_non_finite_on_card(cuda, tensor, index, val):
    """An inf or NaN in q, k, v or dO at head_dim 128: o and the
    gradients hold the plain version's NaN and inf, the finite values at
    the f32 tolerance."""
    b, hq, hkv, s, hd, window, meta = 1, 14, 2, 320, 128, 70, 9
    q, k, v = _qkv_model_layout(cuda, b, hq, hkv, s, hd, torch.float32)
    dout = torch.randn((b, hq, s, hd), device="cuda", generator=cuda)
    {"q": q, "k": k, "v": v, "dO": dout}[tensor][index] = val
    outs = [flash_attention(q, k, v, window=window, num_meta=meta)]
    wants = [ref.flash_attention_ref(q, k, v, window=window, num_meta=meta)]
    outs += _flash_grads(flash_attention, q, k, v, dout, window, meta)
    wants += _flash_grads(ref.flash_attention_ref, q, k, v, dout, window,
                          meta)
    assert not all(bool(torch.isfinite(w).all()) for w in wants)
    for g, w in zip(outs, wants):
        if bool(torch.isfinite(w).all()):
            torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
        else:
            _compare_non_finite(g, w, (2e-5, 2e-5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_128_repeats_bit_for_bit_on_card(cuda, dtype):
    """Two calls of the forward and of the backward at 128 give the same
    bits (no float atomics; the GQA sum in head order)."""
    from repro_torch.kernels.flash_attention import _launch
    q, k, v = _qkv_model_layout(cuda, 2, 8, 1, 333, 128, dtype)
    lse = torch.empty((2, 8, 333), device="cuda")
    out = _launch(q, k, v, 0, 0, lse=lse)
    assert torch.equal(out, _launch(q, k, v, 0, 0, lse=lse))
    dout = torch.randn_like(out)
    r1, r2 = [flash_attention_bwd_128(q, k, v, out, dout, lse)
              for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(r1, r2))


@pytest.mark.parametrize("hd", [32, 64, 65, 100, 128])
def test_flash_attention_128_routes_on_card(cuda, hd):
    """vd = hd in (64, 128] runs flash_fwd_kernel_wgmma128 forward (with
    its images, flash_fwd_kernel_image128) and flash_attention_bwd_128's
    kernels backward, and no hd-128 instantiation of the mma.sync kernels
    (flash_fwd_kernel, flash_bwd_dkdv_kernel, flash_bwd_dq_kernel) runs;
    hd <= 64 stays on those: the launched kernels' names, as
    ``forward_route`` and ``bwd_route`` say, and the output against the
    plain version."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _qkv_model_layout(cuda, 1, 6, 1, 200, hd, torch.float32)
    dout = torch.randn((1, 6, 200, hd), device="cuda", generator=cuda)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = _flash_grads(flash_attention, q, k, v, dout, 0, 0)
    names = " ".join(e.key for e in prof.key_averages())
    wide = hd > 64
    assert forward_route(hd, hd) == ("wgmma128" if wide else "mma")
    assert bwd_route(hd, hd) == ("flash_attention_bwd_128" if wide
                                 else "flash_attention_bwd")
    for kernel in ("flash_fwd_kernel_wgmma128", "flash_fwd_kernel_image128",
                   "flash_bwd_128_dkdv_kernel", "flash_bwd_128_dq_kernel",
                   "flash_bwd_128_image_kernel"):
        assert (kernel in names) == wide, kernel
    for kernel in ("flash_fwd_kernel<", "flash_bwd_dkdv_kernel<",
                   "flash_bwd_dq_kernel<"):
        assert (kernel in names) == (not wide), kernel
    want = _flash_grads(ref.flash_attention_ref, q, k, v, dout, 0, 0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5, msg=name)


def _ssd_grads(fn, x, dt, A, B, C, init, dy, dfinal, chunk):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, dt, A, B, C)]
    ii = None if init is None else init.detach().clone().requires_grad_(True)
    if fn is None:
        y, fin = ref.ssd_chunked(*leaves, chunk, initial_state=ii)
    else:
        y, fin = fn(*leaves, chunk=chunk, initial_state=ii)
    loss = (y * dy).sum()
    if dfinal is not None:
        loss = loss + (fin * dfinal).sum()
    loss.backward()
    torch.cuda.synchronize()
    return [t.grad for t in leaves] + ([ii.grad] if ii is not None else [])


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 2048, 50, 64, 16, 128),         # Hymba
    (1, 1024, 24, 64, 128, 256),        # mamba2-130m
    (2, 256, 24, 64, 128, 128),         # mamba2-130m at the CLI's chunk
    (2, 100, 4, 16, 16, 20),            # small chunks
    (1, 300, 5, 48, 24, 100),           # ragged tiles, n = 24
    (1, 1024, 2, 64, 256, 1024),        # one chunk, the largest state
])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_bwd_matches_plain_autograd_on_card(cuda, b, s, h, p, n,
                                                     chunk, with_state):
    x = torch.randn((b, s, h, p), device="cuda", generator=cuda) * 0.5
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), device="cuda", generator=cuda))
    A = -torch.exp(torch.randn(h, device="cuda", generator=cuda) * 0.3)
    B = torch.randn((b, s, n), device="cuda", generator=cuda) * 0.5
    C = torch.randn((b, s, n), device="cuda", generator=cuda) * 0.5
    init = (torch.randn((b, h, p, n), device="cuda", generator=cuda)
            if with_state else None)
    dy = torch.randn((b, s, h, p), device="cuda", generator=cuda)
    dfinal = (torch.randn((b, h, p, n), device="cuda", generator=cuda)
              if with_state else None)
    before = ssd_scan_bwd.launches
    got = _ssd_grads(ssd_scan, x, dt, A, B, C, init, dy, dfinal, chunk)
    assert ssd_scan_bwd.launches == before + 1
    want = _ssd_grads(None, x, dt, A, B, C, init, dy, dfinal, chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dinit"), got,
                          want):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=1e-4, atol=5e-4 * scale,
                                   msg=name)


@pytest.mark.parametrize("shape", [(1, 512, 4, 64, 16, 128),    # Hymba's
                                   (1, 512, 2, 64, 128, 256)])  # mamba2's
@pytest.mark.parametrize("name", ["x", "dt", "B", "C", "dY"])
@pytest.mark.parametrize("row", [100, 30, 200])
@pytest.mark.parametrize("val", [float("inf"), -float("inf"), float("nan")],
                         ids=["inf", "-inf", "nan"])
def test_ssd_scan_bwd_non_finite_on_card(cuda, shape, name, row, val):
    """An inf or NaN in x, dt, B, C or dY at row 100 of the first chunk (in
    a 64-row tile the passes skip for rows 0-63 and sources 128-...), row
    30 (inside the diagonal tile) or row 200 (the second chunk at Hymba's
    shape): dx, d(dt), dA, dB and dC hold NaN and inf where the plain
    version's autograd does, the finite values at the finite cases'
    tolerance."""
    b, s, h, p, n, chunk = shape
    x = torch.randn((b, s, h, p), device="cuda", generator=cuda) * 0.5
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), device="cuda", generator=cuda))
    A = -torch.exp(torch.randn(h, device="cuda", generator=cuda) * 0.3)
    B = torch.randn((b, s, n), device="cuda", generator=cuda) * 0.5
    C = torch.randn((b, s, n), device="cuda", generator=cuda) * 0.5
    dy = torch.randn((b, s, h, p), device="cuda", generator=cuda)
    target, index = {"x": (x, (0, row, 1, 3)), "dt": (dt, (0, row, 1)),
                     "B": (B, (0, row, 5)), "C": (C, (0, row, 5)),
                     "dY": (dy, (0, row, 1, 3))}[name]
    target[index] = val
    got = _ssd_grads(ssd_scan, x, dt, A, B, C, None, dy, None, chunk)
    want = _ssd_grads(None, x, dt, A, B, C, None, dy, None, chunk)
    for g, w in zip(got, want):
        scale = _finite_scale(w)
        if bool(torch.isfinite(w).all()):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=5e-4 * scale)
        else:
            _compare_non_finite(g, w, (1e-4, 5e-4 * scale))


def test_backward_kernels_repeat_bit_for_bit_on_card(cuda):
    from repro_torch.kernels.flash_attention import _launch
    from repro_torch.kernels.ssd_scan import _launch as ssd_launch
    q, k, v = _qkv_model_layout(cuda, 2, 25, 5, 1024, 64, torch.float32)
    lse = torch.empty((2, 25, 1024), device="cuda")
    out = _launch(q, k, v, 512, 128, lse=lse)
    dout = torch.randn_like(out)
    r1, r2 = [flash_attention_bwd(q, k, v, out, dout, lse, window=512,
                                  num_meta=128) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(r1, r2))
    q, k, v = _qkv_model_layout(cuda, 1, 8, 2, 512, 256, torch.float32)
    lse = torch.empty((1, 8, 512), device="cuda")
    out = _launch(q, k, v, 0, 0, lse=lse)
    dout = torch.randn_like(out)
    r1, r2 = [flash_attention_bwd(q, k, v, out, dout, lse) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(r1, r2))
    x = torch.randn((2, 1024, 24, 64), device="cuda", generator=cuda)
    dt = torch.rand((2, 1024, 24), device="cuda", generator=cuda)
    A = -torch.rand(24, device="cuda", generator=cuda) - 0.5
    B, C = [torch.randn((2, 1024, 128), device="cuda", generator=cuda)
            for _ in range(2)]
    y, _, ws = ssd_launch(x, dt, A, B, C, 256, None)
    dy = torch.randn_like(y)
    r1, r2 = [ssd_scan_bwd(x, dt, A, B, C, ws, dy, None, chunk=256)[:5]
              for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(r1, r2))


def test_serving_path_writes_no_lse_and_keeps_its_bits_on_card(cuda):
    """Without a gradient the forward launches as for serving; with one,
    the same output bits (the log-sum-exp store is the only addition)."""
    q, k, v = _qkv_model_layout(cuda, 2, 25, 5, 512, 64, torch.float32)
    with torch.no_grad():
        served = flash_attention(q, k, v, window=256, num_meta=16)
    trained = flash_attention(*[t.detach().requires_grad_(True)
                                for t in (q, k, v)], window=256, num_meta=16)
    assert served.grad_fn is None and trained.grad_fn is not None
    assert torch.equal(served, trained.detach())


def test_backward_guards_on_card(cuda):
    q, k, v = _qkv_model_layout(cuda, 1, 2, 1, 64, 320, torch.float32)
    with pytest.raises(ValueError, match="head_dim 320 > 256"):
        flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():                # serving at hd 320 still runs
        assert flash_attention(q, k, v).shape == q.shape
    x = torch.randn((1, 64, 2, 16), device="cuda").bfloat16()
    dt = torch.rand((1, 64, 2), device="cuda")
    B = torch.randn((1, 64, 8), device="cuda").bfloat16()
    with pytest.raises(ValueError, match="f32"):
        ssd_scan(x.requires_grad_(True), dt, -torch.ones(2, device="cuda"),
                 B, B, chunk=32)


# ---------------------------------------------------------------------------
# flash_attention with v's head_dim apart from q's and k's (MLA) and the
# MoE/MLA serving path
# ---------------------------------------------------------------------------

def _qkv_vd(gen, b, hq, hkv, s, hd, vd, dtype):
    """q, k at hd and v at vd, [b, s, h, ·] tensors viewed as
    [b, h, s, ·] (the model's layout)."""
    return [(torch.randn((b, s, h, d), device="cuda", generator=gen) * 0.5)
            .to(dtype).transpose(1, 2)
            for h, d in ((hq, hd), (hkv, hd), (hkv, vd))]


@pytest.mark.parametrize("b,hq,hkv,s,hd,vd,window,num_meta", [
    (4, 128, 128, 2048, 192, 128, 0, 0),  # DeepSeek-V2's prefill
    (4, 128, 128, 512, 192, 128, 0, 0),   # its 512-token prompt
    (4, 48, 8, 2048, 128, 128, 0, 0),     # DBRX's prefill (vd = hd)
    (2, 4, 4, 70, 24, 16, 0, 0),          # the reduced MLA config
    (2, 4, 1, 300, 64, 32, 96, 16),       # GQA 4/1, window + meta
    (2, 4, 1, 300, 96, 128, 96, 16),
    (2, 4, 1, 300, 320, 256, 96, 16),     # two O slices, five chunks
    (1, 3, 1, 150, 192, 128, 64, 8),
    (2, 4, 4, 1000, 192, 128, 0, 0),      # MLA, ragged S
    (1, 4, 4, 2047, 192, 128, 0, 0),
    (2, 8, 2, 600, 192, 128, 0, 0),       # GQA 8/2 at MLA's widths
    (2, 4, 2, 333, 256, 64, 96, 16),      # hd 256: four chunks of Q·Kᵀ
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_vd_on_card(cuda, b, hq, hkv, s, hd, vd, window,
                                    num_meta, dtype):
    """vd != hd through flash_fwd_kernel_wgmma (vd <= 128, hd <= 256) or
    the wide kernel ((320, 256)), and every shape the MoE/MLA serving
    path gives the kernel (DBRX's at vd = hd), against the plain version
    at the hd-256 rows' tolerances;
    the output is [B, S, H, vd] memory viewed as [B, H, S, vd], as q's
    layout is."""
    q, k, v = _qkv_vd(cuda, b, hq, hkv, s, hd, vd, dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=window, num_meta=num_meta)
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, hq, s, vd)
    assert got.transpose(1, 2).is_contiguous()
    want = ref.flash_attention_ref(q, k, v, window=window, num_meta=num_meta)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("window,num_meta", [(0, 0), (96, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_vd_non_finite_on_card(cuda, window, num_meta, dtype):
    """At (hd, vd) = (192, 128): inf and NaN in V at keys the kernel skips
    for some rows (the last key; key 100, outside the window of later rows)
    and in visited tiles (keys 70 and 5), in K past v's width (column 150)
    and in Q: the plain version's inf and NaN."""
    b, hq, hkv, s = 2, 6, 6, 448
    q, k, v = _qkv_vd(cuda, b, hq, hkv, s, 192, 128, dtype)
    v[0, 1, s - 1, 3] = float("inf")
    v[1, 0, s - 1, 127] = float("nan")
    v[0, 0, 100, 11] = float("-inf")
    v[1, 1, 70, 64] = float("inf")
    v[0, 2, 5, 17] = float("nan")
    k[0, 1, 300, 150] = float("inf")
    q[1, 4, 200, 129] = float("inf")
    got = flash_attention(q, k, v, window=window, num_meta=num_meta)
    want = ref.flash_attention_ref(q, k, v, window=window, num_meta=num_meta)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    _compare_non_finite(got, want, (tol, tol))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_vd_unaligned_rows_on_card(cuda, dtype):
    """At (192, 128), q, k and v whose rows start off 16 bytes (views of
    [B, S, H, d + 1] memory): the kernel's producer takes its element-wise
    loads where a vector load is not aligned, and matches the plain
    version."""
    b, h, s = 2, 3, 300
    q, k, v = [(torch.randn((b, s, h, d + 1), device="cuda",
                            generator=cuda) * 0.5).to(dtype)[..., :d]
               .transpose(1, 2) for d in (192, 192, 128)]
    assert q.stride(2) % 4 and v.stride(2) % 4
    got = flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_vd_backward_raises_on_card(cuda):
    """A CUDA tensor that needs a gradient at a shape no backward kernel
    takes ((320, 256): vd > 128) raises (no fallback); serving runs. A
    dO of another shape than the output raises."""
    q, k, v = _qkv_vd(cuda, 1, 2, 2, 64, 320, 256, torch.float32)
    with pytest.raises(ValueError, match="vd <= 128"):
        flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == (1, 2, 64, 256)
    from repro_torch.kernels.flash_attention import _launch
    q, k, v = _qkv_vd(cuda, 1, 2, 2, 64, 24, 16, torch.float32)
    lse = torch.empty((1, 2, 64), device="cuda")
    out = _launch(q, k, v, 0, 0, lse=lse)
    with pytest.raises(ValueError, match="must match out"):
        flash_attention_bwd_vd(q, k, v, out, out[..., :8], lse)


@pytest.mark.parametrize("b,hq,hkv,s,hd,vd,window,num_meta", [
    (1, 4, 4, 448, 192, 128, 0, 0),     # DeepSeek-V2's (192, 128)
    (2, 4, 4, 70, 24, 16, 0, 0),        # reduced deepseek-v2's MLA
    (1, 2, 2, 200, 160, 64, 96, 16),    # window + meta
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_vd_lse_on_card(cuda, b, hq, hkv, s, hd, vd, window,
                                        num_meta, dtype):
    """flash_fwd_kernel_wgmma with the log-sum-exp: each row's
    logsumexp of its visible scaled scores, as the plain version computes
    it, and the output bits of the serving launch."""
    from repro_torch.kernels.flash_attention import _launch
    q, k, v = _qkv_vd(cuda, b, hq, hkv, s, hd, vd, dtype)
    lse = torch.empty((b, hq, s), device="cuda")
    out = _launch(q, k, v, window, num_meta, lse=lse)
    served = _launch(q, k, v, window, num_meta, lse=None)
    assert torch.equal(out, served)
    scores = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * hd ** -0.5
    i = torch.arange(s, device="cuda")
    vis = (i[None] <= i[:, None]) & ((window <= 0) | (i[:, None] - i[None] < window)
                                     | (i[None] < num_meta))
    want = torch.logsumexp(scores.masked_fill(~vis, -float("inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,hq,hkv,s,hd,window,num_meta", [
    (1, 8, 1, 2048, 256, 0, 0),         # gemma-2b's training shape (MQA)
    (2, 4, 2, 300, 256, 96, 16),        # GQA, window + meta, ragged S
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_wide_lse_on_card(cuda, b, hq, hkv, s, hd, window,
                                          num_meta, dtype):
    """The forward at hd = vd = 256 (flash_fwd_kernel_wgmma256; the wide
    kernel's slices before it) with the log-sum-exp that the backward at
    256 reads: each row's logsumexp of its visible scaled scores, written
    once (by the first consumer warpgroup), and the output bits of the
    serving launch."""
    from repro_torch.kernels.flash_attention import _launch
    q, k, v = _qkv_model_layout(cuda, b, hq, hkv, s, hd, dtype)
    lse = torch.full((b, hq, s), float("nan"), device="cuda")
    out = _launch(q, k, v, window, num_meta, lse=lse)
    served = _launch(q, k, v, window, num_meta, lse=None)
    assert torch.equal(out, served)
    kk = k.float().repeat_interleave(hq // hkv, dim=1)
    scores = torch.einsum("bhid,bhjd->bhij", q.float(), kk) * hd ** -0.5
    i = torch.arange(s, device="cuda")
    vis = (i[None] <= i[:, None]) & ((window <= 0) | (i[:, None] - i[None] < window)
                                     | (i[None] < num_meta))
    want = torch.logsumexp(scores.masked_fill(~vis, -float("inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,hq,hkv,s,hd,vd,window,num_meta", [
    (1, 128, 128, 2048, 192, 128, 0, 0),  # DeepSeek-V2's training shape
    (2, 4, 4, 200, 192, 128, 0, 0),       # ragged S
    (2, 4, 4, 70, 24, 16, 0, 0),          # reduced deepseek-v2's MLA
    (1, 2, 2, 300, 192, 128, 96, 16),     # window + meta
    (2, 4, 1, 150, 64, 32, 48, 5),        # GQA 4/1, window + meta
    (2, 4, 2, 150, 96, 128, 48, 5),       # vd > hd
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_vd_matches_plain_autograd_on_card(
        cuda, b, hq, hkv, s, hd, vd, window, num_meta, dtype):
    """vd != hd: the call goes through flash_attention_bwd_vd (its counter
    rises, flash_attention_bwd's does not), dq, dk and dv at the
    forward's tolerances."""
    q, k, v = _qkv_vd(cuda, b, hq, hkv, s, hd, vd, dtype)
    dout = torch.randn((b, hq, s, vd), device="cuda", generator=cuda).to(dtype)
    before = (flash_attention_bwd_vd.launches, flash_attention_bwd.launches)
    got = _flash_grads(flash_attention, q, k, v, dout, window, num_meta)
    assert (flash_attention_bwd_vd.launches,
            flash_attention_bwd.launches) == (before[0] + 1, before[1])
    want = _flash_grads(ref.flash_attention_ref, q, k, v, dout, window,
                        num_meta)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol,
                                   msg=name)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,hd,vd,window,num_meta", [
    (1, 4, 4, 130, 200, 192, 128, 0, 0),  # query and key tiles cut, n_q < n_k
    (2, 4, 4, 65, 65, 192, 128, 0, 0),    # one row past a tile
    (1, 2, 2, 333, 333, 192, 128, 70, 3),  # the last query tile's keys
                                           # straddle two key tiles
    (1, 8, 4, 260, 260, 192, 128, 0, 0),  # GQA 2: the ordered group sum
    (1, 8, 2, 260, 260, 192, 128, 48, 5),  # GQA 4, window + meta
    (2, 4, 2, 100, 130, 64, 32, 0, 0),    # (64, 64) padded, n_q < n_k
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_vd_edges_on_card(cuda, b, hq, hkv, sq, sk, hd,
                                              vd, window, num_meta, dtype):
    """flash_attention_bwd_vd at the edges of its wgmma passes: tiles cut
    by S, fewer query rows than keys, a window whose keys cross key tiles,
    and the GQA partials summed in head order, at the forward's
    tolerances."""
    q = (torch.randn((b, sq, hq, hd), device="cuda", generator=cuda) * 0.5
         ).to(dtype).transpose(1, 2)
    k, v = [(torch.randn((b, sk, hkv, d), device="cuda", generator=cuda)
             * 0.5).to(dtype).transpose(1, 2) for d in (hd, vd)]
    dout = torch.randn((b, hq, sq, vd), device="cuda", generator=cuda).to(dtype)
    before = flash_attention_bwd_vd.launches
    got = _flash_grads(flash_attention, q, k, v, dout, window, num_meta)
    assert flash_attention_bwd_vd.launches == before + 1
    want = _flash_grads(ref.flash_attention_ref, q, k, v, dout, window,
                        num_meta)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol,
                                   msg=name)


# (tensor, (b, head, row, column)) at (192, 128), 448 positions, window
# 96, 16 meta tokens: a q row whose masked keys lie in tiles the dK pass
# skips (column 150: the third dK slice), keys the dQ pass skips for later
# rows (one a meta token, one at column 170), a v entry, and dO rows
FLASH_BWD_VD_SITES = [("q", (0, 1, 300, 150)), ("k", (0, 2, 100, 9)),
                      ("k", (0, 1, 5, 170)), ("v", (0, 3, 200, 20)),
                      ("dO", (0, 0, 40, 100)), ("dO", (0, 2, 400, 7))]


@pytest.mark.parametrize("tensor,index", FLASH_BWD_VD_SITES,
                         ids=[f"{t}_row{i[2]}" for t, i in FLASH_BWD_VD_SITES])
@pytest.mark.parametrize("val", [float("inf"), -float("inf"), float("nan")],
                         ids=["inf", "-inf", "nan"])
def test_flash_attention_bwd_vd_non_finite_on_card(cuda, tensor, index, val):
    """An inf or NaN in q, k, v or dO at (192, 128): dq, dk and dv hold NaN
    and inf where the plain version's autograd does, the finite values at
    the f32 tolerance."""
    b, hq, hkv, s, window, meta = 1, 4, 4, 448, 96, 16
    q, k, v = _qkv_vd(cuda, b, hq, hkv, s, 192, 128, torch.float32)
    dout = torch.randn((b, hq, s, 128), device="cuda", generator=cuda)
    {"q": q, "k": k, "v": v, "dO": dout}[tensor][index] = val
    got = _flash_grads(flash_attention, q, k, v, dout, window, meta)
    want = _flash_grads(ref.flash_attention_ref, q, k, v, dout, window, meta)
    assert not all(bool(torch.isfinite(w).all()) for w in want)
    for g, w in zip(got, want):
        if bool(torch.isfinite(w).all()):
            torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
        else:
            _compare_non_finite(g, w, (2e-5, 2e-5))


def test_flash_attention_bwd_vd_repeats_bit_for_bit_on_card(cuda):
    from repro_torch.kernels.flash_attention import _launch
    for hq, hkv in ((8, 8), (8, 2)):
        q, k, v = _qkv_vd(cuda, 2, hq, hkv, 640, 192, 128, torch.float32)
        lse = torch.empty((2, hq, 640), device="cuda")
        out = _launch(q, k, v, 0, 0, lse=lse)
        dout = torch.randn_like(out)
        r1, r2 = [flash_attention_bwd_vd(q, k, v, out, dout, lse)
                  for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(r1, r2))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "dbrx-132b"])
def test_moe_training_matches_cpu_on_card(cuda, arch, monkeypatch):
    """Reduced MoE models from the same weights (drawn on the CPU) train
    on the card as on the CPU: the step-1 loss at rtol 1e-5, every
    gradient leaf within 1e-4 of its largest |value| (the gathers'
    index-accumulates and the kernels sum in other orders), the losses of
    3 AdamW steps at rtol 1e-3 and the step-1 routing equal; the
    attention's backward kernel ran."""
    import numpy as np

    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import tree_flatten
    from repro_torch.launch.steps import _loss_and_grad, build_train_step
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 96)))
                for k in ("tokens", "labels")} for _ in range(3)]
    orig, routes = moe.dispatch_indices, []

    def recording(idx, num_experts, capacity):
        out = orig(idx, num_experts, capacity)
        routes.append((idx.cpu(), out[2].cpu()))
        return out

    monkeypatch.setattr(moe, "dispatch_indices", recording)
    out = {}
    for dev in ("cpu", "cuda"):
        p = _tree_to(params, dev)
        bs = [{k: v.to(dev) for k, v in b.items()} for b in batches]
        before = (flash_attention_bwd_vd.launches, flash_attention_bwd.launches)
        routes.clear()
        loss, _, grads = _loss_and_grad(model, False)(p, bs[0])
        step1 = list(routes)
        step, opt = build_train_step(model, TrainConfig(lr=3e-3, remat=False))
        st, losses = opt.init(p), []
        for b in bs:
            p, st, m = step(p, st, b)
            losses.append(float(m["loss"]))
        ran = (flash_attention_bwd_vd.launches - before[0]
               + flash_attention_bwd.launches - before[1])
        out[dev] = (float(loss), [g.cpu() for g in tree_flatten(grads)[0]],
                    losses, step1, ran)
    (lc, gc, sc, rc, _), (lg, gg, sg, rg, ran) = out["cpu"], out["cuda"]
    assert ran == 4 * cfg.num_layers
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(gg, gc):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    np.testing.assert_allclose(sg, sc, rtol=1e-3)
    assert len(rc) == len(rg) > 0
    for (ic, kc), (ig, kg) in zip(rc, rg):
        assert torch.equal(ic, ig) and torch.equal(kc, kg)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "dbrx-132b"])
def test_moe_routing_equal_on_card_and_cpu(cuda, arch, monkeypatch):
    """Reduced MoE models from the same weights (drawn on the CPU): every
    MoE layer's routing (expert ids, kept assignments) equal on the card
    and on the CPU in the prefill and 4 greedy decode steps, the logits at
    rtol 1e-4 of their scale, the same tokens."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 70)))
    orig = moe.dispatch_indices
    routes = []

    def recording(idx, num_experts, capacity):
        out = orig(idx, num_experts, capacity)
        routes.append((idx.cpu(), out[2].cpu()))
        return out

    monkeypatch.setattr(moe, "dispatch_indices", recording)
    out = {}
    for dev in ("cpu", "cuda"):
        p = _tree_to(params, dev)
        cache = model.make_cache(2, 80, device=dev)
        logits, cache = model.prefill(p, {"tokens": prompts.to(dev)}, cache)
        steps, toks = [logits[:, -1]], []
        for _ in range(4):
            toks.append(serve._sample(steps[-1], 0.0, None))
            logits, cache = model.decode(p, cache,
                                         {"token": toks[-1][:, None]})
            steps.append(logits)
        out[dev] = (torch.stack(steps).cpu(), torch.stack(toks).cpu(),
                    list(routes))
        routes.clear()
    (lc, tc, rc), (lg, tg, rg) = out["cpu"], out["cuda"]
    assert len(rc) == len(rg) > 0
    for (ic, kc), (ig, kg) in zip(rc, rg):
        assert torch.equal(ic, ig) and torch.equal(kc, kg)
    assert torch.equal(tc, tg)
    torch.testing.assert_close(lg, lc, rtol=1e-4,
                               atol=1e-4 * float(lc.abs().max()))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---- sampled participation on the card ---------------------------------------


def _sampled_setup(cuda, tier, depth, *, algo="fedp2p", codec=None,
                   enrolled=24, device="cuda"):
    """A small-CNN ``SampledEngine`` (D enrolled over 12 data clients, K =
    8) on ``device`` with a fresh store of ``tier``; the params are made on
    the CPU, so every device starts from the same bits."""
    from repro_torch.config import FLConfig
    from repro_torch.configs.paper_models import PaperNetConfig
    from repro_torch.data.federated import pseudo_femnist_federated
    from repro_torch.protocols import get
    from repro_torch.protocols.engine import SampledEngine
    from repro_torch.models.paper_nets import init_paper_net
    net = PaperNetConfig(name="cnn-small", kind="cnn", image_size=28,
                         channels=1, hidden=8, num_classes=10)
    data = pseudo_femnist_federated(12, per_client=20, num_classes=10, seed=1)
    fl = FLConfig(num_clients=12, num_clusters=2, devices_per_cluster=4,
                  participation=8, local_epochs=2, lr=0.05,
                  straggler_rate=0.25, num_enrolled=enrolled,
                  participants_per_round=8)
    data_dev = {k: torch.as_tensor(getattr(data, k)) for k in
                ("x", "y", "mask", "test_x", "test_y", "test_mask")}
    data_dev["counts"] = torch.as_tensor(data.counts, dtype=torch.float32)
    se = SampledEngine(net, data_dev, fl, get(algo), codec=codec,
                       pipeline_depth=depth, device=device)
    params = init_paper_net(torch.Generator().manual_seed(0), net)
    se.init_store({k: v.to(device) for k, v in params.items()}, tier=tier)
    return se


def _sampled_state(se):
    st = se.store
    out = {"last_round": torch.from_numpy(st.last_round.copy())}
    if st.resident_flat() is not None:
        out["flat"] = st.flat.cpu()
        if st._residual is not None:
            out["residual"] = st._residual.cpu()
    else:
        for c, r in st._overlay.items():
            out[f"row{c}"] = torch.from_numpy(r.copy())
        for c, r in st._residual_overlay.items():
            out[f"res{c}"] = torch.from_numpy(r.copy())
    return out


def _assert_same_state(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_memory_store_scatter_in_place_on_card(cuda):
    """The resident tier's ``index_copy_`` scatter and ``index_select``
    gather on the card against the CPU, bit for bit; the state buffer is
    written in place."""
    from repro_torch.protocols import MemoryStore
    flat = torch.randn((1000, 4099), generator=torch.Generator().manual_seed(
        1))
    rows = torch.randn((100, 4099), generator=torch.Generator().manual_seed(
        2))
    ids = torch.randperm(1000, generator=torch.Generator().manual_seed(3)
                         )[:100].numpy()
    cpu, card = MemoryStore(flat.clone()), MemoryStore(flat.cuda())
    ptr = card.flat.data_ptr()
    for st, r in ((cpu, rows), (card, rows.cuda())):
        st.scatter(ids, r)
    assert card.flat.data_ptr() == ptr
    assert torch.equal(card.flat.cpu(), cpu.flat)
    back = ids[::-1].copy()
    assert torch.equal(card.gather(back).cpu(), cpu.gather(back))


@pytest.mark.parametrize("tier", ["memory", "checkpoint"])
def test_sampled_pipeline_matches_serial_on_card(cuda, tier, monkeypatch):
    """Pipelined rounds at depths 2 and 3 on the card (stage A on its own
    stream, the cold tier's pinned copies and fetch stream) equal the
    serial loop bit for bit, with cuDNN's algorithms pinned: rows,
    losses, staleness; fedp2p and the topk wire's residuals."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    for algo, codec in (("fedp2p", None), ("gossip", "topk")):
        ref = None
        for depth in (1, 2, 3):
            se = _sampled_setup(cuda, tier, depth, algo=algo, codec=codec)
            gen = torch.Generator(device="cuda").manual_seed(5)
            m = se.run_rounds(gen, 5)
            state = _sampled_state(se)
            state["loss"] = torch.from_numpy(m["train_loss"])
            if ref is None:
                ref = state
            else:
                _assert_same_state(state, ref)
            se.store.close()


def test_sampled_round_matches_cpu(cuda, monkeypatch):
    """One draw set through the card and through the CPU: the stored rows
    at the FL reference tolerance; with cuDNN pinned, the cold tier's
    round (pinned buffers, non-blocking copies) equals the memory tier's
    on the card bit for bit."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cpu = _sampled_setup(None, "memory", 1, device="cpu")
    draws = [cpu.draw_round(torch.Generator().manual_seed(4))
             for _ in range(2)]
    m_cpu = cpu.run_rounds(None, 2, draws=draws)
    outs = {}
    for tier in ("memory", "checkpoint"):
        se = _sampled_setup(cuda, tier, 1)
        outs[tier] = (se.run_rounds(None, 2, draws=draws)["train_loss"],
                      se.store.gather(np.arange(24)).cpu())
    np.testing.assert_array_equal(outs["memory"][0], outs["checkpoint"][0])
    assert torch.equal(outs["memory"][1], outs["checkpoint"][1])
    np.testing.assert_allclose(outs["memory"][0], m_cpu["train_loss"],
                               rtol=1e-4, atol=1e-6)
    want = cpu.store.gather(np.arange(24))
    # the card-vs-CPU rule of the MoE logits above: rtol 1e-4 and an atol
    # of 1e-4 of the largest |value| (cuDNN and the CPU sum the
    # convolutions in other orders over 16 SGD steps)
    torch.testing.assert_close(outs["memory"][1], want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


def test_cold_gather_and_scatter_through_pinned_buffers(cuda):
    """The cold tier's window goes to the card from a pinned buffer with a
    non-blocking copy, and back through a pinned buffer whose event the
    scatter waits on; the fetch thread's copy is on the store's stream and
    the reader's stream waits on its event."""
    from repro_torch.protocols import CheckpointStore
    base = torch.randn((5000,), generator=torch.Generator().manual_seed(0))
    st = CheckpointStore(base.cuda(), 1000, device="cuda")
    rows = torch.randn((64, 5000), device="cuda")
    ids = np.arange(64) * 7
    st.scatter(ids, rows * 2)            # a card tensor: pinned copy + event
    got = st.gather(ids)
    assert got.is_cuda and torch.equal(got, rows * 2)
    h = st.prefetch(np.concatenate([ids[:8], [1, 2]]))
    win = h.result()
    assert torch.equal(win[:8], rows[:8] * 2)
    assert torch.equal(win[8:].cpu(), base.expand(2, -1))
    st.close()
