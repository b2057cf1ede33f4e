"""CPU rehearsal of the split-f32 (3xTF32) arithmetic of the port's
tensor-core kernels (``kernels/csrc/tf32x3.cuh``, used by ``fed_mix.cu``,
``fed_mix_q.cu``, ``flash_attention.cu`` and ``ssd_scan.cu``).

An f32 operand a is split as hi = tf32(a), rounded to nearest with ties
away from zero (the rounding of ``cvt.rna.tf32.f32``), and lo = a - hi,
of which the tensor cores read the top 11 significant bits (the low 13
bits are dropped: truncation). A product is taken as lo·hi + hi·lo +
hi·hi, accumulated in f32. A bf16 or int8 operand is exact in TF32
(lo = 0), so its products take fewer terms. Here the split is emulated in
plain PyTorch with int32 bit operations, and the products of the TF32
parts (exact in f32: 11 x 11 significant bits) are summed by CPU f32
matmuls.

Non-finite values: the full split (``split()``) gives hi = 0, lo = a for
an inf or NaN, and truncates a value whose rounding would carry into the
all-ones exponent; the products then follow IEEE. The fast split
(``split_fast()``, the kernels' hot path) gives such a value an inf or
NaN part, so its products are never silently finite, and the kernels
take that tile again with the full split.

What is NOT emulated: the tensor cores' own accumulation inside an
``mma.sync`` (its order and internal rounding of the f32 sum). These tests
show that the split itself loses far less than the card tolerances allow
(f32 1e-5 for ``fed_mix``, 2e-5 for ``flash_attention``); whether the
tensor cores' accumulation keeps it so is checked on the card only
(``tests/test_torch_cuda.py``).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

F32 = torch.float32
HALF_ULP = 0x1000      # half a TF32 ulp in the f32 bits (bit 12)
DROPPED = 0x1FFF       # the 13 low mantissa bits TF32 drops


ROUND_MAX = 0x7F7FF000  # the least magnitude whose rounding would carry
FLT_MAX = torch.finfo(F32).max


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero: add half an ulp to the magnitude bits, clear the dropped bits. A
    magnitude of ROUND_MAX or more (and a NaN) is truncated instead, as
    ``to_tf32`` does."""
    bits = x.contiguous().view(torch.int32)
    carry = (bits & 0x7FFFFFFF) >= ROUND_MAX
    return (torch.where(carry, bits, bits + HALF_ULP) & ~DROPPED).view(F32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an f32 operand: the low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & ~DROPPED).view(F32)


def split(x: torch.Tensor):
    """``split_fast``, for the values it takes (|x| < ROUND_MAX): hi
    rounded, lo = x - hi as the tensor cores read it."""
    hi = tf32_round(x)
    return hi, tf32_trunc(x - hi)


def split_fast_bits(x: torch.Tensor):
    """``split_fast`` bit for bit, for any x: the rounding's carry may run
    into the exponent (or, for a NaN, the sign); int32 arithmetic wraps as
    the card's does."""
    hi = ((x.contiguous().view(torch.int32) + HALF_ULP) & ~DROPPED).view(F32)
    return hi, tf32_trunc(x - hi)


def split_full(x: torch.Tensor):
    """``split``: an inf or NaN gives hi = 0, lo = x."""
    hi, lo = split(x)
    finite = torch.isfinite(x)
    return (torch.where(finite, hi, torch.zeros_like(x)),
            torch.where(finite, lo, x))


def mm3(a: torch.Tensor, b: torch.Tensor, b_exact: bool = False):
    """a @ b as the kernels take it: lo·hi + hi·lo + hi·hi in f32 (two
    terms when b is exact in TF32)."""
    ah, al = split(a)
    if b_exact:
        return al @ b + ah @ b
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def _spread(n, seed):
    """f32 values over 20 binary orders of magnitude, both signs."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * np.exp2(rng.integers(-10, 10, n))
    return torch.from_numpy(x.astype(np.float32))


def test_split_keeps_ten_mantissa_bits_and_a_to_2_pow_minus_21():
    a = _spread(200_000, 0)
    hi, lo = split(a)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & DROPPED).any())
    err = (hi.double() + lo.double() - a.double()).abs()
    assert bool((err <= 2.0 ** -21 * a.double().abs()).all())
    # hi alone is within half a TF32 ulp (2^-11 relative)
    assert bool(((hi.double() - a.double()).abs()
                 <= 2.0 ** -11 * a.double().abs()).all())


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_tf32_round_ties_away_from_zero(sign):
    # 1 + 2^-11 lies halfway between the TF32 neighbours 1 and 1 + 2^-10;
    # 1 + 2^-11 + 2^-23 lies above the half, 1 + 2^-11 - 2^-23 below it
    x = torch.tensor([1 + 2.0 ** -11, 1 + 2.0 ** -11 + 2.0 ** -23,
                      1 + 2.0 ** -11 - 2.0 ** -23, 1 + 3 * 2.0 ** -11],
                     dtype=torch.float64) * sign
    got = tf32_round(x.to(F32)).double()
    want = torch.tensor([1 + 2.0 ** -10, 1 + 2.0 ** -10, 1.0,
                         1 + 2.0 ** -9], dtype=torch.float64) * sign
    assert torch.equal(got, want)


def test_bf16_is_exact_in_tf32():
    x = _spread(10_000, 1).to(torch.bfloat16).to(F32)
    hi, lo = split(x)
    assert torch.equal(hi, x) and not bool(lo.any())


def _mix_inputs(d, p, seed):
    rng = np.random.default_rng(seed)
    mn = rng.uniform(0, 1, (d, d))
    mo = rng.uniform(0, 1, (d, d))
    tot = (mn + mo).sum(axis=1, keepdims=True)
    return [torch.from_numpy(a.astype(np.float32)) for a in
            (mn / tot, mo / tot, rng.normal(size=(d, p)),
             rng.normal(size=(d, p)))]


def test_three_product_fed_mix_against_float64():
    """The main path's mix at D = 100 (the kernel's [M_new | M_old] @
    [X_new ; X_old] over K = 200) with P = 4099: the split products land
    within 1e-6 of float64, a tenth of the card tolerance (1e-5)."""
    mn, mo, xn, xo = _mix_inputs(100, 4099, 2)
    m = torch.cat([mn, mo], 1)
    x = torch.cat([xn, xo], 0)
    got = mm3(m, x)
    want = m.double() @ x.double()
    err = (got.double() - want).abs()
    assert float(err.max()) < 1e-6
    assert bool((err <= 1e-6 + 1e-6 * want.abs()).all())
    # and the card test's comparison: against the plain f32 version
    plain = ref.fed_mix_ref(mn, mo, xn, xo)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    # one TF32 pass (what the f32 parity rule bans) misses it by far
    one = tf32_round(m) @ tf32_round(x)
    assert float((one.double() - want).abs().max()) > 1e-4


def test_two_product_fed_mix_bf16_against_float64():
    mn, mo, xn, xo = _mix_inputs(100, 1031, 3)
    m = torch.cat([mn, mo], 1)
    x = torch.cat([xn, xo], 0).to(torch.bfloat16).to(F32)
    got = mm3(m, x, b_exact=True)
    want = m.double() @ x.double()
    assert float((got.double() - want).abs().max()) < 1e-6


def _attention_tile(q, k, v, q0, window, num_meta, tile=64, mm=mm3):
    """One 64-row query tile as flash_attention.cu computes it, in f32:
    split products (``mm``) for S = Q·Kᵀ and O += P·V, the online softmax
    over 64-key tiles with the finite -1e30 mask, expf, the 1e-30 floor."""
    rows, hd = q.shape
    scale = hd ** -0.5
    qi = torch.arange(q0, q0 + rows)[:, None]
    m = torch.full((rows, 1), -1e30)
    l = torch.zeros(rows, 1)
    acc = torch.zeros(rows, v.shape[1])
    for k0 in range(0, min(k.shape[0], q0 + rows), tile):
        kj = torch.arange(k0, k0 + tile)[None, :]
        if window > 0 and k0 >= num_meta and q0 - (k0 + tile - 1) >= window:
            continue
        s = mm(q, k[k0:k0 + tile].T.contiguous())
        vis = (kj <= qi) & ((window <= 0) | (qi - kj < window)
                            | (kj < num_meta))
        s = torch.where(vis, s * scale, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.max(1, keepdim=True).values)
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(1, keepdim=True)
        acc = acc * corr + mm(p, v[k0:k0 + tile])
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)


def split_trunc(x: torch.Tensor):
    """The wgmma kernel's fast split (``flash_fwd_kernel_wgmma``): hi the
    f32 truncated to the bits the tensor cores read, lo = x - hi (exact in
    f32) as they read it."""
    hi = tf32_trunc(x)
    return hi, tf32_trunc(x - hi)


def mm3_k8(a: torch.Tensor, b: torch.Tensor):
    """a @ b as flash_fwd_kernel_wgmma accumulates it: k8 step by k8 step
    over the inner dimension (hd's chunks in order for Q·Kᵀ, a key tile's
    keys for P·V), three products a step (lo·hi, hi·lo, hi·hi) into one f32
    accumulator, on the truncating split."""
    ah, al = split_trunc(a)
    bh, bl = split_trunc(b)
    out = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        out = out + al[:, k] @ bh[k]
        out = out + ah[:, k] @ bl[k]
        out = out + ah[:, k] @ bh[k]
    return out


@pytest.mark.parametrize("q0,hd,vd,window,meta,wgmma", [
    pytest.param(1984, 64, 64, 1024, 128, False, id="1984"),
    pytest.param(1024, 64, 64, 1024, 128, False, id="1024"),
    # DeepSeek-V2's MLA prefill (q/k 192, v 128, causal) on the wgmma
    # kernel's split and order
    pytest.param(1984, 192, 128, 0, 0, True, id="mla-1984"),
    pytest.param(1024, 192, 128, 0, 0, True, id="mla-1024"),
    pytest.param(0, 192, 128, 0, 0, True, id="mla-0"),
    pytest.param(1024, 192, 128, 96, 16, True, id="mla-window"),
])
def test_split_attention_tile_against_float64(q0, hd, vd, window, meta,
                                              wgmma):
    """A Hymba-like head (hd 64, 2048 keys, window 1024, 128 meta tokens):
    the last query tile and one whose window starts mid-tile; and MLA's
    (192, 128) as flash_fwd_kernel_wgmma takes it (the truncating split,
    three products a k8 step). Within 2e-6 of float64, a tenth of the card
    tolerance (2e-5)."""
    rng = np.random.default_rng(q0)
    s = 2048
    q, k, v = [torch.from_numpy((rng.normal(size=(s, d)) * 0.5)
                                .astype(np.float32)) for d in (hd, hd, vd)]
    got = _attention_tile(q[q0:q0 + 64], k, v, q0, window, meta,
                          mm=mm3_k8 if wgmma else mm3)
    qd, kd, vd_ = q.double(), k.double(), v.double()
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    vis = (j <= i) & ((window <= 0) | ((i - j) < window) | (j < meta))
    sd = torch.where(vis, qd @ kd.T * hd ** -0.5,
                     torch.tensor(-1e30, dtype=torch.float64))
    want = (torch.softmax(sd, -1) @ vd_)[q0:q0 + 64]
    assert float((got.double() - want).abs().max()) < 2e-6
    # and the card test's comparison: against the plain f32 version
    plain = ref.flash_attention_ref(q[None, None], k[None, None],
                                    v[None, None], window=window,
                                    num_meta=meta)[0, 0, q0:q0 + 64]
    torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# non-finite values
# ---------------------------------------------------------------------------

SPECIALS = [float("inf"), float("-inf"), float("nan")]


def test_split_passes_non_finite_values_through():
    """An inf or NaN splits as hi = 0, lo = the value itself (lo meets only
    the other operand's hi, which has its sign and is zero only where it
    is)."""
    x = torch.tensor(SPECIALS, dtype=F32)
    hi, lo = split_full(x)
    assert not bool(hi.any())
    assert torch.equal(lo[:2], x[:2]) and bool(torch.isnan(lo[2]))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_split_keeps_values_near_flt_max_finite(sign):
    """FLT_MAX and the values whose rounding would carry into the all-ones
    exponent are truncated: hi and lo stay finite, and hi + lo holds the
    value to 2^-21."""
    bits = torch.tensor([ROUND_MAX, ROUND_MAX + 1, 0x7F7FFFFF, 0x7F7FE000,
                         ROUND_MAX - 1], dtype=torch.int32)
    x = bits.view(F32) * sign
    assert float(x.abs().max()) == FLT_MAX
    hi, lo = split_full(x)
    assert bool(torch.isfinite(hi).all()) and bool(torch.isfinite(lo).all())
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())


def _mm3_full(a, b):
    ah, al = split_full(a)
    bh, bl = split_full(b)
    return al @ bh + ah @ bl + ah @ bh


def test_split_products_follow_ieee_with_non_finite_values():
    """A diverged client: inf, -inf, NaN, +-FLT_MAX (and an inf beside a
    -inf) in X of a convex mix. The three split products give inf and NaN
    where the plain f32 product does, and the finite outputs hold 1e-5."""
    mn, mo, xn, _ = _mix_inputs(16, 40, 4)
    m = torch.cat([mn, mo], 1)
    x = torch.cat([xn, xn.flip(0)], 0)
    x[3, 5], x[7, 11], x[1, 17] = SPECIALS
    x[2, 23], x[5, 29] = FLT_MAX, -FLT_MAX
    x[0, 31], x[9, 31] = float("inf"), float("-inf")
    got = _mm3_full(m, x)
    want = m @ x
    assert not bool(torch.isfinite(want).all())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                               equal_nan=True)
    # the same values as the first operand (an inf weight) follow IEEE too
    got_t = _mm3_full(x.T.contiguous(), m.T.contiguous())
    torch.testing.assert_close(got_t, want.T, rtol=1e-5, atol=1e-5,
                               equal_nan=True)


@pytest.mark.parametrize("value", SPECIALS + [-FLT_MAX, FLT_MAX])
def test_fast_split_never_hides_a_non_finite_value(value):
    """split_fast on a value outside its range (an inf, a NaN, a value whose
    rounding carries) gives an inf or NaN part, so its product with any
    finite operand is inf or NaN: the kernels see it and take the tile
    again with the full split."""
    x = torch.full((8,), value, dtype=F32)
    if math.isfinite(value):
        assert (x.view(torch.int32)[0] & 0x7FFFFFFF) >= ROUND_MAX
    if value != value:  # the card's canonical NaN, whose rounding wraps
        x = torch.full((8,), 0x7FFFFFFF, dtype=torch.int32).view(F32)
    hi, lo = split_fast_bits(x)
    assert not bool((torch.isfinite(hi) & torch.isfinite(lo)).all())
    w = torch.full((1, 8), 0.125, dtype=F32)
    wh, wl = split(w)
    prod = wl @ hi[:, None] + wh @ lo[:, None] + wh @ hi[:, None]
    assert not bool(torch.isfinite(prod).any())
