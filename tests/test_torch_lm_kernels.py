"""The plain versions of the port's LM kernels (what CPU tensors take)
against the JAX package: the Pallas kernels in interpret mode, their jnp
oracles and the model's own attention and chunked SSD.

* ``flash_attention``: the sweep of ``tests/test_kernels.py`` (three
  shapes, window 0 and 96, f32 and bf16) against the Pallas kernel and
  ``repro.kernels.ref.flash_attention_ref`` at 3e-4 (f32) / 3e-2 (bf16),
  as that file holds the Pallas kernel; a ragged S the Pallas wrapper
  cannot take; the meta-token term against the model's
  ``_direct_attention`` (rtol 1e-5: both are one dense softmax in f32).
* ``ssd_scan``: the sweep of ``tests/test_kernels.py`` against the Pallas
  kernel and the naive recurrence at rtol 2e-3 / atol 2e-4; with an
  initial state and at small chunks against the model's ``ssd_chunked``
  at rtol 1e-5 / atol 1e-6 (the same chunked algorithm).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jssd  # noqa: E402
from repro.models.attention import _direct_attention  # noqa: E402
from repro.models.ssm import ssd_chunked as jssd_chunked  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _qkv(b, hq, hkv, s, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, s, hd)) * 0.5).astype(np.float32)
            .astype(dtype) for h in (hq, hkv, hkv)]


def _ssd_inputs(b, s, h, p, n, seed=42):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("b,hq,hkv,s,hd,bq,bk", [
    (2, 4, 2, 256, 64, 128, 128),
    (1, 2, 1, 512, 128, 256, 128),     # MQA
    (2, 3, 3, 128, 32, 64, 64),        # MHA odd heads
    # hd 128 at GQA groups 6, 7 and 8 (the dense models' 48/8, 56/8, 64/8)
    (1, 6, 1, 128, 128, 64, 64),
    (1, 7, 1, 192, 128, 64, 64),
    (1, 16, 2, 128, 128, 64, 64),
])
@pytest.mark.parametrize("window", [0, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas(b, hq, hkv, s, hd, bq, bk, window,
                                    dtype):
    jdt = jnp.dtype(dtype)
    q, k, v = _qkv(b, hq, hkv, s, hd, jdt)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  window=window, bq=bq, bk=bk, interpret=True)
    oracle = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), window=window)
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=window)
    assert got.dtype == _t(q).dtype and got.shape == (b, hq, s, hd)
    tol = 3e-4 if dtype == "float32" else 3e-2
    for expect in (want, oracle):
        np.testing.assert_allclose(_np(got), np.asarray(expect, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("s,window", [(200, 0), (200, 64), (1, 0)])
def test_flash_plain_ragged_matches_oracle(s, window):
    """S with no block size the Pallas wrapper accepts for bq = 64."""
    q, k, v = _qkv(2, 4, 2, s, 64, np.float32, seed=1)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), window=window)
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


@pytest.mark.parametrize("s,window,num_meta", [(90, 64, 8), (150, 32, 16),
                                               (90, 0, 8), (40, 64, 8)])
def test_flash_plain_meta_matches_direct_attention(s, window, num_meta):
    """The meta-token term: keys < num_meta stay visible past the window,
    as the model's mask_block keeps them."""
    b, hk, g, hd = 2, 2, 3, 32
    q, k, v = _qkv(b, hk * g, hk, s, hd, np.float32, seed=2)
    pos = jnp.arange(s)
    # the model's layout: q [B,S,Hk,G,hd], k/v [B,S,Hk,hd]
    jq = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(b, s, hk, g, hd)
    want = _direct_attention(jq, jnp.asarray(k).transpose(0, 2, 1, 3),
                             jnp.asarray(v).transpose(0, 2, 1, 3), pos, pos,
                             window, num_meta)
    want = np.asarray(want).reshape(b, s, hk * g, hd).transpose(0, 2, 1, 3)
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=window,
                              num_meta=num_meta)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hk,g,s,window,num_meta", [
    (1, 6, 130, 64, 8), (1, 7, 90, 0, 8), (2, 8, 150, 48, 16),
])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_flash_plain_meta_gqa128_matches_direct_attention(hk, g, s, window,
                                                          num_meta, dtype):
    """The meta-token term at head_dim 128 and GQA groups 6, 7 and 8, with
    and without a window, f32 and bf16 (the model's direct attention on
    the same bf16 values in f32)."""
    b, hd = 1, 128
    jdt = jnp.dtype(dtype)
    q, k, v = _qkv(b, hk * g, hk, s, hd, jdt, seed=3)
    pos = jnp.arange(s)
    f32 = [jnp.asarray(a).astype(jnp.float32) for a in (q, k, v)]
    jq = f32[0].transpose(0, 2, 1, 3).reshape(b, s, hk, g, hd)
    want = _direct_attention(jq, f32[1].transpose(0, 2, 1, 3),
                             f32[2].transpose(0, 2, 1, 3), pos, pos,
                             window, num_meta)
    want = np.asarray(want).reshape(b, s, hk * g, hd).transpose(0, 2, 1, 3)
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=window,
                              num_meta=num_meta)
    assert got.dtype == _t(q).dtype
    tol = (1e-5, 1e-6) if jdt == jnp.float32 else (3e-2, 3e-2)
    np.testing.assert_allclose(_np(got), want, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 128, 3, 16, 32, 32),
    (1, 256, 2, 64, 128, 64),
    (2, 64, 1, 8, 16, 16),
])
def test_ssd_plain_matches_pallas(b, s, h, p, n, chunk):
    x, dt, A, B, C = _ssd_inputs(b, s, h, p, n)
    jargs = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    y_pl, st_pl = jssd(*jargs, chunk=chunk, interpret=True)
    y_ref, st_ref = jref.ssd_scan_ref(*jargs)
    y, st = ops.ssd_scan(*[_t(a) for a in (x, dt, A, B, C)], chunk=chunk)
    assert y.dtype == torch.float32 and st.shape == (b, h, p, n)
    for yw, sw in ((y_pl, st_pl), (y_ref, st_ref)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yw), rtol=2e-3,
                                   atol=2e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(sw), rtol=2e-3,
                                   atol=2e-4)
    # the port's own naive recurrence, the same ground truth
    y_n, st_n = ref.ssd_scan_ref(*[_t(a) for a in (x, dt, A, B, C)])
    np.testing.assert_allclose(y_n.numpy(), np.asarray(y_ref), rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(st_n.numpy(), np.asarray(st_ref), rtol=2e-3,
                               atol=2e-4)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 96, 2, 16, 24, 32), (1, 100, 3, 8, 16, 20), (2, 78, 4, 16, 16, 26),
    (1, 7, 2, 5, 3, 7)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_plain_matches_chunked(b, s, h, p, n, chunk, with_state):
    x, dt, A, B, C = _ssd_inputs(b, s, h, p, n, seed=7)
    init = (np.random.default_rng(3).standard_normal((b, h, p, n))
            .astype(np.float32) if with_state else None)
    y_w, st_w = jssd_chunked(*[jnp.asarray(a) for a in (x, dt, A, B, C)],
                             chunk, initial_state=None if init is None
                             else jnp.asarray(init))
    y, st = ops.ssd_scan(*[_t(a) for a in (x, dt, A, B, C)], chunk=chunk,
                         initial_state=None if init is None else _t(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_w), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_w), rtol=1e-5,
                               atol=1e-6)


def test_cpu_tensors_take_the_plain_versions():
    """The device rule: CPU tensors never launch a kernel."""
    n_fa, n_ssd = ops.flash_attention.launches, ops.ssd_scan.launches
    q, k, v = (_t(a) for a in _qkv(1, 2, 1, 9, 16, np.float32))
    ops.flash_attention(q, k, v, window=4, num_meta=2)
    x, dt, A, B, C = (_t(a) for a in _ssd_inputs(1, 8, 2, 4, 3))
    ops.ssd_scan(x, dt, A, B, C, chunk=4)
    assert ops.flash_attention.launches == n_fa
    assert ops.ssd_scan.launches == n_ssd


def test_lm_kernel_guards():
    q, k, v = (_t(a) for a in _qkv(1, 3, 2, 9, 16, np.float32))
    with pytest.raises(ValueError, match="not a multiple"):
        ops.flash_attention(q, k, v)
    q, k, v = (_t(a) for a in _qkv(1, 2, 1, 9, 16, np.float32))
    with pytest.raises(ValueError, match="one dtype"):
        ops.flash_attention(q, k.double(), v)
    x, dt, A, B, C = (_t(a) for a in _ssd_inputs(1, 8, 2, 4, 3))
    with pytest.raises(ValueError, match="must divide"):
        ops.ssd_scan(x, dt, A, B, C, chunk=3)
    with pytest.raises(ValueError, match="initial_state"):
        ops.ssd_scan(x, dt, A, B, C, chunk=4,
                     initial_state=torch.zeros(1, 2, 4, 4))
