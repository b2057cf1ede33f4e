"""Gradients of the plain versions of the port's LM kernels (what CPU tensors
differentiate through) against the JAX package's gradients:

* ``flash_attention``: the plain version's autograd against JAX's custom
  VJP ``blocked_attention`` (the FlashAttention-2 backward in jnp that the
  card's ``flash_attention_bwd`` kernel follows) and against autodiff of
  ``_direct_attention``, with a window, meta tokens and GQA, and at
  gemma-2b's hd = vd = 256 with MQA (what ``flash_attention_bwd``'s 256
  instantiation computes on the card); rtol 1e-4 and 1e-4 of each
  gradient's largest |value| (f32 sums in other orders);
* ``ssd_scan``: the plain version's autograd (``ref.ssd_chunked``, whose
  flushed exp is out of place, so that autograd can go through it) against
  ``jax.grad`` of the JAX package's ``ssd_chunked``, with and without an
  initial state, the final state's cotangent included; the same
  tolerance;
* the repair itself: backpropagating through ``ops.ssd_scan`` on CPU
  tensors works (an in-place flush made autograd raise), and the flush
  gives the same forward bits as the in-place one did.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import (  # noqa: E402
    _direct_attention, blocked_attention,
)
from repro.models.ssm import ssd_chunked as jssd_chunked  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RTOL = 1e-4


def _close(got, want, what):
    want = np.asarray(want)
    atol = RTOL * max(1e-6, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=atol, err_msg=what)


def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return ((rng.standard_normal((b, s, h, p)) * 0.5).astype(f),
            np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f),
            (-np.exp(rng.standard_normal(h) * 0.3)).astype(f),
            (rng.standard_normal((b, s, n)) * 0.5).astype(f),
            (rng.standard_normal((b, s, n)) * 0.5).astype(f))


def test_ssd_scan_backpropagates_on_the_cpu():
    """The repaired flush: ``ops.ssd_scan`` on CPU tensors that need a
    gradient runs forward and backward (the in-place flush raised
    "modified by an inplace operation" here), and every gradient is
    finite."""
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in _ssd_inputs(2, 64, 3, 8, 4, 0)]
    init = torch.randn(2, 3, 8, 4, requires_grad=True)
    y, final = ops.ssd_scan(*args, chunk=16, initial_state=init)
    (y.square().sum() + final.sum()).backward()
    for t in args + [init]:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())


def test_exp_ftz_keeps_the_forward_bits():
    """The out-of-place flush gives what the in-place one gave: subnormal
    results 0, NaN kept, everything else exp's own bits."""
    z = torch.tensor([0.0, -1.0, -87.0, -88.0, -100.0, -104.0, -200.0,
                      float("-inf"), float("nan"), 3.0, float("inf")])
    e = torch.exp(z)
    want = e.clone().masked_fill_(e < torch.finfo(e.dtype).tiny, 0.0)
    got = ref._exp_ftz(z)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert torch.equal(got[fin], want[fin])


def _attention_inputs(b, hq, hkv, s, hd, seed):
    rng = np.random.default_rng(seed)
    q, k, v = [(rng.standard_normal((b, s, h, hd)) * 0.5).astype(np.float32)
               for h in (hq, hkv, hkv)]
    do = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    return q, k, v, do


def _port_grads(q, k, v, do, window, num_meta):
    """The port's layout: [B, S, H, hd] arrays viewed as [B, H, S, hd]."""
    qt, kt, vt = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                              vt.transpose(1, 2), window=window,
                              num_meta=num_meta)
    out.transpose(1, 2).backward(torch.from_numpy(do))
    return out.transpose(1, 2), qt.grad, kt.grad, vt.grad


@pytest.mark.parametrize("b,hq,hkv,s,hd,window,num_meta", [
    (2, 4, 2, 96, 16, 0, 0),
    (2, 4, 2, 96, 16, 24, 8),        # window + pinned meta tokens, GQA
    (1, 3, 1, 80, 32, 32, 0),        # MQA with a window
    (2, 2, 2, 64, 8, 16, 4),         # MHA
    (1, 8, 1, 64, 256, 0, 0),        # gemma-2b's hd = vd = 256, MQA 8/1
    (2, 4, 1, 48, 256, 16, 4),       # hd 256, MQA with a window and meta
    # hd 128 at GQA groups 6, 7 and 8, with and without a window and meta
    (1, 6, 1, 64, 128, 0, 0),
    (1, 7, 1, 72, 128, 24, 8),
    (1, 16, 2, 64, 128, 16, 4),
    (1, 6, 1, 50, 100, 0, 0),        # hd 100 (the kernel pads it to 128)
])
def test_flash_plain_grads_match_jax(b, hq, hkv, s, hd, window, num_meta):
    q, k, v, do = _attention_inputs(b, hq, hkv, s, hd, seed=s + hd)
    g = hq // hkv
    pos = jnp.arange(s, dtype=jnp.int32)
    out, dq, dk, dv = _port_grads(q, k, v, do, window, num_meta)
    jq = jnp.asarray(q).reshape(b, s, hkv, g, hd)
    jdo = jnp.asarray(do).reshape(b, s, hkv, g, hd)
    for name, fn in (
            ("blocked_attention (custom VJP)",
             lambda q_, k_, v_: blocked_attention(q_, k_, v_, pos, pos,
                                                  window, num_meta,
                                                  q_block=32, k_block=16)),
            ("_direct_attention (autodiff)",
             lambda q_, k_, v_: _direct_attention(q_, k_, v_, pos, pos,
                                                  window, num_meta))):
        jout, vjp = jax.vjp(fn, jq, jnp.asarray(k), jnp.asarray(v))
        jdq, jdk, jdv = vjp(jdo)
        _close(out, np.asarray(jout).reshape(b, s, hq, hd), f"{name}: out")
        _close(dq, np.asarray(jdq).reshape(b, s, hq, hd), f"{name}: dq")
        _close(dk, jdk, f"{name}: dk")
        _close(dv, jdv, f"{name}: dv")


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 3, 8, 4, 16),
    (1, 96, 2, 16, 8, 32),
    (2, 60, 2, 4, 6, 20),
])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_plain_grads_match_jax(b, s, h, p, n, chunk, with_state):
    x, dt, A, B, C = _ssd_inputs(b, s, h, p, n, seed=s + n)
    rng = np.random.default_rng(7)
    init = (rng.standard_normal((b, h, p, n)).astype(np.float32)
            if with_state else None)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dfin = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def jloss(x_, dt_, A_, B_, C_, init_):
        y, fin = jssd_chunked(x_, dt_, A_, B_, C_, chunk,
                              initial_state=init_)
        return jnp.sum(y * dy) + jnp.sum(fin * dfin)

    argnums = (0, 1, 2, 3, 4) + ((5,) if with_state else ())
    jgrads = jax.grad(jloss, argnums=argnums)(
        *[jnp.asarray(a) for a in (x, dt, A, B, C)],
        None if init is None else jnp.asarray(init))

    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, dt, A, B, C)]
    tinit = (None if init is None
             else torch.from_numpy(init).requires_grad_(True))
    y, fin = ops.ssd_scan(*leaves, chunk=chunk, initial_state=tinit)
    ((y * torch.from_numpy(dy)).sum()
     + (fin * torch.from_numpy(dfin)).sum()).backward()
    got = [t.grad for t in leaves] + ([tinit.grad] if with_state else [])
    for name, gt, gj in zip(("dx", "ddt", "dA", "dB", "dC", "dinit"), got,
                            jgrads):
        _close(gt, gj, name)
