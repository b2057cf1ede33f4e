"""Non-finite inputs through the gradients of the port's plain LM kernels
(what CPU tensors differentiate through, and what the card's backward
kernels are held to) against the JAX package's own gradients:

* ``ssd_scan``: ``ops.ssd_scan`` under autograd (``ref.ssd_chunked``)
  against ``jax.grad`` of ``repro.models.ssm.ssd_chunked``. An inf, -inf
  or NaN in x, dt, B, C or dY at a row above the diagonal of a 128-row
  chunk (row 100 of the first chunk, or row 30 of the second) of a
  two-chunk input, without an initial state and with one and a final
  state's cotangent. NaN, +inf and -inf must sit at the same places in
  dx, d(dt), dA, dB, dC and d(initial state); the finite values agree at
  rtol 1e-4 and 1e-4 of the gradient's largest finite |value|.
* ``flash_attention``: ``ops.flash_attention`` under autograd
  (``ref.flash_attention_ref``) against autodiff of ``_direct_attention``
  (what the JAX model differentiates below 4096 rows), with a window,
  meta tokens and GQA, and an inf, -inf or NaN in q, k, v or dO: inside
  the window, at a meta token, and at rows that later keys are masked
  for.

XLA's CPU backend flushes every subnormal result to 0 (and reads
subnormal operands as 0), so a product such as a tiny decay times C·Bᵀ
is 0 there and an inf times it NaN. The port's plain SSD is taken under
the same arithmetic (``torch.set_flush_denormal``) for the comparison;
its own decays flush alike in any mode (``ref._exp_ftz``), and the
gradient through a flushed decay is g · 0, as XLA's is: 0 for a finite
g, NaN for an inf or NaN one.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import _direct_attention  # noqa: E402
from repro.models.ssm import ssd_chunked as jssd_chunked  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

RTOL = 1e-4
INF, NAN = float("inf"), float("nan")
VALUES = pytest.mark.parametrize("value", [INF, -INF, NAN],
                                 ids=["inf", "-inf", "nan"])


def assert_same_non_finite(got, want, what):
    """NaN, +inf and -inf at the same places; the finite values within
    rtol 1e-4 and 1e-4 of the largest finite |value|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    for name, test in (("NaN", np.isnan), ("+inf", np.isposinf),
                       ("-inf", np.isneginf)):
        np.testing.assert_array_equal(test(got), test(want),
                                      err_msg=f"{what}: {name} positions")
    fin = np.isfinite(want)
    if fin.any():
        atol = RTOL * max(1e-6, float(np.abs(want[fin]).max()))
        np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=atol,
                                   err_msg=f"{what}: finite values")


class _FlushDenormal:
    """XLA's CPU arithmetic for the port's ops: subnormals flushed."""

    def __enter__(self):
        assert torch.set_flush_denormal(True), "no flush-to-zero on this CPU"

    def __exit__(self, *exc):
        torch.set_flush_denormal(False)


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------

SSD_B, SSD_S, SSD_H, SSD_P, SSD_N, SSD_CHUNK = 1, 256, 2, 16, 8, 128
# (tensor, index without the row): x [b, S, h, p], dt [b, S, h], B and C
# [b, S, n], dY like x
SSD_SITES = {"x": (1, 3), "dt": (1,), "B": (2,), "C": (2,), "dY": (1, 3)}


def _ssd_inputs(seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    b, s, h, p, n = SSD_B, SSD_S, SSD_H, SSD_P, SSD_N
    return {"x": (rng.standard_normal((b, s, h, p)) * 0.5).astype(f),
            "dt": np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f),
            "A": (-np.exp(rng.standard_normal(h) * 0.3)).astype(f),
            "B": (rng.standard_normal((b, s, n)) * 0.5).astype(f),
            "C": (rng.standard_normal((b, s, n)) * 0.5).astype(f),
            "dY": rng.standard_normal((b, s, h, p)).astype(f),
            "init": rng.standard_normal((b, h, p, n)).astype(f),
            "dfinal": rng.standard_normal((b, h, p, n)).astype(f)}


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no_state", "state"])
@pytest.mark.parametrize("row", [100, SSD_CHUNK + 30],
                         ids=["chunk0_row100", "chunk1_row30"])
@VALUES
@pytest.mark.parametrize("tensor", list(SSD_SITES))
def test_ssd_grads_non_finite_match_jax(tensor, value, row, with_state):
    a = _ssd_inputs(seed=11)
    a[tensor][(0, row) + SSD_SITES[tensor]] = value
    names = ("x", "dt", "A", "B", "C")
    dy = a["dY"]
    dfin = a["dfinal"] if with_state else np.zeros_like(a["dfinal"])

    def jloss(x_, dt_, A_, B_, C_, init_):
        y, fin = jssd_chunked(x_, dt_, A_, B_, C_, SSD_CHUNK,
                              initial_state=init_)
        return jnp.sum(y * dy) + jnp.sum(fin * dfin)

    argnums = (0, 1, 2, 3, 4) + ((5,) if with_state else ())
    jgrads = jax.grad(jloss, argnums=argnums)(
        *[jnp.asarray(a[k]) for k in names],
        jnp.asarray(a["init"]) if with_state else None)

    leaves = [torch.from_numpy(a[k]).requires_grad_(True) for k in names]
    init = (torch.from_numpy(a["init"]).requires_grad_(True) if with_state
            else None)
    with _FlushDenormal():
        y, fin = ops.ssd_scan(*leaves, chunk=SSD_CHUNK, initial_state=init)
        ((y * torch.from_numpy(dy)).sum()
         + (fin * torch.from_numpy(dfin)).sum()).backward()
    got = [t.grad for t in leaves] + ([init.grad] if with_state else [])
    for name, gt, gj in zip(("dx", "ddt", "dA", "dB", "dC", "dinit"), got,
                            jgrads):
        assert_same_non_finite(gt.numpy(), gj, name)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

FL_B, FL_HQ, FL_HKV, FL_S, FL_HD, FL_WINDOW, FL_META = 1, 4, 2, 192, 16, 64, 8
# (tensor, (b, row, head, column)) in the [B, S, H, hd] layout: row 100 of
# a window of 64 (keys 37-100 and the 8 meta tokens visible), a meta token
# every row sees, and rows that most keys are masked for
FL_SITES = [("q", (0, 100, 1, 3)), ("q", (0, 10, 2, 1)),
            ("k", (0, 100, 1, 3)), ("k", (0, 3, 0, 5)),
            ("v", (0, 100, 1, 3)), ("v", (0, 3, 0, 5)),
            ("dO", (0, 100, 1, 3)), ("dO", (0, 20, 3, 3))]


@VALUES
@pytest.mark.parametrize("tensor,index", FL_SITES,
                         ids=[f"{t}_row{i[1]}" for t, i in FL_SITES])
def test_flash_grads_non_finite_match_jax(tensor, index, value):
    rng = np.random.default_rng(5)
    b, s, hd, g = FL_B, FL_S, FL_HD, FL_HQ // FL_HKV
    arrs = {name: (rng.standard_normal((b, s, h, hd)) * 0.5).astype(np.float32)
            for name, h in (("q", FL_HQ), ("k", FL_HKV), ("v", FL_HKV))}
    arrs["dO"] = rng.standard_normal((b, s, FL_HQ, hd)).astype(np.float32)
    arrs[tensor][index] = value
    pos = jnp.arange(s, dtype=jnp.int32)
    _, vjp = jax.vjp(
        lambda q_, k_, v_: _direct_attention(q_, k_, v_, pos, pos, FL_WINDOW,
                                             FL_META),
        jnp.asarray(arrs["q"]).reshape(b, s, FL_HKV, g, hd),
        jnp.asarray(arrs["k"]), jnp.asarray(arrs["v"]))
    jdq, jdk, jdv = vjp(jnp.asarray(arrs["dO"]).reshape(b, s, FL_HKV, g, hd))

    q, k, v = [torch.from_numpy(arrs[n]).requires_grad_(True)
               for n in ("q", "k", "v")]
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), window=FL_WINDOW,
                              num_meta=FL_META)
    out.transpose(1, 2).backward(torch.from_numpy(arrs["dO"]))
    assert_same_non_finite(q.grad.numpy(),
                           np.asarray(jdq).reshape(b, s, FL_HQ, hd), "dq")
    assert_same_non_finite(k.grad.numpy(), jdk, "dk")
    assert_same_non_finite(v.grad.numpy(), jdv, "dv")
