"""Non-finite inputs through the LM kernels' reference: the JAX package's
Pallas kernels (interpret mode) and the port's CPU path
(``ops.flash_attention``, ``ops.ssd_scan``) on the same seeded numpy
inputs with an inf or a NaN placed where the card's kernels skip work and
where they do not. NaN, +inf and -inf must sit at the same places in both;
the finite outputs hold the f32 tolerances of ``test_torch_lm_kernels.py``
(flash 3e-4; the SSD rtol 2e-3 / atol 2e-4). These are the semantics the
card's kernels are held to (``tests/test_torch_cuda.py``).

* ``flash_attention``: the Pallas kernel visits every key tile, and a
  masked key has p = 0, so an inf or NaN in V at a key masked for a row
  makes that row NaN in its column (0 · inf). Masked scores are replaced
  by -1e30, so a non-finite K at a masked key does not propagate; a
  non-finite Q or K at a visible one makes the row's scores inf or NaN.
  Keys in the last tile (above every earlier query tile's diagonal), in
  the first tiles (outside a window), and inside the diagonal tile.
  The meta-token term against the model's dense ``_direct_attention``.
* ``ssd_scan``: the Pallas kernel takes the whole chunk, with the decay
  mask 0 above the diagonal, so an inf or NaN in x, dt, B or C at row 100
  of a 128-row chunk makes rows 0-99 NaN (row 30: rows 0-29); the state
  carries it into the later chunks. Hymba's SSM shape (p 64, n 16, chunk
  128) and mamba2-130m's (p 64, n 128, chunk 256), heads and batch cut.
  XLA flushes subnormal results to 0 on the CPU (as the TPU does), so a
  decay exp(a) below FLT_MIN is 0 there and an inf state times it is NaN;
  the port's SSD flushes its decays alike (``ref._exp_ftz``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jssd  # noqa: E402
from repro.models.attention import _direct_attention  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

INF, NAN = float("inf"), float("nan")


def assert_same_non_finite(got, want, rtol, atol):
    """NaN, +inf and -inf at the same places; the rest within tolerance."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert not np.isfinite(want).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def _qkv(b, hq, hkv, s, hd, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, s, hd)) * 0.5).astype(np.float32)
            for h in (hq, hkv, hkv)]


# (tensor, position, value): position is (b, kv or q head, row, column).
# S = 256 in 64-key tiles: key 255 lies above the diagonal of query tiles
# 0-2, key 5 outside a 96-window of rows >= 101 and inside the diagonal
# tile of query tile 0, key 70 inside tile 1.
FLASH_CASES = [
    ("v", (0, 1, 255, 3), INF), ("v", (0, 0, 255, 7), NAN),
    ("v", (0, 0, 5, 11), -INF), ("v", (0, 1, 70, 13), NAN),
    ("k", (0, 0, 200, 2), INF), ("k", (0, 1, 5, 9), NAN),
    ("q", (0, 2, 150, 4), INF), ("q", (0, 3, 40, 6), NAN),
]


@pytest.mark.parametrize("window", [0, 96])
@pytest.mark.parametrize("case", range(len(FLASH_CASES)))
def test_flash_non_finite_matches_pallas(case, window):
    name, pos, val = FLASH_CASES[case]
    q, k, v = _qkv(1, 4, 2, 256, 32, seed=10 + case)
    {"q": q, "k": k, "v": v}[name][pos] = val
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  window=window, bq=64, bk=64, interpret=True)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window)
    assert_same_non_finite(got.numpy(), want, 3e-4, 3e-4)
    if name == "v":      # every row the key is masked for: NaN in its column
        b, hk, key, e = pos
        rows = np.arange(256)
        masked = key > rows
        if window:
            masked |= rows - key >= window
        for h in (2 * hk, 2 * hk + 1):
            assert np.isnan(np.asarray(got[b, h, masked, e])).all()


@pytest.mark.parametrize("case", [0, 1, 2, 3, 4, 6])
def test_flash_non_finite_meta_matches_direct_attention(case):
    """With meta tokens (keys < 16 stay visible past the window of 64):
    the model's dense attention gives the same NaN and inf."""
    name, pos, val = FLASH_CASES[case]
    b, hk, g, s, hd, window, meta = 1, 2, 2, 256, 32, 64, 16
    q, k, v = _qkv(b, hk * g, hk, s, hd, seed=30 + case)
    {"q": q, "k": k, "v": v}[name][pos] = val
    p = jnp.arange(s)
    jq = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(b, s, hk, g, hd)
    want = _direct_attention(jq, jnp.asarray(k).transpose(0, 2, 1, 3),
                             jnp.asarray(v).transpose(0, 2, 1, 3), p, p,
                             window, meta)
    want = np.asarray(want).reshape(b, s, hk * g, hd).transpose(0, 2, 1, 3)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window,
                              num_meta=meta)
    assert_same_non_finite(got.numpy(), want, 1e-5, 1e-6)


def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    return x, dt, A, B, C


# (b, S, h, p, n, chunk): Hymba's SSM heads and mamba2-130m's, cut in
# heads, batch and length
SSD_SHAPES = {"hymba": (1, 256, 2, 64, 16, 128),
              "mamba2": (1, 512, 2, 64, 128, 256)}


@pytest.mark.parametrize("shape", sorted(SSD_SHAPES))
@pytest.mark.parametrize("name", ["x", "dt", "B", "C"])
@pytest.mark.parametrize("row", [100, 30])
@pytest.mark.parametrize("val", [INF, NAN])
def test_ssd_non_finite_matches_pallas(shape, name, row, val):
    b, s, h, p, n, chunk = SSD_SHAPES[shape]
    x, dt, A, B, C = _ssd_inputs(b, s, h, p, n, seed=row)
    col = {"x": (0, row, 1, 3), "dt": (0, row, 1), "B": (0, row, 5),
           "C": (0, row, 5)}[name]
    {"x": x, "dt": dt, "B": B, "C": C}[name][col] = val
    y_pl, st_pl = jssd(*[jnp.asarray(a) for a in (x, dt, A, B, C)],
                       chunk=chunk, interpret=True)
    y, st = ops.ssd_scan(*[torch.from_numpy(a) for a in (x, dt, A, B, C)],
                         chunk=chunk)
    assert_same_non_finite(y.numpy(), y_pl, 2e-3, 2e-4)
    if name != "C":      # C only reads the state; it never enters it
        assert_same_non_finite(st.numpy(), st_pl, 2e-3, 2e-4)
    # x, dt, B: every earlier row of the chunk is NaN (in x's column and
    # head, dt's head, B's every head); C: its own row, in every head
    y = y.numpy()
    if name == "x":
        assert np.isnan(y[0, :row, 1, 3]).all()
    elif name == "dt":
        assert np.isnan(y[0, :row, 1]).all()
    elif name == "B":
        assert np.isnan(y[0, :row]).all()
    else:
        assert np.isnan(y[0, row]).all()
