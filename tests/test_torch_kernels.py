"""The port's mixing kernels against the JAX package.

* ``fed_mix_segment`` / ``fed_mix`` of ``repro_torch`` (their plain
  PyTorch versions, which CPU tensors take) against the JAX jnp oracles
  over D x P x L x dtype, and against the JAX Pallas kernels in interpret
  mode on a subset of that sweep (interpret mode costs ~0.4 s a call:
  every D at P=130, and the P sweep at D=37);
  tolerances 2e-6 for f32 and 3e-2 for bf16, as tests/test_mixing_spec.py
  uses; output dtypes must match;
* the wrapper guards: bad cluster ids, mismatched x_new/x_old shapes or
  dtypes, and non-contiguous inputs raise ValueError.

The kernels themselves run only on a card: tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fed_mix import fed_mix as jax_fed_mix  # noqa: E402
from repro.kernels.fed_mix_sparse import (  # noqa: E402
    fed_mix_segment as jax_fed_mix_segment,
)
from repro_torch.kernels.fed_mix import fed_mix  # noqa: E402
from repro_torch.kernels.fed_mix_sparse import fed_mix_segment  # noqa: E402

TOL = {"float32": 2e-6, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SWEEP_D = (1, 7, 37, 100)
SWEEP_P = (1, 130, 1000)
# the oracles jitted: one compile per shape instead of one per op
segment_oracle = jax.jit(jref.fed_mix_segment_ref,
                         static_argnames=("num_segments",))
dense_oracle = jax.jit(jref.fed_mix_ref)
SEGMENT_CASES = sorted({(d, p, L) for d in SWEEP_D for p in SWEEP_P
                        for L in (1, 3, d)})


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jnp array and a torch tensor (bf16 made once,
    on the JAX side, and carried over exactly through f32)."""
    j = jnp.asarray(a).astype(DTYPES[dtype][0])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        DTYPES[dtype][1])
    return j, t


def _close(got: torch.Tensor, want, dtype: str, err_msg=""):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=err_msg)


def _segment_inputs(d, p, L, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, L, d).astype(np.int32)
    w_new = (rng.random(d) / d).astype(np.float32)
    w_old = (rng.random(d) / d).astype(np.float32)
    x_new = rng.normal(size=(d, p)).astype(np.float32)
    x_old = rng.normal(size=(d, p)).astype(np.float32)
    return ids, w_new, w_old, x_new, x_old


def _dense_inputs(d, p, seed):
    rng = np.random.default_rng(seed)
    mn = rng.uniform(0, 1, (d, d)).astype(np.float32)
    mo = rng.uniform(0, 1, (d, d)).astype(np.float32)
    tot = (mn + mo).sum(axis=1, keepdims=True)
    return (mn / tot, mo / tot, rng.normal(size=(d, p)).astype(np.float32),
            rng.normal(size=(d, p)).astype(np.float32))


# ---------------------------------------------------------------------------
# fed_mix_segment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,p,L", SEGMENT_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fed_mix_segment_matches_jax(d, p, L, dtype):
    ids, wn, wo, xn, xo = _segment_inputs(d, p, L, seed=d * 1000 + p + L)
    jxn, txn = _pair(xn, dtype)
    jxo, txo = _pair(xo, dtype)
    got = fed_mix_segment(torch.from_numpy(ids), torch.from_numpy(wn),
                          torch.from_numpy(wo), txn, txo, num_segments=L)
    assert got.dtype == txn.dtype and tuple(got.shape) == (d, p)
    want = segment_oracle(jnp.asarray(ids), jnp.asarray(wn),
                          jnp.asarray(wo), jxn, jxo, num_segments=L)
    assert str(want.dtype) == dtype
    _close(got, want, dtype, "vs jnp oracle")
    # the Pallas kernel (interpret mode) on a subset: every D at P=130,
    # and the P sweep at D=37, both with L=3
    if L == 3 and (p == 130 or d == 37):
        pallas = jax_fed_mix_segment(jnp.asarray(ids), jnp.asarray(wn),
                                     jnp.asarray(wo), jxn, jxo,
                                     num_segments=L, interpret=True)
        _close(got, pallas, dtype, "vs Pallas interpret")


# ---------------------------------------------------------------------------
# fed_mix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", SWEEP_D)
@pytest.mark.parametrize("p", SWEEP_P)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fed_mix_matches_jax(d, p, dtype):
    mn, mo, xn, xo = _dense_inputs(d, p, seed=d * 1000 + p)
    jxn, txn = _pair(xn, dtype)
    jxo, txo = _pair(xo, dtype)
    got = fed_mix(torch.from_numpy(mn), torch.from_numpy(mo), txn, txo)
    assert got.dtype == txn.dtype and tuple(got.shape) == (d, p)
    want = dense_oracle(jnp.asarray(mn), jnp.asarray(mo), jxn, jxo)
    _close(got, want, dtype, "vs jnp oracle")
    if p == 130 or (d == 37 and dtype == "float32"):
        pallas = jax_fed_mix(jnp.asarray(mn), jnp.asarray(mo), jxn, jxo,
                             interpret=True)
        _close(got, pallas, dtype, "vs Pallas interpret")


# ---------------------------------------------------------------------------
# wrapper guards (CPU)
# ---------------------------------------------------------------------------

def _seg_args(d=6, p=9, L=3):
    ids, wn, wo, xn, xo = _segment_inputs(d, p, L, seed=0)
    return [torch.from_numpy(a) for a in (ids, wn, wo, xn, xo)]


@pytest.mark.parametrize("bad_id", [-1, 3, 7])
def test_fed_mix_segment_rejects_cluster_ids_out_of_range(bad_id):
    ids, wn, wo, xn, xo = _seg_args()
    ids[2] = bad_id
    with pytest.raises(ValueError, match=r"cluster_ids must lie in \[0"):
        fed_mix_segment(ids, wn, wo, xn, xo, num_segments=3)


def test_fed_mix_segment_rejects_mismatched_x():
    ids, wn, wo, xn, xo = _seg_args()
    with pytest.raises(ValueError, match="differ in shape"):
        fed_mix_segment(ids, wn, wo, xn, xo[:, :-1].contiguous(),
                        num_segments=3)
    with pytest.raises(ValueError, match="differ in dtype"):
        fed_mix_segment(ids, wn, wo, xn, xo.to(torch.bfloat16),
                        num_segments=3)


def test_fed_mix_segment_rejects_non_contiguous():
    ids, wn, wo, xn, xo = _seg_args(d=6, p=12)
    with pytest.raises(ValueError, match="must be contiguous"):
        fed_mix_segment(ids, wn, wo, xn[:, ::2], xo[:, ::2],
                        num_segments=3)
    with pytest.raises(ValueError, match="must be contiguous"):
        fed_mix_segment(torch.stack([ids, ids], 1)[:, 0], wn, wo, xn, xo,
                        num_segments=3)


def test_fed_mix_rejects_mismatched_and_non_contiguous():
    mn, mo, xn, xo = [torch.from_numpy(a) for a in _dense_inputs(6, 12, 0)]
    with pytest.raises(ValueError, match="differ in shape"):
        fed_mix(mn, mo, xn, xo[:-1])
    with pytest.raises(ValueError, match="differ in dtype"):
        fed_mix(mn, mo, xn, xo.to(torch.bfloat16))
    with pytest.raises(ValueError, match="must be contiguous"):
        fed_mix(mn, mo, xn[:, ::2], xo[:, ::2])
    with pytest.raises(ValueError, match="must be contiguous"):
        fed_mix(mn.t(), mo, xn, xo)
    with pytest.raises(ValueError, match=r"must be \[D, D\]"):
        fed_mix(mn[:, :3], mo, xn, xo)
