"""The port's kernels against the JAX package.

* ``fed_mix_segment`` / ``fed_mix`` of ``repro_torch`` (their plain
  PyTorch versions, which CPU tensors take) against the JAX jnp oracles
  over D x P x L x dtype, and against the JAX Pallas kernels in interpret
  mode on a subset of that sweep (interpret mode costs ~0.4 s a call:
  every D at P=130, and the P sweep at D=37);
  tolerances 2e-6 for f32 and 3e-2 for bf16, as tests/test_mixing_spec.py
  uses; output dtypes must match;
* ``fed_mix_matching`` against the Pallas kernel (interpret mode) BIT FOR
  BIT, f32 and bf16, at odd and even D, S = 1 and 2: every operation is
  one rounding in the same order in both; and the card kernel's rounding
  tree (S <= 3) rehearsed in plain PyTorch against the plain stage loop,
  bit for bit, over gossip's ring, round-robin matchings, byes and stages
  that are not involutions;
* ``fed_mix_q`` against the Pallas kernel (interpret mode) and the jnp
  oracle on the JAX kernel tests' cases, plus a bf16 x_old and explicit
  output dtypes, at rtol/atol 1e-5 (the JAX tests' tolerance: the
  matmuls sum in other orders); its two layout errors;
* ``fed_aggregate`` against the Pallas kernel (interpret mode) on the JAX
  kernel tests' cases, 1e-5 for f32 and 3e-2 for bf16, and
  ``ops.fed_aggregate_tree`` on a mixed-dtype tree;
* the wrapper guards: bad cluster ids or partners, mismatched x_new/x_old
  shapes or dtypes, and non-contiguous inputs raise ValueError;
* the build's library digest covers the shared headers (``csrc/*.cuh``).

The kernels themselves run only on a card: tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.compression import Int8Codec as JInt8Codec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fed_aggregate import (  # noqa: E402
    fed_aggregate as jax_fed_aggregate,
)
from repro.kernels.fed_mix import fed_mix as jax_fed_mix  # noqa: E402
from repro.kernels.fed_mix_q import fed_mix_q as jax_fed_mix_q  # noqa: E402
from repro.kernels.fed_mix_sparse import (  # noqa: E402
    fed_mix_matching as jax_fed_mix_matching,
)
from repro.kernels.fed_mix_sparse import (  # noqa: E402
    fed_mix_segment as jax_fed_mix_segment,
)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.fed_aggregate import fed_aggregate  # noqa: E402
from repro_torch.kernels.fed_mix import fed_mix  # noqa: E402
from repro_torch.kernels.fed_mix_q import fed_mix_q  # noqa: E402
from repro_torch.kernels.fed_mix_sparse import (  # noqa: E402
    fed_mix_matching, fed_mix_segment,
)
from repro_torch.protocols.async_gossip import (  # noqa: E402
    matching_perm_stack,
)
from repro_torch.protocols.gossip import _phase_perm_stack  # noqa: E402

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
# fed_mix_matching
# ---------------------------------------------------------------------------

def _matching_inputs(d, p, stages, seed):
    rng = np.random.default_rng(seed)
    if stages == 2:
        perms = _phase_perm_stack(d)
    else:
        stack = matching_perm_stack(d)
        perms = stack[rng.integers(0, stack.shape[0], stages)]
    survive = (rng.random(d) > 0.35).astype(np.float32)
    return (np.ascontiguousarray(perms), survive,
            rng.normal(size=(d, p)).astype(np.float32),
            rng.normal(size=(d, p)).astype(np.float32))


@pytest.mark.parametrize("d", [1, 2, 3, 5, 8, 9, 17])
@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fed_mix_matching_bitwise_vs_pallas(d, stages, dtype):
    perms, survive, xn, xo = _matching_inputs(d, 130, stages,
                                              seed=d * 10 + stages)
    jxn, txn = _pair(xn, dtype)
    jxo, txo = _pair(xo, dtype)
    got = fed_mix_matching(torch.from_numpy(perms),
                           torch.from_numpy(survive), txn, txo)
    assert got.dtype == txn.dtype and tuple(got.shape) == (d, 130)
    want = jax_fed_mix_matching(jnp.asarray(perms), jnp.asarray(survive),
                                jxn, jxo, interpret=True)
    assert str(want.dtype) == dtype
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _tree_mix(perms, survive, x_new, x_old):
    """The card kernel's route for S <= 3, in plain PyTorch: each row's
    output as a rounding tree over 2^S rows of eff, the leaves composed
    from the perms from the last stage down (node r of stage s splits into
    r and perm_s[r]), added pairwise, stage 0's pairs first."""
    d, stages = x_new.shape[0], perms.shape[0]
    leaves = np.arange(d)[:, None]
    for s in range(stages - 1, -1, -1):
        leaves = np.stack([leaves, perms[s][leaves]], axis=-1).reshape(d, -1)
    f32 = torch.float32
    sv = torch.from_numpy(survive)[:, None]
    eff = sv * x_new.to(f32) + (1.0 - sv) * x_old.to(f32)
    node = eff[torch.from_numpy(leaves)]                  # [D, 2^S, P]
    while node.shape[1] > 1:
        node = 0.5 * (node[:, 0::2] + node[:, 1::2])
    return node[:, 0].to(x_new.dtype)


def _stage_maps(kind, d, stages, rng):
    if kind == "ring":              # gossip's two phases, then matchings
        stack = np.concatenate([_phase_perm_stack(d), matching_perm_stack(d)])
        return stack[:stages]
    if kind == "matchings":         # gossip_async's round-robin matchings
        stack = matching_perm_stack(d)
        return stack[rng.integers(0, stack.shape[0], stages)]
    # not involutions: a cyclic shift, random permutations, a map that is
    # no permutation at all
    rows = [np.roll(np.arange(d), 3), rng.permutation(d),
            rng.integers(0, d, d)]
    return np.stack(rows[:stages])


@pytest.mark.parametrize("d", [2, 9, 17, 100])
@pytest.mark.parametrize("stages", [1, 2, 3])
@pytest.mark.parametrize("kind", ["ring", "matchings", "maps"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fed_mix_matching_rounding_tree_is_bitwise(d, stages, kind, dtype):
    """The rounding tree the card kernel computes at S <= 3 equals the
    plain version's stage loop bit for bit (odd D: byes)."""
    rng = np.random.default_rng(d * 100 + stages)
    perms = np.ascontiguousarray(_stage_maps(kind, d, stages, rng)
                                 .astype(np.int32))
    _, survive, xn, xo = _matching_inputs(d, 257, 1, seed=d + stages)
    txn = torch.from_numpy(xn).to(getattr(torch, dtype))
    txo = torch.from_numpy(xo).to(getattr(torch, dtype))
    want = ref.fed_mix_matching_ref(torch.from_numpy(perms),
                                    torch.from_numpy(survive), txn, txo)
    got = _tree_mix(perms, survive, txn, txo)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# fed_mix_q
# ---------------------------------------------------------------------------

# (d, p, chunk, block_r, block_d, block_k): tests/test_compression.py's
# cases for the JAX kernel, with its tile sizes
Q_CASES = [(6, 700, 256, 128, 256, 256), (16, 4096, 256, 8, 1024, 256),
           (17, 513, 128, 8, 128, 16), (1, 129, 64, 128, 128, 256),
           (40, 300, 128, 16, 128, 16)]


def _q_inputs(d, p, chunk, seed):
    mn, mo, x, xo = _dense_inputs(d, p, seed)
    enc = JInt8Codec(chunk=chunk).encode(jnp.asarray(x),
                                         key=jax.random.PRNGKey(0))
    return mn, mo, np.array(enc.values), np.array(enc.scales), xo


@pytest.mark.parametrize("d,p,chunk,block_r,block_d,block_k", Q_CASES)
def test_fed_mix_q_matches_jax(d, p, chunk, block_r, block_d, block_k):
    mn, mo, q, sc, xo = _q_inputs(d, p, chunk, seed=d * p)
    got = fed_mix_q(*(torch.from_numpy(a) for a in (mn, mo, q, sc, xo)),
                    chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (d, p)
    jargs = [jnp.asarray(a) for a in (mn, mo, q, sc, xo)]
    pallas = jax_fed_mix_q(*jargs, chunk=chunk, block_r=block_r,
                           block_d=block_d, block_k=block_k, interpret=True)
    oracle = jref.fed_mix_q_ref(*jargs, chunk=chunk)
    for want, what in ((pallas, "vs Pallas interpret"),
                       (oracle, "vs jnp oracle")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("x_dtype,out_dtype", [("bfloat16", None),
                                               ("bfloat16", "float32"),
                                               ("float32", "bfloat16")])
def test_fed_mix_q_dtypes_match_jax(x_dtype, out_dtype):
    d, p, chunk = 17, 513, 128
    mn, mo, q, sc, xo = _q_inputs(d, p, chunk, seed=3)
    jxo, txo = _pair(xo, x_dtype)
    t_out = None if out_dtype is None else DTYPES[out_dtype][1]
    j_out = None if out_dtype is None else DTYPES[out_dtype][0]
    got = fed_mix_q(*(torch.from_numpy(a) for a in (mn, mo, q, sc)), txo,
                    chunk=chunk, out_dtype=t_out)
    want = jax_fed_mix_q(*(jnp.asarray(a) for a in (mn, mo, q, sc)), jxo,
                         chunk=chunk, out_dtype=j_out, block_r=8,
                         block_d=128, block_k=16, interpret=True)
    assert str(got.dtype)[6:] == str(want.dtype)
    # tolerance of the output dtype: 1e-5 in f32, one bf16 step otherwise
    tol = 1e-5 if str(want.dtype) == "float32" else TOL["bfloat16"]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_fed_mix_q_layout_errors():
    mn, mo, q, sc, xo = (torch.from_numpy(a) for a in
                         _q_inputs(5, 300, 128, seed=1))
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        fed_mix_q(mn, mo, q, sc, xo, chunk=100)
    with pytest.raises(ValueError, match="covers 384 params < x_old's 400"):
        fed_mix_q(mn, mo, q, sc, torch.zeros((5, 400)), chunk=128)


# ---------------------------------------------------------------------------
# fed_aggregate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,block", [(3, 1000, 256), (8, 4096, 1024),
                                       (1, 17, 8), (16, 513, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fed_aggregate_matches_jax(n, d, block, dtype):
    rng = np.random.default_rng(n * d)
    jx, tx = _pair(rng.normal(size=(n, d)).astype(np.float32), dtype)
    w = rng.random(n).astype(np.float32)
    w = w / w.sum()
    got = fed_aggregate(tx, torch.from_numpy(w))
    assert got.dtype == tx.dtype and tuple(got.shape) == (d,)
    want = jax_fed_aggregate(jx, jnp.asarray(w), block_d=block,
                             interpret=True)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_fed_aggregate_tree_mixed_dtypes_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"b": rng.normal(size=(4, 7)).astype(np.float32),
            "a": {"w": rng.normal(size=(4, 3, 5)).astype(np.float32),
                  "h": rng.normal(size=(4, 6)).astype(np.float32)}}
    w = rng.random(4).astype(np.float32)
    jtree = {"b": jnp.asarray(tree["b"]),
             "a": {"w": jnp.asarray(tree["a"]["w"]),
                   "h": jnp.asarray(tree["a"]["h"]).astype(jnp.bfloat16)}}
    ttree = {"b": torch.from_numpy(tree["b"]),
             "a": {"w": torch.from_numpy(tree["a"]["w"]),
                   "h": torch.from_numpy(np.array(
                       jtree["a"]["h"].astype(jnp.float32))).to(
                           torch.bfloat16)}}
    got = ops.fed_aggregate_tree(ttree, torch.from_numpy(w))
    want = jops.fed_aggregate_tree(jtree, jnp.asarray(w))
    for g, j in ((got["b"], want["b"]), (got["a"]["w"], want["a"]["w"]),
                 (got["a"]["h"], want["a"]["h"])):
        assert str(g.dtype)[6:] == str(j.dtype)
        assert tuple(g.shape) == tuple(j.shape)
        np.testing.assert_allclose(g.to(torch.float32).numpy(),
                                   np.asarray(j.astype(jnp.float32)),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# wrapper guards (CPU)
# ---------------------------------------------------------------------------

def test_fed_mix_matching_rejects_bad_partners_and_shapes():
    perms, survive, xn, xo = (torch.from_numpy(a) for a in
                              _matching_inputs(6, 9, 2, seed=0))
    for bad in (-1, 6):
        p = perms.clone()
        p[1, 2] = bad
        with pytest.raises(ValueError, match=r"partner indices must lie"):
            fed_mix_matching(p, survive, xn, xo)
    with pytest.raises(ValueError, match=r"perms must be \[S, D\]"):
        fed_mix_matching(perms[:, :5], survive, xn, xo)
    with pytest.raises(ValueError, match="differ in dtype"):
        fed_mix_matching(perms, survive, xn, xo.to(torch.bfloat16))
    with pytest.raises(ValueError, match="must be contiguous"):
        fed_mix_matching(perms.t().contiguous().t(), survive, xn, xo)


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


# ---------------------------------------------------------------------------
# the build's library digest
# ---------------------------------------------------------------------------

def test_library_path_changes_with_a_shared_header(tmp_path, monkeypatch):
    """An edited csrc/*.cuh must not be served by a stale library: every
    kernel's library path changes with it; an edited .cu changes only its
    own kernel's path."""
    import shutil

    from repro_torch.kernels import backend
    csrc = tmp_path / "csrc"
    shutil.copytree(backend.CSRC, csrc)
    monkeypatch.setattr(backend, "CSRC", csrc)
    before = {n: backend.library_path(n) for n in backend.KERNELS}
    assert backend.library_path("fed_mix") == before["fed_mix"]
    header = csrc / "tf32x3.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: backend.library_path(n) for n in backend.KERNELS}
    assert all(after[n] != before[n] for n in backend.KERNELS)
    src = csrc / "flash_attention.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {n: backend.library_path(n) for n in backend.KERNELS}
    assert [n for n in backend.KERNELS if again[n] != after[n]] == [
        "flash_attention"]
