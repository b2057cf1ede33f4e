"""The port's packing seam (``repro_torch.kernels.ops``) against
``repro.kernels.ops``, bit for bit: ``pack_tree`` columns in JAX's
sorted-key leaf order (also for a dict built in another order and for a
nested one), the promoted buffer dtype, ``unpack_tree``, and
``mean_packed``'s per-leaf-dtype reduction (a bf16 leaf accumulates in its
own dtype); the packing guards; and the codec wire of ``fed_mix_flat``
against the JAX one."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _trees(n, seed, bf16_leaf):
    """The same stacked tree for both packages, the port's dict built in
    reverse-sorted key order."""
    rng = np.random.default_rng(seed)
    arrays = {"w": rng.normal(size=(n, 4, 3)), "b": rng.normal(size=(n, 5)),
              "s": rng.normal(size=(n,)), "a": rng.normal(size=(n, 2, 2, 2))}
    jt, tt = {}, {}
    for k in sorted(arrays, reverse=True):
        j = jnp.asarray(arrays[k].astype(np.float32))
        if bf16_leaf and k == "b":
            j = j.astype(jnp.bfloat16)
        jt[k] = j
        tt[k] = torch.from_numpy(_np32(j).copy()).to(
            torch.bfloat16 if j.dtype == jnp.bfloat16 else torch.float32)
    return jt, tt


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("bf16_leaf", [False, True])
def test_pack_unpack_mean_bitwise(n, bf16_leaf):
    jt, tt = _trees(n, seed=n, bf16_leaf=bf16_leaf)
    assert list(tt) != sorted(tt)          # insertion order is NOT sorted
    jflat, jspec = jops.pack_tree(jt)
    tflat, tspec = ops.pack_tree(tt)
    assert tflat.dtype == torch.float32 and str(jflat.dtype) == "float32"
    np.testing.assert_array_equal(_np32(tflat), _np32(jflat))
    assert tspec.sizes == jspec.sizes and tspec.shapes == jspec.shapes
    # mean_packed: per-leaf dtype on the mixed tree, one reduction otherwise
    np.testing.assert_array_equal(_np32(ops.mean_packed(tflat, tspec)),
                                  _np32(jops.mean_packed(jflat, jspec)))
    # unpack: same leaves, same dtypes, in the port's dict under its keys
    back = ops.unpack_tree(tflat, tspec)
    jback = jops.unpack_tree(jflat, jspec)
    assert sorted(back) == sorted(jback)
    for k in back:
        assert str(back[k].dtype)[6:] == str(jback[k].dtype)
        np.testing.assert_array_equal(_np32(back[k]), _np32(jback[k]))


def test_mean_packed_bf16_buffer_bitwise():
    rng = np.random.default_rng(0)
    j = jnp.asarray(rng.normal(size=(7, 33)).astype(np.float32)).astype(
        jnp.bfloat16)
    jflat, jspec = jops.pack_tree({"x": j})
    tflat, tspec = ops.pack_tree({"x": torch.from_numpy(_np32(j).copy()).to(
        torch.bfloat16)})
    got = ops.mean_packed(tflat, tspec)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np32(got),
                                  _np32(jops.mean_packed(jflat, jspec)))


def test_nested_tree_leaf_order_matches_jax():
    rng = np.random.default_rng(1)
    a = {"z": {"q": rng.normal(size=(2, 3)), "b": rng.normal(size=(2,))},
         "c": [rng.normal(size=(2, 2)), rng.normal(size=(2, 1))]}
    jt = jax.tree.map(lambda x: jnp.asarray(x.astype(np.float32)), a)
    tt = {"z": {"q": torch.from_numpy(a["z"]["q"].astype(np.float32)),
                "b": torch.from_numpy(a["z"]["b"].astype(np.float32))},
          "c": [torch.from_numpy(x.astype(np.float32)) for x in a["c"]]}
    np.testing.assert_array_equal(_np32(ops.pack_tree(tt)[0]),
                                  _np32(jops.pack_tree(jt)[0]))
    back = ops.unpack_tree(*ops.pack_tree(tt))
    assert isinstance(back["c"], list) and list(back["z"]) == ["b", "q"]


def test_pack_tree_pair_and_guards():
    _, tt = _trees(3, seed=0, bf16_leaf=False)
    fn, fo, spec = ops.pack_tree_pair(tt, {k: v + 1 for k, v in tt.items()})
    assert fn.shape == fo.shape == (3, sum(spec.sizes))
    with pytest.raises(ValueError, match="structures differ"):
        ops.pack_tree_pair(tt, {k: v for k, v in tt.items() if k != "a"})
    with pytest.raises(ValueError, match="empty tree"):
        ops.pack_tree({})
    with pytest.raises(ValueError, match="scalar"):
        ops.pack_tree({"a": torch.zeros(())})
    with pytest.raises(ValueError, match="leading client axis"):
        ops.pack_tree({"a": torch.zeros(2, 3), "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="unknown codec"):
        ops.fed_mix_flat(torch.eye(3), torch.zeros(3, 3), fn, fo,
                         codec="int4")


@pytest.mark.parametrize("codec", ["none", "bf16", "int8", "topk"])
def test_fed_mix_flat_codec_wire_matches_jax(codec):
    """The codec branch of ``fed_mix_flat`` (int8: the fused ``fed_mix_q``
    contraction; the others decode, then ``fed_mix``) and the carried
    error-feedback residual against ``repro.kernels.ops.fed_mix_flat``.
    The JAX int8 wire draws its rounding noise from ``key``; the port is
    handed the same noise. Tolerance 1e-5: the matmuls sum in other orders
    (the wire records themselves are bit for bit,
    tests/test_torch_compression.py)."""
    rng = np.random.default_rng(4)
    d, p = 5, 700
    mn = rng.uniform(0, 1, (d, d)).astype(np.float32)
    mo = rng.uniform(0, 1, (d, d)).astype(np.float32)
    tot = (mn + mo).sum(axis=1, keepdims=True)
    mn, mo = mn / tot, mo / tot
    xo = rng.normal(size=(d, p)).astype(np.float32)
    xn = xo + 0.01 * rng.normal(size=(d, p)).astype(np.float32)
    res = (0.001 * rng.normal(size=(d, p))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    u = None
    if codec == "int8":      # the noise the JAX int8 encode draws
        u = torch.from_numpy(np.array(jax.random.uniform(
            key, (d, 3, 256)))).reshape(d, -1)
    state = res if codec == "topk" else None
    jout, jstate = jax.jit(lambda *a: jops.fed_mix_flat(
        *a[:4], codec=codec, codec_state=a[4], key=key))(
            mn, mo, xn, xo, state)
    out, new_state = ops.fed_mix_flat(
        *(torch.from_numpy(a) for a in (mn, mo, xn, xo)), codec=codec,
        codec_state=None if state is None else torch.from_numpy(state),
        u=u)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    if codec == "topk":
        np.testing.assert_allclose(new_state.numpy(), np.asarray(jstate),
                                   rtol=1e-6, atol=1e-7)
    else:
        assert new_state is None and jstate is None
