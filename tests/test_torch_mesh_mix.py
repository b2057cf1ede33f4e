"""The mixing of the port's ``MeshEngine`` and the tree-level seams it
rests on, against the JAX package on the CPU (the draws as in
``test_torch_mesh_engine.py``, whose helpers this file takes):

* the one-device mix alone (``MeshEngine.mix``), given the same ``f_new``
  and ``f_old``, against the no-mesh mixing of JAX's ``MeshEngine._round``
  over every protocol x mix path (auto, dense) x codec (none, int8, topk)
  x sync x survive, with non-uniform counts: rtol 1e-5, atol 1e-6 (topk's
  residual too); bit for bit on the gossip family's spec path without a
  codec (each output one rounding of the same sums in the same order);
* ``Protocol.apply_mixing`` over trees (``ops.fed_mix_tree`` and
  ``spec.apply_spec_tree``) against the JAX package's;
* the mesh path's per-leaf wire, ``compression.wire_tree`` against JAX's
  jitted one (int8 with the noise of JAX's per-leaf ``fold_in(key, i)``,
  bf16) and ``feedback_wire_tree`` (topk, two rounds of residual) at rtol
  1e-6, atol 1e-6: the same int8 record (a flipped rounding would move an
  entry by a whole step, ~1e-2 here), its reconstruction ``f_old +
  q·scale`` rounded by XLA's jitted arithmetic within 2 ulps of the
  port's.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import compression as jcompression  # noqa: E402
from repro_torch import compression  # noqa: E402
from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.protocols import get  # noqa: E402
from repro_torch.protocols.context import make_context  # noqa: E402
from test_torch_mesh_engine import (  # noqa: E402
    COUNTS, D, FL, PROTOCOLS, STRAGGLERS, jax_mix, leaves, mesh_draws,
    mix_trees, torch_tree,
)
from repro_torch.protocols.engine import MeshEngine  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its models are tiny,
    and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("algo", PROTOCOLS)
@pytest.mark.parametrize("mix_path", ["auto", "dense"])
@pytest.mark.parametrize("codec", ["none", "int8", "topk"])
def test_mix_matches_jax(algo, mix_path, codec):
    f_new, f_old = mix_trees(1)
    eng = MeshEngine(None, FLConfig(**FL), D, 1, algorithm=algo,
                     counts=torch.from_numpy(COUNTS), codec=codec,
                     mix_path=mix_path, device="cpu")
    flat_new, flat_old, spec = kernel_ops.pack_tree_pair(
        torch_tree(f_new), torch_tree(f_old))
    n = flat_new.shape[1]
    for i, (survive, sync) in enumerate(
            [(s, y) for s in (np.ones(D, np.float32), STRAGGLERS)
             for y in (True, False)]):
        key = jax.random.PRNGKey(100 + i)
        want = jax_mix(algo, mix_path, codec, f_new, f_old, survive, sync,
                        key)
        got = eng.mix(flat_new, flat_old, spec,
                      mesh_draws(algo, codec, survive, key, n),
                      do_global_sync=sync)
        what = f"{algo} {mix_path} {codec} survive={survive} sync={sync}"
        if codec == "none":
            want = (want,)
        bitwise = (codec == "none" and mix_path == "auto"
                   and algo in ("gossip", "gossip_async"))
        for g, w in zip(leaves(got[0]), jax.tree.leaves(want[0])):
            if bitwise:
                np.testing.assert_array_equal(g, np.asarray(w), what)
            else:
                np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                           atol=1e-6, err_msg=what)
        if codec == "topk":
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                       rtol=1e-5, atol=1e-6, err_msg=what)


@pytest.mark.parametrize("codec", ["none", "int8", "topk"])
@pytest.mark.parametrize("structured", [False, True])
def test_apply_mixing_trees_match_jax(codec, structured):
    """``Protocol.apply_mixing`` over trees: the dense ``fed_mix_tree``
    and the spec's ``apply_spec_tree`` against the JAX package's."""
    f_new, f_old = mix_trees(2)
    key = jax.random.PRNGKey(5)
    survive = STRAGGLERS
    want = jax_mix("fedp2p", "auto" if structured else "dense", codec,
                    f_new, f_old, survive, True, key)
    proto = get("fedp2p")
    fl = FLConfig(**FL)
    ctx = make_context(survive=torch.from_numpy(survive),
                       counts=torch.from_numpy(COUNTS),
                       cluster_ids=torch.from_numpy(
                           proto.mesh_cluster_ids(D, fl)),
                       num_clusters=FL["num_clusters"])
    spec = proto.mixing_spec(ctx) if structured else None
    m_new, m_old = (None, None) if structured else proto.mixing_matrix(ctx)
    c = compression.active(codec)
    kw = {}
    if c is not None:
        n = sum(int(np.prod(x.shape[1:])) for x in jax.tree.leaves(f_new))
        kw = dict(codec=c, u=mesh_draws("fedp2p", codec, survive, key,
                                        n).wire_noise)
    got = proto.apply_mixing(m_new, m_old, torch_tree(f_new),
                             torch_tree(f_old), spec=spec, **kw)
    if c is None:
        got, want = (got,), (want,)
    for g, w in zip(leaves(got[0]), jax.tree.leaves(want[0])):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)


def _leaf_noise(tree, key, codec):
    """The per-leaf int8 noise JAX's ``wire_tree`` draws from ``key``."""
    out = []
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        n = int(np.prod(leaf.shape[1:]))
        shape = (leaf.shape[0], codec.padded(n) // codec.chunk, codec.chunk)
        out.append(torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, i), shape))).reshape(leaf.shape[0], -1))
    return out


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_wire_tree_matches_jax(codec):
    f_new, f_old = mix_trees(3)
    key = jax.random.PRNGKey(9)
    want = jax.jit(functools.partial(jcompression.wire_tree,
                                     jcompression.get(codec)))(
        f_new, f_old, key=key)
    c = compression.get(codec)
    u = _leaf_noise(f_new, key, c) if codec == "int8" else None
    got = compression.wire_tree(c, torch_tree(f_new), torch_tree(f_old),
                                u=u)
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6)


def test_feedback_wire_tree_matches_jax():
    f_new, f_old = mix_trees(4)
    jc, c = jcompression.get("topk"), compression.get("topk")
    jstate = jcompression.init_feedback_state(jc, f_new)
    state = compression.init_feedback_state(c, torch_tree(f_new))
    assert compression.init_feedback_state(compression.get("int8"),
                                           torch_tree(f_new)) is None
    for r in range(2):
        new = jax.tree.map(lambda x: x + 0.01 * r, f_new)
        jtx, jstate = jax.jit(functools.partial(
            jcompression.feedback_wire_tree, jc))(new, f_old, jstate)
        tx, state = compression.feedback_wire_tree(
            c, torch_tree(new), torch_tree(f_old), state)
        for g, w in zip(leaves(tx) + leaves(state),
                        jax.tree.leaves(jtx) + jax.tree.leaves(jstate)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
