"""The port's ``MeshEngine`` on one device (no mesh) against the JAX
package's ``MeshEngine`` without a mesh, on the CPU, with the same numpy
inputs and the same draws: a round's survive mask is handed to both; its
key ``k`` is JAX's, and the port gets what JAX draws from it —
``randint(k, (), 0, R)`` (gossip_async's matching, ``_draw``) and
``uniform(fold_in(k, 0x636F6465), [D, n_pad / chunk, chunk])`` (the int8
wire's rounding noise over the packed width, ``engine.py:1324``).

* One round (reduced qwen2-1.5b: one layer, width 64; D 8 clients in 4
  clusters, 2 local SGD steps of B 2 x S 8, non-uniform counts) through
  ``round_fn`` for fedp2p, fedp2p_topo, fedavg, gossip and gossip_async,
  six cases that take mix_path auto and dense and the none, int8 and topk
  codecs, with and without the global sync and with stragglers (each a
  JAX compile; the mix alone takes the whole grid): the loss to 1e-5, the
  parameters to 1e-4 of each leaf's scale, topk's residual (round
  deltas of O(1) weights) to 1e-6.
* ``broadcast_to_clients``: JAX's [D, ...] state, as views of one packed
  buffer.

The mix alone is held in ``test_torch_mesh_mix.py``, which takes this
file's helpers (``mesh_draws``, ``jax_mix``, ``mix_trees``).

JAX's engines are built once a module (``_jax_engine``): each compiles
its round once a value of ``do_global_sync``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import compression as jcompression  # noqa: E402
from repro import protocols as jprotocols  # noqa: E402
from repro.config import FLConfig as JFLConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.fedp2p import broadcast_to_clients as jbroadcast  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.protocols.context import make_context as jmake_context  # noqa: E402
from repro.protocols.engine import MeshEngine as JMeshEngine  # noqa: E402
from repro.protocols.engine import _resolve_spec as j_resolve_spec  # noqa: E402
from repro_torch import compression  # noqa: E402
from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.core.fedp2p import broadcast_to_clients  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.protocols import get  # noqa: E402
from repro_torch.protocols.async_gossip import matching_perm_stack  # noqa: E402
from repro_torch.protocols.engine import MeshDraws, MeshEngine  # noqa: E402

ARCH = "qwen2-1.5b"
D, STEPS, B, S = 8, 2, 2, 8
FL = dict(num_clusters=4, lr=0.05)
PROTOCOLS = ("fedp2p", "fedp2p_topo", "fedavg", "gossip", "gossip_async")
CODEC_KEY = 0x636F6465
STRAGGLERS = np.array([0., 1, 1, 1, 0, 0, 1, 1], np.float32)
COUNTS = np.random.default_rng(7).uniform(1, 9, D).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its models are tiny,
    and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def leaves(tree):
    return [np.asarray(x) for x in kernel_ops.tree_flatten(tree)[0]]


def _within_scale(got, want, tol, what):
    """Each leaf within ``tol`` of its largest |value|."""
    got, want = leaves(got), [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        atol = tol * max(1e-12, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                   err_msg=f"{what}: leaf {i}")


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config(ARCH).reduced(num_layers=1, max_d_model=64)
    cfg = get_config(ARCH).reduced(num_layers=1, max_d_model=64)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (D, STEPS, B, S), np.int32)
    labels = rng.integers(0, cfg.vocab_size, (D, STEPS, B, S), np.int32)
    return {"jmodel": jmodel, "model": model, "jparams": jparams,
            "params": lm_params_from_jax(_np(jparams)),
            "jbatch": {"tokens": jnp.asarray(tokens),
                       "labels": jnp.asarray(labels)},
            "batch": {"tokens": torch.from_numpy(tokens),
                      "labels": torch.from_numpy(labels)}, "engines": {}}


def _jax_engine(setup, algo, mix_path, codec):
    key = (algo, mix_path, codec)
    if key not in setup["engines"]:
        setup["engines"][key] = JMeshEngine(
            setup["jmodel"], JFLConfig(**FL), D, STEPS, algorithm=algo,
            counts=jnp.asarray(COUNTS), codec=codec, mix_path=mix_path)
    return setup["engines"][key]


def _engine(setup, algo, mix_path, codec):
    return MeshEngine(setup["model"], FLConfig(**FL), D, STEPS,
                      algorithm=algo, counts=torch.from_numpy(COUNTS),
                      codec=codec, mix_path=mix_path, device="cpu")


def mesh_draws(algo, codec, survive, key, n_params):
    """The port's ``MeshDraws`` of a one-device JAX round with mix key
    ``key``."""
    matching = noise = None
    if algo == "gossip_async":
        R = matching_perm_stack(D).shape[0]
        matching = torch.tensor(int(jax.random.randint(key, (), 0, R)))
    if codec == "int8":
        c = compression.get("int8")
        shape = (D, c.padded(n_params) // c.chunk, c.chunk)
        noise = torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, CODEC_KEY), shape))).reshape(D, -1)
    return MeshDraws(survive=torch.from_numpy(survive), matching=matching,
                     wire_noise=noise)


ROUND_CASES = [  # (algo, mix_path, codec, survive, sync)
    ("fedp2p", "auto", "none", STRAGGLERS, True),
    ("fedp2p_topo", "auto", "int8", STRAGGLERS, False),
    ("fedavg", "dense", "none", np.ones(D, np.float32), True),
    ("gossip", "auto", "int8", STRAGGLERS, True),
    ("gossip_async", "dense", "int8", np.ones(D, np.float32), False),
    ("fedp2p", "dense", "topk", STRAGGLERS, True),
]


@pytest.mark.parametrize("algo,mix_path,codec,survive,sync", ROUND_CASES)
def test_round_matches_jax(setup, algo, mix_path, codec, survive, sync):
    jeng = _jax_engine(setup, algo, mix_path, codec)
    eng = _engine(setup, algo, mix_path, codec)
    key = jax.random.PRNGKey(42)
    jfp = jbroadcast(setup["jparams"], D)
    jout = jeng.round_fn(jfp, setup["jbatch"], jnp.asarray(survive), key,
                         do_global_sync=sync)
    fp = broadcast_to_clients(setup["params"], D)
    n = sum(x[0].numel() for x in kernel_ops.tree_flatten(fp)[0])
    out = eng.round_fn(fp, setup["batch"],
                       mesh_draws(algo, codec, survive, key, n),
                       do_global_sync=sync)
    assert len(out) == len(jout)
    np.testing.assert_allclose(float(out[1]), float(jout[1]), rtol=1e-5)
    _within_scale(out[0], jout[0], 1e-4, f"{algo} params")
    if codec == "topk":
        # the residual holds round deltas of O(1) weights: a few of their
        # ulps (1.2e-7), whatever the residual's own scale
        np.testing.assert_allclose(out[2].numpy(), np.asarray(jout[2]),
                                   rtol=0, atol=1e-6)


def mix_trees(seed):
    """A [D, ...] tree of varied leaf sizes (some past the int8 chunk)."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (D, 33, 17), "b": {"c": (D, 300), "d": (D, 2, 2, 3)},
              "e": (D, 5)}
    old = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                       shapes, is_leaf=lambda x: isinstance(x, tuple))
    new = jax.tree.map(
        lambda x: x + 0.05 * rng.normal(size=x.shape).astype(np.float32),
        old)
    return new, old


def torch_tree(tree):
    return jax.tree.map(torch.from_numpy, tree)


def jax_mix(algo, mix_path, codec, f_new, f_old, survive, sync, key):
    """JAX MeshEngine._round's no-mesh mixing, given f_new and f_old."""
    proto = jprotocols.get(algo)
    ids = proto.mesh_cluster_ids(D, JFLConfig(**FL))
    ctx = jmake_context(key=key, survive=jnp.asarray(survive),
                        counts=jnp.asarray(COUNTS), cluster_ids=ids,
                        num_clusters=int(ids.max()) + 1, do_global_sync=sync)
    spec = j_resolve_spec(proto, ctx, mix_path)
    m_new = m_old = None
    if spec is None:
        m_new, m_old = proto.mixing_matrix(ctx)
    c = jcompression.active(codec)
    if c is None:
        return proto.apply_mixing(m_new, m_old, f_new, f_old, spec=spec)
    return proto.apply_mixing(m_new, m_old, f_new, f_old, spec=spec,
                              codec=c, key=jax.random.fold_in(key, CODEC_KEY))


def test_broadcast_state_is_one_packed_buffer(setup):
    """``broadcast_to_clients`` gives JAX's [D, ...] leaves as views of one
    packed buffer, which the engine packs again without a copy."""
    fp = broadcast_to_clients(setup["params"], D)
    jfp = jbroadcast(setup["jparams"], D)
    for g, w in zip(leaves(fp), jax.tree.leaves(jfp)):
        np.testing.assert_array_equal(g, np.asarray(w))
    flat, spec = kernel_ops.packed_view(fp)
    assert flat.shape == (D, sum(spec.sizes)) and flat.is_contiguous()
    assert kernel_ops.tree_flatten(fp)[0][0].data_ptr() == flat.data_ptr()
