"""The port's paper nets (logreg, CNN, LSTM) against
``repro.models.paper_nets``: forward, masked loss, masked accuracy and the
loss gradients, with the JAX weights carried across by
``params_from_jax`` (same HWIO / gate layouts); the batched forward of P
distinct client models against JAX's vmap of the one-model function; and
``params_to_numpy`` as the exact inverse. Tolerance 1e-5 (f32 convolutions
and matmuls sum in other orders in XLA and in PyTorch)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_models import PaperNetConfig as JNet  # noqa: E402
from repro.models import paper_nets as jnets  # noqa: E402
from repro_torch.configs.paper_models import PaperNetConfig  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.models import paper_nets as tnets  # noqa: E402

TOL = 1e-5
# the JAX side under jit (one compile per net, not one per op)
j_forward = jax.jit(jnets.paper_net_forward, static_argnums=2)
j_accuracy = jax.jit(jnets.paper_net_accuracy, static_argnums=2)
j_loss_grad = jax.jit(jax.value_and_grad(jnets.paper_net_loss),
                      static_argnums=2)
NETS = {
    "logreg": dict(name="lr", kind="logreg", input_dim=12, num_classes=5),
    "cnn": dict(name="cnn", kind="cnn", image_size=8, channels=1, hidden=8,
                num_classes=6),
    "lstm": dict(name="lstm", kind="lstm", vocab=11, seq_len=6, hidden=8,
                 num_classes=11, embed_dim=4),
}


def _inputs(kind, cfg, rng, lead):
    if kind == "logreg":
        return rng.normal(size=lead + (cfg["input_dim"],)).astype(np.float32)
    if kind == "cnn":
        s = cfg["image_size"]
        return rng.normal(size=lead + (s, s, 1)).astype(np.float32)
    return rng.integers(0, cfg["vocab"], lead + (cfg["seq_len"],)).astype(
        np.int32)


def _batch(kind, cfg, rng, lead):
    return {"x": _inputs(kind, cfg, rng, lead),
            "y": rng.integers(0, cfg["num_classes"], lead).astype(np.int32),
            "mask": (rng.random(lead) > 0.25).astype(np.float32)}


def _jparams(kind, seed):
    """JAX init, with the zero biases / logreg weights made random so the
    comparison exercises every parameter."""
    p = jnets.init_paper_net(jax.random.PRNGKey(seed), JNet(**NETS[kind]))
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v) + 0.1 * rng.normal(size=v.shape).astype(
        np.float32) for k, v in p.items()}


@pytest.mark.parametrize("kind", list(NETS))
def test_forward_loss_accuracy_grads_match_jax(kind):
    jcfg, tcfg = JNet(**NETS[kind]), PaperNetConfig(**NETS[kind])
    rng = np.random.default_rng(0)
    jp = _jparams(kind, 0)
    batch = _batch(kind, NETS[kind], rng, (9,))
    tp = params_from_jax(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        tnets.paper_net_forward(tp, tb["x"], tcfg).numpy(),
        np.asarray(j_forward(jp, jb["x"], jcfg)),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        float(tnets.paper_net_accuracy(tp, tb, tcfg)),
        float(j_accuracy(jp, jb, jcfg)), rtol=TOL, atol=TOL)
    jloss, jgrads = j_loss_grad(jp, jb, jcfg)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tloss = tnets.paper_net_loss(tp, tb, tcfg)
    tgrads = torch.autograd.grad(tloss, list(tp.values()))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=TOL,
                               atol=TOL)
    for k, g in zip(tp, tgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("kind", list(NETS))
def test_batched_forward_matches_jax_vmap(kind):
    """P distinct client models at once == JAX's vmap of one model."""
    jcfg, tcfg = JNet(**NETS[kind]), PaperNetConfig(**NETS[kind])
    rng = np.random.default_rng(1)
    P = 3
    ps = [_jparams(kind, s) for s in range(P)]
    jstack = {k: np.stack([p[k] for p in ps]) for k in ps[0]}
    batch = _batch(kind, NETS[kind], rng, (P, 5))
    want = jax.jit(jax.vmap(lambda p, b: jnets.paper_net_loss(p, b, jcfg)))(
        jstack, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tnets.paper_net_loss_batched(
        params_from_jax(jstack), {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, tcfg)
    assert got.shape == (P,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("kind", list(NETS))
def test_init_shapes_and_conversion_roundtrip(kind):
    jp = jnets.init_paper_net(jax.random.PRNGKey(0), JNet(**NETS[kind]))
    tp = tnets.init_paper_net(torch.Generator().manual_seed(0),
                              PaperNetConfig(**NETS[kind]))
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    jnp_tree = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(params_from_jax(jnp_tree))
    for k in jnp_tree:
        np.testing.assert_array_equal(back[k], jnp_tree[k])
    bf = params_to_numpy(params_from_jax(
        {"w": np.asarray(jnp.asarray(jnp_tree[next(iter(jnp_tree))])
                         .astype(jnp.bfloat16))}))
    assert bf["w"].dtype == np.float32
