"""``repro_torch.models.moe`` against ``repro.models.moe``, on inputs made
from a numpy seed (weights carried across with ``lm_params_from_jax``):

* ``moe_capacity`` equal, and ``dispatch_indices`` bit for bit on the same
  expert ids, with tokens dropped at capacity;
* ``route``'s weights, expert ids and aux loss on identical logits at
  rtol 1e-6 (the ids equal), ties going to the lower expert index first
  as ``jax.lax.top_k`` sends them;
* ``_moe_ffn_gather`` with and without shared experts, with and without
  drops, at rtol 1e-5 (f32 products summed in other orders).

The MoE models as a whole (routing equal in every layer, then logits,
caches, decode, ``generate`` and ``loss_fn``) are held in
``tests/test_torch_lm.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.models.moe as jmoe  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ["deepseek-v2-236b", "dbrx-132b"]


def _cfgs(arch, **over):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("tokens", [1, 4, 37, 140, 8192])
def test_moe_capacity_matches_jax(tokens):
    for arch in ARCHS:
        for over in ({}, {"num_experts": 160, "num_experts_per_tok": 6}):
            jcfg, cfg = _cfgs(arch, **over)
            assert moe.moe_capacity(cfg, tokens) == jmoe.moe_capacity(
                jcfg, tokens)


@pytest.mark.parametrize("t,k,e,c,skew", [
    (37, 2, 4, 24, False),       # nothing dropped
    (37, 2, 4, 8, False),        # over capacity: later assignments dropped
    (64, 6, 160, 8, False),      # DeepSeek's 160 experts top-6
    (50, 4, 16, 8, True),        # most tokens on expert 3: heavy drops
    (4, 6, 160, 8, False),       # decode: T = B
])
def test_dispatch_indices_bitwise(t, k, e, c, skew):
    rng = np.random.default_rng(t * 100 + e)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
        np.int32)
    if skew:
        idx[:, 0] = 3
        idx[:, 1:] = np.where(idx[:, 1:] == 3, 5, idx[:, 1:])
    want = [np.asarray(a) for a in jmoe.dispatch_indices(jnp.asarray(idx),
                                                         e, c)]
    got = moe.dispatch_indices(torch.from_numpy(idx), e, c)
    for g, w, name in zip(got, want, ("token_for_slot", "slot_for_assign",
                                      "keep")):
        assert g.numpy().dtype == w.dtype, name
        assert np.array_equal(g.numpy(), w), name
    if c < t * k // e:
        assert not want[2].all()        # the case does drop


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("experts,top_k", [(4, 4), (8, 2), (160, 6)])
def test_route_matches_jax(arch, experts, top_k):
    """On identical logits: x in quarters and the router in 256ths, so
    every product and sum of ``x @ router`` is exact in f32 in both
    packages (equal logits also tie now and then)."""
    jcfg, cfg = _cfgs(arch, num_experts=experts, num_experts_per_tok=top_k)
    rng = np.random.default_rng(experts)
    x = (rng.integers(-4, 5, (96, cfg.d_model)) / 4).astype(np.float32)
    w = (rng.integers(-8, 9, (cfg.d_model, experts)) / 256).astype(
        np.float32)
    np.testing.assert_array_equal(x.astype(np.float64) @ w,
                                  np.asarray(jnp.asarray(x) @ w))
    jw, jidx, jaux = jmoe.route(jnp.asarray(w), jnp.asarray(x), jcfg)
    gw, gidx, gaux = moe.route(torch.from_numpy(w), torch.from_numpy(x), cfg)
    assert gidx.dtype == torch.int32
    assert np.array_equal(gidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(gaux), float(jaux), rtol=1e-6)


def test_route_ties_go_to_the_lower_expert():
    """Duplicated router columns give exactly equal probabilities: both
    packages list the lower expert index first."""
    jcfg, cfg = _cfgs("dbrx-132b", num_experts=8, num_experts_per_tok=3)
    rng = np.random.default_rng(5)
    w = rng.standard_normal((cfg.d_model, 4)).astype(np.float32)
    w = np.concatenate([w, w], axis=1)          # expert e ties expert e + 4
    x = rng.standard_normal((32, cfg.d_model)).astype(np.float32)
    _, jidx, _ = jmoe.route(jnp.asarray(w), jnp.asarray(x), jcfg)
    _, gidx, _ = moe.route(torch.from_numpy(w), torch.from_numpy(x), cfg)
    jidx = np.asarray(jidx)
    assert (jidx[:, 1] == jidx[:, 0] + 4).all()     # the tie, lower first
    assert np.array_equal(gidx.numpy(), jidx)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("over", [{}, {"num_experts": 8, "capacity_factor":
                                       0.5}])
def test_moe_ffn_gather_matches_jax(arch, over):
    """deepseek-v2: a shared expert (swiglu); dbrx: none. With 8 experts and
    a capacity factor of 0.5 tokens are dropped."""
    jcfg, cfg = _cfgs(arch, **over)
    assert bool(cfg.num_shared_experts) == (arch == "deepseek-v2-236b")
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    p = lm_params_from_jax(_np(jp))
    assert ("shared" in p) == bool(cfg.num_shared_experts)
    x = np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe._moe_ffn_gather(jp, jnp.asarray(x), jcfg)
    y, aux = moe._moe_ffn_gather(p, torch.from_numpy(x), cfg)
    if over:
        _, jidx, _ = jmoe.route(jp["router"], jnp.asarray(x).reshape(48, -1),
                                jcfg)
        c = jmoe.moe_capacity(jcfg, 48)
        assert not np.asarray(jmoe.dispatch_indices(
            jidx, jcfg.num_experts, c)[2]).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jy).max()))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_tree_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    want = _np(jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32))
    got = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), want)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                        got) == shapes
