"""The dense and VLM configs (gemma-2b, nemotron-4-15b, yi-34b,
chameleon-34b) against the JAX package, reduced, with the JAX weights
carried across by ``lm_params_from_jax``; and the port's registry against
JAX's for all ten architectures.

Each config runs its own branches together in one model: gemma's GeGLU,
RMSNorm(1 + w), √d embedding scale, tied embeddings and MQA (kept at
head_dim 256, its published width, so that the plain flash runs at 256);
nemotron's squared-ReLU MLP, LayerNorm and RoPE on the first half of
each head; yi's SwiGLU at rope theta 5e6; chameleon's qk-norm before
RoPE over mixed text and image token ids. ``reduced()`` makes nemotron,
yi and chameleon MHA; they keep GQA here with ``num_kv_heads=2``.

* prefill logits and caches, then 8 greedy decode steps, against JAX's
  jitted steps at rtol 1e-4 (atol 1e-4 of the logits' scale);
* ``loss_fn`` (ce) at rtol 1e-5 and every gradient leaf within 1e-4 of
  its largest |value| against ``jax.value_and_grad``;
* 3 AdamW steps against JAX's jitted step: the losses at rtol 1e-4, the
  parameters within 2·lr a step (AdamW's first update moves an entry
  whose gradient is ~0 by up to ±lr in either version), and a held-out
  batch's loss after the third update at rtol 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.steps import (  # noqa: E402
    build_decode_step as jbuild_decode_step,
    build_prefill_step as jbuild_prefill_step,
    build_train_step as jbuild_train_step,
)
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.kernels.ops import tree_flatten  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    _loss_and_grad, build_decode_step, build_prefill_step, build_train_step,
)
from repro_torch.models.model import build_model  # noqa: E402

ARCHS = ["gemma-2b", "nemotron-4-15b", "yi-34b", "chameleon-34b"]
B, S, STEPS = 2, 40, 8
RTOL = 1e-4


def _close(got, want, what):
    want = np.asarray(want)
    atol = RTOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol,
                               err_msg=what)


def _configs(arch):
    """The reduced config in both packages (equal field by field), with the
    published attention shape kept where ``reduced()`` changes it."""
    keep = ({"head_dim": 256} if arch == "gemma-2b"
            else {"num_kv_heads": 2})
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **keep)
    cfg = dataclasses.replace(get_config(arch).reduced(), **keep)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def _weights(jcfg, seed=0):
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(seed))
    return jparams, lm_params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_get_config_matches_jax(arch):
    """All ten architectures of the JAX registry, field for field."""
    assert set(ARCH_IDS) == set(JARCH_IDS)
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(jget_config(arch)))
    assert get_config(arch.replace("-", "_")) is get_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jcfg, cfg = _configs(arch)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams, params = _weights(jcfg)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    buf = S + STEPS
    jprefill = jax.jit(jbuild_prefill_step(jmodel))
    jdecode = jax.jit(jbuild_decode_step(jmodel))
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    jcache = jmodel.make_cache(B, buf)
    cache = model.make_cache(B, buf, device="cpu")
    jlogits, jcache = jprefill(jparams, {"tokens": jnp.asarray(prompts)},
                               jcache)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(prompts)},
                            cache)
    assert logits.shape == jlogits.shape == (B, 1, cfg.vocab_size)
    _close(logits, jlogits, "prefill logits")
    assert set(cache) == set(jcache)
    for key in sorted(set(cache) - {"index"}):
        _close(cache[key], jcache[key], f"prefill cache {key}")

    jtok = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
    tok = serve._sample(logits[:, -1], 0.0, None)
    for step in range(STEPS):
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), step
        jlogits, jcache = jdecode(jparams, jcache, {"token": jtok[:, None]})
        logits, cache = decode(params, cache, {"token": tok[:, None]})
        _close(logits, jlogits, f"decode step {step} logits")
        jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        tok = serve._sample(logits, 0.0, None)
    assert cache["index"] == int(jcache["index"]) == S + STEPS
    for key in sorted(set(cache) - {"index"}):
        _close(cache[key], jcache[key], f"decode cache {key}")


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _leaves_close(got, want, scale_tol, what):
    g_leaves, _ = tree_flatten(got)
    w_leaves = jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves), what
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        w = np.asarray(w)
        atol = scale_tol * max(1e-12, float(np.abs(w).max()))
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=atol,
                                   err_msg=f"{what}: leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_jax(arch):
    jcfg, cfg = _configs(arch)
    jparams, params = _weights(jcfg, seed=1)
    data = _batch(cfg, 1)
    (jloss, jmet), jgrads = jax.value_and_grad(
        jbuild_model(jcfg).loss_fn, has_aux=True)(
            jparams, jax.tree.map(jnp.asarray, data))
    loss, metrics, grads = _loss_and_grad(build_model(cfg), False)(
        params, {k: torch.from_numpy(v) for k, v in data.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmet["ce"]),
                               rtol=1e-5)
    _leaves_close(grads, jgrads, 1e-4, f"{arch} grads")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    jcfg, cfg = _configs(arch)
    jparams, params = _weights(jcfg, seed=2)
    tc = dict(lr=3e-3, remat=False)
    jstep, jopt = jbuild_train_step(jbuild_model(jcfg), JTrainConfig(**tc))
    jstep = jax.jit(jstep)
    step, opt = build_train_step(build_model(cfg), TrainConfig(**tc))
    jst, st = jopt.init(jparams), opt.init(params)
    for i in range(3):
        data = _batch(cfg, 10 + i)
        jparams, jst, jm = jstep(jparams, jst, jax.tree.map(jnp.asarray, data))
        params, st, m = step(params, st, {k: torch.from_numpy(v)
                                          for k, v in data.items()})
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"{arch} step {i} {k}")
        for got, want in zip(tree_flatten(params)[0],
                             jax.tree.leaves(jparams)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=2 * tc["lr"] * (i + 1) + 1e-6)
    # the third update is held by a held-out batch's loss after it
    held = _batch(cfg, 20)
    jloss, _ = jax.jit(jbuild_model(jcfg).loss_fn)(
        jparams, jax.tree.map(jnp.asarray, held))
    with torch.no_grad():
        loss, _ = build_model(cfg).loss_fn(
            params, {k: torch.from_numpy(v) for k, v in held.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                               err_msg=f"{arch} held-out loss after step 3")
