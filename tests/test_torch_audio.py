"""The audio config (musicgen-medium) against the JAX package, reduced,
with the JAX weights carried across by ``lm_params_from_jax``.

MusicGen's frontend is a stub in both packages: the decoder takes frame
embeddings [B, S, d] (the sum of the 4 codebook embeddings) and a text
conditioning context [B, Tc, cd], here drawn from a seed with numpy. Each
layer attends to the context (cross-attention, plain in both packages),
and ``heads`` [d, K·V] gives the 4 codebooks' logits.

* prefill logits [B, 1, 4, V] and caches (``cross_k`` / ``cross_v``
  included), then 8 decode steps (logits [B, 4, V]) on seeded frame
  embeddings, against JAX's jitted steps at rtol 1e-4 (atol 1e-4 of the
  logits' scale);
* ``loss_fn`` (the fused CE over the codebook heads, labels [B, S, 4]) at
  rtol 1e-5 and every gradient leaf within 1e-4 of its largest |value|
  against ``jax.value_and_grad``;
* 3 AdamW steps against JAX's jitted step, and a held-out batch's loss
  after the third update at rtol 1e-4;
* the ``heads`` and ``cross`` trees carried leaf by leaf, and the port's
  own init giving JAX's tree of shapes;
* the token entry points refuse audio, as JAX's ``generate`` does.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.steps import (  # noqa: E402
    build_decode_step as jbuild_decode_step,
    build_prefill_step as jbuild_prefill_step,
    build_train_step as jbuild_train_step,
)
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_jax, lm_params_to_numpy,
)
from repro_torch.kernels.ops import tree_flatten  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    _loss_and_grad, build_decode_step, build_prefill_step, build_train_step,
)
from repro_torch.models.model import build_model  # noqa: E402

ARCH = "musicgen-medium"
B, S, STEPS = 2, 40, 8
RTOL = 1e-4


def _close(got, want, what):
    want = np.asarray(want)
    atol = RTOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol,
                               err_msg=what)


def _configs():
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert cfg.family == "audio" and cfg.cross_attend
    return jcfg, cfg


def _weights(jcfg, seed=0):
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(seed))
    return jparams, lm_params_from_jax(jax.tree.map(np.asarray, jparams))


def _inputs(cfg, seed, s=S, labels=False):
    """Frame embeddings, the conditioning context and (``labels``) the
    codebooks' labels, f32/int32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    batch = {"embeds": rng.standard_normal((B, s, cfg.d_model)).astype(f),
             "cross_context": rng.standard_normal(
                 (B, cfg.cross_context_len, cfg.cross_context_dim)).astype(f)}
    if labels:
        batch["labels"] = rng.integers(
            0, cfg.vocab_size, (B, s, cfg.num_codebooks)).astype(np.int32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_prefill_and_decode_match_jax():
    jcfg, cfg = _configs()
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams, params = _weights(jcfg)
    batch = _inputs(cfg, 0)
    frames = np.random.default_rng(1).standard_normal(
        (STEPS, B, 1, cfg.d_model)).astype(np.float32)
    buf, tc = S + STEPS, cfg.cross_context_len
    jprefill = jax.jit(jbuild_prefill_step(jmodel))
    jdecode = jax.jit(jbuild_decode_step(jmodel))
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    jcache = jmodel.make_cache(B, buf, cross_len=tc)
    cache = model.make_cache(B, buf, device="cpu", cross_len=tc)
    jlogits, jcache = jprefill(jparams, jax.tree.map(jnp.asarray, batch),
                               jcache)
    logits, cache = prefill(params, _torch(batch), cache)
    assert logits.shape == jlogits.shape == (B, 1, cfg.num_codebooks,
                                             cfg.vocab_size)
    _close(logits, jlogits, "prefill logits")
    assert set(cache) == set(jcache) and {"cross_k", "cross_v"} <= set(cache)
    assert cache["cross_k"].shape == (cfg.num_layers, B, tc, cfg.num_heads,
                                      cfg.head_dim)
    assert float(cache["cross_k"].abs().max()) > 0
    for key in sorted(set(cache) - {"index"}):
        _close(cache[key], jcache[key], f"prefill cache {key}")
    for step in range(STEPS):
        jlogits, jcache = jdecode(jparams, jcache,
                                  {"embed": jnp.asarray(frames[step])})
        logits, cache = decode(params, cache,
                               {"embed": torch.from_numpy(frames[step])})
        assert logits.shape == (B, cfg.num_codebooks, cfg.vocab_size)
        _close(logits, jlogits, f"decode step {step} logits")
    assert cache["index"] == int(jcache["index"]) == S + STEPS
    for key in sorted(set(cache) - {"index"}):
        _close(cache[key], jcache[key], f"decode cache {key}")


def _leaves_close(got, want, scale_tol, what):
    g_leaves, _ = tree_flatten(got)
    w_leaves = jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves), what
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        w = np.asarray(w)
        atol = scale_tol * max(1e-12, float(np.abs(w).max()))
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=atol,
                                   err_msg=f"{what}: leaf {i}")


def test_loss_fn_and_grads_match_jax():
    jcfg, cfg = _configs()
    jparams, params = _weights(jcfg, seed=1)
    data = _inputs(cfg, 2, labels=True)
    (jloss, jmet), jgrads = jax.value_and_grad(
        jbuild_model(jcfg).loss_fn, has_aux=True)(
            jparams, jax.tree.map(jnp.asarray, data))
    loss, metrics, grads = _loss_and_grad(build_model(cfg), False)(
        params, _torch(data))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmet["ce"]),
                               rtol=1e-5)
    assert set(grads) == {"heads", "layers", "ln_f"}
    assert float(grads["layers"]["cross"]["wk"].abs().max()) > 0
    _leaves_close(grads, jgrads, 1e-4, "musicgen grads")


def test_train_steps_match_jax():
    jcfg, cfg = _configs()
    jparams, params = _weights(jcfg, seed=2)
    tc = dict(lr=3e-3, remat=False)
    jstep, jopt = jbuild_train_step(jbuild_model(jcfg), JTrainConfig(**tc))
    jstep = jax.jit(jstep)
    step, opt = build_train_step(build_model(cfg), TrainConfig(**tc))
    jst, st = jopt.init(jparams), opt.init(params)
    for i in range(3):
        data = _inputs(cfg, 10 + i, labels=True)
        jparams, jst, jm = jstep(jparams, jst, jax.tree.map(jnp.asarray, data))
        params, st, m = step(params, st, _torch(data))
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        for got, want in zip(tree_flatten(params)[0],
                             jax.tree.leaves(jparams)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=2 * tc["lr"] * (i + 1) + 1e-6)
    # the third update is held by a held-out batch's loss after it
    held = _inputs(cfg, 20, labels=True)
    jloss, _ = jax.jit(jbuild_model(jcfg).loss_fn)(
        jparams, jax.tree.map(jnp.asarray, held))
    with torch.no_grad():
        loss, _ = build_model(cfg).loss_fn(params, _torch(held))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                               err_msg="held-out loss after step 3")


def test_remat_matches_the_plain_loss():
    """remat's per-layer checkpoint closes over the conditioning context:
    the same loss and gradients as the plain forward."""
    _, cfg = _configs()
    model = build_model(cfg)
    params = model.init(3, device="cpu")
    data = _torch(_inputs(cfg, 4, s=24, labels=True))
    plain = _loss_and_grad(model, False)(params, data)
    remat = _loss_and_grad(model, True)(params, data)
    torch.testing.assert_close(remat[0], plain[0], rtol=1e-6, atol=0)
    for g, w in zip(tree_flatten(remat[2])[0], tree_flatten(plain[2])[0]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


def test_heads_and_cross_params_round_trip():
    """``lm_params_from_jax`` carries ``heads`` and each layer's ``cross``
    and ``ln_cross`` leaf by leaf; the port's own init gives JAX's tree of
    shapes (``heads`` in place of ``embed``)."""
    jcfg, cfg = _configs()
    jparams, params = _weights(jcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jparams))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(
        lm_params_to_numpy(params)))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        assert np.array_equal(flat_b[path], leaf), path
    names = {jax.tree_util.keystr(path) for path, _ in flat_j}
    assert {"['heads']", "['layers']['cross']['wk']",
            "['layers']['ln_cross']['bias']"} <= names
    assert params["heads"].shape == (cfg.d_model,
                                     cfg.num_codebooks * cfg.vocab_size)
    mine = lm_params_to_numpy(build_model(cfg).init(0, device="cpu"))
    assert (jax.tree.map(lambda a: (a.shape, a.dtype), mine)
            == jax.tree.map(lambda a: (a.shape, a.dtype),
                            jax.tree.map(np.asarray, jparams)))


def test_token_entry_points_refuse_audio():
    """Audio serves through ``Model.prefill`` / ``Model.decode`` with
    embeddings: ``generate`` and ``run_lm_training`` (a token stream)
    raise, naming the way in."""
    prompts = np.zeros((1, 4), dtype=np.int32)
    with pytest.raises(ValueError, match="embeds input"):
        serve.generate(ARCH, prompts, max_new_tokens=2, device="cpu")
    with pytest.raises(ValueError, match="build_train_step"):
        train.run_lm_training(ARCH, steps=1, device="cpu", verbose=False)
