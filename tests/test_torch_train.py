"""The LM training slice against the JAX package, on the CPU:

* ``data/lm.py``'s ``token_stream_batches`` gives JAX's tokens bit for bit;
* the schedules and the sgd, momentum and adamw updates over 5 steps
  against ``repro.optim`` (rtol 1e-6: the same f32 arithmetic);
  ``clip_by_global_norm``, ``cross_entropy`` and ``chunked_cross_entropy``
  (value and gradient) against JAX at rtol 1e-5;
* ``Model.loss_fn`` and every gradient leaf against
  ``jax.value_and_grad(model.loss_fn)`` for reduced hymba-1.5b (GQA kept
  with num_kv_heads=2), qwen2-1.5b, mamba2-130m and the MoE family,
  deepseek-v2-236b (MLA at q/k 24, v 16, a leading dense layer, shared
  experts) and dbrx-132b, on the weights carried by
  ``lm_params_from_jax``: the loss, its CE and the routers' aux loss at
  rtol 1e-5, each gradient leaf within 1e-4 of its largest |value| (a few
  layers of f32 products summed in other orders);
* 3 steps of ``build_train_step`` against JAX's jitted step: losses at
  rtol 1e-4, and the parameters within a tolerance scaled by the learning
  rate. AdamW's first update is lr · g / (|g| + eps) per entry, so an entry
  whose gradient is near zero (and of either sign under a change of
  summation order) moves by up to 2·lr in one version against the other;
* a train step leaves no tensor to the cyclic collector;
* remat and 2 microbatches give the plain step's loss and gradients; for
  the MoE family, remat (whose per-layer checkpoint recomputes the
  routing) routes every token as the plain step does and gives its loss
  and gradients;
* ``run_lm_training`` and the CLI on the CPU: the loss falls, checkpoints
  are written; ``--mode federated --device cpu`` trains (its parity with
  JAX is ``test_torch_federated_train.py``'s).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.lm import token_stream_batches as jstream  # noqa: E402
from repro.launch.steps import build_train_step as jbuild_train_step  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.optim import optimizers as joptim  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.data.lm import token_stream_batches  # noqa: E402
from repro_torch.kernels.ops import tree_flatten  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import _loss_and_grad, build_train_step  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import optimizers, schedules  # noqa: E402

ARCHS = ["hymba-1.5b", "qwen2-1.5b", "mamba2-130m"]
MOE_ARCHS = ["deepseek-v2-236b", "dbrx-132b"]
B, S = 2, 72           # Hymba: 80 positions with its 8 meta tokens, past the window of 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves_close(got, want, scale_tol, what):
    """Each leaf within ``scale_tol`` of the leaf's largest |value|."""
    g_leaves, _ = tree_flatten(got)
    w_leaves = jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves), what
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        w = np.asarray(w)
        atol = scale_tol * max(1e-12, float(np.abs(w).max()))
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=atol,
                                   err_msg=f"{what}: leaf {i}")


# ---------------------------------------------------------------------------
# data, schedules, optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seed", [(512, 0), (32001, 3)])
def test_token_stream_matches_jax(vocab, seed):
    mine, theirs = (token_stream_batches(vocab, 3, 17, seed=seed),
                    jstream(vocab, 3, 17, seed=seed))
    for _ in range(4):
        a, b = next(mine), next(theirs)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kind", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_jax(kind):
    cfg = dict(lr=3e-3, schedule=kind, warmup_steps=4, total_steps=12)
    mine = schedules.make_schedule(TrainConfig(**cfg))
    theirs = jsched.make_schedule(JTrainConfig(**cfg))
    for step in range(15):
        got = mine(torch.tensor(step, dtype=torch.int32))
        want = theirs(jnp.asarray(step, jnp.int32))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _opt_pair(kind, lr):
    if kind == "sgd":
        return optimizers.sgd(lr[0]), joptim.sgd(lr[1])
    if kind == "momentum":
        return optimizers.momentum(lr[0], 0.8), joptim.momentum(lr[1], 0.8)
    return (optimizers.adamw(lr[0], 0.9, 0.95, 1e-8, 0.01),
            joptim.adamw(lr[1], 0.9, 0.95, 1e-8, 0.01))


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw"])
@pytest.mark.parametrize("scheduled", [False, True])
def test_optimizers_match_jax(kind, scheduled):
    rng = np.random.default_rng(1)
    params = {"b": rng.standard_normal((3, 4)).astype(np.float32),
              "a": {"w": rng.standard_normal(5).astype(np.float32)}}
    lr = ((schedules.warmup_cosine_schedule(1e-2, 2, 6),
           jsched.warmup_cosine_schedule(1e-2, 2, 6)) if scheduled
          else (1e-2, 1e-2))
    opt, jopt = _opt_pair(kind, lr)
    p = {"b": torch.from_numpy(params["b"]),
         "a": {"w": torch.from_numpy(params["a"]["w"])}}
    jp = jax.tree.map(jnp.asarray, params)
    st, jst = opt.init(p), jopt.init(jp)
    for step in range(5):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32), params)
        upd, st = opt.update({"b": torch.from_numpy(g["b"]),
                              "a": {"w": torch.from_numpy(g["a"]["w"])}},
                             st, p)
        jupd, jst = jopt.update(jax.tree.map(jnp.asarray, g), jst, jp)
        p = optimizers.apply_updates(p, upd)
        jp = joptim.apply_updates(jp, jupd)
        for got, want in zip(tree_flatten(p)[0], jax.tree.leaves(jp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{kind} step {step}")
        assert int(st["step"]) == int(jst["step"])


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(2)
    g = {"x": rng.standard_normal((4, 3)).astype(np.float32),
         "y": rng.standard_normal(7).astype(np.float32)}
    got, norm = optimizers.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    want, jnorm = joptim.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_matches_jax(with_mask):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32) if with_mask else None
    t = torch.from_numpy(logits).requires_grad_(True)
    got = layers.cross_entropy(t, torch.from_numpy(labels),
                               None if mask is None else torch.from_numpy(mask))
    got.backward()

    def jce(x):
        return jlayers.cross_entropy(x, jnp.asarray(labels),
                                     None if mask is None else jnp.asarray(mask))

    want, jgrad = jax.value_and_grad(jce)(jnp.asarray(logits))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("arch,s", [("qwen2-1.5b", 24), ("mamba2-130m", 30)])
def test_chunked_cross_entropy_matches_jax(arch, s):
    """A chunk of 8 shrunk to a divisor of S (8 of 24, 6 of 30); tied
    (mamba2) and untied (qwen2) embeddings."""
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    rng = np.random.default_rng(4)
    d, v = cfg.d_model, cfg.vocab_size
    embed = {"table": rng.standard_normal((v, d)).astype(np.float32) * 0.1}
    if not cfg.tie_embeddings:
        embed["unembed"] = rng.standard_normal((d, v)).astype(np.float32) * 0.1
    h = rng.standard_normal((2, s, d)).astype(np.float32)
    labels = rng.integers(0, v, (2, s)).astype(np.int32)
    te = {k: torch.from_numpy(a).requires_grad_(True) for k, a in embed.items()}
    th = torch.from_numpy(h).requires_grad_(True)
    got = layers.chunked_cross_entropy(te, th, torch.from_numpy(labels), cfg,
                                       chunk=8)
    got.backward()

    def jce(e, hh):
        return jlayers.chunked_cross_entropy(e, hh, jnp.asarray(labels), jcfg,
                                             chunk=8)

    want, (jge, jgh) = jax.value_and_grad(jce, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, embed), jnp.asarray(h))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=1e-5,
                               atol=1e-7)
    for k in embed:
        np.testing.assert_allclose(te[k].grad.numpy(), np.asarray(jge[k]),
                                   rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the model's loss and its gradients, and the train step
# ---------------------------------------------------------------------------

def _configs(arch):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    if arch == "hymba-1.5b":        # reduced() makes it MHA; keep GQA
        jcfg = dataclasses.replace(jcfg, num_kv_heads=2)
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    return jcfg, cfg


def _setup(arch, seed=0, batch=B):
    jcfg, cfg = _configs(arch)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    params = lm_params_from_jax(_np(jparams))
    data = next(token_stream_batches(cfg.vocab_size, batch, S, seed=seed))
    return jmodel, model, jparams, params, data


def _torch_batch(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_loss_fn_and_grads_match_jax(arch):
    jmodel, model, jparams, params, data = _setup(arch)
    (jloss, jmet), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, data))
    loss, metrics, grads = _loss_and_grad(model, False)(params,
                                                        _torch_batch(data))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmet["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmet["aux"]),
                               rtol=1e-5)
    if arch in MOE_ARCHS:
        assert float(metrics["aux"]) > 0
    _leaves_close(grads, jgrads, 1e-4, f"{arch} grads")


def test_loss_fn_with_a_mask_matches_jax():
    """A ``loss_mask`` takes ``cross_entropy`` on the logits."""
    jmodel, model, jparams, params, data = _setup("qwen2-1.5b", seed=1)
    mask = (np.random.default_rng(5).random((B, S)) > 0.25).astype(np.float32)
    data = {**data, "loss_mask": mask}
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, data))
    loss, _, grads = _loss_and_grad(model, False)(params, _torch_batch(data))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _leaves_close(grads, jgrads, 1e-4, "masked grads")


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-130m"] + MOE_ARCHS)
def test_train_steps_match_jax(arch):
    jcfg, _ = _configs(arch)
    jmodel, model, jparams, params, _ = _setup(arch, seed=2)
    tc = dict(lr=3e-3, remat=False)
    jstep, jopt = jbuild_train_step(jmodel, JTrainConfig(**tc))
    jstep = jax.jit(jstep)
    step, opt = build_train_step(model, TrainConfig(**tc))
    jst, st = jopt.init(jparams), opt.init(params)
    stream = token_stream_batches(jcfg.vocab_size, B, S, seed=2)
    for i in range(3):
        data = next(stream)
        jparams, jst, jm = jstep(jparams, jst, jax.tree.map(jnp.asarray, data))
        params, st, m = step(params, st, _torch_batch(data))
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"{arch} step {i} {k}")
        # an entry whose gradient is ~0 may take AdamW's +-lr first step in
        # either direction: each step can move it by up to 2 lr apart
        for got, want in zip(tree_flatten(params)[0],
                             jax.tree.leaves(jparams)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=2 * tc["lr"] * (i + 1) + 1e-6)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen2-1.5b"])
def test_remat_and_microbatches_match_the_plain_step(arch):
    _, model, _, params, data = _setup(arch, seed=3, batch=4)
    batch = _torch_batch(data)
    loss, _, grads = _loss_and_grad(model, False)(params, batch)
    loss_r, _, grads_r = _loss_and_grad(model, True)(params, batch)
    np.testing.assert_allclose(float(loss_r), float(loss), rtol=1e-6)
    for a, b in zip(tree_flatten(grads_r)[0], tree_flatten(grads)[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))
    outs = {}
    for mb in (1, 2):
        step, opt = build_train_step(model, TrainConfig(lr=1e-3, remat=False,
                                                        microbatches=mb))
        outs[mb] = step(params, opt.init(params), batch)
    np.testing.assert_allclose(float(outs[2][2]["loss"]),
                               float(outs[1][2]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(outs[2][2]["grad_norm"]),
                               float(outs[1][2]["grad_norm"]), rtol=1e-4)
    for a, b in zip(tree_flatten(outs[2][0])[0], tree_flatten(outs[1][0])[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_remat_matches_the_plain_step(arch, monkeypatch):
    """With remat each layer's checkpoint runs the router again in the
    backward: the recomputed routing (expert ids and kept assignments) is
    the forward's, and the loss and gradients are the plain step's."""
    from repro_torch.models import moe
    _, model, _, params, data = _setup(arch, seed=4)
    batch = _torch_batch(data)
    orig, routes = moe.dispatch_indices, []

    def recording(idx, num_experts, capacity):
        out = orig(idx, num_experts, capacity)
        routes.append((idx.clone(), out[2].clone()))
        return out

    monkeypatch.setattr(moe, "dispatch_indices", recording)
    loss, _, grads = _loss_and_grad(model, False)(params, batch)
    plain, routes[:] = list(routes), []
    loss_r, _, grads_r = _loss_and_grad(model, True)(params, batch)
    # the forward's layers in order, then the backward's recomputation in
    # reverse layer order
    n = len(plain)
    assert n > 0 and len(routes) == 2 * n
    for (idx, keep), (p_idx, p_keep) in zip(routes, plain + plain[::-1]):
        assert torch.equal(idx, p_idx) and torch.equal(keep, p_keep)
    np.testing.assert_allclose(float(loss_r), float(loss), rtol=1e-6)
    for a, b in zip(tree_flatten(grads_r)[0], tree_flatten(grads)[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))


def test_train_step_leaves_no_cyclic_garbage():
    """Two train steps (the first included) free their gradients, updates
    and old state by reference counting alone: no tensor is left for
    Python's cyclic collector, which at full width held param-sized trees
    past a step."""
    import gc
    cfg = get_config("dbrx-132b").reduced()
    model = build_model(cfg)
    step, opt = build_train_step(model, TrainConfig(lr=1e-3, remat=False))
    params = model.init(0, device="cpu")
    state = opt.init(params)
    batch = _torch_batch(next(token_stream_batches(cfg.vocab_size, 1, 32,
                                                   seed=0)))
    gc.collect()
    gc.disable()
    try:
        for _ in range(2):
            params, state, _ = step(params, state, batch)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        leaked = [o for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert leaked == []


def test_run_lm_training_on_the_cpu(tmp_path):
    out = train.run_lm_training("qwen2-1.5b", steps=8, batch=2, seq_len=32,
                                ckpt_dir=str(tmp_path), verbose=False,
                                device="cpu")
    assert out["steps"] == 8 and len(out["losses"]) == 8
    assert all(np.isfinite(out["losses"]))
    assert out["final_loss"] < out["first_loss"]
    assert len(out["step_seconds"]) == 8
    assert sorted(p.name for p in tmp_path.glob("step_*.npz")) == [
        "step_00000004.npz", "step_00000008.npz"]


def test_train_cli(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["train", "--mode", "lm", "--steps", "3",
                                     "--device", "cpu"])
    train.main()
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("loss ")
    monkeypatch.setattr("sys.argv", ["train", "--mode", "federated",
                                     "--rounds", "2", "--device", "cpu"])
    train.main()
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("loss ")
