"""Serving on the mesh's model axis: one ``gloo`` world of 4 CPU ranks
(``launch.mesh.run_ranks``, a ``file://`` rendezvous under ``tmp_path``),
spawned once for the module, runs every case on the meshes (1, 4) and
(2, 2); its worker is ``test_torch_model_axis_ranks.model_axis_worker``
(the ranks import no JAX). The JAX results are made here.

For each family's reduced config (dense GQA with its kv heads split,
gemma's MQA split inside its head, MLA with MoE, MoE, hybrid, SSM, audio,
and heads that do not divide over model 4: seqtp), with weights drawn by
JAX and carried across by ``convert.py``:

* the prefill's last logits and 4 greedy decode steps' logits of each
  rank's rows (whole vocabulary, every codebook for audio), the tokens
  equal, against JAX's unsharded jitted steps at rtol 1e-4 and against the
  port's one-process steps at rtol 1e-5;
* each rank's blocks have the spec's local shapes, their bytes are the
  spec's, ``gather_shards`` of ``local_shards`` gives the whole tree bit
  for bit, and ``init_local_params`` (train and decode layouts) equals the
  blocks of the one-device init bit for bit; the local cache has
  ``make_cache_specs``' shapes;
* ``moe_ffn_ep`` against JAX's ``moe_ffn_ep`` itself (a subprocess with 4
  forced host devices): at capacity factor 0.5 tokens drop, and the keep
  masks of every slice equal JAX's (its ``route`` and
  ``dispatch_indices`` on the slice its shard_map routes), the outputs at
  JAX's rtol 3e-4, atol 3e-5; at capacity factor 8 nothing drops and EP
  also equals the one-process gather path.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.steps import (
    build_decode_step as jbuild_decode_step,
    build_prefill_step as jbuild_prefill_step,
)
from repro.models.model import build_model as jbuild_model
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.sharding.place import local_shape, param_shapes
from repro_torch.sharding.rules import (
    abstract_mesh_info, make_param_specs, tree_paths,
)
from test_torch_model_axis_ranks import (
    B, CASES, MESHES, NEW, WORLD, buffer_len, case_config, inputs,
    model_axis_worker, moe_config, serve_steps,
)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RUNS = [(name, mesh) for name in CASES for mesh in MESHES]
RUN_IDS = [f"{n}-{m[0]}x{m[1]}" for n, m in RUNS]
MOE_B, MOE_S = 4, 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_config(name):
    """The JAX twin of the case's config (same fields)."""
    cfg = case_config(name)[0]
    j = dataclasses.replace(jget_config(cfg.name), **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    assert dataclasses.asdict(j) == dataclasses.asdict(cfg)
    return j


def _jax_run(name, jparams):
    """JAX's unsharded prefill and NEW decode steps (greedy)."""
    jcfg = _jax_config(name)
    cfg, s = case_config(name)
    jmodel = jbuild_model(jcfg)
    batch = inputs(cfg, s)
    tc = cfg.cross_context_len if cfg.family == "audio" else 0
    cache = jmodel.make_cache(B, buffer_len(cfg, s), cross_len=tc)
    prefill = jax.jit(jbuild_prefill_step(jmodel))
    decode = jax.jit(jbuild_decode_step(jmodel))
    if cfg.family == "audio":
        logits, cache = prefill(jparams, {
            "embeds": jnp.asarray(batch["embeds"]),
            "cross_context": jnp.asarray(batch["cross_context"])}, cache)
        outs = [np.asarray(logits)]
        for f in batch["frames"]:
            logits, cache = decode(jparams, cache, {"embed": jnp.asarray(f)})
            outs.append(np.asarray(logits)[:, None])
        return outs, None
    logits, cache = prefill(jparams, {"tokens": jnp.asarray(
        batch["tokens"])}, cache)
    outs = [np.asarray(logits[:, -1])]
    toks = [jnp.argmax(logits[:, -1], -1).astype(jnp.int32)]
    for _ in range(NEW):
        logits, cache = decode(jparams, cache, {"token": toks[-1][:, None]})
        outs.append(np.asarray(logits))
        toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
    return outs, np.stack([np.asarray(t) for t in toks], 1)


def _one_process_run(name, weights):
    cfg, s = case_config(name)
    model = build_model(cfg)
    params = lm_params_from_jax(weights)
    batch = {k: torch.from_numpy(v) for k, v in inputs(cfg, s).items()}
    if "tokens" in batch:
        batch["tokens"] = batch["tokens"].long()
    tc = cfg.cross_context_len if cfg.family == "audio" else 0
    cache = model.make_cache(B, buffer_len(cfg, s), device="cpu",
                             cross_len=tc)

    def gather(x):
        return x[:, None] if cfg.family == "audio" and x.dim() == 3 else x

    return serve_steps(model, params, batch, cache,
                       build_prefill_step(model), build_decode_step(model),
                       gather)


def _moe_weights():
    from repro.models import moe as jmoe
    cfg = moe_config(0.5)
    p = jmoe.init_moe(jax.random.PRNGKey(5), _jax_moe_config(0.5),
                      jnp.float32)
    x = np.random.default_rng(6).standard_normal(
        (MOE_B, MOE_S, cfg.d_model)).astype(np.float32)
    return jax.tree.map(np.asarray, p), x


def _jax_moe_config(cf):
    cfg = moe_config(cf)
    return dataclasses.replace(jget_config(cfg.name), **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    weights, jax_out = {}, {}
    for name in CASES:
        jparams = jbuild_model(_jax_config(name)).init(
            jax.random.PRNGKey(CASES.index(name)))
        weights[name] = jax.tree.map(np.asarray, jparams)
        jax_out[name] = _jax_run(name, jparams)
    moe_p, moe_x = _moe_weights()
    rdzv = tmp_path_factory.mktemp("rdzv") / "store"
    outs = run_ranks(model_axis_worker, WORLD,
                     ({"weights": weights, "moe_p": moe_p,
                       "moe_x": moe_x},), backend="gloo",
                     init_method=f"file://{rdzv}", timeout=400)
    return {"outs": outs, "weights": weights, "jax": jax_out,
            "moe_p": moe_p, "moe_x": moe_x,
            "jax_ep": _jax_moe_ep(moe_p, moe_x, tmp_path_factory)}


def _close(got, want, rtol, what):
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_prefill_and_decode_match_jax_unsharded(world, run):
    name, mesh = run
    want, want_tok = world["jax"][name]
    for rank, out in enumerate(world["outs"]):
        got = out[run]
        rows = got["rows"]
        assert len(got["logits"]) == len(want) == NEW + 1
        for step, (g, w) in enumerate(zip(got["logits"], want)):
            _close(g, w[rows], 1e-4, f"{run} rank {rank} step {step}")
        if want_tok is not None:
            assert np.array_equal(got["tokens"], want_tok[rows]), (run, rank)


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_prefill_and_decode_match_one_process(world, run):
    name, mesh = run
    want, want_tok = _one_process_run(name, world["weights"][name])
    for rank, out in enumerate(world["outs"]):
        got = out[run]
        rows = got["rows"]
        for step, (g, w) in enumerate(zip(got["logits"], want)):
            _close(g, w[rows], 1e-5, f"{run} rank {rank} step {step}")
        if want_tok is not None:
            assert np.array_equal(got["tokens"], want_tok[rows]), (run, rank)
        assert got["collectives"] > 0


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_blocks_are_the_specs(world, run):
    """Local shapes, bytes, the round trip and the sliced init."""
    name, mesh = run
    cfg = case_config(name)[0]
    shapes = param_shapes(cfg)
    for rank, out in enumerate(world["outs"]):
        got = out[run]
        assert got["shapes_ok"] and got["cache_shapes_ok"], (run, rank)
        assert got["round_trip"], (run, rank)
        assert got["sliced_init_train"] and got["sliced_init_decode"], (
            run, rank)
    info = abstract_mesh_info(cfg, mesh, ("data", "model"))
    specs = dict(tree_paths(make_param_specs(shapes, cfg, info)))
    want = sum(4 * int(np.prod(local_shape(t.shape, specs[p], info)))
               for p, t in tree_paths(shapes))
    assert all(o[run]["bytes"] == want for o in world["outs"])
    whole = sum(4 * t.numel() for _, t in tree_paths(shapes))
    assert want < whole                  # no rank holds the whole model


def test_the_cases_cover_the_strategies_and_cache_layouts(world):
    """tp, seqtp and dp; sequence-sharded caches (the all-to-all and the
    log-sum-exp merge) and a cache whose slots do not split (gemma's, 29
    slots)."""
    strategy = {name: abstract_mesh_info(case_config(name)[0], (1, 4),
                                         ("data", "model")).strategy
                for name in CASES}
    assert strategy["dense_gqa"] == strategy["mla_moe"] == "tp"
    assert strategy["seqtp"] == "seqtp"
    assert strategy["hybrid"] == strategy["ssm"] == "dp"
    split = {name: world["outs"][0][(name, (1, 4))]["cache_split"]
             for name in CASES}
    assert split["dense_gqa"]["k"][2] == ("model",)
    assert split["hybrid"]["k"][2] == ("model",)
    assert split["mla_moe"]["latent"][2] == ("model",)
    assert split["mqa_split_head"]["k"][2] == ()


def _jax_moe_ep(p, x, tmp_path_factory):
    """JAX's moe_ffn on a (1, 4) and a (2, 2) mesh of forced host devices
    (its expert-parallel path), and the keep masks of the slices its
    shard_map routes (JAX's route and dispatch_indices on them)."""
    d = tmp_path_factory.mktemp("moe_ep")
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((p, x), f)
    code = textwrap.dedent(f"""
        import os, pickle, dataclasses
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, jax.numpy as jnp, numpy as np
        sys_path = {SRC!r}
        from repro.configs import get_config
        from repro.models import moe as M
        from repro.sharding.rules import make_mesh_info
        from repro.sharding.context import use_rules
        p, x = pickle.load(open({str(d / "in.pkl")!r}, "rb"))
        fields = pickle.loads({pickle.dumps({
            cf: dataclasses.asdict(moe_config(cf)) for cf in (0.5, 8.0)})!r})
        out = {{}}
        for cf, kw in fields.items():
            cfg = dataclasses.replace(get_config(kw["name"]), **kw)
            for shape in ((1, 4), (2, 2)):
                mesh = jax.make_mesh(shape, ("data", "model"))
                info = make_mesh_info(cfg, mesh)
                with use_rules({{}}, mesh_info=info):
                    y, aux = jax.jit(lambda p, x: M.moe_ffn(p, x, cfg))(p, x)
                b_loc = x.shape[0] // shape[0]
                sl = b_loc * x.shape[1] // shape[1]
                keeps = {{}}
                for di in range(shape[0]):
                    xs = x[di * b_loc:(di + 1) * b_loc].reshape(-1, x.shape[2])
                    for ti in range(shape[1]):
                        my = jnp.asarray(xs[ti * sl:(ti + 1) * sl])
                        _, idx, _ = M.route(p["router"], my, cfg)
                        keeps[(di, ti)] = np.asarray(M.dispatch_indices(
                            idx, cfg.num_experts, M.moe_capacity(cfg, sl))[2])
                out[(cf, shape)] = (np.asarray(y), float(aux), keeps)
        pickle.dump(out, open({str(d / "out.pkl")!r}, "wb"))
        print("OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert "OK" in res.stdout, res.stderr[-3000:]
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x4", "2x2"])
@pytest.mark.parametrize("cf", (0.5, 8.0))
def test_moe_ffn_ep_matches_jax_ep(world, mesh, cf):
    want_y, want_aux, keeps = world["jax_ep"][(cf, mesh)]
    dropped = False
    for rank, out in enumerate(world["outs"]):
        y, kept, aux = out[("moe_ep", mesh, cf)]
        di, ti = divmod(rank, mesh[1])
        b_loc = MOE_B // mesh[0]
        np.testing.assert_allclose(y, want_y[di * b_loc:(di + 1) * b_loc],
                                   rtol=3e-4, atol=3e-5,
                                   err_msg=f"{mesh} cf {cf} rank {rank}")
        assert len(kept) == 1 and np.array_equal(kept[0], keeps[(di, ti)])
        dropped |= not kept[0].all()
        np.testing.assert_allclose(aux, want_aux, rtol=3e-4)
    assert dropped == (cf < 1.0)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x4", "2x2"])
def test_moe_ffn_ep_without_drops_equals_the_gather_path(world, mesh):
    cfg = moe_config(8.0)
    p = lm_params_from_jax(world["moe_p"])
    want, _ = moe._moe_ffn_gather(p, torch.from_numpy(world["moe_x"]), cfg)
    for rank, out in enumerate(world["outs"]):
        y = out[("moe_ep", mesh, 8.0)][0]
        b_loc = MOE_B // mesh[0]
        di = rank // mesh[1]
        np.testing.assert_allclose(y, want.numpy()[di * b_loc:
                                                   (di + 1) * b_loc],
                                   rtol=3e-4, atol=3e-5)


def test_train_step_on_a_mesh_raises_naming_13b2():
    """Training on the model axis is ROADMAP item 13b.2: nothing falls
    back to a one-device step."""
    from repro_torch.config import TrainConfig
    from repro_torch.launch.steps import build_train_step
    cfg = case_config("dense_gqa")[0]
    for mesh in MESHES:
        info = abstract_mesh_info(cfg, mesh, ("data", "model"))
        with pytest.raises(NotImplementedError, match="13b.2"):
            build_train_step(build_model(cfg), TrainConfig(), info, B)
    one = abstract_mesh_info(cfg, (1, 1), ("data", "model"))
    build_train_step(build_model(cfg), TrainConfig(), one, B)
