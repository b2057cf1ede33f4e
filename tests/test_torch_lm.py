"""The serving slice as a whole against the JAX package, with the JAX
weights carried across by ``lm_params_from_jax``:

* prefill logits and caches, then 8 greedy decode steps, against JAX's
  ``build_prefill_step`` / ``build_decode_step`` (under ``jax.jit``) at
  rtol 1e-4 (atol 1e-4 of the logits' scale: a two-layer model's f32
  matmuls summed in other orders), greedy tokens equal. Five
  configurations: reduced Hymba with ``num_kv_heads=2`` (``reduced()``
  makes it MHA), reduced qwen2-1.5b, reduced mamba2-130m, reduced
  deepseek-v2-236b (MLA's latent cache and absorbed decode, one leading
  dense layer, a shared expert) and reduced dbrx-132b (LayerNorm, MoE).
  The prompt (70 tokens, 78 positions with Hymba's 8 meta tokens) runs
  past the reduced window of 64, so meta pinning and the ring buffer are
  driven, and its length has no divisor equal to the SSD chunk (32): the
  mixer picks 26 (Hymba) or 14. In the MoE models every layer's routing
  (expert ids, kept assignments) is held equal before the logits are
  compared, also with 8 experts and a capacity factor of 0.5, where
  tokens are dropped at capacity;
* ``loss_fn`` (ce and the MoE load-balance aux) of the MoE models at
  rtol 1e-4, and the MoE/MLA parameter trees carried across leaf by leaf;
* ``serve.generate`` against the JAX ``generate`` on the same weights:
  equal tokens;
* the port's counterpart of ``test_decode_matches_prefill``
  (``tests/test_arch_smoke.py``): teacher-forced decode reproduces the
  cache-free forward's logits;
* the entry points default to the card; MoE training runs on the CPU and
  defaults to the card; the fused CE's audio heads branch gives ln V on
  zero heads; ``init_params``
  draws a seed's weights as the stacking of a list of layers did.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.models.moe as jmoe  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.steps import (  # noqa: E402
    build_decode_step as jbuild_decode_step,
    build_prefill_step as jbuild_prefill_step,
)
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_jax, lm_params_to_numpy,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_decode_step, build_prefill_step,
)
from repro_torch.launch.train import run_lm_training  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCHS = ["hymba-1.5b", "qwen2-1.5b", "mamba2-130m", "deepseek-v2-236b",
         "dbrx-132b"]
MOE_ARCHS = ["deepseek-v2-236b", "dbrx-132b"]
B, S, STEPS = 2, 70, 8
RTOL = 1e-4


def _close(got, want, what):
    want = np.asarray(want)
    atol = RTOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol,
                               err_msg=what)


def _configs(arch):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    if arch == "hymba-1.5b":        # reduced() makes it MHA; keep GQA
        jcfg = dataclasses.replace(jcfg, num_kv_heads=2)
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def _weights(jmodel, seed=0):
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    return jparams, lm_params_from_jax(jax.tree.map(np.asarray, jparams))


def _buf_len(cfg):
    """generate's cache size for this prompt."""
    m = cfg.num_meta_tokens
    buf = max((cfg.sliding_window or (S + STEPS)) + m, m + 1)
    if cfg.family == "ssm":
        buf = 8
    return max(buf, S + m + (0 if cfg.sliding_window else STEPS))


def _routing_recorder(monkeypatch):
    """Record every MoE layer's (expert ids, kept assignments) in both
    packages, in call order: the JAX side through an ordered debug
    callback, which runs inside the jitted steps' layer scan."""
    got, want = [], []
    jorig, orig = jmoe.dispatch_indices, moe.dispatch_indices

    def jpatched(idx, num_experts, capacity):
        out = jorig(idx, num_experts, capacity)
        jax.debug.callback(lambda i, k: want.append((np.asarray(i),
                                                     np.asarray(k))),
                           idx, out[2], ordered=True)
        return out

    def patched(idx, num_experts, capacity):
        out = orig(idx, num_experts, capacity)
        got.append((idx.numpy().copy(), out[2].numpy().copy()))
        return out

    monkeypatch.setattr(jmoe, "dispatch_indices", jpatched)
    monkeypatch.setattr(moe, "dispatch_indices", patched)

    def check(what, jout):
        """The routing of the step just run equal on both sides."""
        jax.block_until_ready(jout)
        jax.effects_barrier()
        assert len(got) == len(want) > 0, what
        for layer, ((gi, gk), (wi, wk)) in enumerate(zip(got, want)):
            assert np.array_equal(gi, wi), f"{what}: layer {layer} experts"
            assert np.array_equal(gk, wk), f"{what}: layer {layer} kept"
        dropped = not all(k.all() for _, k in want)
        got.clear()
        want.clear()
        return dropped

    return check


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, monkeypatch):
    _prefill_decode_parity(*_configs(arch), monkeypatch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_with_drops_matches_jax(arch, monkeypatch):
    """8 experts and a capacity factor of 0.5: the prefill drops
    assignments at capacity in every MoE layer."""
    jcfg, cfg = [dataclasses.replace(c, num_experts=8, capacity_factor=0.5)
                 for c in _configs(arch)]
    assert _prefill_decode_parity(jcfg, cfg, monkeypatch)


def _prefill_decode_parity(jcfg, cfg, monkeypatch):
    """Prefill, 8 greedy decode steps and the caches against JAX's jitted
    steps; in MoE models the routing of every layer first. Returns whether
    the prefill dropped an assignment."""
    routing = (_routing_recorder(monkeypatch) if cfg.family == "moe"
               else None)
    dropped = False
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams, params = _weights(jmodel)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    buf = _buf_len(cfg)
    m = cfg.num_meta_tokens
    if cfg.sliding_window:
        assert S + m > cfg.sliding_window and buf < S + m + STEPS  # ring
    if cfg.family in ("ssm", "hybrid"):
        assert (S + m) % cfg.ssm_chunk and cfg.ssm_chunk < S + m

    jprefill = jax.jit(jbuild_prefill_step(jmodel))
    jdecode = jax.jit(jbuild_decode_step(jmodel))
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    jcache = jmodel.make_cache(B, buf)
    cache = model.make_cache(B, buf, device="cpu")
    jlogits, jcache = jprefill(jparams, {"tokens": jnp.asarray(prompts)},
                               jcache)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(prompts)},
                            cache)
    if routing:
        dropped = routing("prefill", jlogits)
    assert logits.shape == jlogits.shape
    _close(logits, jlogits, "prefill logits")
    assert cache["index"] == int(jcache["index"]) == S + m
    assert set(cache) == set(jcache)
    for key in sorted(set(cache) - {"index"}):
        _close(cache[key], jcache[key], f"prefill cache {key}")

    jtok = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
    tok = serve._sample(logits[:, -1], 0.0, None)
    for step in range(STEPS):
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), step
        jlogits, jcache = jdecode(jparams, jcache, {"token": jtok[:, None]})
        logits, cache = decode(params, cache, {"token": tok[:, None]})
        if routing:
            routing(f"decode step {step}", jlogits)
        _close(logits, jlogits, f"decode step {step} logits")
        jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        tok = serve._sample(logits, 0.0, None)
    assert cache["index"] == int(jcache["index"]) == S + m + STEPS
    for key in sorted(set(cache) - {"index"}):
        _close(cache[key], jcache[key], f"decode cache {key}")
    return dropped


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_fn_matches_jax(arch):
    """``loss_fn``'s loss, ce and aux (the MoE layers' load-balance loss,
    summed over the layers) against the JAX package's, on its weights."""
    jcfg, cfg = _configs(arch)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams, params = _weights(jmodel)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (B, 48)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, 48)).astype(np.int32)
    jloss, jm = jax.jit(jmodel.loss_fn)(
        jparams, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    with torch.no_grad():
        loss, m = model.loss_fn(params, {"tokens": torch.from_numpy(tokens),
                                         "labels": torch.from_numpy(labels)})
    assert float(jm["aux"]) > 0
    for got, want in ((loss, jloss), (m["ce"], jm["ce"]),
                      (m["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mla_params_round_trip(arch):
    """``lm_params_from_jax`` carries ``dense_layers``, ``moe/*`` (the
    shared experts included) and MLA's leaves with their layouts, and the
    port's own init gives the JAX tree's shapes."""
    jcfg, cfg = _configs(arch)
    jparams, params = _weights(jbuild_model(jcfg))
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jparams))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(
        lm_params_to_numpy(params)))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        assert np.array_equal(flat_b[path], leaf), path
    names = {jax.tree_util.keystr(path) for path, _ in flat_j}
    if arch == "deepseek-v2-236b":
        assert {"['dense_layers']['mlp']['w_in']",
                "['layers']['moe']['shared']['w_gate']",
                "['layers']['attn']['w_uk']",
                "['layers']['attn']['w_q']"} <= names
        r, h = cfg.kv_lora_rank, cfg.num_heads
        assert params["layers"]["attn"]["w_uk"].shape[1:] == (
            r, h, cfg.qk_nope_head_dim)
    else:
        assert "['layers']['moe']['w_gate']" in names
    mine = lm_params_to_numpy(build_model(cfg).init(0, device="cpu"))
    assert (jax.tree.map(lambda a: (a.shape, a.dtype), mine)
            == jax.tree.map(lambda a: (a.shape, a.dtype),
                            jax.tree.map(np.asarray, jparams)))


def test_init_params_draws_as_before():
    """Drawing layer by layer into preallocated [L, ...] leaves gives the
    weights that drawing every layer and then stacking them gave (the
    same generator calls in the same order), bit for bit."""
    cfg = get_config("hymba-1.5b").reduced()
    gen = torch.Generator().manual_seed(0)
    embed = transformer.init_embed(gen, cfg)
    meta = transformer.embed_init(gen, (cfg.num_meta_tokens, cfg.d_model))
    layers = [transformer._init_layer(gen, cfg, torch.float32)
              for _ in range(cfg.num_layers)]

    def stack(trees):
        return {k: (stack([t[k] for t in trees]) if isinstance(trees[0][k],
                                                               dict)
                    else torch.stack([t[k] for t in trees]))
                for k in trees[0]}

    want = {"embed": embed, "meta": meta, "layers": stack(layers),
            "ln_f": transformer.init_norm(cfg, cfg.d_model)}
    got = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    flat_w = jax.tree_util.tree_leaves_with_path(lm_params_to_numpy(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(
        lm_params_to_numpy(got)))
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        assert np.array_equal(flat_g[path], leaf), path


def test_init_params_with_only_dense_layers():
    """A config cut to its leading dense layers draws no MoE layer: the
    stacked layers are empty and the dense layer holds the draws that come
    right after the embedding; the model still serves."""
    cfg = get_config("deepseek-v2-236b").reduced(num_layers=1)
    assert cfg.first_dense_layers == cfg.num_layers == 1
    gen = torch.Generator().manual_seed(0)
    transformer.init_embed(gen, cfg)
    dense = transformer._init_layer(gen, cfg, torch.float32, moe_layer=False)
    got = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    assert got["layers"] == {}
    flat_w = jax.tree_util.tree_leaves_with_path(lm_params_to_numpy(dense))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(
        lm_params_to_numpy(got["dense_layers"])))
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        assert np.array_equal(flat_g[path][0], leaf), path
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    out = serve._generate(cfg, prompts, max_new_tokens=3, temperature=0.0,
                          window=0, seed=0, verbose=False, device="cpu",
                          params=got, generator=None)
    assert out["logits_finite"] and out["tokens"].shape == (2, 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_generate(arch):
    """The entry point itself, on the JAX generate's own weights (its
    config: two layers, width 128) and prompt."""
    jcfg = jget_config(arch).reduced(num_layers=2, max_d_model=128)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    want = jserve.generate(arch, prompts, max_new_tokens=6)
    got = serve.generate(arch, prompts, max_new_tokens=6, device="cpu",
                         params=lm_params_from_jax(
                             jax.tree.map(np.asarray, jparams)))
    assert got["tokens"].dtype == np.int32 and got["logits_finite"]
    assert np.array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Teacher-forced decode reproduces the cache-free forward's logits
    step by step (KV and SSM caches, ring addressing), on the port's own
    seeded init."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(1, device="cpu")
    b, s = 2, 32
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(1))
    m = cfg.num_meta_tokens
    with torch.inference_mode():
        full, _, _ = transformer.forward(params, cfg, tokens=toks)
        half = s // 2
        cache = model.make_cache(b, s + m + 2, device="cpu")
        last, cache = model.prefill(params, {"tokens": toks[:, :half]}, cache)
        outs = [last[:, -1]]
        for t in range(half, s):
            logits, cache = model.decode(params, cache,
                                         {"token": toks[:, t:t + 1]})
            outs.append(logits)
    dec = torch.stack(outs[:-1], dim=1)
    torch.testing.assert_close(dec, full[:, half - 1:s - 1], rtol=2e-3,
                               atol=2e-3)


def test_generate_temperature_uses_the_generator():
    kw = dict(max_new_tokens=5, temperature=1.0, device="cpu")
    prompts = np.zeros((2, 9), dtype=np.int32)
    params = build_model(get_config("qwen2-1.5b").reduced(
        num_layers=2, max_d_model=128)).init(0, device="cpu")
    a = serve.generate("qwen2-1.5b", prompts, params=params,
                       generator=torch.Generator().manual_seed(3), **kw)
    b = serve.generate("qwen2-1.5b", prompts, params=params,
                       generator=torch.Generator().manual_seed(3), **kw)
    assert np.array_equal(a["tokens"], b["tokens"])


def test_params_round_trip():
    jcfg, _ = _configs("hymba-1.5b")
    jparams, params = _weights(jbuild_model(jcfg))
    back = lm_params_to_numpy(params)
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jparams))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        assert np.array_equal(flat_b[path], leaf), path
    mine = lm_params_to_numpy(build_model(
        get_config("hymba-1.5b").reduced()).init(0, device="cpu"))
    want = jax.tree.map(np.asarray, jbuild_model(
        jget_config("hymba-1.5b").reduced()).init(jax.random.PRNGKey(0)))
    assert (jax.tree.map(lambda a: (a.shape, a.dtype), mine)
            == jax.tree.map(lambda a: (a.shape, a.dtype), want))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    prompts = np.zeros((1, 4), dtype=np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.generate("qwen2-1.5b", prompts, max_new_tokens=2)
    model = build_model(get_config("qwen2-1.5b").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.make_cache(1, 8)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_training_runs_on_the_cpu(arch):
    """The MoE and MLA families train through ``run_lm_training`` (reduced:
    four layers, width 256): finite losses; ``tests/test_torch_train.py``
    holds the step against JAX."""
    out = run_lm_training(arch, steps=2, batch=2, seq_len=32, device="cpu",
                          verbose=False)
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_training_defaults_to_the_card(arch):
    """Without ``device`` the entry point trains on the card; on a host
    with none it raises the card error (before any weight is drawn)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_lm_training(arch, steps=1, device=None, verbose=False)


def test_loss_fn_waits_for_the_training_slice():
    """The training slice has landed (``tests/test_torch_train.py`` holds
    it against JAX): ``loss_fn`` gives a finite loss with its metrics. So
    has the audio codebook heads' branch of the fused CE: with zero heads
    every codebook's logits are 0, so the loss is ln V exactly
    (``tests/test_torch_audio.py`` holds it against JAX)."""
    from repro_torch.models.layers import chunked_cross_entropy
    cfg = get_config("qwen2-1.5b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    loss, metrics = model.loss_fn(params, {"tokens": tokens,
                                           "labels": tokens})
    assert torch.isfinite(loss) and set(metrics) == {"ce", "aux"}
    acfg = get_config("musicgen-medium").reduced()
    k, v = acfg.num_codebooks, acfg.vocab_size
    labels = torch.zeros((1, 8, k), dtype=torch.long)
    ce = chunked_cross_entropy(None, torch.randn((1, 8, acfg.d_model)),
                               labels, acfg,
                               heads=torch.zeros(acfg.d_model, k * v))
    torch.testing.assert_close(ce, torch.tensor(np.log(v), dtype=ce.dtype))
