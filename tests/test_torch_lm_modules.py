"""The port's LM modules against their JAX counterparts on the same numpy
inputs and weights: norms, RoPE, every MLP variant, embedding and logits,
the mask and ring addressing, ``attention`` (cache-free, prefill, decode)
and ``ssm_mixer`` (cache-free, prefill, decode). Tolerance rtol 1e-5 with
an atol of 1e-5 of the output's scale: both sides compute in f32, and
their matmuls sum in other orders, which moves the last bits of values
near zero.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention, layers, ssm  # noqa: E402

RTOL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=atol)


def _cfgs(**kw):
    base = dict(name="t", family="dense", num_layers=1, d_model=64,
                vocab_size=97, num_heads=4, num_kv_heads=2, d_ff=96)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "rmsnorm_p1",
                                       "layernorm"])
def test_apply_norm(norm_type):
    jcfg, cfg = _cfgs(norm_type=norm_type, norm_eps=1e-5)
    jp = jlayers.init_norm(jcfg, 64, jnp.float32)
    jp = {k: v + 0.1 * _x(64, seed=i) for i, (k, v) in enumerate(jp.items())}
    x = _x(2, 5, 64, seed=3, scale=2.0)
    want = jlayers.apply_norm(jp, jnp.asarray(x), jcfg)
    _close(layers.apply_norm(params_from_jax(_np_tree(jp)),
                             torch.from_numpy(x), cfg), want)
    ref_p = layers.init_norm(cfg, 64)
    assert set(ref_p) == set(jp)


def test_rms_normalize():
    x, s = _x(3, 7, 32, seed=1), _x(32, seed=2)
    want = jlayers.rms_normalize(jnp.asarray(x), jnp.asarray(s))
    _close(layers.rms_normalize(torch.from_numpy(x), torch.from_numpy(s)),
           want)


@pytest.mark.parametrize("rope_pct,theta", [(1.0, 10000.0), (0.5, 1e6)])
def test_rope(rope_pct, theta):
    jcfg, cfg = _cfgs(rope_pct=rope_pct, rope_theta=theta)
    x = _x(2, 9, 4, 16, seed=4)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32) + 100, (2, 9))
    _close(layers.rope_frequencies(cfg, 16),
           jlayers.rope_frequencies(jcfg, 16))
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                            cfg)
    _close(got, want)


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "squared_relu",
                                     "gelu"])
@pytest.mark.parametrize("bias", [False, True])
def test_mlp(variant, bias):
    jcfg, cfg = _cfgs(mlp_variant=variant, mlp_bias=bias)
    jp = _np_tree(jlayers.init_mlp(jax.random.PRNGKey(1), jcfg, 64, 96,
                                   jnp.float32))
    if bias:
        jp["b_in"], jp["b_out"] = _x(96, seed=5), _x(64, seed=6)
    x = _x(2, 5, 64, seed=7)
    want = jlayers.apply_mlp(jp, jnp.asarray(x), jcfg)
    _close(layers.apply_mlp(params_from_jax(jp), torch.from_numpy(x), cfg),
           want)
    mine = layers.init_mlp(torch.Generator().manual_seed(0), cfg, 64, 96)
    assert {k: v.shape for k, v in mine.items()} == {
        k: torch.Size(v.shape) for k, v in jp.items()}


@pytest.mark.parametrize("tie,softcap,embed_scale", [
    (False, 0.0, False), (True, 0.0, False), (True, 30.0, True)])
def test_embed_and_logits(tie, softcap, embed_scale):
    jcfg, cfg = _cfgs(tie_embeddings=tie, logit_softcap=softcap,
                      embed_scale=embed_scale)
    jp = _np_tree(jlayers.init_embed(jax.random.PRNGKey(2), jcfg,
                                     jnp.float32))
    toks = np.random.default_rng(0).integers(0, 97, (2, 6)).astype(np.int32)
    p = params_from_jax(jp)
    x = layers.embed_tokens(p, torch.from_numpy(toks), cfg)
    _close(x, jlayers.embed_tokens(jp, jnp.asarray(toks), jcfg))
    h = _x(2, 6, 64, seed=8)
    _close(layers.compute_logits(p, torch.from_numpy(h), cfg),
           jlayers.compute_logits(jp, jnp.asarray(h), jcfg))
    mine = layers.init_embed(torch.Generator().manual_seed(0), cfg)
    assert set(mine) == set(jp)


def test_mask_block_and_write_slot():
    q = np.arange(40, 45, dtype=np.int32)
    kv = np.array([0, 1, 2, 3, 44, 40, 41, 42, 43, -1, 10, 20],
                  dtype=np.int32)
    for window, meta in ((0, 0), (3, 0), (3, 4), (0, 4)):
        want = jattn.mask_block(jnp.asarray(q), jnp.asarray(kv), window, meta)
        got = attention.mask_block(torch.from_numpy(q), torch.from_numpy(kv),
                                   window, meta)
        assert np.array_equal(got.numpy(), np.asarray(want))
    for buf, meta in ((12, 4), (12, 0), (5, 8), (1, 0)):
        for idx in range(30):
            assert attention.cache_write_slot(buf, idx, meta) == int(
                jattn.cache_write_slot(buf, idx, meta))


def _attn_setup(**kw):
    jcfg, cfg = _cfgs(**kw)
    jp = _np_tree(jattn.init_attention(jax.random.PRNGKey(3), jcfg,
                                       jnp.float32))
    if jcfg.qkv_bias:
        for i, k in enumerate(("bq", "bk", "bv")):
            jp[k] = 0.1 * _x(*jp[k].shape, seed=20 + i)
    if jcfg.qk_norm:
        jp["q_norm"] = 1.0 + 0.1 * _x(16, seed=30)
        jp["k_norm"] = 1.0 + 0.1 * _x(16, seed=31)
    return jcfg, cfg, jp, params_from_jax(jp)


ATTN_CASES = [dict(), dict(qkv_bias=True), dict(qk_norm=True),
              dict(num_kv_heads=4), dict(num_kv_heads=1)]


@pytest.mark.parametrize("kw", ATTN_CASES)
@pytest.mark.parametrize("window,num_meta", [(0, 0), (8, 3)])
def test_attention_cache_free(kw, window, num_meta):
    jcfg, cfg, jp, p = _attn_setup(**kw)
    s = 21
    x = _x(2, s, 64, seed=9)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want, _ = jattn.attention(jp, jnp.asarray(x), jcfg,
                              positions=jnp.asarray(pos), window=window,
                              num_meta=num_meta)
    got, bufs = attention.attention(p, torch.from_numpy(x), cfg,
                                    positions=torch.from_numpy(pos),
                                    window=window, num_meta=num_meta)
    assert bufs is None
    _close(got, want)


@pytest.mark.parametrize("kw", ATTN_CASES[:3])
@pytest.mark.parametrize("window,num_meta", [(0, 0), (8, 3)])
def test_attention_prefill_then_decode(kw, window, num_meta):
    """Prefill into a ring buffer of window + meta slots, then decode steps
    past its end (ring addressing, pinned meta slots)."""
    jcfg, cfg, jp, p = _attn_setup(**kw)
    b, s, hk, hd = 2, 10, cfg.num_kv_heads, cfg.head_dim
    buf = max(s, (window or 16) + num_meta)
    x = _x(b, s + 6, 64, seed=10)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    jk = jnp.zeros((b, buf, hk, hd))
    jv = jnp.zeros((b, buf, hk, hd))
    kbuf = torch.zeros((b, buf, hk, hd))
    vbuf = torch.zeros((b, buf, hk, hd))
    slots = np.arange(buf)
    kv_pos = np.where(slots < s, slots, -1).astype(np.int32)
    want, (jk, jv) = jattn.attention(
        jp, jnp.asarray(x[:, :s]), jcfg, positions=jnp.asarray(pos),
        window=window, num_meta=num_meta, kv_bufs=(jk, jv),
        kv_pos=jnp.asarray(kv_pos))
    got, (kbuf, vbuf) = attention.attention(
        p, torch.from_numpy(x[:, :s].copy()), cfg,
        positions=torch.from_numpy(pos), window=window, num_meta=num_meta,
        kv_bufs=(kbuf, vbuf), kv_pos=torch.from_numpy(kv_pos))
    _close(got, want)
    _close(kbuf, jk)
    _close(vbuf, jv)
    for idx in range(s, s + 6):
        slot = attention.cache_write_slot(buf, idx, num_meta)
        kv_pos[slot] = idx
        step_pos = np.full((b, 1), idx, dtype=np.int32)
        xs = x[:, idx:idx + 1].copy()
        want, (jk, jv) = jattn.attention(
            jp, jnp.asarray(xs), jcfg, positions=jnp.asarray(step_pos),
            window=window, num_meta=num_meta, kv_bufs=(jk, jv),
            kv_pos=jnp.asarray(kv_pos), write_slot=jnp.int32(slot))
        got, (kbuf, vbuf) = attention.attention(
            p, torch.from_numpy(xs), cfg, positions=torch.from_numpy(step_pos),
            window=window, num_meta=num_meta, kv_bufs=(kbuf, vbuf),
            kv_pos=torch.from_numpy(kv_pos.copy()), write_slot=slot)
        _close(got, want)
        _close(kbuf, jk)


def _ssm_setup(nstate=16, headdim=16, chunk=32):
    jcfg = JModelConfig(name="t", family="ssm", num_layers=1, d_model=64,
                        vocab_size=97, ssm_state=nstate,
                        ssm_head_dim=headdim, ssm_chunk=chunk)
    jdims = jssm.ssm_dims(jcfg)
    dims = ssm.ssm_dims(ModelConfig(**dataclasses.asdict(jcfg)))
    assert dataclasses.asdict(dims) == dataclasses.asdict(jdims)
    jp = _np_tree(jssm.init_ssm(jax.random.PRNGKey(4), jdims, jnp.float32))
    jp["conv_b"] = 0.1 * _x(*jp["conv_b"].shape, seed=40)
    jp["D"] = 1.0 + 0.1 * _x(*jp["D"].shape, seed=41)
    mine = ssm.init_ssm(torch.Generator().manual_seed(0), dims)
    assert {k: v.shape for k, v in mine.items()} == {
        k: torch.Size(v.shape) for k, v in jp.items()}
    return jdims, dims, jp, params_from_jax(jp)


@pytest.mark.parametrize("s", [64, 70, 5])
def test_ssm_mixer_cache_free(s):
    jdims, dims, jp, p = _ssm_setup()
    x = _x(2, s, 64, seed=11)
    want, _ = jssm.ssm_mixer(jp, jnp.asarray(x), jdims)
    got, cache = ssm.ssm_mixer(p, torch.from_numpy(x), dims)
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("s,nstate,chunk", [(70, 16, 32), (48, 24, 16)])
def test_ssm_mixer_prefill_then_decode(s, nstate, chunk):
    jdims, dims, jp, p = _ssm_setup(nstate=nstate, chunk=chunk)
    b = 2
    x = _x(b, s + 5, 64, seed=12)
    jcache = jssm.init_ssm_cache(b, jdims, jnp.float32)
    cache = ssm.init_ssm_cache(b, dims)
    want, jcache = jssm.ssm_mixer(jp, jnp.asarray(x[:, :s]), jdims,
                                  cache=jcache)
    got, cache = ssm.ssm_mixer(p, torch.from_numpy(x[:, :s].copy()), dims,
                               cache=cache)
    _close(got, want)
    for key in ("conv", "state"):
        _close(cache[key], jcache[key])
    for t in range(s, s + 5):
        xs = x[:, t:t + 1].copy()
        want, jcache = jssm.ssm_mixer(jp, jnp.asarray(xs), jdims,
                                      cache=jcache)
        got, cache = ssm.ssm_mixer(p, torch.from_numpy(xs), dims,
                                   cache=cache)
        _close(got, want)
        for key in ("conv", "state"):
            _close(cache[key], jcache[key])
