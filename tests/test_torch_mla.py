"""``repro_torch.models.mla`` and ``flash_attention`` at v's own head_dim
against the JAX package, on inputs made from a numpy seed (weights carried
across with ``lm_params_from_jax``):

* ``ref.flash_attention_ref`` (the kernel's plain version, what CPU
  tensors take through ``ops.flash_attention``) with vd != hd against
  JAX's ``attention_core`` (its ``_direct_attention``) and
  ``blocked_attention``, at rtol 1e-5: MLA's reduced (24, 16) and
  full-width (192, 128), and (64, 32), (96, 128), (320, 256) with GQA, a
  window and meta tokens. The scale is q's and k's head_dim's;
* ``mla_attention``'s prefill (the latent expanded into per-head K and V,
  then ``ops.flash_attention``) and its absorbed decode against the latent
  cache, with ``q_lora_rank`` 0 (``reduced()``) and > 0 (DeepSeek-V2's
  own form), at rtol 1e-4: outputs and the latent and rotated-key caches;
* the wrapper's guards: k and v of one [B, Hkv, T]; at vd != hd the
  backward is ``flash_attention_bwd_vd`` (``flash_attention_bwd`` refuses
  it), which runs on CUDA tensors only and raises past hd 256 or vd 128;
* the output's allocation: q's layout at every vd (``torch.empty_like``'s
  at vd = hd for a dense q).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.models.mla as jmla  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.attention import (  # noqa: E402
    attention_core, blocked_attention,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _bwd_vd_widths, _empty_out, flash_attention_bwd, flash_attention_bwd_vd,
)
from repro_torch.models import mla  # noqa: E402


def _qkv(rng, b, hq, hkv, s, hd, vd):
    return [(rng.standard_normal((b, s, h, d)) * 0.5).astype(np.float32)
            for h, d in ((hq, hd), (hkv, hd), (hkv, vd))]


@pytest.mark.parametrize("b,hq,hkv,s,hd,vd,window,num_meta", [
    (2, 4, 4, 70, 24, 16, 0, 0),           # reduced deepseek-v2's MLA
    (1, 2, 2, 130, 192, 128, 0, 0),        # DeepSeek-V2's q/k 192, v 128
    (2, 4, 1, 150, 64, 32, 48, 5),         # GQA 4/1, window + meta
    (2, 4, 1, 150, 96, 128, 48, 5),
    (1, 4, 1, 140, 320, 256, 64, 8),
])
def test_flash_attention_ref_vd_matches_jax(b, hq, hkv, s, hd, vd, window,
                                            num_meta):
    q, k, v = _qkv(np.random.default_rng(hd + vd), b, hq, hkv, s, hd, vd)
    pos = jnp.arange(s)
    jq = jnp.asarray(q).reshape(b, s, hkv, hq // hkv, hd)
    want = np.asarray(attention_core(jq, jnp.asarray(k), jnp.asarray(v), pos,
                                     pos, window, num_meta))
    blocked = np.asarray(blocked_attention(jq, jnp.asarray(k), jnp.asarray(v),
                                           pos, pos, window, num_meta,
                                           q_block=32, k_block=64))
    tq, tk, tv = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    got = ref.flash_attention_ref(tq, tk, tv, window=window,
                                  num_meta=num_meta)
    via_ops = ops.flash_attention(tq, tk, tv, window=window,
                                  num_meta=num_meta)
    assert got.shape == (b, hq, s, vd)
    assert torch.equal(via_ops, got)           # CPU tensors: the plain version
    got = got.transpose(1, 2).reshape(want.shape).numpy()
    for w in (want, blocked):
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5)


def test_flash_attention_guards_vd():
    q, k, v = [torch.zeros((1, 2, 8, d)) for d in (24, 24, 16)]
    with pytest.raises(ValueError, match="Hkv, T, vd"):
        ops.flash_attention(q, k, v[:, :, :7])
    with pytest.raises(ValueError, match="Hkv, T, vd"):
        ops.flash_attention(q, k, v[..., :0])
    lse = torch.zeros((1, 2, 8))
    out = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="flash_attention_bwd_vd takes it"):
        flash_attention_bwd(q, k, v, out, out, lse)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention_bwd_vd(q, k, v, out, out, lse)
    q, k, v = [torch.zeros((1, 2, 8, d)) for d in (320, 320, 256)]
    with pytest.raises(ValueError, match="vd <= 128"):
        flash_attention_bwd_vd(q, k, v, out, out, lse)


@pytest.mark.parametrize("hd,vd,widths", [
    (24, 16, (64, 64)),      # reduced deepseek-v2's MLA
    (64, 32, (64, 64)),
    (32, 64, (64, 64)),
    (96, 128, (192, 128)),   # vd > hd
    (160, 64, (192, 128)),
    (192, 128, (192, 128)),  # DeepSeek-V2's MLA
])
def test_flash_attention_bwd_vd_widths(hd, vd, widths):
    """The (HD, VD) instantiation of flash_attention_bwd_vd's wgmma passes
    that a shape runs at, whose widths size the GQA partials: whole
    64-column chunks, (64, 64) where hd and vd fit, else (192, 128)."""
    assert _bwd_vd_widths(hd, vd) == widths


def _layout(t):
    """Strides of the dims that hold more than one element."""
    return [st for st, n in zip(t.stride(), t.shape) if n > 1]


@pytest.mark.parametrize("shape,perm", [
    ((2, 3, 5, 8), (0, 1, 2, 3)),          # [B, H, S, hd]
    ((2, 5, 3, 8), (0, 2, 1, 3)),          # the model's [B, S, H, hd] view
    ((1, 5, 1, 8), (0, 2, 1, 3)),          # one batch row, one head
    ((3, 5, 2, 8), (2, 0, 1, 3)),          # [H, B, S, hd] memory
])
def test_flash_output_keeps_q_layout(shape, perm):
    """The output is laid out as q is, its head_dim innermost: at vd = hd
    as ``torch.empty_like(q)`` lays a dense q out, at vd != hd the same
    order of the first three dims."""
    q = torch.empty(shape).permute(*perm)
    assert _layout(_empty_out(q, 8)) == _layout(torch.empty_like(q))
    for vd in (4, 8, 12):
        out = _empty_out(q, vd)
        want = torch.empty(shape[:3] + (vd,)).permute(*perm)
        assert out.shape == want.shape
        assert _layout(out) == _layout(want)


def _cfgs(q_lora_rank):
    jcfg = dataclasses.replace(jget_config("deepseek-v2-236b").reduced(),
                               q_lora_rank=q_lora_rank)
    cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                              q_lora_rank=q_lora_rank)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


@pytest.mark.parametrize("q_lora_rank", [0, 48])
def test_mla_prefill_and_absorbed_decode_match_jax(q_lora_rank):
    """A prefill of 40 positions into a 48-slot latent cache, then 6 decode
    steps, each against the JAX layer on the JAX buffers."""
    jcfg, cfg = _cfgs(q_lora_rank)
    jp = jmla.init_mla(jax.random.PRNGKey(1), jcfg, jnp.float32)
    p = lm_params_from_jax(jax.tree.map(np.asarray, jp))
    assert ("w_uq" in p) == (q_lora_rank > 0)
    rng = np.random.default_rng(q_lora_rank)
    b, s, buf, steps = 2, 40, 48, 6
    x = rng.standard_normal((b, s + steps, cfg.d_model)).astype(np.float32)
    r, rope_d = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    jbufs = (jnp.zeros((b, buf, r)), jnp.zeros((b, buf, rope_d)))
    bufs = (torch.zeros((b, buf, r)), torch.zeros((b, buf, rope_d)))
    slots = np.arange(buf)
    kv_pos = np.where(slots < s, slots, -1).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))

    jy, jbufs = jmla.mla_attention(jp, jnp.asarray(x[:, :s]), jcfg,
                                   positions=jnp.asarray(pos),
                                   kv_bufs=jbufs, kv_pos=jnp.asarray(kv_pos))
    y, bufs = mla.mla_attention(p, torch.from_numpy(x[:, :s]), cfg,
                                positions=torch.from_numpy(pos.copy()),
                                kv_bufs=bufs, kv_pos=torch.from_numpy(kv_pos))
    _close(y, jy, "prefill")
    for g, w, name in zip(bufs, jbufs, ("latent", "k_rope")):
        _close(g, w, f"prefill {name}")

    for t in range(s, s + steps):
        kv_pos[t] = t
        pos1 = np.full((b, 1), t, dtype=np.int32)
        jy, jbufs = jmla.mla_attention(
            jp, jnp.asarray(x[:, t:t + 1]), jcfg, positions=jnp.asarray(pos1),
            kv_bufs=jbufs, kv_pos=jnp.asarray(kv_pos), write_slot=t)
        y, bufs = mla.mla_attention(
            p, torch.from_numpy(x[:, t:t + 1]), cfg,
            positions=torch.from_numpy(pos1), kv_bufs=bufs,
            kv_pos=torch.from_numpy(kv_pos.copy()), write_slot=t)
        _close(y, jy, f"decode position {t}")
        for g, w, name in zip(bufs, jbufs, ("latent", "k_rope")):
            _close(g, w, f"decode position {t} {name}")


@pytest.mark.parametrize("q_lora_rank", [0, 48])
def test_mla_cache_free_forward_matches_jax(q_lora_rank):
    """The training / cache-free form (no buffers) with a window and meta
    tokens, as ``attention_core`` masks them."""
    jcfg, cfg = _cfgs(q_lora_rank)
    jp = jmla.init_mla(jax.random.PRNGKey(2), jcfg, jnp.float32)
    p = lm_params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(7).standard_normal(
        (2, 50, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(50, dtype=np.int32)[None], (2, 50))
    jy, jnew = jmla.mla_attention(jp, jnp.asarray(x), jcfg,
                                  positions=jnp.asarray(pos), window=16,
                                  num_meta=3)
    y, new = mla.mla_attention(p, torch.from_numpy(x), cfg,
                               positions=torch.from_numpy(pos.copy()),
                               window=16, num_meta=3)
    assert jnew is None and new is None
    _close(y, jy, "cache-free forward")


def test_init_mla_tree_matches_jax():
    for q_lora_rank in (0, 48):
        jcfg, cfg = _cfgs(q_lora_rank)
        want = jax.tree.map(
            lambda a: (a.shape, str(a.dtype)),
            jmla.init_mla(jax.random.PRNGKey(0), jcfg, jnp.float32))
        got = mla.init_mla(torch.Generator().manual_seed(0), cfg)
        assert {k: (tuple(t.shape), str(t.dtype)[6:])
                for k, t in got.items()} == want
