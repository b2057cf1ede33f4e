"""Attention (the counterpart of ``repro.models.attention``): GQA/MQA/MHA
with RoPE, qk-norm, sliding windows, meta-token pinning and full or
ring-buffer KV caches; and the audio family's cross-attention over a
conditioning context.

The port's dispatcher: self-attention over positions 0..S-1 (prefill and
the cache-free forward) goes to the ``flash_attention`` kernel through
``ops`` whatever S is — the JAX package's switch to its jnp blocked path
at 4096 query rows does not apply here. One-token decode against the ring
buffer stays plain PyTorch (``attention_core``: ``mask_block`` plus a
softmax), as the JAX package computes it outside Pallas.

Cache layout is owned by ``transformer.py`` (buffers of all layers stacked
``[L, ...]``); this module works on one layer's buffers, and writes a step's
keys and values into them IN PLACE (the JAX package returns updated copies):
a decode step then moves one slot, not the whole buffer. ``window`` and
``num_meta`` are Python ints.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, rms_normalize

NEG_INF = -1e30
_BIG = 2 ** 30


# ---------------------------------------------------------------------------
# Masking
# ---------------------------------------------------------------------------

def mask_block(q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int = 0,
               num_meta: int = 0) -> torch.Tensor:
    """[Sq, Tk] visibility. window<=0 => full causal. kv slots with pos < 0
    are empty. kv positions < num_meta are always visible (pinned meta)."""
    q = q_pos[:, None].to(torch.int64)
    k = kv_pos[None, :].to(torch.int64)
    eff_w = window if window > 0 else _BIG
    visible = ((q - k) < eff_w) | (k < num_meta)
    return (k >= 0) & (k <= q) & visible


# ---------------------------------------------------------------------------
# Attention cores (q grouped for GQA: [B,S,Hk,G,hd])
# ---------------------------------------------------------------------------

def attention_core(q, k, v, q_pos, kv_pos, window=0, num_meta=0):
    """Dense attention at arbitrary query and slot positions, plain
    PyTorch (the JAX package's ``_direct_attention``): the one-token decode
    step against the ring buffer. q [B,Sq,Hk,G,hd], k/v [B,Tk,Hk,hd] ->
    [B,Sq,Hk,G,hd]. The JAX ``attention_core``'s switch between its dense
    and blocked forms lives in ``attention`` here: positions 0..S-1 go to
    the kernel (``self_attention``)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bshgd,bthd->bhgst", q, k).to(torch.float32)
    scores = scores * scale
    mask = mask_block(q_pos, kv_pos, window, num_meta)
    scores = torch.where(mask[None, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhgst,bthv->bshgv", probs, v)


def self_attention(q, k, v, window=0, num_meta=0):
    """Attention of positions 0..S-1 over themselves through the
    ``flash_attention`` kernel. q [B,S,Hk,G,hd], k/v [B,S,Hk,hd] ->
    [B,S,Hk,G,hd]. The [B, S, H, hd] tensors are handed over as
    [B, H, S, hd] views; the kernel reads and writes them by strides."""
    b, s, hk, g, hd = q.shape
    out = ops.flash_attention(q.reshape(b, s, hk * g, hd).transpose(1, 2),
                              k.transpose(1, 2), v.transpose(1, 2),
                              window=window, num_meta=num_meta)
    return out.transpose(1, 2).reshape(b, s, hk, g, hd)


# ---------------------------------------------------------------------------
# Ring-buffer slot addressing
# ---------------------------------------------------------------------------

def cache_write_slot(buf_len: int, index: int, num_meta: int) -> int:
    """Ring addressing with the first ``num_meta`` slots pinned. Positions
    < num_meta map to their own slot; later positions ring over the rest.
    For a full cache (buf_len >= total length) this is the identity."""
    if index < min(buf_len, num_meta):
        return index
    return num_meta + (index - num_meta) % max(buf_len - num_meta, 1)


# ---------------------------------------------------------------------------
# Standard (non-MLA) attention block
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg, dtype=torch.float32) -> Dict:
    hq, hk, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    p = {
        "wq": dense_init(gen, d, (d, hq * hd), dtype),
        "wk": dense_init(gen, d, (d, hk * hd), dtype),
        "wv": dense_init(gen, d, (d, hk * hd), dtype),
        "wo": dense_init(gen, hq * hd, (hq * hd, d), dtype),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((hk * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((hk * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    b, s, _ = x.shape
    hq, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hk, hd)
    v = v.reshape(b, s, hk, hd)
    if cfg.qk_norm:
        q = rms_normalize(q, p["q_norm"])
        k = rms_normalize(k, p["k_norm"])
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    return q, k, v


def attention(p: Dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              window: int = 0, num_meta: int = 0,
              kv_bufs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              kv_pos: Optional[torch.Tensor] = None,
              write_slot: Optional[int] = None,
              ) -> Tuple[torch.Tensor,
                         Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """One layer of self-attention.

    Train (no cache):      kv_bufs is None.
    Prefill (fill cache):  kv_bufs given, S > 1 -> keys/values written to
                           slots [0:S).
    Decode (one token):    kv_bufs given, S == 1, write_slot = ring slot.
    Without a cache and at prefill, ``positions`` must run 0..S-1 (what
    ``transformer.forward`` gives): the kernel masks by those positions.
    kv_pos: absolute position per cache slot AFTER this step's write (-1
    empty). The buffers are written in place and returned.
    """
    b, s, _ = x.shape
    hq, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg, positions)
    q = q.reshape(b, s, hk, hq // hk, hd)

    new_bufs = None
    if kv_bufs is None:
        out = self_attention(q, k, v, window, num_meta)
    else:
        k_buf, v_buf = kv_bufs
        if s == 1:
            k_buf[:, write_slot] = k[:, 0]
            v_buf[:, write_slot] = v[:, 0]
            out = attention_core(q, k_buf, v_buf, positions[:1, 0], kv_pos,
                                 window, num_meta)
        else:                                        # prefill
            if s > k_buf.shape[1]:
                raise ValueError(f"attention: prefill of {s} positions into "
                                 f"a cache of {k_buf.shape[1]} slots")
            k_buf[:, :s] = k
            v_buf[:, :s] = v
            out = self_attention(q, k, v, window, num_meta)
        new_bufs = (k_buf, v_buf)

    y = out.reshape(b, s, hq * hd) @ p["wo"]
    return y, new_bufs


# ---------------------------------------------------------------------------
# Cross-attention (musicgen conditioning)
# ---------------------------------------------------------------------------

def init_cross_attention(gen: torch.Generator, cfg,
                         dtype=torch.float32) -> Dict:
    hq, hd, d = cfg.num_heads, cfg.head_dim, cfg.d_model
    cd = cfg.cross_context_dim or d
    return {
        "wq": dense_init(gen, d, (d, hq * hd), dtype),
        "wk": dense_init(gen, cd, (cd, hq * hd), dtype),
        "wv": dense_init(gen, cd, (cd, hq * hd), dtype),
        "wo": dense_init(gen, hq * hd, (hq * hd, d), dtype),
    }


def cross_attention(p: Dict, x: torch.Tensor, cfg, *,
                    context: Optional[torch.Tensor] = None,
                    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]]
                    = None,
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """Attention of x's positions over every position of a conditioning
    context, unmasked. Either ``context`` [B, Tc, cd] (training and
    prefill: its keys and values are computed and returned, for the cache)
    or the cached ``cross_kv`` (decode). Plain PyTorch, as the JAX package
    computes it in jnp: two einsums and a softmax over Tc."""
    b, s, _ = x.shape
    hq, hd = cfg.num_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    if cross_kv is None:
        tc = context.shape[1]
        k = (context @ p["wk"]).reshape(b, tc, hq, hd)
        v = (context @ p["wv"]).reshape(b, tc, hq, hd)
    else:
        k, v = cross_kv
    scores = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32)
    probs = torch.softmax(scores * hd ** -0.5, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, v)
    return out.reshape(b, s, hq * hd) @ p["wo"], (k, v)
