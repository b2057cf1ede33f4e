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

On a mesh's model axis (``sharding.context``): under ``tp`` each rank
projects its block of query heads (``wq``'s columns) and of kv heads
(``wk`` / ``wv``'s); where num_kv_heads does not divide over ``model``
(gemma-2b's one kv head at model 4: ``wk`` split inside its head) the
projected keys and values are all-gathered over ``model``, as the JAX
package's ``act_kv`` rule makes GSPMD do. ``wo`` is row-parallel (an
all-reduce over ``model``). The KV cache is sequence-sharded as
``make_cache_specs`` says: its slot dim is split over ``model`` (rank r
owns slots [r·W/m, (r+1)·W/m)) and each rank holds every kv head of its
slots. A prefill sends each position's keys and values to the rank that
owns its slot (one all-to-all over ``model``, heads -> slots, when the
heads are split); a decode step gathers the step's queries over
``model``, each rank attends over its own slots for every head, and the
partial (max, sum, output) of the ranks are merged by log-sum-exp, each
rank keeping its heads' rows for ``wo``. The same routine serves every
strategy and the ring slots and meta tokens of windowed layers.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (
    apply_rope, dense_init, rms_normalize, tp_info,
)
from repro_torch.sharding.context import current_mesh_info, shard

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
    """-> q [B, S, Hq', hd], k and v [B, S, Hk', hd]: every head on one
    device; under ``tp`` this rank's block of query heads and of kv heads
    (every kv head where they do not divide over ``model``)."""
    b, s, _ = x.shape
    hq, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    info = tp_info()
    q = shard(x @ p["wq"], "act_q", (None, s, hq * hd))
    k, v = x @ p["wk"], x @ p["wv"]
    if info is not None and k.shape[-1] < hk * hd and hk % info.tp_size:
        k = info.all_gather(k, 2, (info.tp_axis,))
        v = info.all_gather(v, 2, (info.tp_axis,))
    k = shard(k, "act_kv", (None, s, hk * hd))
    v = shard(v, "act_kv", (None, s, hk * hd))
    if cfg.qkv_bias:
        q = q + _block(p["bq"], q.shape[-1], info)
        k = k + _block(p["bk"], k.shape[-1], info)
        v = v + _block(p["bv"], v.shape[-1], info)
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = rms_normalize(q, p["q_norm"])
        k = rms_normalize(k, p["k_norm"])
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    return q, k, v


def _block(t: torch.Tensor, n: int, info) -> torch.Tensor:
    """This rank's ``n`` entries of a whole vector ``t`` split over the
    model axis (``t`` itself when it holds ``n``)."""
    if t.shape[-1] == n:
        return t
    return t.narrow(-1, info.tp_index * n, n)


def group_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_lo: int, kv_lo: int, group: int):
    """Local query heads ``q`` [B, S, Hq', hd] (global heads q_lo ...)
    with the kv heads they read from local ``k`` / ``v`` [B, T, Hk', hd]
    (global heads kv_lo ...) -> (q [B, S, Hk'', G'', hd], k, v
    [B, T, Hk'', hd]): GQA's grouping of the JAX package (query head h
    reads kv head h // group) restricted to the local query heads."""
    b, s, hq_l, hd = q.shape
    if hq_l % group == 0 and q_lo % group == 0:        # whole groups
        first, n = q_lo // group - kv_lo, hq_l // group
        g = group
    elif group % hq_l == 0:                            # inside one group
        first, n, g = q_lo // group - kv_lo, 1, hq_l
    else:                                              # one kv head each
        idx = torch.tensor([(q_lo + j) // group - kv_lo
                            for j in range(hq_l)], device=k.device)
        return (q.reshape(b, s, hq_l, 1, hd), k.index_select(2, idx),
                v.index_select(2, idx))
    if (first, n) != (0, k.shape[2]):
        k, v = k.narrow(2, first, n), v.narrow(2, first, n)
    return q.reshape(b, s, n, g, hd), k, v


def _merge_partials(part: torch.Tensor, info) -> torch.Tensor:
    """Merge per-rank partial attention over slot blocks: ``part`` [...,
    vd + 2] holds this rank's output (unnormalized), its row max and its
    row sum; the ranks' partials along the model axis are combined by
    log-sum-exp. -> the normalized output [..., vd]."""
    parts = info.all_gather(part[None], 0, (info.tp_axis,))
    o, m, lsum = parts[..., :-2], parts[..., -2:-1], parts[..., -1:]
    top = m.max(dim=0).values
    w = torch.exp(m - top)
    return (w * o).sum(dim=0) / torch.clamp((w * lsum).sum(dim=0),
                                            min=1e-30)


def partial_attention(q, k, v, q_pos, kv_pos, window=0, num_meta=0):
    """A rank's part of dense attention over its block of slots: q
    [B, Sq, Hk, G, hd], k/v [B, Tk, Hk, vd] -> [B, Sq, Hk, G, vd + 2]:
    the unnormalized output, the row max and the row sum (f32), for
    ``_merge_partials``. A row with no visible slot here has max NEG_INF
    and sum 0: it weighs nothing in the merge."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bshgd,bthd->bhgst", q, k).to(torch.float32)
    scores = scores * scale
    mask = mask_block(q_pos, kv_pos, window, num_meta)[None, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.max(dim=-1, keepdim=True).values
    p = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    o = torch.einsum("bhgst,bthv->bshgv", p.to(v.dtype), v).to(
        torch.float32)
    stats = torch.cat([m, p.sum(dim=-1, keepdim=True)], dim=-1)
    return torch.cat([o, stats.permute(0, 3, 1, 2, 4)], dim=-1)


def owned_slots(info, buf: int, held: int) -> int:
    """The first slot this rank's block of a cache of ``buf`` slots holds
    (it holds ``held``): 0 unless the slots are split over ``model``."""
    if info is None or held == buf:
        return 0
    return info.tp_index * held


def write_prefill(buf: torch.Tensor, x: torch.Tensor, lo: int,
                  info=None) -> None:
    """Write positions 0..S-1 of ``x`` [B, S, Hk', ...] into this rank's
    block of a cache ``buf`` [B, W', Hk, ...], whose first slot is ``lo``
    (``owned_slots``). With ``info``, ``x`` holds this rank's block of
    heads and the slots are split over ``model``: the block of slots rank
    j owns goes to j, all heads of it coming back (an all-to-all over
    ``model``, heads -> slots)."""
    s, held = x.shape[1], buf.shape[1]
    n = max(0, min(held, s - lo))
    if info is not None:
        send = x.new_zeros((info.tp_size, x.shape[0], held)
                           + tuple(x.shape[2:]))
        for j in range(info.tp_size):
            nj = max(0, min(held, s - j * held))
            if nj:
                send[j, :, :nj] = x[:, j * held:j * held + nj]
        got = info.all_to_all(send, (info.tp_axis,))   # [m(src), B, W', h']
        if n:
            buf[:, :n] = got.movedim(0, 2).reshape(
                buf.shape[0], held, -1, *x.shape[3:])[:, :n]
    elif n:
        buf[:, :n] = x[:, lo:lo + n]


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
    empty), every slot's (the whole cache's on a mesh). The buffers are
    written in place and returned.
    """
    b, s, _ = x.shape
    hq, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    info, tpi = current_mesh_info(), tp_info()
    q, k, v = _project_qkv(p, x, cfg, positions)
    hq_l, hk_l = q.shape[2], k.shape[2]
    q_lo = tpi.tp_index * hq_l if hq_l < hq else 0
    kv_lo = tpi.tp_index * hk_l if hk_l < hk else 0
    kv_split = hk_l < hk

    new_bufs = None
    if kv_bufs is None:
        out = self_attention(*group_heads(q, k, v, q_lo, kv_lo, hq // hk),
                             window, num_meta)
    else:
        k_buf, v_buf = kv_bufs
        buf, held = kv_pos.shape[0], k_buf.shape[1]
        if s == 1:
            out = _decode_attention(q, k, v, k_buf, v_buf, cfg, info,
                                    q_lo, kv_split, positions, kv_pos,
                                    write_slot, window, num_meta)
        else:                                        # prefill
            if s > buf:
                raise ValueError(f"attention: prefill of {s} positions into "
                                 f"a cache of {buf} slots")
            lo = owned_slots(info, buf, held)
            for cache_buf, new in ((k_buf, k), (v_buf, v)):
                if kv_split and held == buf:         # every slot, all heads
                    write_prefill(cache_buf, tpi.all_gather(
                        new, 2, (tpi.tp_axis,)), 0)
                else:
                    write_prefill(cache_buf, new, lo,
                                  tpi if kv_split else None)
            out = self_attention(*group_heads(q, k, v, q_lo, kv_lo,
                                              hq // hk), window, num_meta)
        new_bufs = (k_buf, v_buf)

    y = out.reshape(b, s, hq_l * hd) @ p["wo"]
    if tpi is not None:
        y = tpi.all_reduce(y, (tpi.tp_axis,))
    return y, new_bufs


def _decode_attention(q, k, v, k_buf, v_buf, cfg, info, q_lo, kv_split,
                      positions, kv_pos, write_slot, window, num_meta):
    """One token's attention against the cache; -> [B, 1, Hq', hd] for
    the local query heads. The new token's keys and values are written
    (every kv head) into the slot ``write_slot``, by the rank that owns
    it where the slots are split."""
    b, hd = q.shape[0], q.shape[-1]
    hq, hk = cfg.num_heads, cfg.num_kv_heads
    hq_l = q.shape[2]
    buf, held = kv_pos.shape[0], k_buf.shape[1]
    if kv_split:                                     # every kv head
        k = info.all_gather(k, 2, (info.tp_axis,))
        v = info.all_gather(v, 2, (info.tp_axis,))
    lo = owned_slots(info, buf, held)
    if lo <= write_slot < lo + held:
        k_buf[:, write_slot - lo] = k[:, 0]
        v_buf[:, write_slot - lo] = v[:, 0]
    q_pos = positions[:1, 0]
    if held == buf:                                  # every slot here
        out = attention_core(*group_heads(q, k_buf, v_buf, q_lo, 0,
                                          hq // hk), q_pos, kv_pos, window,
                             num_meta)
        return out.reshape(b, 1, hq_l, hd)
    if hq_l < hq:                                    # every query head
        q = info.all_gather(q, 2, (info.tp_axis,))
    part = partial_attention(q.reshape(b, 1, hk, hq // hk, hd), k_buf,
                             v_buf, q_pos, kv_pos[lo:lo + held], window,
                             num_meta)
    out = _merge_partials(part, info).to(v_buf.dtype).reshape(b, 1, hq, hd)
    return out.narrow(2, q_lo, hq_l)


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
    computes it in jnp: two einsums and a softmax over Tc. Under ``tp``
    each rank attends with its block of heads (the ``/cross/`` rules); the
    returned keys and values hold every head (the cache's layout: an
    all-gather over ``model``) and ``wo`` is row-parallel."""
    b, s, _ = x.shape
    hq, hd = cfg.num_heads, cfg.head_dim
    info = tp_info()
    q = (x @ p["wq"]).reshape(b, s, -1, hd)
    hq_l = q.shape[2]
    lo = info.tp_index * hq_l if hq_l < hq else 0
    if cross_kv is None:
        tc = context.shape[1]
        k = (context @ p["wk"]).reshape(b, tc, -1, hd)
        v = (context @ p["wv"]).reshape(b, tc, -1, hd)
        if k.shape[2] < hq:
            cross_kv = (info.all_gather(k, 2, (info.tp_axis,)),
                        info.all_gather(v, 2, (info.tp_axis,)))
        else:
            cross_kv = (k, v)
            k, v = k.narrow(2, lo, hq_l), v.narrow(2, lo, hq_l)
    else:
        k, v = (t.narrow(2, lo, hq_l) for t in cross_kv)
    scores = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32)
    probs = torch.softmax(scores * hd ** -0.5, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, v)
    y = out.reshape(b, s, hq_l * hd) @ p["wo"]
    if info is not None:
        y = info.all_reduce(y, (info.tp_axis,))
    return y, cross_kv
