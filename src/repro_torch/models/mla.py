"""Multi-head Latent Attention (the counterpart of ``repro.models.mla``;
DeepSeek-V2, arXiv:2405.04434).

Prefill (and the cache-free forward) expands the compressed latent into
per-head K and V and runs the ``flash_attention`` kernel through ``ops``
with v's own head_dim: q/k ``nope + rope`` (192 at full width), v
``v_head_dim`` (128). This is the port's dispatcher rule of
``models/attention.py``: self-attention over positions 0..S-1 goes to the
kernel, where the JAX package calls its jnp ``attention_core``. Decode is
the ABSORBED form, plain PyTorch as in the JAX package: W_uk folds into the
query and W_uv into the output, so a step attends straight over the latent
cache, ``kv_lora_rank + rope`` wide per position instead of
``2 * num_heads * head_dim``.

The cache is one layer's ``(latent [B, W, r], k_rope [B, W, rope])``
buffers, written IN PLACE as in ``models/attention.py``; the latent is
stored after its RMS norm and ``k_rope`` after its rotation (at
``head_dim = rope``).

On a mesh's model axis under ``tp``: ``w_uq`` / ``w_uk`` / ``w_uv`` (and
``wo``'s rows) hold this rank's block of heads, ``w_dq`` / ``w_dkv`` /
``w_kr`` are whole, so the latent is computed on every rank and each
writes its own block of the cache's slots. The absorbed decode gathers
the step's absorbed queries over ``model``, attends over its own slots
for every head and merges the ranks' partials by log-sum-exp, as
``models/attention.py`` does over its keys.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.attention import (
    NEG_INF, _merge_partials, mask_block, owned_slots, write_prefill,
)
from repro_torch.models.layers import (
    apply_rope, dense_init, rms_normalize, tp_info,
)
from repro_torch.sharding.context import current_mesh_info


def init_mla(gen: torch.Generator, cfg, dtype=torch.float32) -> Dict:
    d, h = cfg.d_model, cfg.num_heads
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    nope, rope_d, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
    p = {
        "w_dkv": dense_init(gen, d, (d, r), dtype),
        "kv_norm": torch.ones((r,), dtype=dtype, device=gen.device),
        "w_uk": dense_init(gen, r, (r, h, nope), dtype),
        "w_uv": dense_init(gen, r, (r, h, vd), dtype),
        "w_kr": dense_init(gen, d, (d, rope_d), dtype),
        "wo": dense_init(gen, h * vd, (h * vd, d), dtype),
    }
    if qr > 0:
        p["w_dq"] = dense_init(gen, d, (d, qr), dtype)
        p["q_norm"] = torch.ones((qr,), dtype=dtype, device=gen.device)
        p["w_uq"] = dense_init(gen, qr, (qr, h, nope + rope_d), dtype)
    else:
        p["w_q"] = dense_init(gen, d, (d, h, nope + rope_d), dtype)
    return p


def _queries(p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """-> (q_nope [B, S, H, nope], q_rope [B, S, H, rope], rotated)."""
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank > 0:
        q = rms_normalize(x @ p["w_dq"], p["q_norm"])
        q = torch.einsum("bsq,qhd->bshd", q, p["w_uq"])
    else:
        q = torch.einsum("bsd,dhe->bshe", x, p["w_q"])
    q_rope = apply_rope(q[..., nope:], positions, cfg, head_dim=rope_d)
    return q[..., :nope], q_rope


def _latent(p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """-> (c [B, S, r] after its RMS norm, k_rope [B, S, rope] rotated)."""
    c = rms_normalize(x @ p["w_dkv"], p["kv_norm"])
    k_rope = apply_rope(x @ p["w_kr"], positions, cfg,
                        head_dim=cfg.qk_rope_head_dim)
    return c, k_rope


def mla_attention(p: Dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                  window: int = 0, num_meta: int = 0,
                  kv_bufs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  kv_pos: Optional[torch.Tensor] = None,
                  write_slot: Optional[int] = None,
                  ) -> Tuple[torch.Tensor,
                             Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """One layer of MLA. ``kv_bufs`` = (latent [B, W, r], k_rope
    [B, W, rope]) when serving, written in place and returned; the
    arguments are ``models/attention.py`` ``attention``'s (train: no
    cache; prefill: S > 1 from position 0; decode: S == 1 at
    ``write_slot``, ``kv_pos`` the slots' positions after the write)."""
    b, s, _ = x.shape
    nope, rope_d, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
    info, tpi = current_mesh_info(), tp_info()
    h = p["w_uk"].shape[1]                           # this rank's heads
    lo_h = tpi.tp_index * h if h < cfg.num_heads else 0
    q_nope, q_rope = _queries(p, x, cfg, positions)
    if q_nope.shape[2] > h:                          # w_q is whole
        q_nope, q_rope = q_nope.narrow(2, lo_h, h), q_rope.narrow(2, lo_h, h)
    c, k_rope = _latent(p, x, cfg, positions)

    if kv_bufs is not None and s == 1:
        # ---- absorbed decode against the latent cache ----
        lat_buf, kr_buf = kv_bufs
        buf, held = kv_pos.shape[0], lat_buf.shape[1]
        lo = owned_slots(info, buf, held)
        if lo <= write_slot < lo + held:
            lat_buf[:, write_slot - lo] = c[:, 0]
            kr_buf[:, write_slot - lo] = k_rope[:, 0]
        # absorb W_uk into q: [B,1,H,nope] x [r,H,nope] -> [B,H,r]
        q_lat = torch.einsum("bshd,rhd->bhr", q_nope, p["w_uk"])
        q_rope = q_rope[:, 0]                                   # [B,H,rope]
        if held < buf and h < cfg.num_heads:         # every head's query
            q_lat = tpi.all_gather(q_lat, 1, (tpi.tp_axis,))
            q_rope = tpi.all_gather(q_rope, 1, (tpi.tp_axis,))
        s_lat = torch.einsum("bhr,btr->bht", q_lat, lat_buf)
        s_rope = torch.einsum("bhe,bte->bht", q_rope, kr_buf)
        scores = (s_lat + s_rope).to(torch.float32) * (nope + rope_d) ** -0.5
        msk = mask_block(positions[:1, 0], kv_pos[lo:lo + held], window,
                         num_meta)[0]
        scores = torch.where(msk[None, None], scores,
                             torch.full_like(scores, NEG_INF))
        if held == buf:
            probs = torch.softmax(scores, dim=-1).to(lat_buf.dtype)
            ctx_lat = torch.einsum("bht,btr->bhr", probs, lat_buf)
        else:                            # this rank's slots: merge partials
            m = scores.max(dim=-1, keepdim=True).values
            pr = torch.where(msk[None, None], torch.exp(scores - m),
                             torch.zeros_like(scores))
            part = torch.cat([torch.einsum("bht,btr->bhr", pr.to(
                lat_buf.dtype), lat_buf).to(torch.float32), m,
                pr.sum(dim=-1, keepdim=True)], dim=-1)
            ctx_lat = _merge_partials(part, info).to(lat_buf.dtype)
            ctx_lat = ctx_lat.narrow(1, lo_h, h)
        out = torch.einsum("bhr,rhv->bhv", ctx_lat, p["w_uv"])  # absorb W_uv
        y = out.reshape(b, 1, h * vd) @ p["wo"]
        if tpi is not None:
            y = tpi.all_reduce(y, (tpi.tp_axis,))
        return y, (lat_buf, kr_buf)

    # ---- train / prefill: expand the latent into per-head K and V ----
    if kv_bufs is not None:                                   # prefill
        lat_buf, kr_buf = kv_bufs
        buf, held = kv_pos.shape[0], lat_buf.shape[1]
        if s > buf:
            raise ValueError(f"mla_attention: prefill of {s} positions into "
                             f"a cache of {buf} slots")
        lo = owned_slots(info, buf, held)
        write_prefill(lat_buf, c, lo)
        write_prefill(kr_buf, k_rope, lo)
    # the JAX package's einsums "bsr,rhd->bshd" as products with [r, H·d]
    # views: v comes out [B, S, H, vd] with head_dim stride 1, as the
    # kernel needs (an einsum may hand back a permuted layout)
    k_nope = (c @ p["w_uk"].reshape(-1, h * nope)).reshape(b, s, h, nope)
    v = (c @ p["w_uv"].reshape(-1, h * vd)).reshape(b, s, h, vd)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rope_d)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    # [B, S, H, ·] viewed as [B, H, S, ·]: the kernel reads by strides
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), window=window,
                              num_meta=num_meta)
    y = out.transpose(1, 2).reshape(b, s, h * vd) @ p["wo"]
    if tpi is not None:
        y = tpi.all_reduce(y, (tpi.tp_axis,))
    return y, kv_bufs
