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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.attention import NEG_INF, mask_block
from repro_torch.models.layers import apply_rope, dense_init, rms_normalize


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
    h = cfg.num_heads
    nope, rope_d, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
    q_nope, q_rope = _queries(p, x, cfg, positions)
    c, k_rope = _latent(p, x, cfg, positions)

    if kv_bufs is not None and s == 1:
        # ---- absorbed decode against the latent cache ----
        lat_buf, kr_buf = kv_bufs
        lat_buf[:, write_slot] = c[:, 0]
        kr_buf[:, write_slot] = k_rope[:, 0]
        # absorb W_uk into q: [B,1,H,nope] x [r,H,nope] -> [B,H,r]
        q_lat = torch.einsum("bshd,rhd->bhr", q_nope, p["w_uk"])
        s_lat = torch.einsum("bhr,btr->bht", q_lat, lat_buf)
        s_rope = torch.einsum("bshe,bte->bht", q_rope, kr_buf)
        scores = (s_lat + s_rope).to(torch.float32) * (nope + rope_d) ** -0.5
        msk = mask_block(positions[:1, 0], kv_pos, window, num_meta)[0]
        scores = torch.where(msk[None, None], scores,
                             torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(lat_buf.dtype)
        ctx_lat = torch.einsum("bht,btr->bhr", probs, lat_buf)
        out = torch.einsum("bhr,rhv->bhv", ctx_lat, p["w_uv"])  # absorb W_uv
        return out.reshape(b, 1, h * vd) @ p["wo"], (lat_buf, kr_buf)

    # ---- train / prefill: expand the latent into per-head K and V ----
    if kv_bufs is not None:                                   # prefill
        lat_buf, kr_buf = kv_bufs
        if s > lat_buf.shape[1]:
            raise ValueError(f"mla_attention: prefill of {s} positions into "
                             f"a cache of {lat_buf.shape[1]} slots")
        lat_buf[:, :s] = c
        kr_buf[:, :s] = k_rope
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
    return y, kv_bufs
