"""Mixture-of-Experts (the counterpart of ``repro.models.moe``): a top-k
router and the capacity-bounded GATHER dispatch.

Token -> slot assignment is integer bookkeeping (``dispatch_indices``),
tokens are gathered into a dense ``[E, C, d]`` buffer, the experts run as
batched matrix products over it (``torch.bmm``, as the JAX package leaves
its ``einsum`` to XLA: no Pallas kernel), and the results are gathered
back per (token, k) and weighted. Covers DBRX (16 experts, top-4) and
DeepSeek-V2 (2 shared + 160 routed experts, top-6).

The capacity ``C`` is the JAX package's: at decode (T = B tokens) it is 8,
so every decode step runs every expert over its 8 slots and reads all the
expert weights; that is the design being ported. The JAX package's
expert-parallel ``moe_ffn_ep`` (shard_map over a mesh) waits for the
port's mesh (ROADMAP item 13): ``moe_ffn`` is the single-program path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, dense_init, init_mlp


def moe_capacity(cfg, num_tokens: int) -> int:
    """Per-expert slot count, padded to a multiple of 8 (the JAX package's
    TPU tiling, kept so that both packages drop the same tokens)."""
    c = (cfg.capacity_factor * num_tokens * cfg.num_experts_per_tok
         / cfg.num_experts)
    return max(8, int(math.ceil(c / 8.0)) * 8)


def init_moe(gen: torch.Generator, cfg, dtype=torch.float32) -> Dict:
    """Router (f32, as in the JAX package), the experts' stacked
    ``[E, d, ff]`` / ``[E, ff, d]`` weights and the shared experts' MLP,
    drawn from ``gen`` in the JAX package's key order."""
    e, d = cfg.num_experts, cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    p = {"router": dense_init(gen, d, (d, e), torch.float32),
         "w_in": dense_init(gen, d, (e, d, ff), dtype),
         "w_out": dense_init(gen, ff, (e, ff, d), dtype)}
    if cfg.mlp_variant in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, d, (e, d, ff), dtype)
    if cfg.num_shared_experts:
        shared_cfg = dataclasses.replace(cfg, mlp_bias=False)
        p["shared"] = init_mlp(gen, shared_cfg, d,
                               ff * cfg.num_shared_experts, dtype)
    return p


def _expert_ffn(p: Dict, xe: torch.Tensor, cfg) -> torch.Tensor:
    """xe: [E, C, d] -> [E, C, d], batched over experts."""
    h = torch.bmm(xe, p["w_in"])
    v = cfg.mlp_variant
    if v == "swiglu":
        h = F.silu(torch.bmm(xe, p["w_gate"])) * h
    elif v == "geglu":
        h = F.gelu(torch.bmm(xe, p["w_gate"]), approximate="tanh") * h
    elif v == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, p["w_out"])


def route(router_w: torch.Tensor, x_flat: torch.Tensor, cfg
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (weights [T, k] in x's dtype, expert_idx [T, k] int32,
    aux_loss scalar f32). The top k are taken by a stable descending sort,
    so equal probabilities go to the lower expert index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order among
    ties)."""
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    logits = x_flat.to(torch.float32) @ router_w               # [T, E]
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :k], idx[:, :k]
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e, f_e the share of
    # the T*k assignments that went to expert e, times k
    counts = torch.bincount(idx.reshape(-1), minlength=e)
    f = counts.to(torch.float32) / idx.numel() * k
    pbar = probs.mean(dim=0)
    aux = e * torch.sum(f * pbar) * cfg.router_aux_loss_coef
    return weights.to(x_flat.dtype), idx.to(torch.int32), aux


def dispatch_indices(idx: torch.Tensor, num_experts: int, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integer-only slotting. idx: [T, k] expert ids. An assignment's slot
    within its expert is its rank among that expert's assignments in
    (token, k) order; ranks from ``capacity`` on are dropped.

    Returns:
      token_for_slot [E*C] int32 (-1 = empty slot)
      slot_for_assign [T, k] int32 (-1 = dropped)
      keep [T, k] bool
    """
    t, k = idx.shape
    flat = idx.reshape(-1).long()                             # [T*k]
    onehot = F.one_hot(flat, num_experts)                     # [T*k, E]
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    keep = pos < capacity
    slot = torch.where(keep, flat * capacity + pos, -1)
    token_id = torch.arange(t, dtype=torch.int32,
                            device=idx.device).repeat_interleave(k)
    # kept slots are distinct; the dropped ones all go to a spare last
    # entry, cut off after the scatter (no host sync for a boolean index)
    n = num_experts * capacity
    token_for_slot = torch.full((n + 1,), -1, dtype=torch.int32,
                                device=idx.device)
    token_for_slot.scatter_(0, torch.where(keep, slot, n), token_id)
    return (token_for_slot[:n], slot.to(torch.int32).reshape(t, k),
            keep.reshape(t, k))


def moe_ffn(p: Dict, x: torch.Tensor, cfg
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> ([B, S, d], aux_loss): the single-program gather
    path (the JAX package's ``moe_ffn`` without a mesh)."""
    return _moe_ffn_gather(p, x, cfg)


def _moe_ffn_gather(p: Dict, x: torch.Tensor, cfg
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    t, e, k = b * s, cfg.num_experts, cfg.num_experts_per_tok
    x_flat = x.reshape(t, d)
    weights, idx, aux = route(p["router"], x_flat, cfg)
    c = moe_capacity(cfg, t)
    token_for_slot, slot_for_assign, keep = dispatch_indices(idx, e, c)

    # ---- gather tokens into expert buffers ----
    safe_tok = torch.clamp(token_for_slot, min=0).long()
    xe = x_flat[safe_tok] * (token_for_slot >= 0)[:, None].to(x.dtype)
    ye = _expert_ffn(p, xe.reshape(e, c, d), cfg).reshape(e * c, d)

    # ---- combine back per assignment ----
    safe_slot = torch.clamp(slot_for_assign, min=0).long()
    per_assign = ye[safe_slot.reshape(-1)].reshape(t, k, d)
    w = (weights * keep.to(weights.dtype))[..., None]
    y = torch.sum(per_assign * w, dim=1)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x_flat, cfg)
    return y.reshape(b, s, d), aux
