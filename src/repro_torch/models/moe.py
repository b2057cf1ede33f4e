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
expert weights; that is the design being ported.

On a mesh (``sharding.context.current_mesh_info``) ``moe_ffn`` takes the
JAX package's dispatch rule: the expert-parallel ``moe_ffn_ep`` where the
experts divide over ``model`` and each model-axis slice of the data
shard's tokens holds at least 8 (prefill); else the gather path with the
semantics of one program over the global batch (decode): the tokens are
all-gathered over the batch's axes, routed and slotted globally, each rank
runs its block of experts over their slots (the ``moe_ecd`` rule), the
slots are all-gathered over ``model``, and each rank combines its rows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, dense_init, init_mlp
from repro_torch.sharding.context import (
    activation_spec, current_mesh_info, shard,
)


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
    """x: [B, S, d] -> ([B, S, d], aux_loss). Without a mesh the
    single-program gather path; on one, the JAX package's dispatch (the
    module's docstring). ``x`` is this rank's rows of the batch."""
    info = current_mesh_info()
    if info is None:
        return _moe_ffn_gather(p, x, cfg)
    if cfg.num_experts % info.tp_size == 0:
        t_loc = x.shape[0] * x.shape[1]
        if t_loc % info.tp_size == 0 and t_loc // info.tp_size >= 8:
            return moe_ffn_ep(p, x, cfg, info)
    return _moe_ffn_mesh_gather(p, x, cfg, info)


def _local_experts(p: Dict, cfg, info) -> Tuple[Dict, int]:
    """(this rank's block of the expert weights, its first expert): the
    block the ``moe_ecd`` rule gives (every expert where they do not
    divide over ``model``); weights held whole are cut to it."""
    e, m = cfg.num_experts, info.tp_size
    n = e // m if e % m == 0 else e
    lo = info.tp_index * n if n < e else 0
    names = [k for k in ("w_in", "w_gate", "w_out") if k in p]
    return {k: (p[k] if p[k].shape[0] == n else p[k].narrow(0, lo, n))
            for k in names}, lo


def _batch_axes() -> Tuple[str, ...]:
    spec = activation_spec("act_btd")
    return spec[0] if spec else ()


def _combine(ye_flat, slot_for_assign, weights, keep, t, k, d):
    safe_slot = torch.clamp(slot_for_assign, min=0).long()
    per_assign = ye_flat[safe_slot.reshape(-1)].reshape(t, k, d)
    w = (weights * keep.to(weights.dtype))[..., None]
    return torch.sum(per_assign * w, dim=1)


def _gather_slots(x_flat, token_for_slot, e, c):
    safe_tok = torch.clamp(token_for_slot, min=0).long()
    xe = x_flat[safe_tok] * (token_for_slot >= 0)[:, None].to(x_flat.dtype)
    return xe.reshape(e, c, x_flat.shape[-1])


def _moe_ffn_gather(p: Dict, x: torch.Tensor, cfg
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    t, e, k = b * s, cfg.num_experts, cfg.num_experts_per_tok
    x_flat = x.reshape(t, d)
    weights, idx, aux = route(p["router"], x_flat, cfg)
    c = moe_capacity(cfg, t)
    token_for_slot, slot_for_assign, keep = dispatch_indices(idx, e, c)
    ye = _expert_ffn(p, _gather_slots(x_flat, token_for_slot, e, c),
                     cfg).reshape(e * c, d)
    y = _combine(ye, slot_for_assign, weights, keep, t, k, d)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x_flat, cfg)
    return y.reshape(b, s, d), aux


def _moe_ffn_mesh_gather(p: Dict, x: torch.Tensor, cfg, info
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gather path of one program over the global batch, on a mesh:
    the batch's rows all-gathered over their axes, routed and slotted as
    one program does, this rank's experts over their slots, the slots
    all-gathered over ``model``, this rank's rows combined."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    baxes = _batch_axes()
    xg = info.all_gather(x, 0, baxes) if baxes else x
    t = xg.shape[0] * s
    x_flat = xg.reshape(t, d)
    weights, idx, aux = route(p["router"], x_flat, cfg)
    c = moe_capacity(cfg, t)
    token_for_slot, slot_for_assign, keep = dispatch_indices(idx, e, c)
    experts, lo = _local_experts(p, cfg, info)
    n = experts["w_in"].shape[0]
    xe = _gather_slots(x_flat, token_for_slot, e, c).narrow(0, lo, n)
    xe = shard(xe, "moe_ecd", (e, c, d))
    ye = _expert_ffn(experts, xe, cfg)
    if n < e:
        ye = info.all_gather(ye, 0, (info.tp_axis,))
    y = _combine(ye.reshape(e * c, d), slot_for_assign, weights, keep, t,
                 k, d)
    y = y.reshape(-1, s, d)
    if baxes:
        y = y.narrow(0, info.index(baxes) * b, b)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg)
    return y, aux


def moe_ffn_ep(p: Dict, x: torch.Tensor, cfg, info
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's expert-parallel path. The data shard's t_loc
    tokens (``x``, the same on every rank of its model line) are cut into
    ``model`` slices of sl = t_loc / model; each rank routes its slice and
    slots it at ``moe_capacity(cfg, sl)`` (so the token drops are the
    slices', not one program's), one all-to-all over ``model`` takes each
    expert's slots to the rank that holds it (``[E/m, m·C, d]``), the
    experts run as ``torch.bmm``, a second all-to-all brings the results
    back, each rank combines its slice, and the slices are all-gathered.
    ``aux`` is the slices' mean over ``model`` and the batch's axes."""
    b, s, d = x.shape
    e, k, m = cfg.num_experts, cfg.num_experts_per_tok, info.tp_size
    t_loc = b * s
    sl = t_loc // m
    c_sub = moe_capacity(cfg, sl)
    x_flat = x.reshape(t_loc, d)
    my = x_flat.narrow(0, info.tp_index * sl, sl)
    weights, idx, aux = route(p["router"], my, cfg)
    token_for_slot, slot_for_assign, keep = dispatch_indices(idx, e, c_sub)
    xe = _gather_slots(my, token_for_slot, e, c_sub)         # [E, C, d]
    e_loc = e // m
    xe = info.all_to_all(xe, (info.tp_axis,))       # [m(src) x E/m, C, d]
    xe = xe.reshape(m, e_loc, c_sub, d).transpose(0, 1).reshape(
        e_loc, m * c_sub, d)
    experts, _ = _local_experts(p, cfg, info)
    ye = _expert_ffn(experts, xe, cfg)
    ye = ye.reshape(e_loc, m, c_sub, d).transpose(0, 1).contiguous()
    ye = info.all_to_all(ye, (info.tp_axis,)).reshape(e * c_sub, d)
    y_my = _combine(ye, slot_for_assign, weights, keep, sl, k, d)
    y = info.all_gather(y_my, 0, (info.tp_axis,))              # [t_loc, d]
    axes = (info.tp_axis,) + tuple(a for a in _batch_axes()
                                   if a != info.tp_axis)
    aux = info.all_reduce(aux.reshape(1).clone(), axes)[0] / info.size(axes)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x_flat, cfg)
    return y.reshape(b, s, d), aux
