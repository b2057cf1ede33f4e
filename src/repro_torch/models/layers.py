"""Shared layer primitives (the counterpart of ``repro.models.layers``):
initializers, norms, MLP variants, RoPE, embedding, logits and the
cross-entropy losses.

Params are plain nested dicts of tensors; dense weights keep the JAX
``[in, out]`` layout and are applied as ``x @ w``.

On a mesh's model axis (``sharding.context.current_mesh_info``) the layers
run on their local blocks: the embedding's lookup is vocab-parallel (a
masked local lookup, then an all-reduce over ``model``) wherever the table
holds a block of the vocabulary, the logits come out vocab-sharded, and
under the ``tp`` strategy the MLP is column-parallel into ``w_in`` /
``w_gate`` and row-parallel out of ``w_out``, with one all-reduce over
``model`` (``b_out`` added once, after it). Initializers draw from
an explicit ``torch.Generator`` and create their tensors on its device, so
a seed gives the same weights wherever the generator lives (a CPU
generator gives the same weights on every device).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.context import current_mesh_info

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, fan_in: int, shape,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal (±3σ) fan-in init."""
    std = 1.0 / math.sqrt(max(fan_in, 1))
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (t * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32
               ) -> torch.Tensor:
    t = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (t * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg, dim: int, dtype=torch.float32, device=None) -> Dict:
    fill = torch.zeros if cfg.norm_type == "rmsnorm_p1" else torch.ones
    p = {"scale": fill((dim,), dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def _self_dot(x: torch.Tensor) -> torch.Tensor:
    """sum(x*x) over the last dim, accumulated in f32."""
    xf = x.to(torch.float32)
    return (xf * xf).sum(dim=-1)


def apply_norm(p: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """RMSNorm / gemma-style RMSNorm(1+w) / LayerNorm with eps
    ``cfg.norm_eps``; the reductions run in f32, the rest in x's dtype."""
    d = x.shape[-1]
    if cfg.norm_type == "layernorm":
        mu = (x.to(torch.float32).sum(dim=-1) / d)[..., None]
        xc = x - mu.to(x.dtype)
        var = (_self_dot(xc) / d)[..., None]
        inv = torch.rsqrt(var + cfg.norm_eps).to(x.dtype)
        return xc * inv * p["scale"] + p["bias"]
    ms = (_self_dot(x) / d)[..., None]
    inv = torch.rsqrt(ms + cfg.norm_eps).to(x.dtype)
    scale = p["scale"]
    if cfg.norm_type == "rmsnorm_p1":
        scale = 1.0 + scale
    return x * inv * scale


def rms_normalize(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Stateless RMSNorm with an externally supplied scale (qk-norm, the
    hybrid branch norms, the SSM gate norm); eps 1e-6 as in the JAX
    package, not ``cfg.norm_eps``."""
    ms = (_self_dot(x) / x.shape[-1])[..., None]
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg, d_model: int, d_ff: int,
             dtype=torch.float32) -> Dict:
    p = {"w_in": dense_init(gen, d_model, (d_model, d_ff), dtype),
         "w_out": dense_init(gen, d_ff, (d_ff, d_model), dtype)}
    if cfg.mlp_variant in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, d_model, (d_model, d_ff), dtype)
    if cfg.mlp_bias:
        p["b_in"] = torch.zeros((d_ff,), dtype=dtype, device=gen.device)
        p["b_out"] = torch.zeros((d_model,), dtype=dtype, device=gen.device)
    return p


def tp_info():
    """The ``MeshInfo`` when the layers split their heads, hidden units
    and experts over a model axis (the ``tp`` strategy, model > 1); else
    None."""
    info = current_mesh_info()
    if info is None or info.strategy != "tp" or info.tp_size == 1:
        return None
    return info


def apply_mlp(p: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The MLP; under ``tp`` on this rank's hidden units, the partial
    outputs summed over the model axis."""
    info = tp_info()
    h = x @ p["w_in"]
    if "b_in" in p:
        h = h + p["b_in"]
    v = cfg.mlp_variant
    if v == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    elif v == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * h
    elif v == "squared_relu":
        h = torch.square(F.relu(h))
    elif v == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp variant {v}")
    out = h @ p["w_out"]
    if info is not None:
        out = info.all_reduce(out, (info.tp_axis,))
    if "b_out" in p:
        out = out + p["b_out"]
    return out


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(cfg, head_dim: int, device=None) -> torch.Tensor:
    rot = int(head_dim * cfg.rope_pct)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (cfg.rope_theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg,
               head_dim: int = 0) -> torch.Tensor:
    """Rotate the first ``rope_pct * head_dim`` dims of ``x``.

    x: [..., S, H, hd] (or [..., S, hd]); positions: broadcastable to
    [..., S]."""
    hd = head_dim or x.shape[-1]
    inv_freq = rope_frequencies(cfg, hd, device=x.device)
    rot = inv_freq.shape[0] * 2
    if rot == 0:
        return x
    ang = positions[..., None].to(torch.float32) * inv_freq   # [..., S, rot/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == cos.dim() + 1:          # [..., S, H, hd]: broadcast heads
        cos, sin = cos[..., None, :], sin[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, cfg, dtype=torch.float32) -> Dict:
    p = {"table": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model,
                                  (cfg.d_model, cfg.vocab_size), dtype)
    return p


def embed_tokens(p: Dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """The table's rows of ``tokens``. With the table's vocabulary split
    over the model axis: each rank looks up the ids of its block (zeros
    for the others) and the ranks' rows are summed: exact, one non-zero
    term a row. A decode step's FSDP block (``place.StationaryTable``)
    looks up every row's tokens instead of gathering the table."""
    table, info = p["table"], current_mesh_info()
    if hasattr(table, "lookup"):
        x = table.lookup(tokens)
    elif info is None or table.shape[0] == cfg.vocab_size:
        x = table[tokens]
    else:
        n = table.shape[0]
        ids = tokens.long() - info.tp_index * n
        mine = (ids >= 0) & (ids < n)
        x = table[ids.clamp(0, n - 1)] * mine[..., None].to(table.dtype)
        x = info.all_reduce(x, (info.tp_axis,))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def compute_logits(p: Dict, h: torch.Tensor, cfg) -> torch.Tensor:
    """[..., V] logits, or this rank's block of the vocabulary where the
    table / unembedding holds one (``gather_vocab`` assembles them)."""
    w = p["table"] if cfg.tie_embeddings else p["unembed"]
    if hasattr(w, "project"):                # a decode step's FSDP block
        logits = w.project(h)
    elif cfg.tie_embeddings:
        logits = h @ w.T
    else:
        logits = h @ w
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def gather_vocab(logits: torch.Tensor, vocab: int, info=None
                 ) -> torch.Tensor:
    """Vocab-sharded logits [..., V / model] -> [..., V] on every rank of
    the model axis of ``info`` (None: the installed one); the identity
    when they are whole."""
    info = info or current_mesh_info()
    if info is None or logits.shape[-1] == vocab:
        return logits
    return info.all_gather(logits, logits.dim() - 1, (info.tp_axis,))


def _chunk_loss(embed_params: Dict, h_c: torch.Tensor, lab_c: torch.Tensor,
                cfg, heads=None) -> torch.Tensor:
    if heads is not None:
        logits = (h_c @ heads).reshape(h_c.shape[0], h_c.shape[1],
                                       cfg.num_codebooks, cfg.vocab_size)
    else:
        logits = compute_logits(embed_params, h_c, cfg)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab_c[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def chunked_cross_entropy(embed_params: Dict, h: torch.Tensor,
                          labels: torch.Tensor, cfg, chunk: int = 512,
                          heads=None) -> torch.Tensor:
    """Fused unembed + CE over sequence chunks, so that the full [B, S, V]
    f32 logits never exist (V can be 256k): each chunk's logits are
    recomputed in the backward (``torch.utils.checkpoint``). The chunk is
    512, shrunk to a divisor of S; the chunks' sums are added in order and
    divided by ``labels.numel()``. The gold logit is a gather (the JAX
    package's one-hot select and sum give the same value). ``heads``
    (audio): the [d, K·V] projection to the codebooks' logits, each chunk's
    [B, cs, K, V]; labels are then [B, S, K]."""
    b, s, _ = h.shape
    cs = chunk
    while s % cs:
        cs -= 1
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, cs):
        total = total + checkpoint(_chunk_loss, embed_params, h[:, c0:c0 + cs],
                                   labels[:, c0:c0 + cs], cfg, heads,
                                   use_reentrant=False)
    return total / labels.numel()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token-level cross entropy; logits [..., V], labels [...] int;
    with ``mask``, the mean over its weight (at least 1)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
