"""Decoder backbone (the counterpart of ``repro.models.transformer``) for
every family of the JAX package's registry:

  dense / vlm : attn -> mlp                      (qwen2, gemma, nemotron,
                                                  yi; chameleon)
  audio       : attn -> cross-attn -> mlp        (musicgen conditioning)
  moe         : attn|mla -> moe (+ leading dense layers: deepseek-v2; dbrx)
  ssm         : ssd mixer only                   (mamba2)
  hybrid      : (attn ∥ ssm, mean-combined) -> mlp (hymba, + meta tokens)

Layer params are stacked ``[L, ...]`` as in the JAX package (deepseek's
leading dense layers apart, in ``dense_layers``); the layer loop is a
Python loop over them (in place of ``lax.scan``), each layer's attention
window a Python int from ``layer_windows`` (the leading dense layers'
is 0). The MoE layers' load-balance losses are summed into ``aux``.
Audio takes frame embeddings in place of tokens, attends to a
conditioning context in every layer, and projects to its codebooks'
logits through ``heads`` [d, K·V] (it has no embedding table).

On a mesh (``sharding.context``: the launcher's ``use_rules`` installs
the ``MeshInfo``, the activation rules and the parameters' specs) the
params are this rank's blocks: each layer's are gathered into the form the
layers compute with as the loop reaches it (``sharding.place.for_use``:
FSDP / ZeRO-3 over the data axes, and the model axis wherever a layer
does not split that dim itself), and ``shard`` checks the activations'
local shapes where the JAX package constrains them.

Serving caches are stacked ``[L, ...]`` too and are updated IN PLACE: a
layer writes its keys and values into its slice of the stacked buffers and
its new SSM state and conv tail are copied into theirs, so a decode step
moves what changed and no more; a prefill writes each layer's
cross-attention keys and values into ``cross_k`` / ``cross_v``, which
decode reads. ``index`` is a Python int (the JAX package keeps a 0-d
array); ``slot_pos`` stays a device tensor.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_mlp, apply_norm, compute_logits, dense_init, embed_init,
    embed_tokens, init_embed, init_mlp, init_norm, rms_normalize,
)
from repro_torch.sharding.context import (
    current_mesh_info, current_param_specs, shard,
)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg, dtype, *,
                moe_layer: bool = False) -> Dict:
    dev = gen.device
    p: Dict = {"ln1": init_norm(cfg, cfg.d_model, dtype, dev)}
    if cfg.family == "ssm":
        p["ssm"] = ssm_mod.init_ssm(gen, ssm_mod.ssm_dims(cfg), dtype)
        return p
    if cfg.use_mla:
        p["attn"] = mla_mod.init_mla(gen, cfg, dtype)
    else:
        p["attn"] = attn_mod.init_attention(gen, cfg, dtype)
    if cfg.family == "hybrid":
        p["ssm"] = ssm_mod.init_ssm(gen, ssm_mod.ssm_dims(cfg), dtype)
        p["attn_branch_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                           device=dev)
        p["ssm_branch_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                          device=dev)
    if cfg.cross_attend:
        p["ln_cross"] = init_norm(cfg, cfg.d_model, dtype, dev)
        p["cross"] = attn_mod.init_cross_attention(gen, cfg, dtype)
    p["ln2"] = init_norm(cfg, cfg.d_model, dtype, dev)
    if moe_layer:
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype)
    else:
        ff = (cfg.moe_dense_d_ff if cfg.family == "moe" and cfg.moe_dense_d_ff
              else cfg.d_ff)
        p["mlp"] = init_mlp(gen, cfg, cfg.d_model, ff, dtype)
    return p


def _init_stacked(n: int, draw: Callable[[], Dict], keep: Callable,
                  prefix: str) -> Dict:
    """``n`` layers drawn one after another by ``draw``, stacked [n, ...]:
    each layer is copied into leaves allocated once (from layer 0's shapes)
    and then freed, so the peak is the stack plus one layer, not two
    stacks (the draws are those of stacking a list of n draws). ``n`` 0
    draws nothing and gives an empty tree. ``keep(path, leaf)`` picks the
    part of each drawn leaf that is stacked (a rank's slice:
    ``sharding/place.py``); ``path`` is the stacked leaf's
    (``prefix/...``)."""
    if n == 0:
        return {}

    def drawn():
        return _keep_tree(keep, draw(), prefix)

    layer = drawn()
    stacked = _map(lambda t: t.new_empty((n,) + t.shape), layer)
    for i in range(n):
        if i:
            del layer                  # freed before the next draw
            layer = drawn()
        _map(lambda dst, src: dst[i].copy_(src), stacked, layer)
    return stacked


def _keep_tree(keep: Callable, tree: Dict, prefix: str) -> Dict:
    return {k: (_keep_tree(keep, v, f"{prefix}/{k}") if isinstance(v, dict)
                else keep(f"{prefix}/{k}", v)) for k, v in tree.items()}


def _map(fn: Callable, tree: Dict, *rest: Dict) -> Dict:
    return {k: (_map(fn, v, *[r[k] for r in rest]) if isinstance(v, dict)
                else fn(v, *[r[k] for r in rest]))
            for k, v in tree.items()}


def _index(tree: Dict, i: int) -> Dict:
    return _map(lambda t: t[i], tree)


def init_params(gen: torch.Generator, cfg, dtype=torch.float32,
                keep: Optional[Callable] = None) -> Dict:
    """Seeded random weights, drawn from ``gen`` on its device. The same
    tree as the JAX package's ``init_params`` (layers stacked [L, ...],
    the leading dense layers in ``dense_layers``); the numbers differ (no
    threefry port). The draws run embed (audio: its codebook ``heads``
    [d, K·V] in its place), meta, the stacked layers, then the dense
    layers. ``keep(path, leaf)`` keeps a part of each leaf as it is drawn
    (a rank's slice, ``sharding/place.py``): the draws are the same, so
    the parts are slices of the whole init bit for bit, and no more than
    one layer (or the embeddings) is ever whole."""
    if keep is None:
        def keep(path, t):
            return t
    params: Dict = {}
    if cfg.family == "audio":
        kv = cfg.num_codebooks * cfg.vocab_size
        params["heads"] = keep("heads", dense_init(
            gen, cfg.d_model, (cfg.d_model, kv), dtype))
    else:
        params["embed"] = _keep_tree(keep, init_embed(gen, cfg, dtype),
                                     "embed")
    if cfg.num_meta_tokens:
        params["meta"] = keep("meta", embed_init(
            gen, (cfg.num_meta_tokens, cfg.d_model), dtype))
    fd = cfg.first_dense_layers
    moe_layer = cfg.family == "moe"
    params["layers"] = _init_stacked(
        cfg.num_layers - fd,
        lambda: _init_layer(gen, cfg, dtype, moe_layer=moe_layer),
        keep, "layers")
    if fd:
        params["dense_layers"] = _init_stacked(
            fd, lambda: _init_layer(gen, cfg, dtype, moe_layer=False),
            keep, "dense_layers")
    params["ln_f"] = _keep_tree(
        keep, init_norm(cfg, cfg.d_model, dtype, gen.device), "ln_f")
    return params


# ---------------------------------------------------------------------------
# Caches (stacked over layers)
# ---------------------------------------------------------------------------

def layer_windows(cfg) -> List[int]:
    """Per-layer attention window (0 = full attention)."""
    fd = cfg.first_dense_layers
    idx = range(fd, cfg.num_layers)
    if cfg.sliding_window and cfg.global_layer_every:
        return [0 if i % cfg.global_layer_every == 0 else cfg.sliding_window
                for i in idx]
    return [cfg.sliding_window for _ in idx]


def init_cache(cfg, batch: int, buf_len: int, dtype=torch.float32,
               device=None, cross_len: int = 0) -> Dict:
    """buf_len: KV buffer slots (callers choose full length or
    window+meta); cross_len: the conditioning context's positions (audio's
    cross-attention keys and values, written by the prefill)."""
    n_layers = cfg.num_layers
    cache: Dict = {
        "index": 0,
        "slot_pos": torch.full((buf_len,), -1, dtype=torch.int32,
                               device=device),
    }
    if cfg.family in ("ssm", "hybrid"):
        dims = ssm_mod.ssm_dims(cfg)
        cache["conv"] = torch.zeros(
            (n_layers, batch, dims.conv_width - 1, dims.conv_ch),
            dtype=dtype, device=device)
        cache["state"] = torch.zeros(
            (n_layers, batch, dims.nheads, dims.headdim, dims.nstate),
            dtype=torch.float32, device=device)
    if cfg.family != "ssm" and cfg.use_mla:
        cache["latent"] = torch.zeros((n_layers, batch, buf_len,
                                       cfg.kv_lora_rank), dtype=dtype,
                                      device=device)
        cache["k_rope"] = torch.zeros((n_layers, batch, buf_len,
                                       cfg.qk_rope_head_dim), dtype=dtype,
                                      device=device)
    elif cfg.family != "ssm":
        hk, hd = cfg.num_kv_heads, cfg.head_dim
        for key in ("k", "v"):
            cache[key] = torch.zeros((n_layers, batch, buf_len, hk, hd),
                                     dtype=dtype, device=device)
    if cfg.cross_attend:
        hq, hd = cfg.num_heads, cfg.head_dim
        for key in ("cross_k", "cross_v"):
            cache[key] = torch.zeros((n_layers, batch, cross_len, hq, hd),
                                     dtype=dtype, device=device)
    return cache


_PER_LAYER_KEYS = ("k", "v", "latent", "k_rope", "conv", "state",
                   "cross_k", "cross_v")


def _split_cache(cache: Optional[Dict], fd: int) -> Tuple[Dict, Dict]:
    """-> (the leading dense layers' buffers, the stacked layers'), each a
    dict of [L, ...] views of the cache's per-layer buffers ({} without a
    cache): the dense layers own the first ``fd`` slices."""
    if cache is None:
        return {}, {}
    per_layer = {k: v for k, v in cache.items() if k in _PER_LAYER_KEYS}
    head = {k: v[:fd] for k, v in per_layer.items()} if fd else {}
    return head, {k: v[fd:] for k, v in per_layer.items()}


# ---------------------------------------------------------------------------
# One layer
# ---------------------------------------------------------------------------

def _layer_forward(lp: Dict, x, bufs: Dict, cfg, *, positions, window: int,
                   kv_pos, write_slot, cross_context=None,
                   moe_layer: bool = False
                   ) -> Tuple[torch.Tensor, Dict, Optional[torch.Tensor]]:
    """Returns (x_out, new_bufs, the MoE layer's aux loss or None). With
    cross-attention, ``cross_context`` [B, Tc, cd] gives the keys and
    values (training, prefill); without it the cached ones serve
    (decode)."""
    new_bufs: Dict = {}
    h = shard(apply_norm(lp["ln1"], x, cfg), "act_btd",
              (None,) + tuple(x.shape[1:]))
    ssm_cache = ({"conv": bufs["conv"], "state": bufs["state"]}
                 if "conv" in bufs else None)

    if cfg.family == "ssm":
        y, new_ssm = ssm_mod.ssm_mixer(lp["ssm"], h, ssm_mod.ssm_dims(cfg),
                                       cache=ssm_cache)
        if new_ssm is not None:
            new_bufs.update(new_ssm)
        return x + y, new_bufs, None

    kv_keys = ("latent", "k_rope") if cfg.use_mla else ("k", "v")
    kv_bufs = (tuple(bufs[k] for k in kv_keys) if kv_keys[0] in bufs
               else None)
    attn_fn = mla_mod.mla_attention if cfg.use_mla else attn_mod.attention
    y_attn, new_kv = attn_fn(
        lp["attn"], h, cfg, positions=positions, window=window,
        num_meta=cfg.num_meta_tokens, kv_bufs=kv_bufs, kv_pos=kv_pos,
        write_slot=write_slot)
    if new_kv is not None:
        new_bufs.update(zip(kv_keys, new_kv))

    if cfg.family == "hybrid":
        y_ssm, new_ssm = ssm_mod.ssm_mixer(lp["ssm"], h,
                                           ssm_mod.ssm_dims(cfg),
                                           cache=ssm_cache)
        if new_ssm is not None:
            new_bufs.update(new_ssm)
        y = 0.5 * (rms_normalize(y_attn, lp["attn_branch_norm"])
                   + rms_normalize(y_ssm, lp["ssm_branch_norm"]))
    else:
        y = y_attn
    x = x + y

    if cfg.cross_attend:
        hc = apply_norm(lp["ln_cross"], x, cfg)
        cross_kv = ((bufs["cross_k"], bufs["cross_v"])
                    if "cross_k" in bufs and cross_context is None else None)
        y_cross, (ck, cv) = attn_mod.cross_attention(
            lp["cross"], hc, cfg, context=cross_context, cross_kv=cross_kv)
        x = x + y_cross
        if "cross_k" in bufs:
            new_bufs["cross_k"], new_bufs["cross_v"] = ck, cv

    h2 = shard(apply_norm(lp["ln2"], x, cfg), "act_btd",
               (None,) + tuple(x.shape[1:]))
    if moe_layer:
        y2, aux = moe_mod.moe_ffn(lp["moe"], h2, cfg)
        return x + y2, new_bufs, aux
    return x + apply_mlp(lp["mlp"], h2, cfg), new_bufs, None


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------

def forward(params: Dict, cfg, *, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            cross_context: Optional[torch.Tensor] = None,
            cache: Optional[Dict] = None, last_only: bool = False,
            remat: bool = False, return_hidden: bool = False,
            ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (logits, cache, aux_loss) — or (hidden, ...) when
    ``return_hidden``: the normed hidden states before the unembedding
    (training's fused chunked CE takes them). ``last_only`` keeps the last
    position only (what a prefill returns; every position's logits are
    independent, so this only skips work). ``remat`` recomputes each layer
    in the backward (one ``torch.utils.checkpoint`` per layer, where the
    JAX package has ``jax.checkpoint`` around its scan body); it applies to
    the cache-free forward. Audio takes ``embeds`` [B, S, d] (frame
    embeddings) in place of ``tokens``, and ``cross_context`` [B, Tc, cd]
    in training and prefill.

    Train: cache None. Prefill: fresh cache, S>1. Decode: cache, S==1.
    logits: [B,S,V] ([B,S,K,V] for audio); meta-token positions stripped.
    The cache is updated in place and returned.
    """
    info, specs = current_mesh_info(), current_param_specs()

    def use(tree, tree_specs, prefix):
        """Blocks at ``prefix`` (one layer's under a stacked key) in the
        form the layers compute with (a decode step's weights stationary
        where they can be)."""
        if specs is None:
            return tree
        from repro_torch.sharding.place import for_use
        return for_use(tree, tree_specs, info, prefix,
                       stationary=decode)

    s_in = (tokens if embeds is None else embeds).shape[1]
    decode = cache is not None and s_in == 1   # one-token step with history
    def top(key):
        """``params[key]`` (a top-level subtree) as the layers use it,
        gathered where it is used and dropped after."""
        return use({key: params[key]}, specs and {key: specs[key]},
                   "")[key]

    x = (embed_tokens(top("embed"), tokens, cfg) if embeds is None
         else embeds)
    b = x.shape[0]
    dev = x.device
    m = cfg.num_meta_tokens

    if m and not decode:
        meta = top("meta")[None].expand(b, m, cfg.d_model).to(x.dtype)
        x = torch.cat([meta, x], dim=1)
    s = x.shape[1]
    x = shard(x, "act_btd", (None, s, x.shape[2]))

    write_slot = None
    kv_pos = None
    if decode:
        idx = cache["index"]
        positions = torch.full((b, 1), idx, dtype=torch.int32, device=dev)
        buf = cache["slot_pos"].shape[0]
        write_slot = attn_mod.cache_write_slot(buf, idx, m)
        kv_pos = cache["slot_pos"].clone()
        kv_pos[write_slot] = idx
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=dev)[None].expand(b, s)
        if cache is not None:                        # prefill
            slots = torch.arange(cache["slot_pos"].shape[0],
                                 dtype=torch.int32, device=dev)
            kv_pos = torch.where(slots < s, slots, torch.full_like(slots, -1))

    # (stacked params, their buffers, index, window, MoE layer): the
    # leading dense layers (window 0), then the stacked layers
    fd = cfg.first_dense_layers
    head_bufs, tail_bufs = _split_cache(cache, fd)
    plan = [("dense_layers", head_bufs, i, 0, False) for i in range(fd)]
    plan += [("layers", tail_bufs, i, w, cfg.family == "moe")
             for i, w in enumerate(layer_windows(cfg))]
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    for key, bufs_all, i, window, moe_layer in plan:
        if remat and cache is None:
            def body(xc, key=key, i=i, window=window, moe_layer=moe_layer):
                out, _, aux = _layer_forward(
                    _index(params[key], i), xc, {}, cfg,
                    positions=positions, window=window, kv_pos=None,
                    write_slot=None, cross_context=cross_context,
                    moe_layer=moe_layer)
                return out if aux is None else (out, aux)
            out = checkpoint(body, x, use_reentrant=False)
            x, aux = out if moe_layer else (out, None)
        else:
            bufs = {k: v[i] for k, v in bufs_all.items()}
            x, new_bufs, aux = _layer_forward(
                use(_index(params[key], i), specs and specs[key], key), x,
                bufs, cfg,
                positions=positions,
                window=window, kv_pos=kv_pos, write_slot=write_slot,
                cross_context=cross_context, moe_layer=moe_layer)
            for k, new in new_bufs.items():
                if new is not bufs[k]:
                    bufs[k].copy_(new)
        if aux is not None:
            aux_total = aux_total + aux

    if cache is not None:
        cache["slot_pos"] = kv_pos
        cache["index"] = cache["index"] + 1 if decode else s

    if m and not decode:
        x = x[:, m:]
    if last_only and not return_hidden:
        x = x[:, -1:]
    x = apply_norm(top("ln_f"), x, cfg)
    if return_hidden:
        return x, cache, aux_total
    if cfg.family == "audio":
        heads = top("heads")
        logits = heads.project(x) if hasattr(heads, "project") else (
            x @ heads)
        kv = cfg.num_codebooks * cfg.vocab_size
        if logits.shape[-1] < kv and cfg.num_codebooks % info.tp_size:
            # the heads' columns split inside a codebook: whole logits
            logits = info.all_gather(logits, 2, (info.tp_axis,))
        logits = logits.reshape(b, x.shape[1], -1, cfg.vocab_size)
        full = (None, x.shape[1], cfg.num_codebooks, cfg.vocab_size)
    else:
        logits = compute_logits(top("embed"), x, cfg)
        full = (None, x.shape[1], cfg.vocab_size)
    return shard(logits, "act_btv", full), cache, aux_total
