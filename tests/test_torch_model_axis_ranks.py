"""The rank side of ``tests/test_torch_model_axis.py`` (no tests here): the
reduced configs of each family, and the worker each gloo rank runs. It
imports no JAX, so the spawned ranks never load it.

``model_axis_worker`` runs, for every case on one mesh, this rank's part of
the prefill and of greedy decode steps from whole weights handed in
(``sharding.place.local_shards``), and returns what the test compares: its
rows, the logits of every step over the whole vocabulary, the tokens, the
blocks' shapes and bytes, and whether the round trips and the sliced init
held bit for bit.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import _sample, cache_len
from repro_torch.launch.steps import (
    build_decode_step, build_prefill_step, decode_params, param_specs,
)
from repro_torch.models import transformer
from repro_torch.models.layers import gather_vocab
from repro_torch.models.model import build_model
from repro_torch.sharding.place import (
    gather_shards, init_local_cache, init_local_params, local_rows,
    local_shape, local_shards, shard_bytes,
)
from repro_torch.sharding.rules import (
    cache_batch_axes, make_cache_specs, make_mesh_info, tree_paths,
)

B, NEW = 4, 4            # global batch; greedy decode steps after prefill
MESHES = ((1, 4), (2, 2))
WORLD = 4


def case_config(name):
    """(config, prompt length) of each family's case, reduced so every
    split divides: dense GQA (8 query, 4 kv heads: the kv heads split,
    the prefill's all-to-all), gemma's MQA (its one kv head split inside
    the head at model 4 and 2: the keys gathered; a cache that does not
    split), MLA with MoE (a leading dense layer), MoE (top-4 of 4),
    hybrid (meta tokens, a window, the ring), SSM, audio
    (cross-attention, codebook heads), and heads that do not divide over
    model 4 (the seqtp strategy)."""
    def red(arch, **kw):
        c = get_config(arch).reduced(num_layers=2, max_d_model=128)
        return dataclasses.replace(c, **kw)

    if name == "dense_gqa":
        return red("nemotron-4-15b", num_heads=8, num_kv_heads=4,
                   head_dim=16, d_ff=256), 27
    if name == "mqa_split_head":
        return red("gemma-2b", d_ff=256), 24
    if name == "mla_moe":
        return red("deepseek-v2-236b", moe_d_ff=64, moe_dense_d_ff=128), 27
    if name == "moe":
        return red("dbrx-132b", moe_d_ff=64), 27
    if name == "hybrid":
        return red("hymba-1.5b", num_kv_heads=2, d_ff=256), 68
    if name == "ssm":
        return red("mamba2-130m"), 27
    if name == "audio":
        return red("musicgen-medium", d_ff=256), 27
    if name == "seqtp":
        return red("qwen2-1.5b", num_heads=6, num_kv_heads=2, head_dim=16,
                   d_ff=256), 27
    raise KeyError(name)


CASES = ("dense_gqa", "mqa_split_head", "mla_moe", "moe", "hybrid", "ssm",
         "audio", "seqtp")


def inputs(cfg, s, seed=0):
    """The case's global batch: token prompts, or audio's frame
    embeddings and context (its decode frames too)."""
    rng = np.random.default_rng(seed)
    if cfg.family != "audio":
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
            np.int32)}
    f = np.float32
    return {"embeds": rng.standard_normal((B, s, cfg.d_model)).astype(f),
            "cross_context": rng.standard_normal(
                (B, cfg.cross_context_len, cfg.cross_context_dim)).astype(f),
            "frames": rng.standard_normal((NEW, B, 1, cfg.d_model)).astype(f)}


def buffer_len(cfg, s):
    return s + NEW + 1 if cfg.family == "audio" else cache_len(cfg, s,
                                                               NEW + 1)


def serve_steps(model, params, batch, cache, prefill, decode,
                gather=lambda x: x):
    """Prefill and NEW decode steps: -> (every step's logits on the host,
    the greedy tokens). Audio decodes the given frames."""
    cfg = model.cfg
    if cfg.family == "audio":
        logits, cache = prefill(params, {"embeds": batch["embeds"],
                                         "cross_context":
                                             batch["cross_context"]}, cache)
        outs = [gather(logits)]
        for f in batch["frames"]:
            logits, cache = decode(params, cache, {"embed": f})
            outs.append(gather(logits))
        return [o.float().numpy() for o in outs], None
    logits, cache = prefill(params, {"tokens": batch["tokens"]}, cache)
    outs = [gather(logits[:, -1])]
    toks = [_sample(outs[-1], 0.0, None)]
    for _ in range(NEW):
        logits, cache = decode(params, cache, {"token": toks[-1][:, None]})
        outs.append(gather(logits))
        toks.append(_sample(outs[-1], 0.0, None))
    return ([o.float().numpy() for o in outs],
            torch.stack(toks, 1).numpy())


def _equal_trees(a, b):
    return all(torch.equal(x, dict(tree_paths(b))[p])
               for p, x in tree_paths(a) if isinstance(x, torch.Tensor))


def _gather_logits(cfg, info):
    """Logits of this rank's rows over the whole vocabulary: the
    vocab-sharded LM logits all-gathered; audio's [B', 1, K', V] (or
    decode's [B', K', V]) over every codebook (dim 2, split over model
    where the heads' columns split by codebook)."""
    if cfg.family != "audio":
        return lambda x: gather_vocab(x, cfg.vocab_size, info)

    def gather(x):
        if x.dim() == 3:
            x = x[:, None]
        if x.shape[2] < cfg.num_codebooks:
            x = info.all_gather(x, 2, (info.tp_axis,))
        return x

    return gather


def run_case(name, weights, info):
    """One case on this rank's mesh: -> the dict the test reads."""
    cfg, s = case_config(name)
    model = build_model(cfg)
    whole = lm_params_from_jax(weights)
    specs = param_specs(model, info, "train")
    params = local_shards(whole, specs, info)
    shapes_ok = all(
        tuple(t.shape) == local_shape(dict(tree_paths(whole))[p].shape,
                                      dict(tree_paths(specs))[p], info)
        for p, t in tree_paths(params))
    got = {"shapes_ok": shapes_ok, "bytes": shard_bytes(params),
           "round_trip": _equal_trees(gather_shards(params, specs, info),
                                      whole)}
    # the sliced init: slices of the one-device init, bit for bit
    for mode in ("train", "decode"):
        own = init_local_params(model, info, 3, mode=mode, device="cpu")
        ref = local_shards(model.init(3, device="cpu"),
                           param_specs(model, info, mode), info)
        got[f"sliced_init_{mode}"] = _equal_trees(own, ref)
    batch = inputs(cfg, s)
    axes = cache_batch_axes(info, B)
    rows = np.arange(B).reshape(info.size(axes) if axes else 1, -1)[
        info.index(axes) if axes else 0]
    local = {k: local_rows(torch.from_numpy(v), info, axes)
             if k != "frames" else torch.from_numpy(v)[:, rows]
             for k, v in batch.items()}
    if "tokens" in local:
        local["tokens"] = local["tokens"].long()
    tc = cfg.cross_context_len if cfg.family == "audio" else 0
    cache = init_local_cache(model, info, B, buffer_len(cfg, s),
                             device="cpu", cross_len=tc)
    meta = transformer.init_cache(cfg, B, buffer_len(cfg, s),
                                  device=torch.device("meta"), cross_len=tc)
    cspecs = make_cache_specs(meta, cfg, info, B)
    got["cache_shapes_ok"] = all(
        tuple(t.shape) == local_shape(dict(tree_paths(meta))[p].shape,
                                      dict(tree_paths(cspecs))[p], info)
        for p, t in tree_paths(cache) if isinstance(t, torch.Tensor))
    got["cache_split"] = {p: dict(tree_paths(cspecs))[p] for p, _ in
                          tree_paths(cache) if p in ("k", "latent")}
    prefill = build_prefill_step(model, info, B)
    decode = build_decode_step(model, info, B)

    class Decode:
        """The decode step on the decode layout, made on first use."""
        params = None

        def __call__(self, params, cache, b):
            if self.params is None:
                self.params = decode_params(model, params, info)
            return decode(self.params, cache, b)

    info.comm.reset()
    got["logits"], got["tokens"] = serve_steps(
        model, params, local, cache, prefill, Decode(),
        _gather_logits(cfg, info))
    got["rows"] = rows
    got["collectives"] = info.comm.calls
    return got


def moe_config(capacity_factor):
    """The EP check's MoE: 8 experts, top 2, a shared expert."""
    return dataclasses.replace(case_config("mla_moe")[0], num_experts=8,
                               num_experts_per_tok=2, num_shared_experts=1,
                               capacity_factor=capacity_factor)


def moe_ep_case(p_np, x_np, capacity_factor, mesh, device="cpu"):
    """``moe_ffn`` (the expert-parallel path) on this rank's rows of
    ``x`` from its blocks of the layer's weights, on ``device``, every
    ``dispatch_indices`` call's keep mask recorded: -> (y rows, keep
    masks, aux)."""
    import repro_torch.models.moe as m
    from repro_torch.sharding.context import use_rules
    from repro_torch.sharding.place import for_use
    from repro_torch.sharding.rules import (
        leaf_spec, make_activation_rules,
    )
    cfg = moe_config(capacity_factor)
    info = make_mesh_info(cfg, mesh)
    whole = {k: v[None] for k, v in dict(tree_paths(
        lm_params_from_jax(p_np, device))).items()}  # one stacked layer
    specs = {k: leaf_spec("layers/moe/" + k, tuple(v.shape), cfg, info)
             for k, v in whole.items()}
    blocks = {k: t[0] for k, t in local_shards(whole, specs, info).items()}
    nest = {}
    for k, t in for_use(blocks, specs, info, "layers/moe").items():
        node = nest
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = t
    x = torch.from_numpy(x_np).to(device)
    xl = local_rows(x, info, cache_batch_axes(info, x.shape[0]))
    kept, orig = [], m.dispatch_indices

    def recorder(idx, e, c):
        out = orig(idx, e, c)
        kept.append(out[2].cpu().numpy().copy())
        return out

    rules = make_activation_rules(cfg, info, mode="prefill",
                                  batch=x.shape[0])
    m.dispatch_indices = recorder
    try:
        with torch.inference_mode(), use_rules(rules, mesh_info=info,
                                               batch=x.shape[0]):
            y, aux = m.moe_ffn(nest, xl, cfg)
    finally:
        m.dispatch_indices = orig
    return y.cpu().numpy(), kept, float(aux)


def model_axis_worker(rank, world, payload):
    """Every case on each mesh of MESHES, one gloo world of WORLD ranks;
    the meshes' process groups made once each. On (2, 2) every leaf of
    more than 4 KB is gathered in pieces (``place.GATHER_BYTES``), and
    stacks are resharded layer by layer."""
    from repro_torch.sharding import place
    torch.set_num_threads(1)
    out = {}
    for shape in MESHES:
        place.GATHER_BYTES = 4096 if shape == (2, 2) else 1 << 28
        mesh = make_debug_mesh(*shape)
        for name in CASES:
            info = make_mesh_info(case_config(name)[0], mesh)
            out[(name, shape)] = run_case(name, payload["weights"][name],
                                          info)
        for cf in (0.5, 8.0):
            out[("moe_ep", shape, cf)] = moe_ep_case(
                payload["moe_p"], payload["moe_x"], cf, mesh)
    return out


# ---------------------------------------------------------------------------
# On the card (tests/test_torch_cuda_mesh.py): ranks sharing card 0 over gloo
# ---------------------------------------------------------------------------

def card_config():
    """A reduced-width dense GQA config at head_dim 128 (8 query, 4 kv
    heads: 4 and 2 a rank at model 2, the hd-128 flash forward)."""
    return dataclasses.replace(
        get_config("nemotron-4-15b").reduced(num_layers=2, max_d_model=512),
        num_heads=8, num_kv_heads=4, head_dim=128, d_ff=1024)


def card_serving_worker(rank, world, payload):
    """Prefill and greedy decode on a (1, world) mesh on card 0: this
    rank's blocks drawn by ``init_local_params`` (seed 0, in turn), the
    kernels' launch counts of the run."""
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import generate_on_mesh
    torch.cuda.set_device(0)
    backend.use_full_f32()
    cfg = card_config()
    model = build_model(cfg)
    info = make_mesh_info(cfg, make_debug_mesh(1, world))
    params = init_local_params(model, info, 0, device="cuda")
    flash_attention.launches = 0
    out = generate_on_mesh(model, params, payload["prompts"], info,
                           max_new_tokens=payload["new"], device="cuda")
    out["flash_launches"] = flash_attention.launches
    return out


def card_moe_worker(rank, world, payload):
    """``moe_ffn_ep`` on a (1, world) mesh on card 0 at each capacity
    factor of ``payload``."""
    torch.cuda.set_device(0)
    mesh = make_debug_mesh(1, world)
    return {cf: moe_ep_case(payload["p"], payload["x"], cf, mesh, "cuda")
            for cf in payload["cfs"]}
