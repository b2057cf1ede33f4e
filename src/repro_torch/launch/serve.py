"""Batched serving (the counterpart of ``repro.launch.serve``):
prefill, then a greedy or temperature decode loop over the ring/pinned KV
cache and the SSM caches.

    python -m repro_torch.launch.serve --arch hymba-1.5b [--full]
        [--device cuda|cpu]

runs on the card unless ``--device cpu``; without ``--full`` the config is
cut to two layers and width 128, as the JAX package's ``generate`` cuts
it. Prefill attention (MLA's included, at v's own head_dim) and prefill
SSD run through the ``flash_attention`` and ``ssd_scan`` kernels; decode
is plain PyTorch (MLA's absorbed step over the latent cache included).
Token prompts serve every family but audio (musicgen), whose frame
embeddings and conditioning context go through ``Model.prefill`` and
``Model.decode`` (the audio batch schema in ``models/model.py``).

``generate_on_mesh`` is the same greedy loop on a mesh's model axis: each
rank serves its rows of the batch from its blocks of the weights (the
train layout for the prefill, the decode layout after it) and of the
cache; the vocab-sharded logits are all-gathered before each argmax.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import backend
from repro_torch.launch.steps import (
    build_decode_step, build_prefill_step, decode_params,
)
from repro_torch.models.layers import gather_vocab
from repro_torch.models.model import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(arch: str, prompts: np.ndarray, *, max_new_tokens: int = 16,
             temperature: float = 0.0, reduced: bool = True, window: int = 0,
             seed: int = 0, verbose: bool = False, device=None,
             params: Optional[Dict] = None,
             generator: Optional[torch.Generator] = None) -> Dict:
    """prompts: [B, S] int. Returns generated token ids [B, max_new] (numpy
    int32), the prefill seconds, the decode seconds per token (host clock
    around synchronized work) and whether every logit was finite.

    ``device``: None is the card (raises without one); the CPU only when
    asked. ``params``: the model's weights on that device; None draws the
    port's own seeded init (``seed``). ``generator``: the
    ``torch.Generator`` temperature sampling draws from (None: one on the
    device seeded with ``seed + 1``). Greedy decoding is ``argmax``, the
    first maximum winning."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced(num_layers=2, max_d_model=128)
    return _generate(cfg, prompts, max_new_tokens=max_new_tokens,
                     temperature=temperature, window=window, seed=seed,
                     verbose=verbose, device=device, params=params,
                     generator=generator)


def _generate(cfg, prompts: np.ndarray, *, max_new_tokens: int,
              temperature: float, window: int, seed: int, verbose: bool,
              device, params: Optional[Dict],
              generator: Optional[torch.Generator]) -> Dict:
    """``generate``'s body for a ``ModelConfig`` (a depth-cut one, say: the
    card's checks time the serving path through here)."""
    if cfg.family == "audio":
        raise ValueError("audio serving uses embeds input: drive "
                         "Model.prefill / Model.decode with the audio batch "
                         "schema (frame embeddings and cross_context)")
    dev = backend.resolve_device(device)
    model = build_model(cfg)
    if params is None:
        params = model.init(seed, device=dev)
    b, s = prompts.shape
    cache = model.make_cache(b, cache_len(cfg, s, max_new_tokens, window),
                             device=dev)
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed + 1)

    prefill = build_prefill_step(model)
    decode = build_decode_step(model)
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                             device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens}, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    out = [_sample(logits[:, -1], temperature, generator)]
    t0 = time.perf_counter()
    for _ in range(max_new_tokens - 1):
        logits, cache = decode(params, cache, {"token": out[-1][:, None]})
        finite &= torch.isfinite(logits).all()
        out.append(_sample(logits, temperature, generator))
    _sync(dev)
    t_decode = time.perf_counter() - t0
    per_token = t_decode / max(max_new_tokens - 1, 1)
    if verbose:
        print(f"prefill {t_prefill * 1e3:.1f} ms; "
              f"decode {per_token * 1e3:.1f} ms/token")
    return {"tokens": torch.stack(out, dim=1).cpu().numpy(),
            "prefill_s": t_prefill, "decode_s_per_token": per_token,
            "logits_finite": bool(finite)}


def cache_len(cfg, prompt_len: int, max_new_tokens: int, window: int = 0
              ) -> int:
    """The KV cache's slots for a prompt and its new tokens: the window
    and the meta tokens for a windowed model, every position otherwise,
    and never fewer than the prompt's positions."""
    m = cfg.num_meta_tokens
    buf = (window or cfg.sliding_window or (prompt_len + max_new_tokens)) + m
    buf = max(buf, m + 1)
    if cfg.family == "ssm":
        buf = 8
    return max(buf, prompt_len + m
               + (0 if cfg.sliding_window else max_new_tokens))


def generate_on_mesh(model, params: Dict, prompts: np.ndarray, info, *,
                     max_new_tokens: int = 16, window: int = 0,
                     release: bool = False, device=None) -> Dict:
    """Greedy decoding on a mesh: ``prompts`` [B, S] is the global batch,
    ``params`` this rank's blocks in the train layout
    (``sharding.place.init_local_params``; with ``release`` they are
    dropped from the dict as the decode layout is made). Returns this
    rank's rows' tokens [B', max_new] (numpy int32), their prefill logits
    at the last position over the whole vocabulary (numpy f32), the rows'
    global indices, the prefill seconds and the decode seconds a token
    (host clock around synchronized work), the seconds this rank spent in
    the model axis's collectives in each (``collective_s``), its
    parameter bytes in the two layouts and whether every logit was
    finite."""
    from repro_torch.sharding.place import shard_bytes
    from repro_torch.sharding.place import init_local_cache, local_rows
    from repro_torch.sharding.rules import cache_batch_axes
    cfg = model.cfg
    if cfg.family == "audio":
        raise ValueError("audio serving uses embeds input: drive the "
                         "serving steps with the audio batch schema")
    dev = backend.resolve_device(device)
    b, s = prompts.shape
    cache = init_local_cache(model, info, b,
                             cache_len(cfg, s, max_new_tokens, window),
                             device=dev)
    axes = cache_batch_axes(info, b)
    rows = np.arange(b)
    if axes:
        n = b // info.size(axes)
        rows = rows[info.index(axes) * n:(info.index(axes) + 1) * n]
    tokens = local_rows(torch.as_tensor(np.asarray(prompts),
                                        dtype=torch.int64, device=dev),
                        info, axes)
    prefill = build_prefill_step(model, info, b)
    train_bytes = shard_bytes(params)
    _sync(dev)
    comm0 = info.comm.seconds
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens}, cache)
    logits = gather_vocab(logits[:, -1], cfg.vocab_size, info)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    comm_prefill = info.comm.seconds - comm0
    finite = torch.isfinite(logits).all()
    first = logits.float().cpu().numpy()
    out = [_sample(logits, 0.0, None)]
    if dev.type == "cuda":
        # ranks may share a card: the prefill's cached blocks go back to
        # it before the decode layout is made
        torch.cuda.empty_cache()
    params = decode_params(model, params, info, release)
    decode = build_decode_step(model, info, b)
    _sync(dev)
    comm0 = info.comm.seconds
    t0 = time.perf_counter()
    for _ in range(max_new_tokens - 1):
        logits, cache = decode(params, cache, {"token": out[-1][:, None]})
        logits = gather_vocab(logits, cfg.vocab_size, info)
        finite &= torch.isfinite(logits).all()
        out.append(_sample(logits, 0.0, None))
    _sync(dev)
    per_token = (time.perf_counter() - t0) / max(max_new_tokens - 1, 1)
    return {"tokens": torch.stack(out, dim=1).cpu().numpy(),
            "prefill_logits": first, "rows": rows, "prefill_s": t_prefill,
            "decode_s_per_token": per_token,
            "collective_s": {"prefill": comm_prefill,
                             "decode": info.comm.seconds - comm0},
            "param_bytes": {"train": train_bytes,
                            "decode": shard_bytes(params)},
            "logits_finite": bool(finite)}


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (default: cut to "
                         "two layers, width 128)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    cfg = get_config(args.arch)
    vocab = cfg.vocab_size if args.full else cfg.reduced().vocab_size
    prompts = rng.integers(0, vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    out = generate(args.arch, prompts, max_new_tokens=args.max_new_tokens,
                   temperature=args.temperature, reduced=not args.full,
                   device=args.device, verbose=True)
    print("generated:", out["tokens"][:, :8], "...")


if __name__ == "__main__":
    main()
