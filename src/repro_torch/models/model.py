"""Public model API (the counterpart of ``repro.models.model``):
``build_model(cfg)`` returns a ``Model`` with init / prefill / decode /
make_cache and the training loss, uniform across the ten architectures
of the JAX package's registry (the loss carries the MoE layers'
load-balance ``aux``). Batch schemas:

  LM families (dense/moe/ssm/hybrid/vlm):
    train:   {"tokens": [B,S] int, "labels": [B,S] int, optional
              "loss_mask": [B,S]}
    prefill: {"tokens": [B,S] int}
    decode:  {"token":  [B,1] int}
  audio (musicgen; its frontend is a stub that gives embeddings):
    train:   {"embeds": [B,S,d], "cross_context": [B,Tc,cd],
              "labels": [B,S,K] int}
    prefill: {"embeds": [B,S,d], "cross_context": [B,Tc,cd]}
    decode:  {"embed":  [B,1,d]}
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from repro_torch.kernels import backend
from repro_torch.models import transformer
from repro_torch.models.layers import chunked_cross_entropy, cross_entropy


@dataclass(frozen=True)
class Model:
    cfg: object
    init: Callable
    loss_fn: Callable
    prefill: Callable
    decode: Callable
    make_cache: Callable


def _forward_kwargs(cfg, batch: Dict) -> Dict:
    """The forward's inputs from a batch: audio's frame embeddings and
    conditioning context, the other families' token ids."""
    if cfg.family == "audio":
        kw = {"embeds": batch.get("embeds", batch.get("embed"))}
        if "cross_context" in batch:
            kw["cross_context"] = batch["cross_context"]
        return kw
    return {"tokens": batch.get("tokens", batch.get("token"))}


def build_model(cfg) -> Model:

    def init(seed: int = 0, dtype=torch.float32, device=None) -> Dict:
        """Seeded random weights drawn on ``device`` (None: the card)."""
        gen = torch.Generator(device=backend.resolve_device(device))
        return transformer.init_params(gen.manual_seed(seed), cfg, dtype)

    def loss_fn(params, batch, *, remat: bool = False):
        """-> (loss, {"ce", "aux"}). Without a ``loss_mask``, the fused
        chunked unembed + CE on the hidden states (the full [B, S, V] f32
        logits never exist); with one, ``cross_entropy`` on the logits."""
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        kw = _forward_kwargs(cfg, batch)
        if mask is None:
            h, _, aux = transformer.forward(params, cfg, remat=remat,
                                            return_hidden=True, **kw)
            ce = chunked_cross_entropy(params.get("embed"), h, labels, cfg,
                                       heads=params.get("heads"))
        else:
            logits, _, aux = transformer.forward(params, cfg, remat=remat,
                                                 **kw)
            ce = cross_entropy(logits, labels, mask)
        loss = ce + aux
        return loss, {"ce": ce, "aux": aux}

    def make_cache(batch: int, buf_len: int, dtype=torch.float32,
                   device=None, cross_len: int = 0) -> Dict:
        """``cross_len``: audio's conditioning positions (Tc)."""
        return transformer.init_cache(cfg, batch, buf_len, dtype,
                                      backend.resolve_device(device),
                                      cross_len=cross_len)

    def prefill(params, batch, cache):
        """-> (logits [B,1,V] ([B,1,K,V] for audio) of the last position,
        the filled cache)."""
        logits, cache, _ = transformer.forward(
            params, cfg, cache=cache, last_only=True,
            **_forward_kwargs(cfg, batch))
        return logits, cache

    def decode(params, cache, batch):
        """-> (logits [B,V] ([B,K,V] for audio), the cache one step on)."""
        logits, cache, _ = transformer.forward(
            params, cfg, cache=cache, **_forward_kwargs(cfg, batch))
        return logits[:, -1], cache

    return Model(cfg=cfg, init=init, loss_fn=loss_fn, prefill=prefill,
                 decode=decode, make_cache=make_cache)
