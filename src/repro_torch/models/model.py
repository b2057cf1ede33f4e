"""Public model API (the counterpart of ``repro.models.model``):
``build_model(cfg)`` returns a ``Model`` with init / prefill / decode /
make_cache and the training loss for the LM families the port serves
(dense, moe, ssm, hybrid; the loss carries the MoE layers' load-balance
``aux``). Batch schemas:

    train:   {"tokens": [B,S] int, "labels": [B,S] int, optional
              "loss_mask": [B,S]}
    prefill: {"tokens": [B,S] int}
    decode:  {"token":  [B,1] int}
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


def build_model(cfg) -> Model:
    transformer.check_supported(cfg)

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
        if mask is None:
            h, _, aux = transformer.forward(
                params, cfg, tokens=batch["tokens"], remat=remat,
                return_hidden=True)
            ce = chunked_cross_entropy(params["embed"], h, labels, cfg)
        else:
            logits, _, aux = transformer.forward(
                params, cfg, tokens=batch["tokens"], remat=remat)
            ce = cross_entropy(logits, labels, mask)
        loss = ce + aux
        return loss, {"ce": ce, "aux": aux}

    def make_cache(batch: int, buf_len: int, dtype=torch.float32,
                   device=None) -> Dict:
        return transformer.init_cache(cfg, batch, buf_len, dtype,
                                      backend.resolve_device(device))

    def prefill(params, batch, cache):
        """-> (logits [B,1,V] of the last position, the filled cache)."""
        logits, cache, _ = transformer.forward(
            params, cfg, tokens=batch["tokens"], cache=cache, last_only=True)
        return logits, cache

    def decode(params, cache, batch):
        """-> (logits [B,V], the cache one step on)."""
        logits, cache, _ = transformer.forward(
            params, cfg, tokens=batch["token"], cache=cache)
        return logits[:, -1], cache

    return Model(cfg=cfg, init=init, loss_fn=loss_fn, prefill=prefill,
                 decode=decode, make_cache=make_cache)
