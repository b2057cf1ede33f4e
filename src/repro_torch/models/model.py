"""Public model API (the counterpart of ``repro.models.model``):
``build_model(cfg)`` returns a ``Model`` with init / prefill / decode /
make_cache for the LM families the port serves (dense, ssm, hybrid).
Batch schemas:

    prefill: {"tokens": [B,S] int}
    decode:  {"token":  [B,1] int}

``loss_fn`` belongs to LM training, which a later slice ports.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from repro_torch.kernels import backend
from repro_torch.models import transformer


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

    def loss_fn(params, batch, **kwargs):
        raise NotImplementedError(
            "LM training (loss_fn, chunked cross-entropy, optimizers, the "
            "data pipeline) is not ported to repro_torch yet: the LM "
            "training slice of ROADMAP item 14")

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
