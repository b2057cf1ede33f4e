"""Initializers of the paper nets (the counterpart of ``dense_init`` /
``embed_init`` in ``repro.models.layers``), drawn from an explicit CPU
``torch.Generator`` so a seed gives the same weights on every device."""
from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, fan_in: int, shape,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal (±3σ) fan-in init."""
    std = 1.0 / math.sqrt(max(fan_in, 1))
    t = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (t * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32
               ) -> torch.Tensor:
    t = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    return (t * 0.02).to(dtype)
