"""Learning-rate schedules (callables of the integer step), the
counterpart of ``repro.optim.schedules``. A schedule takes the step as a
Python int or a 0-d tensor and returns a 0-d f32 tensor on the step's
device, computed in f32 as the JAX package computes it."""
from __future__ import annotations

import math

import torch

from repro_torch.config import TrainConfig


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine_schedule(lr: float, warmup_steps: int, total_steps: int,
                           final_frac: float = 0.1):
    cos = cosine_schedule(lr, max(total_steps - warmup_steps, 1), final_frac)

    def f(step):
        step = torch.as_tensor(step)
        warm = lr * _f32(step) / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))
    return f


def make_schedule(cfg: TrainConfig):
    if cfg.schedule == "constant":
        return constant_schedule(cfg.lr)
    if cfg.schedule == "cosine":
        return cosine_schedule(cfg.lr, cfg.total_steps)
    if cfg.schedule == "warmup_cosine":
        return warmup_cosine_schedule(cfg.lr, cfg.warmup_steps,
                                      cfg.total_steps)
    raise ValueError(cfg.schedule)
