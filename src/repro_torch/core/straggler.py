"""Straggler simulation (§4.5): each selected device independently fails to
report with probability ``rate``. Aggregation renormalizes over survivors —
semantically "the device's update never arrived"."""
from __future__ import annotations

import torch


def straggler_mask(gen: torch.Generator, num_selected: int,
                   rate: float) -> torch.Tensor:
    """[num_selected] f32 mask on ``gen``'s device, 1 = survived.
    rate == 0 -> all ones, and nothing is drawn."""
    if rate <= 0.0:
        return torch.ones((num_selected,), dtype=torch.float32,
                          device=gen.device)
    u = torch.rand((num_selected,), generator=gen, device=gen.device)
    return (u < 1.0 - rate).to(torch.float32)
