"""Serving step functions (the counterpart of ``build_prefill_step`` /
``build_decode_step`` in ``repro.launch.steps``), without a mesh: the
model's prefill and decode under ``torch.inference_mode``. The train step
and the mesh wait for later slices (ROADMAP items 13-14)."""
from __future__ import annotations

import torch

from repro_torch.models.model import Model


def build_prefill_step(model: Model):
    @torch.inference_mode()
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)

    return prefill_step


def build_decode_step(model: Model):
    @torch.inference_mode()
    def decode_step(params, cache, batch):
        return model.decode(params, cache, batch)

    return decode_step
