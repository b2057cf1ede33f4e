"""Parameter conversion between the JAX package's trees and the port's
dicts of tensors. The layouts are the same on both sides (HWIO kernels,
the LSTM's i, f, g, o gates), so conversion only changes the container:
numpy arrays in, tensors out, and back.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bf16: exact via f32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def params_from_jax(tree, device="cpu") -> Dict:
    """A JAX param tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) -> the port's params on
    ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _to_tensor(tree, device)


def params_to_numpy(params) -> Dict:
    """The inverse: the port's params -> nested dicts of numpy arrays (bf16
    leaves come back as float32, which holds them exactly)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def lm_params_from_jax(tree, device="cpu") -> Dict:
    """The JAX package's LM parameter tree (nested dicts of numpy arrays,
    the stacked ``layers`` and ``dense_layers`` included) -> the port's
    tree on ``device``. The layouts are the same (dense weights
    ``[in, out]``, layers stacked ``[L, ...]``, the experts' ``[E, d, ff]``
    and MLA's ``w_uk [r, h, nope]`` / ``w_uq [qr, h, nope + rope]``), so
    this copies leaf by leaf."""
    return params_from_jax(tree, device)


def lm_params_to_numpy(params) -> Dict:
    """The inverse of ``lm_params_from_jax``."""
    return params_to_numpy(params)
