"""Activation-sharding context (the counterpart of
``repro.sharding.context``).

Model code calls ``shard(x, "act_btd")`` where the JAX package does. A
launcher installs the activation rules (logical name -> spec) with
``use_rules``, together with the ``MeshInfo`` the modules' collectives run
on and the parameter specs the layers' weights are gathered from. In the
JAX package ``shard`` is ``with_sharding_constraint``: GSPMD then moves
the data. Here each rank holds its local slice already, so ``shard``
checks that the local tensor has the shape the rule gives it and returns
it: a layout that is wrong raises where JAX would constrain. Without
rules, ``shard`` is the identity, and the same model code runs on one
device.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence

import torch

_state = threading.local()


def current_rules() -> Optional[Dict]:
    return getattr(_state, "rules", None)


def current_mesh_info():
    """The ``MeshInfo`` installed by the launcher (None on one device)."""
    return getattr(_state, "mesh_info", None)


def current_param_specs() -> Optional[Dict]:
    """The spec tree of the parameters the running step was handed (None:
    the weights are whole, or already in the form the layers use)."""
    return getattr(_state, "param_specs", None)


@contextlib.contextmanager
def use_rules(rules: Optional[Dict], mesh_info=None, param_specs=None,
              batch: int = 0):
    """Install ``rules`` (made for the global batch ``batch``), the
    ``MeshInfo`` and the parameters' spec tree for the block's calls."""
    prev = (current_rules(), current_mesh_info(), current_param_specs(),
            getattr(_state, "batch", 0))
    _state.rules, _state.mesh_info, _state.param_specs, _state.batch = (
        rules, mesh_info, param_specs, batch)
    try:
        yield
    finally:
        (_state.rules, _state.mesh_info, _state.param_specs,
         _state.batch) = prev


def activation_spec(name: str):
    rules = current_rules()
    return None if rules is None else rules.get(name)


def local_dim(n: int, axes: Sequence[str], info) -> int:
    """The local size of a dim of global size ``n`` split over ``axes``:
    n / their size where it divides; whole where it does not (the port
    cannot pad, so a rule that does not divide a dim leaves it whole)."""
    k = info.size(axes)
    return n // k if n % k == 0 else n


def shard(x: torch.Tensor, name: str, full: Sequence[Optional[int]]
          ) -> torch.Tensor:
    """Check ``x`` against the rule ``name`` and return it (the identity
    without rules). ``full`` is the tensor's global shape, None for the
    batch dim (the global batch the rules were made for)."""
    spec = activation_spec(name)
    if spec is None:
        return x
    info = current_mesh_info()
    full = tuple(getattr(_state, "batch", 0) if n is None else n
                 for n in full)
    want = tuple(local_dim(n, axes, info) for n, axes in zip(full, spec))
    want = want + tuple(full[len(spec):])
    if tuple(x.shape) != want:
        raise ValueError(f"shard({name!r}): the local tensor is "
                         f"{tuple(x.shape)}, the rule {spec} gives {want} "
                         f"of the global {tuple(full)}")
    return x
