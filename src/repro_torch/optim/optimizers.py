"""Optimizers on parameter trees (the counterpart of
``repro.optim.optimizers``): SGD, momentum, AdamW, as plain tensor
arithmetic, not ``torch.optim`` (whose AdamW applies the weight decay and
eps elsewhere).

The API mirrors the optax pattern of the JAX package:

    opt = adamw(lr=..., ...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)   # updates = deltas
    params = apply_updates(params, updates)

Trees are nested dicts of tensors, walked in JAX's leaf order
(``ops.tree_flatten``); the step counter is a 0-d int32 tensor on the
parameters' device. Learning rates may be floats or schedules (callables
of the step). Every function returns new tensors, as the JAX package does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Union

import torch

from repro_torch.config import TrainConfig
from repro_torch.kernels.ops import tree_flatten, tree_unflatten

Schedule = Union[float, Callable]


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(lr(step) if callable(lr) else lr,
                           dtype=torch.float32, device=step.device)


def _map(fn, *trees):
    """``fn`` over the leaves of same-structure trees -> a tree (or a
    tuple of trees when ``fn`` returns tuples)."""
    leaves, treedef = tree_flatten(trees[0])
    rest = [tree_flatten(t)[0] for t in trees[1:]]
    out = [fn(*args) for args in zip(leaves, *rest)]
    if out and isinstance(out[0], tuple):
        return tuple(tree_unflatten(treedef, list(col)) for col in zip(*out))
    return tree_unflatten(treedef, out)


def _device(tree) -> torch.device:
    return tree_flatten(tree)[0][0].device


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def apply_updates(params, updates):
    return _map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype),
                params, updates)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so that their global L2 norm is at most ``max_norm``,
    the norm before clipping); the squares are summed leaf by leaf in JAX's
    leaf order."""
    leaves = tree_flatten(grads)[0]
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    norm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return _map(lambda g: g * scale.to(g.dtype), grads), norm


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _zeros(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params=None):
        step = state["step"]
        eta = _lr_at(lr, step)
        updates = _map(lambda g: -eta * g.to(torch.float32), grads)
        return updates, {"step": step + 1}

    return Optimizer(init, update)


def momentum(lr: Schedule, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"step": _step0(params), "m": _zeros(params)}

    def update(grads, state, params=None):
        step = state["step"]
        eta = _lr_at(lr, step)
        m = _map(lambda mo, g: beta * mo + g.to(torch.float32),
                 state["m"], grads)
        updates = _map(lambda mo: -eta * mo, m)
        return updates, {"step": step + 1, "m": m}

    return Optimizer(init, update)


def adamw(lr: Schedule, beta1: float = 0.9, beta2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"step": _step0(params), "m": _zeros(params),
                "v": _zeros(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        eta = _lr_at(lr, step)
        stepf = step.to(torch.float32)
        bc1 = 1.0 - beta1 ** stepf
        bc2 = 1.0 - beta2 ** stepf

        def upd(g, m, v, p):
            # the JAX package's operations in its order; each result is
            # written over a temporary of this leaf's own where it can be,
            # so that at most two leaf-sized temporaries live beside the
            # outputs (at full width the largest leaf is GBs)
            g = g.to(torch.float32)
            m_new = (beta1 * m).add_((1 - beta1) * g)
            v_new = (beta2 * v).add_(torch.square(g).mul_(1 - beta2))
            denom = (v_new / bc2).sqrt_().add_(eps)
            delta = (m_new / bc1).div_(denom)
            del denom
            delta.add_(weight_decay * p.to(torch.float32))
            return delta.mul_(-eta), m_new, v_new

        updates, m, v = _map(upd, grads, state["m"], state["v"], params)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def make_optimizer(cfg: TrainConfig, lr: Schedule = None) -> Optimizer:
    """The configured optimizer at ``lr`` (default ``cfg.lr``, a constant:
    as in the JAX package, the train step does not read ``cfg.schedule``)."""
    lr = cfg.lr if lr is None else lr
    if cfg.optimizer == "sgd":
        return sgd(lr)
    if cfg.optimizer == "momentum":
        return momentum(lr, cfg.momentum)
    if cfg.optimizer == "adamw":
        return adamw(lr, cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay)
    raise ValueError(cfg.optimizer)
