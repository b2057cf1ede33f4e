"""Step functions (the counterpart of ``repro.launch.steps``): the train
step (forward and backward through ``torch.autograd``, gradient
accumulation over microbatches, global-norm clipping and the optimizer
update) and the serving steps (the model's prefill and decode under
``torch.inference_mode``).

Given a ``MeshInfo`` the serving steps run on this rank's blocks of the
params, cache and batch, with the activation rules of their mode
installed by ``use_rules`` as in the JAX package: prefill on the
``make_param_specs(mode="train")`` layout and decode on the
``mode="decode"`` (weight-stationary) one, as the JAX package's dry-run
lowers them (``decode_params`` moves one to the other: an all-gather
over the data axes). Training on a mesh (gradients through the
collectives, the gradient pins, microbatches over shards) is ROADMAP item
13b.2: ``build_train_step`` raises for a mesh of more than one rank.
Federated training over clients is ``protocols.engine.MeshEngine``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.profiler import record_function

from repro_torch.config import TrainConfig
from repro_torch.kernels.ops import tree_flatten, tree_unflatten
from repro_torch.models.model import Model
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import apply_updates, clip_by_global_norm
from repro_torch.sharding.context import use_rules
from repro_torch.sharding.rules import (
    MeshInfo, make_activation_rules, make_param_specs,
)


def _loss_and_grad(model: Model, remat: bool):
    """(params, batch) -> (loss, metrics, grads): ``model.loss_fn`` and its
    gradient with respect to every leaf of ``params`` (zeros for a leaf
    the loss does not read, as JAX gives), all detached."""

    def fn(params, batch):
        leaves, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, metrics = model.loss_fn(tree_unflatten(treedef, leaves),
                                          batch, remat=remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(treedef, grads))

    return fn


def build_train_step(model: Model, train_cfg: TrainConfig,
                     info: Optional[MeshInfo] = None, batch_size: int = 0):
    """-> (train_step, optimizer). ``train_step(params, opt_state, batch)``
    returns (new params, new optimizer state, {"loss", "grad_norm", "ce",
    "aux"}), every metric a 0-d tensor on the params' device. With
    ``train_cfg.microbatches = mb > 1`` the batch's rows i, i + mb, ... form
    microbatch i (the JAX package's split), whose f32 gradients are summed
    in order and divided by mb. The clipping and the optimizer update run
    under the profiler label ``train_step.optimizer``."""
    if info is not None and info.world_size > 1:
        raise NotImplementedError(
            f"training on a mesh of {dict(zip(info.axis_names, info.axis_sizes))}"
            " (gradients through the model axis's collectives, the gradient "
            "pins, microbatches over shards) is ROADMAP item 13b.2; the "
            "port's train step runs on one device")
    # torch.utils.checkpoint (the chunked CE's, and remat's) imports
    # torch._dynamo on its first call, and that import leaves reference
    # cycles through the frames it runs under: a first step would keep its
    # params, gradients and updates alive until Python's cyclic collector
    # ran (one to three param-sized copies more at the next update's peak,
    # 8.6 GB each at 2.15 B params). Imported here, outside any step.
    import torch._dynamo  # noqa: F401
    opt = make_optimizer(train_cfg)
    loss_and_grad = _loss_and_grad(model, train_cfg.remat)
    mb = max(1, train_cfg.microbatches)

    def train_step(params, opt_state, batch):
        if mb == 1:
            loss, metrics, grads = loss_and_grad(params, batch)
        else:
            for k, leaf in batch.items():
                if leaf.shape[0] % mb:
                    raise ValueError(f"train_step: batch[{k!r}] has "
                                     f"{leaf.shape[0]} rows, not a multiple "
                                     f"of microbatches={mb}")
            g_acc, loss_sum = None, None
            for i in range(mb):
                loss_i, _, g = loss_and_grad(
                    params, {k: v[i::mb] for k, v in batch.items()})
                leaves, treedef = tree_flatten(g)
                leaves = [x.to(torch.float32) for x in leaves]
                if g_acc is None:
                    g_acc, loss_sum = leaves, loss_i
                else:
                    g_acc = [a + x for a, x in zip(g_acc, leaves)]
                    loss_sum = loss_sum + loss_i
            grads = tree_unflatten(treedef, [a / mb for a in g_acc])
            loss = loss_sum / mb
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        with torch.no_grad(), record_function("train_step.optimizer"):
            grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
            updates, new_opt = opt.update(grads, opt_state, params)
            # the gradients are not read again: freed before the new
            # params are made (4 B a param off the update's peak)
            del grads
            new_params = apply_updates(params, updates)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm,
                                     **metrics}

    return train_step, opt


def param_specs(model: Model, info: MeshInfo, mode: str = "train") -> Dict:
    """The spec tree of ``model``'s params on ``info``'s mesh in the
    layout of ``mode`` (train | decode; prefill uses train's)."""
    from repro_torch.sharding.place import param_shapes
    return make_param_specs(param_shapes(model.cfg), model.cfg, info,
                            "decode" if mode == "decode" else "train")


def decode_params(model: Model, params: Dict, info: MeshInfo,
                  release: bool = False) -> Dict:
    """This rank's blocks in the train layout -> in the decode layout
    (``release``: the train blocks are dropped from ``params`` as they
    go, see ``sharding.place.reshard``)."""
    from repro_torch.sharding.place import reshard
    return reshard(params, param_specs(model, info, "train"),
                   param_specs(model, info, "decode"), info, release)


def _serving_step(model: Model, mode: str, info: Optional[MeshInfo],
                  batch_size: int):
    rules = specs = None
    if info is not None:
        rules = make_activation_rules(model.cfg, info, mode=mode,
                                      batch=batch_size)
        specs = param_specs(model, info, mode)
    fn = model.prefill if mode == "prefill" else model.decode

    @torch.inference_mode()
    def step(params, a, b):
        with use_rules(rules, mesh_info=info, param_specs=specs,
                       batch=batch_size):
            return fn(params, a, b)

    return step


def build_prefill_step(model: Model, info: Optional[MeshInfo] = None,
                       batch_size: int = 0):
    """``prefill_step(params, batch, cache)``; on a mesh, this rank's
    blocks (train layout) of a global batch of ``batch_size`` rows: its
    logits are vocab-sharded (``layers.gather_vocab``)."""
    return _serving_step(model, "prefill", info, batch_size)


def build_decode_step(model: Model, info: Optional[MeshInfo] = None,
                      batch_size: int = 0):
    """``decode_step(params, cache, batch)``; on a mesh, this rank's
    blocks in the decode layout (``decode_params``)."""
    return _serving_step(model, "decode", info, batch_size)
