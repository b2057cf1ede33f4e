"""Step functions (the counterpart of ``repro.launch.steps``), without a
mesh: the train step (forward and backward through ``torch.autograd``,
gradient accumulation over microbatches, global-norm clipping and the
optimizer update) and the serving steps (the model's prefill and decode
under ``torch.inference_mode``). The model axis's shardings wait for
ROADMAP items 13b and 15; federated training over clients is
``protocols.engine.MeshEngine``."""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.config import TrainConfig
from repro_torch.kernels.ops import tree_flatten, tree_unflatten
from repro_torch.models.model import Model
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import apply_updates, clip_by_global_norm


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


def build_train_step(model: Model, train_cfg: TrainConfig):
    """-> (train_step, optimizer). ``train_step(params, opt_state, batch)``
    returns (new params, new optimizer state, {"loss", "grad_norm", "ce",
    "aux"}), every metric a 0-d tensor on the params' device. With
    ``train_cfg.microbatches = mb > 1`` the batch's rows i, i + mb, ... form
    microbatch i (the JAX package's split), whose f32 gradients are summed
    in order and divided by mb. The clipping and the optimizer update run
    under the profiler label ``train_step.optimizer``."""
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
