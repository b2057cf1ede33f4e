"""LM training driver (the counterpart of ``repro.launch.train``'s
``run_lm_training`` and ``main``):

    python -m repro_torch.launch.train --mode lm --arch mamba2-130m
        [--steps N] [--full] [--ckpt-dir DIR] [--device cuda|cpu]

runs on the card unless ``--device cpu``; without ``--full`` the config is
cut to four layers and width 256, as the JAX package cuts it. The step is
``launch/steps.py``'s ``build_train_step``: on the card the attention and
SSD layers run the ``flash_attention`` and ``ssd_scan`` kernels forward and
their hand-written backward kernels. ``--mode federated`` (the paper's
protocol over LM clients) waits for ROADMAP item 13.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data.lm import token_stream_batches
from repro_torch.kernels import backend
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import build_model


def run_lm_training(arch: str, *, steps: int = 100, batch: int = 8,
                    seq_len: int = 128, reduced: bool = True,
                    train_cfg: Optional[TrainConfig] = None,
                    ckpt_dir: Optional[str] = None, log_every: int = 10,
                    seed: int = 0, verbose: bool = True,
                    device=None) -> Dict:
    """Train ``arch`` on the synthetic token stream for ``steps`` steps
    from the port's seeded init (drawn on ``device``; None is the card).
    Returns {"losses", "final_loss", "first_loss", "steps"} as the JAX
    package does, and "step_seconds": each step's host time, which ends at
    the read of its loss (a synchronization on the card). Checkpoints of
    {"params": ...} at every ``steps // 2`` steps when ``ckpt_dir``."""
    cfg = get_config(arch)
    if cfg.family == "audio":
        raise ValueError(
            f"run_lm_training draws a token stream, which {arch!r} (audio) "
            "cannot take: build its step with launch.steps.build_train_step "
            "and feed it the embeds batch ({'embeds', 'cross_context', "
            "'labels' [B, S, K]})")
    if reduced:
        cfg = cfg.reduced(num_layers=4, max_d_model=256)
    dev = backend.resolve_device(device)
    model = build_model(cfg)
    tc = train_cfg or TrainConfig(lr=3e-3, schedule="warmup_cosine",
                                  warmup_steps=max(10, steps // 10),
                                  total_steps=steps, remat=False)
    step_fn, opt = build_train_step(model, tc)

    params = model.init(seed, device=dev)
    opt_state = opt.init(params)
    stream = token_stream_batches(cfg.vocab_size, batch, seq_len, seed=seed)
    losses, step_seconds = [], []
    t0 = time.time()
    for i in range(steps):
        t_step = time.perf_counter()
        batch_t = {k: torch.from_numpy(v).to(dev)
                   for k, v in next(stream).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch_t)
        losses.append(float(metrics["loss"]))
        step_seconds.append(time.perf_counter() - t_step)
        if verbose and ((i + 1) % log_every == 0 or i == 0):
            print(f"  step {i+1:5d} loss={losses[-1]:.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
        if ckpt_dir and (i + 1) % max(1, steps // 2) == 0:
            save_checkpoint(ckpt_dir, i + 1, {"params": params})
    return {"losses": losses, "final_loss": losses[-1],
            "first_loss": losses[0], "steps": steps,
            "step_seconds": step_seconds}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--mode", choices=("lm", "federated"), default="lm")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--full", action="store_true",
                    help="full (unreduced) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    if args.mode == "federated":
        raise NotImplementedError(
            "--mode federated (the paper's protocol over LM clients) is not "
            "ported to repro_torch yet (ROADMAP item 13)")
    out = run_lm_training(args.arch, steps=args.steps,
                          reduced=not args.full, ckpt_dir=args.ckpt_dir,
                          device=args.device)
    print(f"loss {out['first_loss']:.4f} -> {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
