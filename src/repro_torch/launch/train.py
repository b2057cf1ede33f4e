"""Training entry points (the counterpart of ``repro.launch.train``):

  * ``run_lm_training`` — LM training of any architecture:

        python -m repro_torch.launch.train --mode lm --arch mamba2-130m
            [--steps N] [--full] [--ckpt-dir DIR] [--device cuda|cpu]

    without ``--full`` the config is cut to four layers and width 256, as
    the JAX package cuts it. The step is ``launch/steps.py``'s
    ``build_train_step``: on the card the attention and SSD layers run the
    ``flash_attention`` and ``ssd_scan`` kernels forward and their
    hand-written backward kernels.
  * ``run_federated_training`` — the paper's protocol over LM clients with
    heterogeneous token streams, on ``protocols.engine.MeshEngine`` (one
    card: the protocol's mixing kernels):

        python -m repro_torch.launch.train --mode federated
            [--arch A] [--rounds T] [--algorithm fedp2p|fedavg|gossip|...]
            [--codec none|bf16|int8|topk] [--straggler-rate R]
            [--device cuda|cpu]

    at the JAX package's cut (two layers, width 128).

Both run on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch

import numpy as np

from repro_torch import compression, protocols
from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import FLConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.fedp2p import broadcast_to_clients
from repro_torch.data.lm import token_stream_batches
from repro_torch.kernels import backend
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import build_model
from repro_torch.protocols.engine import MeshEngine


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


def run_federated_training(arch: str, *, rounds: int = 20,
                           num_clients: int = 4, num_clusters: int = 2,
                           local_steps: int = 4, batch: int = 4,
                           seq_len: int = 64, algorithm: str = "fedp2p",
                           codec: str = "none", sync_period: int = 1,
                           straggler_rate: float = 0.0, lr: float = 5e-3,
                           seed: int = 0, counts=None, verbose: bool = True,
                           device=None) -> Dict:
    """The paper's protocol over ``num_clients`` LM clients, each on its
    own token stream (a different successor table, seed ``100 + c``), on
    ``arch`` cut to two layers and width 128. ``algorithm`` is any
    registered protocol, ``counts`` the per-client |D_i| weights,
    ``codec`` the lossy wire of every exchanged update. The model is the
    port's seeded init on ``device`` (None: the card); the rounds' draws
    come from a generator seeded ``seed + 1`` on the device. Batches are
    staged in sync_period-aligned chunks of about 64 rounds ([n, D, steps,
    B, S]), each chunk one ``run_rounds`` call; a stateful codec's
    residual is threaded across them. Returns {"losses", "final_loss",
    "first_loss"}, the losses read back once a chunk."""
    cfg = get_config(arch).reduced(num_layers=2, max_d_model=128)
    dev = backend.resolve_device(device)
    model = build_model(cfg)
    fl = FLConfig(num_clusters=num_clusters, lr=lr,
                  straggler_rate=straggler_rate, sync_period=sync_period,
                  algorithm=protocols.get(algorithm).name, codec=codec)
    engine = MeshEngine(model, fl, num_clients, local_steps,
                        algorithm=algorithm, counts=counts, device=dev)
    f_params = broadcast_to_clients(model.init(seed, device=dev),
                                    num_clients)
    streams = [token_stream_batches(cfg.vocab_size, batch, seq_len,
                                    seed=100 + c)
               for c in range(num_clients)]
    sp = max(1, sync_period)
    chunk_rounds = max(sp, (64 // sp) * sp)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    losses = []
    done = 0
    stateful = engine.codec is not None and engine.codec.stateful
    cstate = None
    while done < rounds:
        n = min(chunk_rounds, rounds - done)
        staged = [[[next(streams[c]) for _ in range(local_steps)]
                   for c in range(num_clients)] for _ in range(n)]
        bt = {k: torch.from_numpy(np.stack([[np.stack([s[k] for s in client])
                                             for client in rnd]
                                            for rnd in staged])).to(dev)
              for k in ("tokens", "labels")}
        if stateful:
            f_params, loss_buf, cstate = engine.run_rounds(
                f_params, gen, n, bt, codec_state=cstate)
        else:
            f_params, loss_buf = engine.run_rounds(f_params, gen, n, bt)
        losses.extend(float(x) for x in loss_buf.cpu())
        done += n
    if verbose:
        for t in range(4, rounds, 5):
            print(f"  [{algorithm}] round {t+1:4d} loss={losses[t]:.4f}")
    return {"losses": losses, "final_loss": losses[-1],
            "first_loss": losses[0]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--mode", choices=("lm", "federated"), default="lm")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--algorithm", default="fedp2p",
                    choices=protocols.names())
    ap.add_argument("--codec", default="none", choices=compression.names(),
                    help="lossy wire format for federated exchange")
    ap.add_argument("--straggler-rate", type=float, default=0.0)
    ap.add_argument("--full", action="store_true",
                    help="full (unreduced) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    if args.mode == "lm":
        out = run_lm_training(args.arch, steps=args.steps,
                              reduced=not args.full, ckpt_dir=args.ckpt_dir,
                              device=args.device)
    else:
        out = run_federated_training(args.arch, rounds=args.rounds,
                                     algorithm=args.algorithm,
                                     codec=args.codec,
                                     straggler_rate=args.straggler_rate,
                                     device=args.device)
    print(f"loss {out['first_loss']:.4f} -> {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
