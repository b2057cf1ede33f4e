#!/usr/bin/env python3
"""cuDNN's algorithm choice and the port's FL runs on the card.

    python3 scripts/torch_cudnn_pin.py [--out FILE]

Two measurements on CNN-FEMNIST at full width (246,590 params, the data
and learning rate of ``chip_smoke.py``'s main path), each with cuDNN
pinned (``torch.backends.cudnn.deterministic = True``, ``benchmark =
False``) and with PyTorch's defaults (``deterministic = False``,
``benchmark = False``), TF32 off in both:

* ``repeat``: fedp2p and gossip_async at the JAX package's Table-1
  participation (10 participants: fedp2p L = 5, Q = 2) for three rounds
  from the same weights and the same draws, each run twice in this
  process; the per-round train losses are printed in full, so two
  processes (or two calls) can be compared too;
* ``cost``: seconds per round of fedp2p, fedavg and gossip (the main
  path's configurations: 100, 10 and 100 participants), two rounds after
  a warm-up round, in the order default, pinned, pinned, default.

Prints one JSON line per measurement and the card's name and power limit;
``--out`` also writes them to a file. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def set_cudnn(torch, pinned: bool) -> None:
    torch.backends.cudnn.deterministic = pinned
    torch.backends.cudnn.benchmark = False


def run(torch, net, data, kw, algo, rounds, pinned):
    """Per-round train losses and seconds of ``rounds`` rounds of ``algo``
    from ``init_params(0)`` with draws from a card generator seeded 1 (as
    ``Simulator.run`` draws them)."""
    from repro_torch.config import FLConfig
    from repro_torch.core.simulator import Simulator
    sim = Simulator(net, data, FLConfig(**kw))
    engine = sim.engine(algo)          # the port turns TF32 off
    set_cudnn(torch, pinned)           # then this run's cuDNN mode
    params = sim.init_params(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = engine.run_rounds(params, gen, rounds)
    torch.cuda.synchronize()
    return m["train_loss"].tolist(), time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.paper_models import CNN_FEMNIST
    from repro_torch.data.federated import pseudo_femnist_federated
    data = pseudo_femnist_federated(100, num_classes=62, seed=0)
    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    table1 = {"lr": 0.05, "num_clusters": 5, "devices_per_cluster": 2,
              "participation": 10}
    for algo in ("fedp2p", "gossip_async"):
        for pinned in (True, False):
            losses = [run(torch, CNN_FEMNIST, data, table1, algo, 3,
                          pinned)[0] for _ in range(2)]
            emit({"measure": "repeat", "algorithm": algo, "participants": 10,
                  "cudnn_pinned": pinned, "train_loss_run1": losses[0],
                  "train_loss_run2": losses[1],
                  "equal": losses[0] == losses[1]})
    main_path = {"fedp2p": {"lr": 0.05}, "fedavg": {"lr": 0.05},
                 "gossip": {"lr": 0.05, "participation": 100}}
    for algo, kw in main_path.items():
        secs = {}
        for pinned in (False, True, True, False):
            run(torch, CNN_FEMNIST, data, kw, algo, 1, pinned)   # warm-up
            _, s = run(torch, CNN_FEMNIST, data, kw, algo, 2, pinned)
            secs.setdefault("pinned" if pinned else "default", []).append(
                s / 2)
        emit({"measure": "cost", "algorithm": algo,
              "seconds_per_round": secs})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"nvidia_smi": smi, "device": torch.cuda.get_device_name(0)})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
