#!/usr/bin/env python3
"""Device times of the port's kernels from one source tree, for comparing
two trees on one card.

    python3 scripts/torch_kernel_ab.py --src DIR [--label NAME] [--out FILE]

Imports ``repro_torch`` from ``DIR`` (a checkout's ``src/``; its kernels
build into that checkout's ``build/``) and times, with ``chip_smoke.py``'s
inputs and its ``device_ms`` (torch.profiler, mean of 20 calls after 3
warm-up calls), the summed device time of every kernel one call launches:

* ``flash_attention`` at Hymba-1.5B's 2048-position prefill (B 4, 25/5
  heads of 64, 128 meta tokens), window 1024 and a full layer, and at
  gemma-2b's (B 4, 8/1 heads of 256, causal; null where the tree's
  wrapper refuses head_dim 256);
* ``ssd_scan`` at Hymba's SSM heads (50 x 64, state 16, chunk 128, an
  initial state);
* ``fed_mix_matching`` at the FL main shape (D = 100, P = 246,590, f32),
  S = 2 (gossip's ring) and S = 1 (gossip_async);
* one Hymba-1.5B serving prefill at full width (B 4, 1920 tokens: 2048
  positions; seeded weights drawn on the card; mean of 3 after one
  warm-up);

and, on the host clock around synchronized work, ``Simulator.run``'s
seconds per round of fedp2p on CNN-FEMNIST at full width (100 clients,
default ``FLConfig`` with lr 0.05): one warm-up round, then 3 rounds.

Run it once per tree in turns (parent, change, change, parent) inside one
call to compare two versions; each run prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def fedp2p_seconds_per_round(torch, rounds=3):
    import time

    from repro_torch.config import FLConfig
    from repro_torch.configs.paper_models import CNN_FEMNIST
    from repro_torch.core.simulator import Simulator
    from repro_torch.data.federated import pseudo_femnist_federated
    sim = Simulator(CNN_FEMNIST, pseudo_femnist_federated(100, num_classes=62,
                                                          seed=0),
                    FLConfig(lr=0.05))
    sim.run(rounds=1, algorithm="fedp2p")           # warm up cuDNN
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(rounds=rounds, algorithm="fedp2p")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / rounds


def hymba_prefill_ms(torch, cs):
    """{"ms": summed device time of one prefill's kernels, ...}."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.model import build_model
    model = build_model(get_config(cs.LM_ARCH))
    params = model.init(0, device="cuda")
    prefill = build_prefill_step(model)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (cs.LM_B, cs.LM_PROMPTS[1]))).cuda()

    def run():
        prefill(params, {"tokens": tokens},
                model.make_cache(cs.LM_B, cs.LM_S))

    per = cs.device_ms(torch, run, reps=3, warmup=1)
    return {"ms": sum(per.values()),
            "flash_ms": sum(v for k, v in per.items()
                            if "flash_fwd_kernel" in k)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import backend
    from repro_torch.kernels.fed_mix_sparse import fed_mix_matching
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    backend.use_full_f32()
    backend.build(("flash_attention", "ssd_scan", "fed_mix_matching",
                   "fed_mix_segment"))
    rows = {}

    def record(key, fn):
        per = cs.device_ms(torch, fn)
        rows[key] = {"ms": sum(per.values()),
                     "kernels_ms": {k[:60]: v for k, v in per.items()}}

    q, k, v = cs.attention_inputs(torch, cs.LM_B, cs.LM_HQ, cs.LM_HKV,
                                  cs.LM_S, cs.LM_HD, torch.float32, seed=7)
    for window in (cs.LM_WINDOW, 0):
        record(f"flash_window{window}",
               lambda: flash_attention(q, k, v, window=window,
                                       num_meta=cs.LM_META))
    qw, kw_, vw = cs.attention_inputs(torch, cs.LM_B, cs.WIDE_HQ,
                                      cs.WIDE_HKV, cs.LM_S, cs.WIDE_HD,
                                      torch.float32, seed=9)
    try:
        record("flash_gemma_hd256", lambda: flash_attention(qw, kw_, vw))
    except ValueError as exc:        # a tree whose wrapper caps head_dim
        rows["flash_gemma_hd256"] = {"ms": None, "error": str(exc)}
    args_ssd, init = cs.ssd_inputs(torch, cs.LM_B, cs.LM_S, 50, 64, 16, 8,
                                   True)
    record("ssd_scan_hymba",
           lambda: ssd_scan(*args_ssd, chunk=128, initial_state=init))
    for stages in (2, 1):
        m = cs.matching_inputs(torch, cs.MAIN_D, cs.MAIN_P, stages,
                               torch.float32, seed=3)
        record(f"fed_mix_matching_S{stages}", lambda: fed_mix_matching(*m))
    rows["hymba_prefill"] = hymba_prefill_ms(torch, cs)
    rows["fedp2p_seconds_per_round"] = fedp2p_seconds_per_round(torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    line = json.dumps({"label": args.label or args.src, "nvidia_smi": smi,
                       "times": rows})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
