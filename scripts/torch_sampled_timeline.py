#!/usr/bin/env python3
"""Where a sampled round's host and card time go, by pipeline depth (the
card only).

    python3 scripts/torch_sampled_timeline.py [--rounds 5] [--out FILE]

Runs ``chip_smoke.sampled_split`` (the cold tier's store gather, window
and scatter at depth 1, then 5 rounds at each depth with the card's idle
gaps between windows), then drives fedp2p at CNN-FEMNIST's full width
over 10^6 clients on the checkpoint tier (K = 100, cuDNN pinned) for
``--rounds`` rounds at depths 1, 2 and 3 with every stage of the driver
wrapped: each call's host start and end and, from CUDA events recorded at
its start and end on the main stream, its device start and end, all in
seconds from the run's start. Prints the timeline and each depth's gaps
between windows; writes everything as JSON to ``--out`` (default
``build/sampled_timeline.json``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAGES = ("round", "_issue_round", "_acquire_window", "_window",
          "_retire_round")
STORE_CALLS = ("gather", "scatter", "prefetch", "write_back")


def wrap(torch, obj, name, log, t0):
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        start = time.perf_counter() - t0[0]
        ev0 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = fn(*args, **kwargs)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        log.append((name, start, time.perf_counter() - t0[0], ev0, ev1))
        return out

    setattr(obj, name, timed)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="build/sampled_timeline.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_sampled_timeline: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.config import FLConfig
    from repro_torch.kernels import backend
    from repro_torch.models.paper_nets import init_paper_net
    backend.use_full_f32()
    print(cs.nvidia_smi(), flush=True)
    backend.build(["fed_mix_segment"])
    split = cs.sampled_split(torch, {})
    print(json.dumps(split), flush=True)
    net, data, kw = cs.femnist_setup(full=True)
    fl = FLConfig(**{**kw, "num_enrolled": cs.SAMPLED_COLD_D,
                     "participants_per_round": 100})
    params = init_paper_net(torch.Generator().manual_seed(0), net,
                            device="cuda")
    timeline = {}
    with cs.cudnn_pinned(torch):
        for depth in (1, 2, 3):
            se = cs.sampled_engine(torch, net, data, fl, "fedp2p", "cuda",
                                   depth=depth)
            se.init_store(params, tier="checkpoint")
            log, t0 = [], [0.0]
            for name in STAGES:
                wrap(torch, se, name, log, t0)
            for name in STORE_CALLS:
                wrap(torch, se.store, name, log, t0)
            base = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0[0] = time.perf_counter()
            base.record()
            se.run_rounds(torch.Generator(device="cuda").manual_seed(3),
                          args.rounds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0[0]
            rows = [(n, s, e, base.elapsed_time(a) / 1e3,
                     base.elapsed_time(b) / 1e3) for n, s, e, a, b in log]
            wins = [r for r in rows if r[0] == "_window"]
            gaps = [b[3] - a[4] for a, b in zip(wins, wins[1:])]
            timeline[depth] = {"wall_s": wall, "gaps_s": gaps,
                               "calls": rows}
            print(f"depth {depth}: wall {wall:.3f} s, card gaps between "
                  f"windows {[round(g, 4) for g in gaps]}", flush=True)
            for r in rows:
                print("   ", r[0], *(f"{v:.4f}" for v in r[1:]), flush=True)
            se.store.close()
            del se
            torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"split": split, "timeline": timeline},
                              default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
