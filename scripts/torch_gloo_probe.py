#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives the ``gloo`` backend takes for
CUDA tensors, and how long each kernel source's ``nvcc`` takes.

    python3 scripts/torch_gloo_probe.py [--ranks 2] [--no-build]

Part 1 builds every kernel source of ``src/repro_torch/kernels/csrc`` in
parallel (one ``nvcc`` each, the flags of ``kernels/backend.py``), polling
them so each source's own wall seconds are read when it ends. Part 2
spawns ``--ranks`` gloo ranks on card 0 and tries, on CUDA tensors,
``all_reduce``, ``all_gather``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single`` and ``broadcast``,
each held against the value it should give; it prints one JSON line
``{"build_seconds": ..., "collectives": {name: "ok" | error}}``.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def build_seconds():
    """Each source's nvcc wall seconds, all started together."""
    from repro_torch.kernels import backend
    backend.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in backend.KERNELS:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=backend.BUILD_DIR)
        os.close(fd)
        cmd = [backend.nvcc(), *backend.NVCC_FLAGS, "-o", tmp,
               str(backend.CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                        stderr=subprocess.DEVNULL), tmp)
    t0, done = time.perf_counter(), {}
    while len(done) < len(procs):
        for name, (proc, tmp) in procs.items():
            if name not in done and proc.poll() is not None:
                done[name] = (round(time.perf_counter() - t0, 1),
                              proc.returncode)
                Path(tmp).unlink(missing_ok=True)
        time.sleep(0.2)
    return done


def probe_rank(rank, world):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    out = {}

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as exc:  # noqa: BLE001 -- recorded per collective
            out[name] = f"{type(exc).__name__}: {str(exc)[:200]}"

    def all_reduce():
        x = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        assert float(x[0]) == world * (world + 1) / 2

    def all_gather():
        x = torch.full((3,), float(rank), device=dev)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        assert [float(p[0]) for p in parts] == list(range(world))

    def all_gather_into_tensor():
        x = torch.full((3,), float(rank), device=dev)
        y = torch.empty((world * 3,), device=dev)
        dist.all_gather_into_tensor(y, x)
        assert float(y[3 * (world - 1)]) == world - 1

    def reduce_scatter_tensor():
        x = torch.arange(world * 2, dtype=torch.float32, device=dev)
        y = torch.empty((2,), device=dev)
        dist.reduce_scatter_tensor(y, x)
        assert float(y[0]) == world * 2 * rank

    def all_to_all_single():
        x = torch.arange(world, dtype=torch.float32, device=dev) + 10 * rank
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        assert [float(v) for v in y] == [10 * r + rank for r in range(world)]

    def broadcast():
        x = torch.full((2,), float(rank), device=dev)
        dist.broadcast(x, 0)
        assert float(x[0]) == 0.0

    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("reduce_scatter_tensor", reduce_scatter_tensor),
                     ("all_to_all_single", all_to_all_single),
                     ("broadcast", broadcast)):
        attempt(name, fn)
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--no-build", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gloo_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch.mesh import run_ranks
    res = {"device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda}
    if not args.no_build:
        res["build_seconds"] = build_seconds()
    per_rank = run_ranks(probe_rank, args.ranks, backend="gloo",
                         timeout=300)
    res["collectives"] = per_rank[0]
    res["agree_across_ranks"] = all(r == per_rank[0] for r in per_rank)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
