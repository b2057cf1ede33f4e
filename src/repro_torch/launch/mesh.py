"""The mesh on ``torch.distributed`` (the counterpart of
``repro.launch.mesh``), and the launch of its ranks.

A ``Mesh`` names the axes of a process group's ranks: ``(data, model)``
or ``(pod, data, model)``, as ``MeshConfig`` lays them out. The port's
mesh has client axes only (``model`` is 1): rank i holds client i's rows.
``make_mesh`` needs an initialized process group of the mesh's size.

``run_ranks`` starts a world of ranks as spawned processes, one
``init_process_group`` each, and gathers what each returns. The caller
picks the backend from the layout: ``nccl`` where each rank has a card of
its own, ``gloo`` otherwise (the CPU, or several ranks sharing one card,
which NCCL refuses). A backend that cannot take the tensors raises;
nothing swaps it for another.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import MeshConfig


@dataclass(frozen=True)
class Mesh:
    """Axis sizes and names over the ranks of ``group`` (None: the
    default group)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    group: Optional[object] = None


def make_mesh(cfg: MeshConfig, group=None) -> Mesh:
    """The mesh of ``cfg`` over ``group``'s ranks; their count must be
    ``cfg.num_devices``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size(group)
    if world != cfg.num_devices:
        raise ValueError(f"mesh {dict(zip(cfg.axis_names, cfg.shape))} "
                         f"needs {cfg.num_devices} ranks; the process group "
                         f"has {world}")
    return Mesh(shape=cfg.shape, axis_names=cfg.axis_names, group=group)


def make_debug_mesh(data: int = 2, model: int = 1, *, pod: int = 1,
                    group=None) -> Mesh:
    """A small mesh for tests (rank count permitting)."""
    return make_mesh(MeshConfig(data=data, model=model, pod=pod), group)


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port on localhost that is free now (for a ``tcp://``
    rendezvous)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, backend, init_method, timeout, jobs,
               results):
    try:
        fn, args = jobs.get()
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=timedelta(seconds=timeout))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def run_ranks(fn: Callable, world_size: int, args: tuple = (), *,
              backend: str = "gloo", init_method: Optional[str] = None,
              timeout: float = 300.0) -> List:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes, each in a process group of ``backend`` joined at
    ``init_method`` (default ``tcp://localhost:<a free port>``), and
    return the ranks' results in rank order. ``fn`` and ``args`` are
    pickled: ``fn`` must be importable by name. A rank that raises or
    dies fails the call, and so does a world that has not finished within
    ``timeout`` seconds; either way every rank is stopped."""
    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
    ctx = mp.get_context("spawn")
    jobs, results = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, backend, init_method, timeout,
                               jobs, results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    # the work goes through a queue, not the processes' arguments: a
    # process's arguments are written to it while it starts, and a large
    # payload would hold each start until the rank before it had read it
    for _ in procs:
        jobs.put((fn, args))
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_ranks: {world_size - len(got)} of {world_size} "
                    f"ranks did not finish within {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_ranks: rank(s) {dead} exited "
                                       "without a result") from None
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        _stop(procs)
    return [got[r] for r in range(world_size)]
