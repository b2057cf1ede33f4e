"""Fault execution: the runtime side of a ``FaultPlan`` (the counterpart
of ``repro.faults.inject``).

``FaultInjector`` is the store-facing half: the ``SampledEngine`` arms it
per round (``begin_round``) and ``protocols.store.CheckpointStore`` calls
its hooks from the read path (``on_read``) and the prefetch worker
(``on_prefetch``). The tensor helpers (``corrupt_flat``, ``guard_flat``) are the engine-side
halves: poison flagged rows inside the round, and the scatter-back guard
that keeps a poisoned row out of the carry. Both are elementwise selects
on the packed buffer with no arithmetic on its floats, so their results
are the JAX package's bit for bit.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.faults.plan import MODE_CODES


class InjectedFault(Exception):
    """Base for faults the plan injects (never raised by real failures)."""


class InjectedReadError(InjectedFault, IOError):
    """A transient checkpoint-tier read failure; the store's
    retry-with-backoff loop is expected to absorb it."""


class InjectedWorkerDeath(InjectedFault, RuntimeError):
    """The prefetch worker died mid-fetch; the engine is expected to fall
    back to a synchronous gather."""


class FaultInjector:
    """Arms the store-tier hooks with the current round's ``FaultSpec``.

    Thread-safety: ``begin_round`` runs on the engine thread while
    ``on_read``/``on_prefetch`` run on the prefetch worker — every hook
    takes one lock. Each armed fault fires AT MOST once (the kill flag and
    read-error budget are consumed), so the recovery path (retry, sync
    fallback) never re-trips the same fault and recovery terminates.
    """

    def __init__(self, plan):
        self.plan = plan
        self._lock = threading.Lock()
        self._read_budget = 0
        self._delay = 0.0
        self._kill = False
        self.counters = {"read_errors": 0, "delays": 0, "worker_deaths": 0}

    def begin_round(self, t: int) -> None:
        spec = self.plan.for_round(t)
        with self._lock:
            self._read_budget = 0 if spec is None else int(spec.read_errors)
            self._delay = 0.0 if spec is None else float(spec.prefetch_delay)
            self._kill = bool(spec is not None and spec.kill_prefetch)

    def on_read(self) -> None:
        """Called before each store read attempt; raises while the round's
        injected-read budget lasts (each raise consumes one)."""
        with self._lock:
            if self._read_budget <= 0:
                return
            self._read_budget -= 1
            self.counters["read_errors"] += 1
        raise InjectedReadError("injected transient checkpoint read error")

    def on_prefetch(self) -> None:
        """Called on the prefetch worker before it fetches: stalls by the
        round's delay, then dies if the round kills the worker."""
        with self._lock:
            delay, self._delay = self._delay, 0.0
            kill, self._kill = self._kill, False
        if delay > 0.0:
            self.counters["delays"] += 1
            time.sleep(delay)
        if kill:
            self.counters["worker_deaths"] += 1
            raise InjectedWorkerDeath("injected prefetch worker death")


def corrupt_rows_np(rows: np.ndarray, corrupt) -> np.ndarray:
    """Host-side poison: ``corrupt`` is ``[(row_idx, mode), ...]`` into
    ``rows`` (copied, [n, S]). Mirrors ``corrupt_flat`` bit for bit."""
    out = np.array(rows, copy=True)
    for i, mode in corrupt:
        if mode == "nan":
            out[i] = np.nan
        elif mode == "inf":
            out[i] = np.inf
        elif mode == "bitflip":
            out[i] = (out[i].view(np.int32) ^ (1 << 30)).view(out.dtype)
        else:
            raise ValueError(f"unknown corrupt mode {mode!r}")
    return out


def corrupt_flat(flat: torch.Tensor, flag: torch.Tensor,
                 mode: torch.Tensor) -> torch.Tensor:
    """Poison of a packed buffer: rows of ``flat`` [K, S] f32 with ``flag``
    [K] > 0 are replaced per ``mode`` [K] int32 (``MODE_CODES``). The bit
    flip XORs an exponent bit through an int32 view — the row stays finite
    but wrong, so only the fault flag can catch it. A new tensor; ``flat``
    is not modified."""
    if flat.dtype != torch.float32:
        raise TypeError(f"corrupt_flat expects a packed float32 window, "
                        f"got {flat.dtype}")
    flipped = (flat.view(torch.int32) ^ (1 << 30)).view(torch.float32)

    def rows(m):
        return (mode == MODE_CODES[m])[:, None]

    poison = torch.where(rows("nan"), torch.full_like(flat, float("nan")),
                         torch.where(rows("inf"),
                                     torch.full_like(flat, float("inf")),
                                     flipped))
    return torch.where((flag > 0)[:, None], poison, flat)


def guard_flat(new_flat: torch.Tensor, old_flat: torch.Tensor, flag=None):
    """The scatter-back guard: reject any row of ``new_flat`` [K, S] that
    is non-finite or fault-flagged, reverting it to ``old_flat``'s
    pre-round row. Returns ``(guarded [K, S], rejected [K] bool)``."""
    bad = ~torch.isfinite(new_flat).all(dim=1)
    if flag is not None:
        bad = bad | (flag > 0)
    return torch.where(bad[:, None], old_flat, new_flat), bad
