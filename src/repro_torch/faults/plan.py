"""Fault plans: frozen per-round fault schedules drawn from one seed — a
copy of ``repro.faults.plan`` (numpy only): the same seed gives the same
plan, bit for bit.

A ``FaultPlan`` is pure data — no clocks, no RNG state at run time — so
the same plan replayed against the same engine key gives bit-identical
failures, selections, and recoveries. That determinism is what lets the
chaos soak assert bounded degradation and lets tests pin exact counter
values.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

#: corrupted-update poison modes: ``nan`` scatters NaNs through the row,
#: ``inf`` floods it, ``bitflip`` flips an exponent bit (the row stays
#: FINITE — only the fault *flag* catches it, exercising the guard's
#: flagged-row path, not just the isfinite path)
CORRUPT_MODES = ("nan", "inf", "bitflip")

#: mode name -> the int code the traced dense-engine arrays carry
MODE_CODES = {m: i for i, m in enumerate(CORRUPT_MODES)}


@dataclass(frozen=True)
class FaultSpec:
    """Every fault one round injects. Client references are ENROLLED ids
    (store row numbers); on resident engines id == row slot and ids >= P
    are ignored."""
    round_index: int
    #: client ids whose update never arrives (dropout mid-round)
    drop: Tuple[int, ...] = ()
    #: (client id, mode) corrupted-upload rows; mode in ``CORRUPT_MODES``
    corrupt: Tuple[Tuple[int, str], ...] = ()
    #: transient checkpoint-tier read failures to inject this round (each
    #: consumes one store read attempt; the store's retry loop recovers)
    read_errors: int = 0
    #: seconds the prefetch worker stalls before fetching (a slow link)
    prefetch_delay: float = 0.0
    #: the prefetch worker dies mid-fetch — the handle raises and the
    #: engine must fall back to a synchronous gather
    kill_prefetch: bool = False

    def __post_init__(self):
        for _, mode in self.corrupt:
            if mode not in CORRUPT_MODES:
                raise ValueError(f"unknown corrupt mode {mode!r}; expected "
                                 f"one of {', '.join(CORRUPT_MODES)}")

    @property
    def empty(self) -> bool:
        return not (self.drop or self.corrupt or self.read_errors
                    or self.prefetch_delay or self.kill_prefetch)


@dataclass(frozen=True)
class FaultPlan:
    """The full schedule: one optional ``FaultSpec`` per round. Frozen and
    hashable (engine caches key on it)."""
    specs: Tuple[FaultSpec, ...] = ()
    seed: int = 0
    _by_round: dict = field(default=None, repr=False, compare=False,
                            hash=False)

    def for_round(self, t: int) -> Optional[FaultSpec]:
        """This round's spec, or ``None`` (a fault-free round)."""
        by = object.__getattribute__(self, "_by_round")
        if by is None:
            by = {s.round_index: s for s in self.specs}
            object.__setattr__(self, "_by_round", by)
        spec = by.get(int(t))
        return None if spec is None or spec.empty else spec

    @property
    def empty(self) -> bool:
        return all(s.empty for s in self.specs)

    def dense_arrays(self, T: int, P: int):
        """The plan as traced-friendly arrays for the resident engines'
        scan bodies: ``(drop [T, P] f32, flag [T, P] f32, mode [T, P]
        int32)`` — row slot == client id; ids >= P are ignored. Mode codes
        follow ``MODE_CODES``."""
        drop = np.zeros((T, P), np.float32)
        flag = np.zeros((T, P), np.float32)
        mode = np.zeros((T, P), np.int32)
        for t in range(T):
            spec = self.for_round(t)
            if spec is None:
                continue
            for c in spec.drop:
                if 0 <= c < P:
                    drop[t, c] = 1.0
            for c, m in spec.corrupt:
                if 0 <= c < P:
                    flag[t, c] = 1.0
                    mode[t, c] = MODE_CODES[m]
        return drop, flag, mode


def active(faults) -> Optional[FaultPlan]:
    """Normalize to the injection layer's active form: ``None`` (or a plan
    that injects nothing) -> ``None``, so every engine guard gates on one
    ``is None`` check and the disabled path traces the exact pre-fault
    program — the ``compression.active`` discipline."""
    if faults is None:
        return None
    if not isinstance(faults, FaultPlan):
        raise TypeError(f"faults must be a FaultPlan or None, got "
                        f"{type(faults).__name__}")
    return None if faults.empty else faults


def make_plan(num_clients: int, rounds: int, *, seed: int = 0,
              drop_rate: float = 0.0, corrupt_rate: float = 0.0,
              modes: Tuple[str, ...] = CORRUPT_MODES,
              read_error_rate: float = 0.0,
              prefetch_delay: float = 0.0, prefetch_delay_rate: float = 0.0,
              kill_prefetch_rounds: Tuple[int, ...] = ()) -> FaultPlan:
    """Draw a deterministic ``FaultPlan``: per round, each client drops
    with ``drop_rate`` and uploads a corrupted row with ``corrupt_rate``
    (mode drawn uniformly from ``modes``); ``read_error_rate`` is the
    per-round probability of one injected transient store-read failure;
    ``prefetch_delay_rate`` rounds stall the prefetch worker by
    ``prefetch_delay`` seconds; ``kill_prefetch_rounds`` name rounds whose
    prefetch worker dies. Same seed -> same plan, bit for bit."""
    for name, rate in (("drop_rate", drop_rate),
                       ("corrupt_rate", corrupt_rate),
                       ("read_error_rate", read_error_rate),
                       ("prefetch_delay_rate", prefetch_delay_rate)):
        if not (0.0 <= rate <= 1.0):
            raise ValueError(f"make_plan: {name} must lie in [0, 1], "
                             f"got {rate}")
    rng = np.random.default_rng(seed)
    kill = set(int(t) for t in kill_prefetch_rounds)
    specs = []
    for t in range(int(rounds)):
        dropped = np.nonzero(rng.random(num_clients) < drop_rate)[0]
        corrupted = np.nonzero(rng.random(num_clients) < corrupt_rate)[0]
        # a client can't both drop and corrupt: the drop wins (no upload)
        corrupted = np.setdiff1d(corrupted, dropped)
        corrupt = tuple(
            (int(c), modes[int(rng.integers(len(modes)))])
            for c in corrupted)
        spec = FaultSpec(
            round_index=t,
            drop=tuple(int(c) for c in dropped),
            corrupt=corrupt,
            read_errors=int(rng.random() < read_error_rate),
            prefetch_delay=(prefetch_delay
                            if rng.random() < prefetch_delay_rate else 0.0),
            kill_prefetch=t in kill)
        if not spec.empty:
            specs.append(spec)
    return FaultPlan(specs=tuple(specs), seed=seed)
