"""repro_torch.faults — deterministic, seed-driven fault injection (the
counterpart of ``repro.faults``).

A ``FaultPlan`` is a frozen tuple of per-round ``FaultSpec``s drawn from
one seed (``make_plan``), so a faulted run replays bit-identically.
``active(plan)`` normalizes the disabled forms (``None`` / an empty plan)
to ``None``: an engine gates every fault step on that one check, so a
``faults=None`` engine runs exactly the fault-free program. The
``DenseEngine`` wires client dropout (folded into the survive mask) and
corrupted uploads (NaN / inf / bit-flip rows, rejected by the finite check
and the fault flag, then by the scatter-back guard); the ``SampledEngine``
wires the same, plus ``FaultInjector``'s store-tier hooks (transient read
errors, a stalled or dead prefetch worker) and the cold retry of rejected
clients.
"""
from repro_torch.faults.inject import (  # noqa: F401
    FaultInjector, InjectedFault, InjectedReadError, InjectedWorkerDeath,
    corrupt_flat, corrupt_rows_np, guard_flat,
)
from repro_torch.faults.plan import (  # noqa: F401
    CORRUPT_MODES, MODE_CODES, FaultPlan, FaultSpec, active, make_plan,
)

__all__ = [
    "FaultSpec", "FaultPlan", "make_plan", "active", "CORRUPT_MODES",
    "MODE_CODES", "FaultInjector", "InjectedFault", "InjectedReadError",
    "InjectedWorkerDeath", "corrupt_flat", "corrupt_rows_np", "guard_flat",
]
