"""Optimizers and learning-rate schedules (the counterpart of
``repro.optim``): plain tensor arithmetic over a parameter tree, in JAX's
leaf order."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, apply_updates, clip_by_global_norm, make_optimizer,
    momentum, sgd,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant_schedule, cosine_schedule, make_schedule, warmup_cosine_schedule,
)
