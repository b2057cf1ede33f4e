"""Host-side feed onto a mesh (the counterpart of ``repro.data.pipeline``):
each rank takes its rows of every host batch (the batch dim split over
``batch_dims``' axes, as the launcher's rules split the activations) and
places them on its device, with ``prefetch`` batches in flight."""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ShapeConfig
from repro_torch.sharding.rules import MeshInfo, Spec, batch_dims


def batch_shardings(cfg, shape: ShapeConfig, info: MeshInfo
                    ) -> Callable[[np.ndarray], Tuple[Spec, slice]]:
    """-> ``spec_for(leaf)``: a host leaf's spec (its batch dim over the
    batch's axes, the rest whole) and this rank's rows of it."""
    bax = batch_dims(info, shape.global_batch, shape.mode, cfg.vocab_size)
    n = shape.global_batch // info.size(bax)
    lo = info.index(bax) * n if bax else 0

    def spec_for(leaf: np.ndarray) -> Tuple[Spec, slice]:
        return ((bax,) + ((),) * (leaf.ndim - 1), slice(lo, lo + n))

    return spec_for


def sharded_batches(host_iter: Iterator[Dict[str, np.ndarray]], cfg,
                    shape: ShapeConfig, info: Optional[MeshInfo],
                    prefetch: int = 2, device=None) -> Iterator[Dict]:
    """Wrap a host batch iterator: this rank's rows of each batch, copied
    to ``device`` (None: the card) without waiting, ``prefetch`` batches
    in flight ahead of the consumer. Without a mesh, every row."""
    from repro_torch.kernels import backend
    dev = backend.resolve_device(device)
    spec_for = (batch_shardings(cfg, shape, info) if info is not None
                else None)

    def place(v: np.ndarray) -> torch.Tensor:
        rows = v if spec_for is None else v[spec_for(v)[1]]
        t = torch.from_numpy(np.ascontiguousarray(rows))
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    pending = []
    for batch in host_iter:
        pending.append({k: place(v) for k, v in batch.items()})
        if len(pending) > prefetch:
            yield pending.pop(0)
    yield from pending
