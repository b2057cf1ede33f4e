"""Cluster formation — phase 1 of every FedP2P round (§3.1), drawn from an
explicit ``torch.Generator`` on the engine's device (the counterpart of
``repro.core.partition``; a generator takes the place of the JAX key, so
the draws differ from JAX's — parity tests hand both packages the same
draws instead)."""
from __future__ import annotations

from typing import Tuple

import torch


def random_partition(gen: torch.Generator, num_clients: int,
                     num_clusters: int, devices_per_cluster: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample L*Q distinct clients and assign Q to each of L clusters.

    Returns (selected [L*Q] int64 client indices, cluster_ids [L*Q] int32),
    on ``gen``'s device.
    """
    L, Q = num_clusters, devices_per_cluster
    perm = torch.randperm(num_clients, generator=gen, device=gen.device)
    cluster_ids = torch.arange(L, dtype=torch.int32,
                               device=gen.device).repeat_interleave(Q)
    return perm[: L * Q], cluster_ids


def sample_participants(gen: torch.Generator, num_clients: int,
                        participation: int) -> torch.Tensor:
    """FedAvg client sampling (|Z| = participation), uniform without
    replacement."""
    perm = torch.randperm(num_clients, generator=gen, device=gen.device)
    return perm[:participation]
