"""Cluster formation — phase 1 of every FedP2P round (§3.1), drawn from an
explicit ``torch.Generator`` on the engine's device (the counterpart of
``repro.core.partition``; a generator takes the place of the JAX key, so
the draws differ from JAX's — parity tests hand both packages the same
draws instead). ``topology_partition`` is the §5 host-side variant on
numpy, seeded with an int."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.topology import Topology, grid_cluster_assignment


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


def topology_partition(seed: int, topo: Topology, num_clusters: int,
                       devices_per_cluster: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """§5 topology-aware variant (host-side, numpy): sample L*Q devices
    uniformly, then cut into clusters along the region space so
    intra-cluster hop counts are small. ``seed`` seeds numpy's
    ``default_rng``; the JAX version draws it from its key
    (``randint(key, (), 0, 2**31 - 1)``), and the same seed gives the same
    partition here. Pass ``int(torch.randint(0, 2**31 - 1, (),
    generator=gen))`` to draw it from a generator."""
    n = topo.hops.shape[0]
    L, Q = num_clusters, devices_per_cluster
    rng = np.random.default_rng(int(seed))
    selected = rng.permutation(n)[: L * Q]
    ids = grid_cluster_assignment(topo, selected, L)
    return selected, ids
