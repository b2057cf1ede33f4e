"""Device-network topology model (paper §5: "grouping devices based on
communication hops would greatly benefit communication efficiency") — a
copy of ``repro.core.topology`` (numpy only), bit for bit with it.

We model devices as nodes placed in a 2-D grid of "regions"; hop distance is
the L1 (Manhattan) region distance plus an intra-region hop. Pairwise
bandwidth decays with hop count. This supplies:

  * a hop-distance matrix for the topology-aware partitioner,
  * per-round communication-time estimates for clusters (used by the
    comm-efficiency benchmark to show the topology-aware gain).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Topology:
    coords: np.ndarray          # [N, 2] region coordinates
    hops: np.ndarray            # [N, N] pairwise hop counts
    bandwidth: np.ndarray       # [N, N] pairwise bandwidth (bytes/s)


def make_topology(num_devices: int, grid: int = 8, base_bw: float = 25e6,
                  decay: float = 0.7, seed: int = 0) -> Topology:
    """Random placement on a grid x grid region lattice; bandwidth
    base_bw * decay**hops (+1 hop inside a region)."""
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, grid, size=(num_devices, 2))
    d = np.abs(coords[:, None, :] - coords[None, :, :]).sum(-1)
    hops = d + 1
    np.fill_diagonal(hops, 0)
    bandwidth = base_bw * decay ** np.maximum(hops - 1, 0)
    np.fill_diagonal(bandwidth, np.inf)
    return Topology(coords=coords, hops=hops, bandwidth=bandwidth)


def cluster_comm_time(topo: Topology, members: np.ndarray,
                      model_bytes: float) -> float:
    """Ring-allreduce time for one cluster: bottlenecked by the slowest link
    on the ring (members visited in index order)."""
    m = np.asarray(members)
    n = len(m)
    if n <= 1:
        return 0.0
    ring_bw = min(topo.bandwidth[m[i], m[(i + 1) % n]] for i in range(n))
    return 2.0 * (n - 1) / n * model_bytes / ring_bw


def grid_cluster_assignment(topo: Topology, selected: np.ndarray,
                            num_clusters: int) -> np.ndarray:
    """Topology-aware assignment: sort selected devices by Morton-ish key
    (row-major region order) and cut into contiguous clusters, so clusters
    have small internal hop counts."""
    sel = np.asarray(selected)
    key = topo.coords[sel, 0] * 1024 + topo.coords[sel, 1]
    order = np.argsort(key, kind="stable")
    ids = np.empty(len(sel), dtype=np.int32)
    chunks = np.array_split(np.arange(len(sel)), num_clusters)
    for c, chunk in enumerate(chunks):
        ids[order[chunk]] = c
    return ids
