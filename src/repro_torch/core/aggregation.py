"""Model aggregation — the paper's ``Aggregate(·)`` operator (the
counterpart of ``repro.core.aggregation``).

``weighted_average`` is the Algo-1/Algo-2 primitive:
    theta <- sum_i gamma_i theta_i,   gamma_i = |D_i| / sum |D_i|
over a stacked tree (leaves have a leading client axis).

``cluster_then_global`` is FedP2P's two-stage version: data-weighted within
each cluster, then an UNWEIGHTED mean over the live clusters (§3.1 step 3).
``cluster_models`` gives the per-cluster models theta_{Z_l}.

The [N] coefficients are plain PyTorch, in the JAX package's operations.
The weighted reductions of ``weighted_average`` and
``cluster_then_global`` are one ``ops.fed_aggregate_tree`` pass each: the
tree packed into one [N, sum(sizes)] buffer, a CUDA buffer through the
``fed_aggregate`` kernel (f32 accumulation), each leaf cast back to its
dtype. ``cluster_models``' [L, N] x [N, sum(sizes)] product is one
``torch.matmul``, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def _normalize(weights: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Normalized aggregation coefficients, with degenerate-round guards:
    zero-weight survivors fall back to uniform over the mask; an all-zero
    mask (every client straggled) falls back to uniform over all
    clients."""
    w = weights.to(torch.float32)
    uniform_all = torch.ones_like(w) / w.shape[0]
    if mask is None:
        total = torch.sum(w)
        return torch.where(total > 0, w / torch.clamp_min(total, 1e-12),
                           uniform_all)
    m = mask.to(torch.float32)
    w = w * m
    total = torch.sum(w)
    m_total = torch.sum(m)
    fallback = torch.where(m_total > 0, m / torch.clamp_min(m_total, 1e-12),
                           uniform_all)
    return torch.where(total > 0, w / torch.clamp_min(total, 1e-12),
                       fallback)


def weighted_average(stacked_params, weights: torch.Tensor,
                     mask: Optional[torch.Tensor] = None):
    """stacked_params: tree, leaves [N, ...]; weights [N] (|D_i| counts);
    mask [N] 0/1 straggler survival. Returns the tree without the N
    axis."""
    return ops.fed_aggregate_tree(stacked_params, _normalize(weights, mask))


def _cluster_weights(weights, cluster_ids, num_clusters, mask):
    """(w [N] masked f32 weights, onehot [N, L], cluster_tot [L])."""
    w = weights.to(torch.float32)
    if mask is not None:
        w = w * mask.to(torch.float32)
    onehot = F.one_hot(cluster_ids.long(), num_clusters).to(torch.float32)
    return w, onehot, onehot.T @ w


def cluster_then_global(stacked_params, weights: torch.Tensor,
                        cluster_ids: torch.Tensor, num_clusters: int,
                        mask: Optional[torch.Tensor] = None):
    """FedP2P two-stage aggregation.

    stacked_params leaves [N, ...]; weights [N]; cluster_ids [N] in
    [0, L); mask [N]. Within cluster l: theta_l = sum_i gamma_i theta_i
    with gamma_i = w_i / sum_{j in l} w_j. Globally: the mean over the
    live clusters (a cluster whose weights are all 0 is left out)."""
    w, onehot, cluster_tot = _cluster_weights(weights, cluster_ids,
                                              num_clusters, mask)
    live = (cluster_tot > 0).to(torch.float32)                         # [L]
    n_live = torch.clamp_min(torch.sum(live), 1.0)
    # per-client coefficient: (w_i / cluster_tot_{c(i)}) / n_live if live
    denom = torch.clamp_min(cluster_tot, 1e-12)
    coef = w * (onehot @ (live / denom)) / n_live                      # [N]
    return ops.fed_aggregate_tree(stacked_params, coef)


def cluster_models(stacked_params, weights: torch.Tensor,
                   cluster_ids: torch.Tensor, num_clusters: int,
                   mask: Optional[torch.Tensor] = None):
    """Per-cluster weighted averages (the theta_{Z_l}); leaves [L, ...]."""
    w, onehot, cluster_tot = _cluster_weights(weights, cluster_ids,
                                              num_clusters, mask)
    coef = onehot * (w[:, None] / torch.clamp_min(cluster_tot, 1e-12)[None])
    flat, spec = ops.pack_tree(stacked_params)
    return ops.unpack_tree(coef.T @ flat.to(torch.float32), spec)
