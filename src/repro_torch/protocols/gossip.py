"""DecentralizedGossip — the paper's "mostly pairwise" limit on the
Protocol interface (the counterpart of ``repro.protocols.gossip``).

No server step at all: every round each participant averages models with
its ring neighbours through two pairwise exchange phases (even pairs, then
odd pairs). The composed mixing operator W = W2 @ W1 is symmetric doubly
stochastic, so repeated rounds contract toward consensus without any
coordinator traffic. Stragglers contribute their OLD model to their
partners (their update "never arrived"), keeping every row convex. On a
mesh of ranks (``psum_mix``) each phase is an all-reduce within each
2-rank process group: device-to-device traffic only, no server.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import FLConfig
from repro_torch.core.comm_model import CommParams, allreduce_time
from repro_torch.core.topology import Topology
from repro_torch.protocols.base import Protocol
from repro_torch.protocols.context import RoundContext
from repro_torch.protocols.spec import MatchingSpec


def _phase_groups(D: int) -> Tuple[List[List[int]], List[List[int]]]:
    """Two partitions of range(D) into ring-adjacent pairs (plus a singleton
    when D is odd): phase 1 pairs (0,1)(2,3)..., phase 2 pairs (1,2)(3,4)...
    with the wrap pair (D-1, 0) when D is even."""
    phase1 = [[i, i + 1] for i in range(0, D - 1, 2)]
    if D % 2:
        phase1.append([D - 1])
    phase2 = [[i, i + 1] for i in range(1, D - 1, 2)]
    if D % 2:
        phase2.insert(0, [0])
    else:
        phase2.append([D - 1, 0])
    if D == 1:
        phase1, phase2 = [[0]], [[0]]
    return phase1, phase2


def perm_of_groups(D: int, groups) -> np.ndarray:
    """[D] partner map of a pairing: perm[i] = i's partner (itself for a
    bye/singleton) — the O(D) form of a matching's averaging matrix."""
    perm = np.arange(D, dtype=np.int32)
    for g in groups:
        if len(g) == 2:
            perm[g[0]], perm[g[1]] = g[1], g[0]
    return perm


@functools.lru_cache(maxsize=None)
def _phase_perm_stack(D: int) -> np.ndarray:
    """[2, D] partner maps of the two ring phases (even pairs, odd pairs)."""
    g1, g2 = _phase_groups(D)
    return np.stack([perm_of_groups(D, g1), perm_of_groups(D, g2)])


def _avg_matrix(D: int, groups: List[List[int]]) -> np.ndarray:
    """[D, D] doubly stochastic matrix averaging within each group."""
    W = np.zeros((D, D), np.float32)
    for g in groups:
        for i in g:
            for j in g:
                W[i, j] = 1.0 / len(g)
    return W


_ON_DEVICE: Dict[tuple, torch.Tensor] = {}


def on_device(make, D: int, device: torch.device) -> torch.Tensor:
    """``make(D)`` (a static numpy table) as a tensor on ``device``, copied
    there once: the round loop then indexes it without a host transfer."""
    key = (make, D, device)
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.from_numpy(np.ascontiguousarray(
            make(D))).to(device)
    return _ON_DEVICE[key]


def ring_matrix(D: int) -> np.ndarray:
    """The composed one-round mixing operator W2 @ W1 (doubly stochastic;
    rows/cols sum to 1)."""
    g1, g2 = _phase_groups(D)
    return _avg_matrix(D, g2) @ _avg_matrix(D, g1)


def straggler_split(W: torch.Tensor, survive: torch.Tensor):
    """(M_new, M_old) = (W·diag(s), W·diag(1-s)): a straggler's column
    mixes in its old params."""
    s = survive.to(torch.float32)
    return W * s[None, :], W * (1.0 - s)[None, :]


def pairwise_mix(info, phases):
    """``psum_mix``'s local function of the gossip family: the effective
    model (a straggler's old params), then, for each partition of
    ``phases`` in turn, the mean over this rank's group of it."""

    def local_fn(x_new, x_old, s, c):
        s = s.to(torch.float32)[:, None]
        eff = s * x_new + (1.0 - s) * x_old
        for groups in phases:
            q = len(next(g for g in groups if info.rank in g))
            eff = info.psum(eff / q, groups)
        return eff

    return local_fn


class DecentralizedGossip(Protocol):
    name = "gossip"

    def num_participants(self, fl: FLConfig) -> int:
        return fl.participation

    def num_clusters(self, fl: FLConfig) -> int:
        # every participant is its own "cluster"; mixing is purely pairwise
        return fl.participation

    def partition(self, gen: torch.Generator, fl: FLConfig,
                  topology: Optional[Topology] = None):
        sel = self.select_participants(gen, fl)
        return sel, torch.arange(fl.participation, dtype=torch.int32,
                                 device=gen.device)

    def mesh_cluster_ids(self, num_clients_dev: int,
                         fl: FLConfig) -> np.ndarray:
        return np.arange(num_clients_dev, dtype=np.int32)

    def mixing_spec(self, ctx: RoundContext) -> MatchingSpec:
        """Permutation structure: the round is two sequential pairing
        phases, each an O(D) partner map. ``ctx.counts`` is ignored
        (pairwise exchanges are plain means) and ``ctx.do_global_sync`` is
        ignored (there is no server step)."""
        D = int(ctx.survive.shape[0])
        return MatchingSpec(
            perms=on_device(_phase_perm_stack, D, ctx.survive.device),
            survive=ctx.survive)

    def mixing_matrix(self, ctx: RoundContext):
        # ctx.counts and ctx.do_global_sync are ignored, as in mixing_spec
        D = int(ctx.survive.shape[0])
        return straggler_split(on_device(ring_matrix, D, ctx.survive.device),
                               ctx.survive)

    def mesh_partitions(self, num_clients: int, cluster_ids) -> tuple:
        return _phase_groups(num_clients)

    def psum_mix(self, f_new, f_old, ctx: RoundContext):
        """The two ring phases as all-reduces within the phase's pairs (a
        bye's singleton moves nothing); a straggler's effective model is
        its old params."""
        D = self.static_num_clients(ctx)
        return self._shard_mix(pairwise_mix(ctx.mesh_info,
                                            _phase_groups(D)),
                               f_new, f_old, ctx)

    def comm_time(self, p: CommParams, P: int, *, L: Optional[float] = None,
                  ctx: Optional[RoundContext] = None) -> float:
        """Two pairwise phases, all pairs in parallel: each phase is an
        n=2 ring allreduce over a device-device link. No server term and no
        dependence on P. Prices codec-adjusted wire bytes."""
        return 2.0 * allreduce_time(p.wire_bytes, 2, p.device_bw)

    def wire_model(self, D: int, L: int, *, do_global_sync: bool = True):
        """One term per ring phase: the phase's pairs, each a 2-device ring
        moving one effective model (singleton byes move nothing)."""
        g1, g2 = _phase_groups(D)
        return tuple((2, sum(1 for g in gs if len(g) == 2), 1.0)
                     for gs in (g1, g2))
