"""AsyncGossip — a per-round *random* pairwise matching (the counterpart of
``repro.protocols.async_gossip``).

Every mix a fresh perfect matching of the D participants is drawn and each
matched pair averages models (a straggler contributes its OLD params). Over
rounds the expected mixing operator is a dense doubly stochastic matrix,
so consensus contracts without any fixed ring schedule or server step.

The matching is drawn uniformly from the *round-robin 1-factorization* of
K_D (the circle method): R = D-1 (D even) or D (D odd, one bye per round)
perfect matchings that jointly cover every pair exactly once. The draw is
``RoundContext.matching``, a 0-d device tensor the engine draws up front
(``RoundDraws.matching``); the structured spec indexes the [R, D]
partner-map stack with it and the dense oracle the [R, D, D] matrix stack,
on the device, so the two lowerings stay identical and the round loop
never reads the draw back.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch

from repro_torch.config import FLConfig
from repro_torch.core.comm_model import CommParams, allreduce_time
from repro_torch.core.topology import Topology
from repro_torch.protocols.base import Protocol
from repro_torch.protocols.context import RoundContext
from repro_torch.protocols.gossip import on_device, straggler_split
from repro_torch.protocols.spec import MatchingSpec


@functools.lru_cache(maxsize=None)
def round_robin_matchings(D: int) -> tuple:
    """The circle-method 1-factorization of K_D: a tuple of R perfect
    matchings (each a tuple of pair/singleton groups, jointly partitioning
    range(D)), covering every unordered pair exactly once across rounds.
    R = D-1 for even D; R = D for odd D (one bye — a singleton — per round).
    """
    if D <= 1:
        return (((0,),),) if D == 1 else ()
    n = D if D % 2 == 0 else D + 1      # pad odd D with a dummy node
    rounds: List[tuple] = []
    for r in range(n - 1):
        groups: List[tuple] = []
        a, b = n - 1, r
        if a < D and b < D:
            groups.append((min(a, b), max(a, b)))
        elif b < D:
            groups.append((b,))          # paired with the dummy -> bye
        for k in range(1, n // 2):
            a, b = (r + k) % (n - 1), (r - k) % (n - 1)
            groups.append((min(a, b), max(a, b)))
        rounds.append(tuple(sorted(groups)))
    return tuple(rounds)


@functools.lru_cache(maxsize=None)
def matching_perm_stack(D: int) -> np.ndarray:
    """[R, D] partner-map stack: row r is the r-th round-robin matching as
    an O(D) permutation (perm[i] = i's partner; itself for the bye).

    Computed closed-form from the circle method (node a < n-1 partners
    b = 2r - a mod n-1, the r-th circle node partners the fixed node n-1)
    rather than from ``round_robin_matchings``, whose tuple structure holds
    millions of Python objects at D in the thousands."""
    if D <= 1:
        return np.zeros((1, 1), np.int32) if D == 1 else \
            np.zeros((0, 0), np.int32)
    n = D if D % 2 == 0 else D + 1      # pad odd D with a dummy node
    R = n - 1
    r = np.arange(R)[:, None]
    a = np.arange(n - 1)[None, :]
    b = (2 * r - a) % (n - 1)           # circle partner of node a, round r
    b = np.where(a == r, n - 1, b)      # node r partners the fixed node
    perms = np.concatenate([b, r], axis=1)  # fixed node n-1 partners r
    if n != D:                          # odd D: dummy-partner -> bye (self)
        perms = perms[:, :D]
        bye = perms == D
        perms = np.where(bye, np.broadcast_to(np.arange(D), perms.shape),
                         perms)
    return perms.astype(np.int32)


@functools.lru_cache(maxsize=None)
def matching_matrix_stack(D: int) -> np.ndarray:
    """[R, D, D] stack: entry r is the symmetric doubly stochastic averaging
    matrix of the r-th round-robin matching."""
    matchings = round_robin_matchings(D)
    Ws = np.zeros((len(matchings), D, D), np.float32)
    for r, groups in enumerate(matchings):
        for g in groups:
            for i in g:
                for j in g:
                    Ws[r, i, j] = 1.0 / len(g)
    return Ws


class AsyncGossip(Protocol):
    name = "gossip_async"

    def num_participants(self, fl: FLConfig) -> int:
        return fl.participation

    def num_clusters(self, fl: FLConfig) -> int:
        # pairwise: every participant is its own cluster, pairs vary by round
        return fl.participation

    def num_matchings(self, fl: FLConfig,
                      num_clients: Optional[int] = None) -> int:
        """R, the size of the round-robin family a mix over
        ``num_clients`` rows (default: P) draws from."""
        D = num_clients or self.num_participants(fl)
        return int(matching_perm_stack(D).shape[0])

    def mesh_cluster_ids(self, num_clients_dev: int,
                         fl: FLConfig) -> np.ndarray:
        return np.arange(num_clients_dev, dtype=np.int32)

    def partition(self, gen: torch.Generator, fl: FLConfig,
                  topology: Optional[Topology] = None):
        sel = self.select_participants(gen, fl)
        return sel, torch.arange(fl.participation, dtype=torch.int32,
                                 device=gen.device)

    def _draw(self, ctx: RoundContext) -> torch.Tensor:
        """This mix's matching index as a [1] device tensor — the ONE draw
        both lowerings share."""
        if ctx.matching is None:
            raise ValueError(
                f"protocol {self.name!r} is stochastic: build the "
                "RoundContext with its drawn matching index "
                "(make_context(matching=...)), or the matching would "
                "silently repeat every round")
        return ctx.matching.reshape(1).to(device=ctx.survive.device,
                                          dtype=torch.int64)

    def mixing_spec(self, ctx: RoundContext) -> MatchingSpec:
        """Permutation structure: ONE partner map, selected from the [R, D]
        round-robin stack by the drawn index — O(D) index memory per round.
        ``ctx.counts``/``ctx.do_global_sync`` are ignored as in
        ``mixing_matrix``."""
        D = int(ctx.survive.shape[0])
        stack = on_device(matching_perm_stack, D, ctx.survive.device)
        return MatchingSpec(perms=stack.index_select(0, self._draw(ctx)),
                            survive=ctx.survive)

    def mixing_matrix(self, ctx: RoundContext):
        # ctx.counts ignored (pairwise exchanges are plain means);
        # ctx.do_global_sync ignored (no server step)
        D = int(ctx.survive.shape[0])
        Ws = on_device(matching_matrix_stack, D, ctx.survive.device)
        return straggler_split(Ws.index_select(0, self._draw(ctx))[0],
                               ctx.survive)

    def comm_time(self, p: CommParams, P: int, *, L: Optional[float] = None,
                  ctx: Optional[RoundContext] = None) -> float:
        """One pairwise phase, all pairs in parallel (half the traffic of the
        two-phase ring gossip): an n=2 ring allreduce over a device-device
        link. No server term, no dependence on P. Prices codec-adjusted
        wire bytes."""
        return allreduce_time(p.wire_bytes, 2, p.device_bw)

    def wire_model(self, D: int, L: int, *, do_global_sync: bool = True):
        """One matching per round: D // 2 pairs, each a 2-device ring
        moving one effective model (every matching of the family has
        exactly D // 2 pairs; the bye is a singleton)."""
        return ((2, D // 2, 1.0),)
