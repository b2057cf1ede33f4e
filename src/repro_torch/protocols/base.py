"""The pluggable federated-learning Protocol interface + registry (the
counterpart of ``repro.protocols.base``).

Each strategy is one stateless object carrying its client selection and
cluster formation (``partition``), its mixing operator in dense form
(``mixing_matrix``) and structured form (``mixing_spec``), and its §3.2
communication-cost model (``comm_time`` / ``wire_model``). Every per-round
method reads one ``RoundContext``. Convention:

    f_out = M_new @ f_new + M_old @ f_old

where every row of ``M_new + M_old`` sums to 1 (dropped updates fall back
to old params, never to zeros). Randomness comes from an explicit
``torch.Generator``. ``mesh_cluster_ids`` is the static cluster layout of
the sampled engine's active window; the mesh lowering (``psum_mix``)
waits for the mesh slice (ROADMAP module item 13).
"""
from __future__ import annotations

import functools
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import FLConfig
from repro_torch.core.comm_model import CommParams
from repro_torch.core.partition import sample_participants
from repro_torch.core.topology import Topology
from repro_torch.protocols.context import RoundContext


class Protocol:
    """Abstract decentralization strategy. Subclass + ``register`` to add
    one. Implementations must be stateless (one instance serves every
    engine)."""

    #: registry key, e.g. "fedp2p"
    name: str = ""
    #: True -> ``partition``/``comm_time`` want a ``core.topology.Topology``
    needs_topology: bool = False

    # -- participant selection / cluster formation -----------------------
    def num_participants(self, fl: FLConfig) -> int:
        """P — how many clients one round of this protocol trains."""
        return fl.participation

    def num_clusters(self, fl: FLConfig) -> int:
        """L — cluster count backing ``partition``'s cluster_ids."""
        return 1

    def select_participants(self, gen: torch.Generator,
                            fl: FLConfig) -> torch.Tensor:
        """[P] distinct client indices for this round, via the
        participation strategy named by ``fl.participation_strategy``."""
        return get_participation(fl.participation_strategy).select(
            gen, fl.num_clients, self.num_participants(fl), fl)

    def partition(self, gen: torch.Generator, fl: FLConfig,
                  topology: Optional[Topology] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(selected [P] int64, cluster_ids [P] int32 in
        [0, num_clusters(fl))), on ``gen``'s device. ``topology`` is read
        only by topology-aware protocols."""
        sel = self.select_participants(gen, fl)
        return sel, torch.zeros((self.num_participants(fl),),
                                dtype=torch.int32, device=gen.device)

    def mesh_cluster_ids(self, num_clients_dev: int,
                         fl: FLConfig) -> np.ndarray:
        """Static [D] int32 cluster assignment of a D-wide client axis (the
        sampled engine's active window). Contiguous by default; a width
        the protocol cannot carve raises ``ValueError``."""
        return np.zeros((num_clients_dev,), np.int32)

    def num_matchings(self, fl: FLConfig,
                      num_clients: Optional[int] = None) -> int:
        """R > 0 for a protocol that draws one of R matchings per mix
        (``RoundContext.matching``, drawn by the engine) over
        ``num_clients`` rows (default: P); 0 otherwise."""
        return 0

    # -- aggregation semantics --------------------------------------------
    def mixing_matrix(self, ctx: RoundContext
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(M_new, M_old), each [D, D]: f_out = M_new @ f_new + M_old @
        f_old."""
        raise NotImplementedError

    def mixing_spec(self, ctx: RoundContext):
        """The structured form of ``mixing_matrix`` (a ``SegmentSpec`` or
        ``MatchingSpec``), or
        ``None`` for dense-only protocols. Contract:
        ``mixing_spec(ctx).to_dense()`` reproduces ``mixing_matrix(ctx)``
        exactly."""
        return None

    # -- §3.2 analytic communication model --------------------------------
    def comm_time(self, p: CommParams, P: int, *, L: Optional[float] = None,
                  ctx: Optional[RoundContext] = None) -> float:
        """Wall-clock seconds of one round's communication for P sampled
        devices (the paper's H(·) functions)."""
        raise NotImplementedError

    def wire_model(self, D: int, L: int, *, do_global_sync: bool = True
                   ) -> Optional[Tuple[Tuple[int, int, float], ...]]:
        """The declared §3.2 wire structure of one round: a tuple of
        ``(group_size, num_groups, model_copies)`` ring-allreduce terms,
        or ``None``."""
        return None


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Protocol] = {}


def register(protocol: Protocol) -> Protocol:
    """Register a Protocol instance under ``protocol.name``."""
    if not protocol.name:
        raise ValueError("protocol must define a non-empty .name")
    if protocol.name in _REGISTRY:
        raise ValueError(f"protocol {protocol.name!r} is already registered")
    _REGISTRY[protocol.name] = protocol
    return protocol


def names() -> Tuple[str, ...]:
    """Registered protocol names, in registration order."""
    return tuple(_REGISTRY)


def get(name: str) -> Protocol:
    """Look up a registered protocol; unknown names raise, never a silent
    FedAvg fallback."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown protocol {name!r}; registered protocols: "
            f"{', '.join(names())}") from None


def resolve(name: str, topology_aware: bool = False) -> Protocol:
    """Map an ``FLConfig`` (algorithm, topology_aware) pair to a protocol,
    as the JAX package does: ``topology_aware=True`` upgrades ``name`` to
    ``name + '_topo'`` when such a variant is registered; when it is not,
    and the base protocol is not topology-aware itself, the flag would do
    nothing, so it warns."""
    if topology_aware:
        if f"{name}_topo" in _REGISTRY:
            return get(f"{name}_topo")
        proto = get(name)
        if not proto.needs_topology:
            warnings.warn(
                f"topology_aware=True has no effect for protocol {name!r}: "
                f"no {name + '_topo'!r} variant is registered and {name!r} "
                f"is not topology-aware itself",
                UserWarning, stacklevel=2)
        return proto
    return get(name)


# ---------------------------------------------------------------------------
# Participation strategies — how the K-sized active set is drawn
# ---------------------------------------------------------------------------

class ParticipationStrategy:
    """Client-selection rule: ``select(gen, D, K, fl)`` returns [K]
    distinct int64 indices into the D-client population, on ``gen``'s
    device. Strategies are stateless; register one instance per rule
    (``register_participation``)."""

    #: registry key, e.g. "uniform"
    name: str = ""

    def select(self, gen: torch.Generator, num_clients: int,
               num_participants: int, fl: FLConfig) -> torch.Tensor:
        raise NotImplementedError


class UniformParticipation(ParticipationStrategy):
    """The paper's uniform-without-replacement sampling: the
    ``core.partition.sample_participants`` draw."""

    name = "uniform"

    def select(self, gen: torch.Generator, num_clients: int,
               num_participants: int, fl: FLConfig) -> torch.Tensor:
        return sample_participants(gen, num_clients, num_participants)


#: seed of the static per-client resource scores (the JAX package's
#: enrollment key ``PRNGKey(0x5C0BE5)``; a CPU generator here, so the
#: scores do not depend on the engine's device)
PARETO_SCORE_SEED = 0x5C0BE5


@functools.lru_cache(maxsize=4)
def _pareto_log_scores(num_clients: int, alpha: float,
                       device: torch.device) -> torch.Tensor:
    """[D] f32 log Pareto(alpha) resource scores by the inverse CDF of
    uniforms on [1e-6, 1), drawn once from a fixed-seed CPU generator."""
    g = torch.Generator().manual_seed(PARETO_SCORE_SEED)
    u = torch.rand((num_clients,), generator=g) * (1.0 - 1e-6) + 1e-6
    return (-(1.0 / alpha) * torch.log(u)).to(device)


def pareto_top_k(log_score: torch.Tensor, avail: torch.Tensor,
                 gumbel: torch.Tensor, k: int) -> torch.Tensor:
    """The K winners of a Gumbel top-K over ``log_score`` among the
    ``avail`` clients: unavailable clients are pushed down by 1e9, so they
    fill only slots the available pool leaves empty. In f32 many such keys
    tie; a stable descending sort takes tied keys lowest index first, as
    ``jax.lax.top_k`` does (``torch.topk`` does not). Returns [K] int64."""
    g = log_score + gumbel
    g = torch.where(avail, g, g - 1e9)
    return torch.sort(g, descending=True, stable=True).indices[:k]


class ParetoParticipation(ParticipationStrategy):
    """Participation-rate-capped biased selection (SNIPPETS.md snippet 1):
    each enrolled client carries a static Pareto(alpha) resource score;
    each round an independent Bernoulli(``fl.participation_rate``)
    availability mask is drawn, and the K winners are a weighted sample
    without replacement (Gumbel top-K over log-scores) among the
    available clients. The draw always returns K distinct indices."""

    name = "pareto"
    #: Pareto shape: alpha = 3 keeps a heavy but finite-variance tail
    alpha: float = 3.0

    def select(self, gen: torch.Generator, num_clients: int,
               num_participants: int, fl: FLConfig) -> torch.Tensor:
        dev = gen.device
        avail = torch.rand((num_clients,), generator=gen,
                           device=dev) < fl.participation_rate
        u = torch.rand((num_clients,), generator=gen, device=dev)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(torch.clamp_min(u, tiny)))
        log_score = _pareto_log_scores(num_clients, self.alpha, dev)
        return pareto_top_k(log_score, avail, gumbel, num_participants)


_PARTICIPATION: Dict[str, ParticipationStrategy] = {}


def register_participation(strategy: ParticipationStrategy
                           ) -> ParticipationStrategy:
    """Register a ParticipationStrategy instance under ``strategy.name``."""
    if not strategy.name:
        raise ValueError("participation strategy must define a non-empty "
                         ".name")
    if strategy.name in _PARTICIPATION:
        raise ValueError(f"participation strategy {strategy.name!r} is "
                         "already registered")
    _PARTICIPATION[strategy.name] = strategy
    return strategy


def participation_names() -> Tuple[str, ...]:
    """Registered participation-strategy names, in registration order."""
    return tuple(_PARTICIPATION)


def get_participation(name: str) -> ParticipationStrategy:
    """Look up a participation strategy; unknown names raise (never a
    silent uniform fallback)."""
    try:
        return _PARTICIPATION[name]
    except KeyError:
        raise ValueError(
            f"unknown participation strategy {name!r}; registered "
            f"strategies: {', '.join(participation_names())}") from None


register_participation(UniformParticipation())
register_participation(ParetoParticipation())


def active_window_size(fl: FLConfig, proto: Protocol) -> int:
    """K — clients per sampled round: the explicit
    ``fl.participants_per_round``, else the protocol's own count."""
    return fl.participants_per_round or proto.num_participants(fl)


def validate_participation(fl: FLConfig, proto: Protocol) -> int:
    """Validate the (enrolled D, active K) pair against ``proto``'s
    structural needs and return K: K <= D, and the protocol's window
    layout (``mesh_cluster_ids``) must exist at width K — the fedp2p
    family carves L equal contiguous clusters, so L | K."""
    D = fl.enrolled
    K = active_window_size(fl, proto)
    if K > D:
        raise ValueError(
            f"sampled participation: K={K} active clients per round exceed "
            f"the D={D} enrolled population (protocol {proto.name!r}); "
            "need K <= D")
    try:
        proto.mesh_cluster_ids(K, fl)
    except ValueError:
        L = fl.num_clusters
        need = "K >= L (and L | K)" if K < L else "L | K"
        raise ValueError(
            f"sampled participation: protocol {proto.name!r} carves its "
            f"active window into L={L} equal contiguous clusters, which a "
            f"K={K} window cannot realize; need {need}") from None
    return K
