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
``torch.Generator``; the mesh lowering (``psum_mix``) waits for the mesh
slice (ROADMAP module item 13).
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

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

    def num_matchings(self, fl: FLConfig) -> int:
        """R > 0 for a protocol that draws one of R matchings per mix
        (``RoundContext.matching``, drawn by the engine); 0 otherwise."""
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
# Participation strategies
# ---------------------------------------------------------------------------

class UniformParticipation:
    """The paper's uniform-without-replacement sampling:
    ``select(gen, D, K, fl)`` returns [K] distinct indices into the
    D-client population."""

    name = "uniform"

    def select(self, gen: torch.Generator, num_clients: int,
               num_participants: int, fl: FLConfig) -> torch.Tensor:
        return sample_participants(gen, num_clients, num_participants)


_PARTICIPATION = {"uniform": UniformParticipation()}


def get_participation(name: str) -> UniformParticipation:
    """Look up a participation strategy; unknown names raise (the pareto
    strategy arrives with the sampled engine, ROADMAP module item 12)."""
    try:
        return _PARTICIPATION[name]
    except KeyError:
        raise ValueError(
            f"unknown participation strategy {name!r}; registered "
            f"strategies: {', '.join(_PARTICIPATION)}") from None
