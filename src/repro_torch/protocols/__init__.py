"""repro_torch.protocols — the protocol registry of the port.

    proto = protocols.get("fedp2p")
    sel, cids = proto.partition(gen, fl)
    spec = proto.mixing_spec(ctx)          # SegmentSpec / MatchingSpec
    M_new, M_old = proto.mixing_matrix(ctx)

Every protocol of the JAX package is ported: FedAvg, FedP2P, the
topology-aware FedP2P (``resolve("fedp2p", topology_aware=True)``),
gossip and gossip_async; so are the participation strategies (uniform,
pareto) and sampled participation's client-state stores
(``MemoryStore``, ``CheckpointStore``, ``make_store``), which
``protocols.engine.SampledEngine`` drives.
"""
from repro_torch.protocols.base import (  # noqa: F401
    ParetoParticipation, ParticipationStrategy, Protocol,
    UniformParticipation, active_window_size, get, get_participation, names,
    participation_names, register, register_participation, resolve,
    validate_participation,
)
from repro_torch.protocols.async_gossip import AsyncGossip
from repro_torch.protocols.context import RoundContext, make_context  # noqa: F401
from repro_torch.protocols.fedavg import FedAvg
from repro_torch.protocols.fedp2p import FedP2P
from repro_torch.protocols.gossip import DecentralizedGossip
from repro_torch.protocols.spec import (  # noqa: F401
    MatchingSpec, SegmentSpec, apply_spec_flat,
)
from repro_torch.protocols.store import (  # noqa: F401
    CheckpointStore, ClientStateStore, MemoryStore, PrefetchHandle,
    make_store,
)
from repro_torch.protocols.topology_aware import TopologyAwareFedP2P

register(FedAvg())
register(FedP2P())
register(DecentralizedGossip())
register(TopologyAwareFedP2P())
register(AsyncGossip())
