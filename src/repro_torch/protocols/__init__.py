"""repro_torch.protocols — the protocol registry of the port.

    proto = protocols.get("fedp2p")
    sel, cids = proto.partition(gen, fl)
    spec = proto.mixing_spec(ctx)          # SegmentSpec
    M_new, M_old = proto.mixing_matrix(ctx)

FedAvg and FedP2P are ported; ``get``/``resolve`` raise for the JAX
package's other protocols, naming the ROADMAP item that ports them.
"""
from repro_torch.protocols.base import (  # noqa: F401
    Protocol, get, get_participation, names, register, resolve,
)
from repro_torch.protocols.context import RoundContext, make_context  # noqa: F401
from repro_torch.protocols.fedavg import FedAvg
from repro_torch.protocols.fedp2p import FedP2P
from repro_torch.protocols.spec import SegmentSpec, apply_spec_flat  # noqa: F401

register(FedAvg())
register(FedP2P())
