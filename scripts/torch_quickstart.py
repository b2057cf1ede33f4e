"""Quickstart on the PyTorch port: every registered protocol on SynCov
(paper §4.1) — FedAvg (Algo 1), FedP2P (Algo 2), decentralized gossip (the
no-server limit), topology-aware FedP2P (§5) and async gossip (a fresh
random matching per round).

    PYTHONPATH=src python scripts/torch_quickstart.py [--device cpu]
        [--rounds 15] [--clients 100]

``Simulator.run`` drives ``DenseEngine.run_rounds`` on the card (the
default) or, with ``--device cpu``, on the kernels' plain versions. A new
strategy is one ``repro_torch.protocols.Protocol`` subclass (its
``mixing_matrix(ctx)``, optionally ``mixing_spec(ctx)`` and ``psum_mix``)
and a ``register`` call: it then shows up in this loop.
"""
import argparse

import torch

from repro_torch import protocols
from repro_torch.config import FLConfig
from repro_torch.configs.paper_models import LOGREG_SYN
from repro_torch.core.comm_model import CommParams, optimal_L, speedup_R
from repro_torch.core.simulator import Simulator
from repro_torch.data.federated import pack_clients
from repro_torch.data.synthetic import syncov


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--clients", type=int, default=100)
    args = ap.parse_args()

    # --- data: non-IID clients, covariate shift + quantity skew ---
    xs, ys = syncov(num_clients=args.clients, seed=0)
    data = pack_clients(xs, ys, num_classes=10, seed=0)

    # --- protocol: L=5 local P2P networks x Q=2 devices, E=10 epochs ---
    fl = FLConfig(num_clients=args.clients, num_clusters=5,
                  devices_per_cluster=2, participation=10, local_epochs=10,
                  batch_size=10, lr=0.05)
    sim = Simulator(LOGREG_SYN, data, fl, device=args.device)

    best = {}
    for name in protocols.names():
        print(f"== {name} ==")
        best[name] = sim.run(rounds=args.rounds, algorithm=name, seed=0,
                             verbose=True).best_acc
    print("\nbest accuracy: "
          + " ".join(f"{n}={a:.4f}" for n, a in best.items()))

    # --- the RoundContext the protocols read: gossip_async's matching is
    # a drawn index, another index another matching ---
    proto = protocols.get("gossip_async")
    m0, _ = proto.mixing_matrix(protocols.make_context(
        matching=torch.tensor(0), num_clients=10))
    m1, _ = proto.mixing_matrix(protocols.make_context(
        matching=torch.tensor(1), num_clients=10))
    print(f"\ngossip_async matchings differ across draws: "
          f"{bool((m0 != m1).any())}")

    # --- communication model (§3.2): what does each round cost? ---
    p = CommParams(model_bytes=100e6, server_bw=1e9, device_bw=1e7, alpha=4)
    P = 1000
    print(f"comm model @P={P}: optimal L*={optimal_L(p, P):.1f}, "
          f"speedup R={speedup_R(p, P):.2f}x over FedAvg")
    for name in protocols.names():
        print(f"  H_{name}(P={P}) = "
              f"{protocols.get(name).comm_time(p, P):.1f}s")


if __name__ == "__main__":
    main()
