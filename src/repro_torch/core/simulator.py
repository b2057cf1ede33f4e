"""Protocol simulation facade (the counterpart of
``repro.core.simulator``).

All round mechanics live in ``repro_torch.protocols.engine.DenseEngine``.
``Simulator.run`` drives ``DenseEngine.run_rounds``, whose metrics stay on
the device as [T] tensors, and reads them back to the host ONCE, into the
same ``History`` the JAX package returns.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch import faults as fault_lib
from repro_torch import protocols
from repro_torch.config import FLConfig
from repro_torch.configs.paper_models import PaperNetConfig
from repro_torch.core.topology import Topology, make_topology
from repro_torch.data.federated import FederatedDataset
from repro_torch.kernels import backend, fed_mix_sparse
from repro_torch.models.paper_nets import init_paper_net
from repro_torch.protocols.engine import DenseEngine


@dataclass
class History:
    """Per-run training record. ``train_loss`` carries EVERY round, the
    accuracy entries are subsampled by ``eval_every``; ``acc_rounds`` holds
    the 1-based round number of each ``acc``/``acc_client_mean`` entry."""
    acc: List[float] = field(default_factory=list)
    acc_client_mean: List[float] = field(default_factory=list)
    train_loss: List[float] = field(default_factory=list)
    acc_rounds: List[int] = field(default_factory=list)
    #: per-round fault counters (``repro_torch.faults``) — filled only when
    #: the run had an active fault plan, empty otherwise
    dropped: List[int] = field(default_factory=list)
    rejected_rows: List[int] = field(default_factory=list)
    retries: List[int] = field(default_factory=list)
    prefetch_fallbacks: List[int] = field(default_factory=list)

    @property
    def best_acc(self) -> float:
        return max(self.acc) if self.acc else 0.0


class Simulator:
    """``device=None`` runs on the card and raises where there is none;
    pass ``device="cpu"`` for the CPU. On the card TF32 is turned off
    (``backend.use_full_f32``): the reference is full f32. ``faults``
    (a ``repro_torch.faults.FaultPlan``) is forwarded to every engine; a
    topology-aware protocol with no ``topology`` given gets
    ``make_topology(fl.num_clients, seed=fl.seed)``."""

    def __init__(self, net: PaperNetConfig, data: FederatedDataset,
                 fl: FLConfig, topology: Optional[Topology] = None, *,
                 mix_path: Optional[str] = None, faults=None, device=None):
        self.net, self.fl = net, fl
        self.topology = topology
        #: the fault plan in active form (None keeps every run fault-free)
        self.faults = fault_lib.active(faults)
        self.device = backend.resolve_device(device)
        #: default mixing lowering for every engine (None = fl.mix_path)
        self.mix_path = mix_path or fl.mix_path

        def put(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype).to(self.device)

        self.data_dev = {
            "x": put(data.x), "y": put(data.y), "mask": put(data.mask),
            "counts": put(data.counts, torch.float32),
            "test_x": put(data.test_x), "test_y": put(data.test_y),
            "test_mask": put(data.test_mask),
        }
        self._engines: Dict[tuple, DenseEngine] = {}

    def init_params(self, seed: int = 0):
        return init_paper_net(torch.Generator().manual_seed(seed), self.net,
                              device=self.device)

    def engine(self, algorithm: str, codec=None,
               mix_path: Optional[str] = None) -> DenseEngine:
        """Registry dispatch — unknown names raise ValueError listing the
        registered protocols (unknown codecs list the registered codecs).
        Engines are cached per (protocol, codec, mix_path, fault plan)."""
        proto = protocols.resolve(algorithm,
                                  topology_aware=self.fl.topology_aware)
        codec = codec if codec is not None else self.fl.codec
        if codec == "none":
            codec = None
        mix_path = mix_path or self.mix_path
        cache_key = (proto.name, codec, mix_path, self.faults)
        if cache_key not in self._engines:
            if proto.needs_topology and self.topology is None:
                self.topology = make_topology(self.fl.num_clients,
                                              seed=self.fl.seed)
            self._engines[cache_key] = DenseEngine(
                self.net, self.data_dev, self.fl, proto, self.topology,
                codec=codec, mix_path=mix_path, faults=self.faults,
                device=self.device)
        return self._engines[cache_key]

    @property
    def evaluate(self):
        """params -> (sample-weighted acc, client-mean acc). Evaluation
        is codec-independent, so any cached engine of the configured
        protocol serves it; a new engine is built only when none is."""
        proto = protocols.resolve(self.fl.algorithm,
                                  topology_aware=self.fl.topology_aware)
        for (pname, *_), eng in self._engines.items():
            if pname == proto.name:
                return eng.evaluate
        return self.engine(self.fl.algorithm).evaluate

    def run(self, rounds: int = 0, algorithm: str = "", seed: int = 0,
            eval_every: int = 1, verbose: bool = False,
            codec=None, mix_path: Optional[str] = None) -> History:
        """Train ``rounds`` rounds from ``init_params(seed)``, drawing the
        rounds' randomness from a generator seeded with ``seed + 1`` on the
        simulator's device."""
        rounds = rounds or self.fl.rounds
        algorithm = algorithm or self.fl.algorithm
        engine = self.engine(algorithm, codec=codec, mix_path=mix_path)
        params = self.init_params(seed)
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        _, metrics = engine.run_rounds(params, gen, rounds,
                                       eval_every=eval_every)
        # the one read-back of the run
        loss, acc, acc_m = torch.stack(
            [metrics["train_loss"], metrics["acc"],
             metrics["acc_client_mean"]]).tolist()
        fed_mix_sparse.check_cluster_ids(self.device)
        hist = History()
        counters = [n for n in ("dropped", "rejected_rows", "retries",
                                "prefetch_fallbacks") if n in metrics]
        if counters:        # a faulted run: its counters in one read-back
            values = torch.stack([metrics[n] for n in counters]).tolist()
            for name, v in zip(counters, values):
                getattr(hist, name).extend(v)
        for t in range(rounds):
            hist.train_loss.append(loss[t])
            if (t + 1) % eval_every == 0 or t == rounds - 1:
                hist.acc.append(acc[t])
                hist.acc_client_mean.append(acc_m[t])
                hist.acc_rounds.append(t + 1)
                if verbose:
                    print(f"  [{algorithm}] round {t+1:4d} "
                          f"acc={acc[t]:.4f} loss={loss[t]:.4f}")
        return hist
