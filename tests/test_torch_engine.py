"""The port's ``DenseEngine`` / ``Simulator`` against the JAX package's,
round for round, with identical randomness: each round's draws are made
from the JAX key tree (outside jit, as the JAX engine splits it) and
handed to the port as ``RoundDraws``:

  key, kr = split(key)                       per round (engine.py:400)
  k_sel, k_tr, k_str, k_mix = split(kr, 4)   (engine.py:279)
  sel, cids = proto.partition(k_sel, fl)     permutation (partition.py:27)
  survive = straggler_mask(k_str, P, rate)   (straggler.py:12-14)
  keys = split(fold_in(k_tr, r), P)          per sub-round (engine.py:304)
  split(key_i, E) -> permutation(e, n_max)   per epoch (engine.py:114,129)
  k_r = fold_in(k_mix, r)                    mix r = 1..S (engine.py:293)
  randint(k_r, (), 0, R)                     gossip_async (async_gossip:136)
  uniform(fold_in(k_r, 0x636F6465), ...)     int8 rounding (engine.py:86,95)

Covered: fedp2p and fedavg x mix_path auto and dense x sync_period 1 and
2 through a T=3 ``run_rounds`` against ``repro.core.simulator.Simulator.run``
(logreg on SynCov with stragglers); on the main path's fedp2p one narrow
CNN ``_round_rows`` (the mixed per-client rows); and the CNN at its full
published widths, one ``_round_rows`` and a T=2 ``run_rounds`` with four
clients and E=1. Tolerance: rtol 1e-4 / atol 1e-5 on
per-round train_loss, acc and acc_client_mean and on the mixed rows — the
two packages sum in other orders (XLA vs PyTorch convolutions, matmuls
and segment sums) across dozens of SGD steps; accuracies agree exactly.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import protocols as jprotocols  # noqa: E402
from repro.config import FLConfig as JFLConfig  # noqa: E402
from repro.configs.paper_models import (  # noqa: E402
    CNN_FEMNIST as J_CNN_FEMNIST,
)
from repro.configs.paper_models import LOGREG_SYN as J_LOGREG  # noqa: E402
from repro.configs.paper_models import PaperNetConfig as JNet  # noqa: E402
from repro.core.simulator import Simulator as JSimulator  # noqa: E402
from repro.core.straggler import straggler_mask as j_straggler  # noqa: E402
from repro.data.federated import pseudo_femnist_federated  # noqa: E402
from repro.protocols.engine import DenseEngine as JDenseEngine  # noqa: E402
from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.configs.paper_models import (  # noqa: E402
    CNN_FEMNIST, LOGREG_SYN, PaperNetConfig,
)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.data.federated import pack_clients  # noqa: E402
from repro_torch.data.synthetic import syncov  # noqa: E402
from repro_torch.protocols.async_gossip import (  # noqa: E402
    matching_perm_stack,
)
from repro_torch.protocols.engine import DenseEngine, RoundDraws  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
T = 3
LOGREG_FL = dict(num_clients=20, num_clusters=2, devices_per_cluster=3,
                 participation=5, local_epochs=2, batch_size=10, lr=0.05,
                 straggler_rate=0.3)
CNN_FL = dict(num_clients=8, num_clusters=2, devices_per_cluster=2,
              participation=4, local_epochs=2, batch_size=5, lr=0.05,
              straggler_rate=0.3)
CNN = dict(name="cnn-8", kind="cnn", image_size=8, channels=1, hidden=8,
           num_classes=5)


@functools.partial(jax.jit, static_argnums=(0, 1, 3))
def _jax_draws(proto, fl, kr, n_max):
    P = proto.num_participants(fl)
    k_sel, k_tr, k_str, k_mix = jax.random.split(kr, 4)
    sel, cids = proto.partition(k_sel, fl, None)
    survive = j_straggler(k_str, P, fl.straggler_rate)

    def epochs(key):
        return jax.vmap(lambda e: jax.random.permutation(e, n_max))(
            jax.random.split(key, fl.local_epochs))

    perms = [jax.vmap(epochs)(jax.random.split(jax.random.fold_in(k_tr, r),
                                               P))
             for r in range(max(1, fl.sync_period))]
    k_mix = [jax.random.fold_in(k_mix, r)
             for r in range(1, max(1, fl.sync_period) + 1)]
    return sel, cids, survive, jax.numpy.stack(perms), k_mix


def round_draws(proto, fl, kr, n_max, int8=None) -> RoundDraws:
    """One round's draws from the JAX round key ``kr``, exactly as
    ``repro.protocols.engine.DenseEngine._round_rows`` draws them (the
    same threefry calls, jitted here as a whole). ``int8`` = ``(codec,
    n_params)`` adds the int8 codec's rounding noise."""
    sel, cids, survive, perms, mix_keys = _jax_draws(proto, fl, kr, n_max)
    P = proto.num_participants(fl)
    matching = noise = None
    if proto.name == "gossip_async":
        R = matching_perm_stack(P).shape[0]
        matching = torch.tensor([int(jax.random.randint(k, (), 0, R))
                                 for k in mix_keys], dtype=torch.int64)
    if int8 is not None:
        codec, n = int8
        shape = (P, codec.padded(n) // codec.chunk, codec.chunk)
        noise = torch.stack([torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(k, 0x636F6465), shape))).reshape(P, -1)
            for k in mix_keys])
    return RoundDraws(
        sel=torch.tensor(np.asarray(sel), dtype=torch.int64),
        cluster_ids=torch.tensor(np.asarray(cids), dtype=torch.int32),
        survive=torch.tensor(np.asarray(survive), dtype=torch.float32),
        batch_perm=torch.tensor(np.asarray(perms), dtype=torch.int64),
        matching=matching, wire_noise=noise)


def run_draws(proto, fl, seed, rounds, n_max, int8=None):
    """The draws of ``Simulator.run(seed=seed)``: key PRNGKey(seed + 1)."""
    key, out = jax.random.PRNGKey(seed + 1), []
    for _ in range(rounds):
        key, kr = jax.random.split(key)
        out.append(round_draws(proto, fl, kr, n_max, int8))
    return out


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.fixture(scope="module")
def syncov_data():
    return pack_clients(*syncov(num_clients=20, seed=0), 10, seed=0)


@pytest.fixture(scope="module")
def femnist_data():
    d = pseudo_femnist_federated(8, classes_per_client=3, per_client=12,
                                 num_classes=5, seed=0)
    return dataclasses.replace(   # 8x8 crops for the 8x8 test CNN
        d, x=np.ascontiguousarray(d.x[:, :, :8, :8]),
        test_x=np.ascontiguousarray(d.test_x[:, :, :8, :8]))


@pytest.mark.parametrize("algo", ["fedp2p", "fedavg"])
@pytest.mark.parametrize("mix_path", ["auto", "dense"])
@pytest.mark.parametrize("sync_period", [1, 2])
def test_run_rounds_matches_jax_simulator(syncov_data, algo, mix_path,
                                          sync_period):
    kw = dict(LOGREG_FL, sync_period=sync_period, mix_path=mix_path)
    jsim = JSimulator(J_LOGREG, syncov_data, JFLConfig(**kw))
    hist = jsim.run(rounds=T, algorithm=algo, seed=0)
    sim = Simulator(LOGREG_SYN, syncov_data, FLConfig(**kw), device="cpu")
    engine = sim.engine(algo)
    draws = run_draws(jprotocols.get(algo), JFLConfig(**kw), 0, T,
                      syncov_data.y.shape[1])
    params = params_from_jax(jax.tree.map(np.asarray, jsim.init_params(0)))
    _, m = engine.run_rounds(params, None, T, draws=draws)
    assert all(v.shape == (T,) for v in m.values())
    _close(m["train_loss"].numpy(), hist.train_loss, "train_loss")
    _close(m["acc"].numpy(), hist.acc, "acc")
    _close(m["acc_client_mean"].numpy(), hist.acc_client_mean,
           "acc_client_mean")


def test_cnn_round_rows_match_jax(femnist_data):
    algo, kw = "fedp2p", dict(CNN_FL)
    jfl, fl = JFLConfig(**kw), FLConfig(**kw)
    jsim = JSimulator(JNet(**CNN), femnist_data, jfl)
    jparams = jsim.init_params(0)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    n_max = femnist_data.y.shape[1]
    # one round's mixed per-client rows, before the consensus collapse
    jeng = JDenseEngine(JNet(**CNN), jsim.data_dev, jfl,
                        jprotocols.get(algo))
    jflat, jspec = jeng._pack_params(jparams)
    kr = jax.random.PRNGKey(5)
    jrows, jlosses, _ = jax.jit(jeng._round_rows, static_argnums=0)(
        jspec, jflat, kr)
    sim = Simulator(PaperNetConfig(**CNN), femnist_data, fl, device="cpu")
    eng = sim.engine(algo)
    flat, spec = eng._pack_params(params)
    rows, losses, _ = eng._round_rows(
        spec, flat, round_draws(jprotocols.get(algo), jfl, kr, n_max))
    assert rows.shape == tuple(jrows.shape)
    _close(rows.numpy(), np.asarray(jrows), "mixed rows")
    _close(losses.numpy(), np.asarray(jlosses), "client losses")


@pytest.fixture(scope="module")
def femnist_full_data():
    return pseudo_femnist_federated(4, per_client=12, num_classes=62, seed=0)


def test_cnn_full_width_matches_jax(femnist_full_data):
    """The main path's CNN at its published widths (28x28x1, hidden 64, 62
    classes; 246,590 params) with a few clients and E=1: one round's mixed
    rows, then a T=2 ``run_rounds`` against ``Simulator.run``."""
    data, algo = femnist_full_data, "fedp2p"
    kw = dict(num_clients=4, num_clusters=2, devices_per_cluster=2,
              participation=4, local_epochs=1, batch_size=5, lr=0.05,
              straggler_rate=0.3)
    jfl, fl = JFLConfig(**kw), FLConfig(**kw)
    jsim = JSimulator(J_CNN_FEMNIST, data, jfl)
    jparams = jsim.init_params(0)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert sum(v.numel() for v in params.values()) == 246_590
    n_max = data.y.shape[1]
    sim = Simulator(CNN_FEMNIST, data, fl, device="cpu")
    eng = sim.engine(algo)

    jeng = JDenseEngine(J_CNN_FEMNIST, jsim.data_dev, jfl,
                        jprotocols.get(algo))
    jflat, jspec = jeng._pack_params(jparams)
    kr = jax.random.PRNGKey(5)
    jrows, jlosses, _ = jax.jit(jeng._round_rows, static_argnums=0)(
        jspec, jflat, kr)
    flat, spec = eng._pack_params(params)
    rows, losses, _ = eng._round_rows(
        spec, flat, round_draws(jprotocols.get(algo), jfl, kr, n_max))
    _close(rows.numpy(), np.asarray(jrows), "mixed rows")
    _close(losses.numpy(), np.asarray(jlosses), "client losses")

    hist = jsim.run(rounds=2, algorithm=algo, seed=0)
    draws = run_draws(jprotocols.get(algo), jfl, 0, 2, n_max)
    _, m = eng.run_rounds(params, None, 2, draws=draws)
    _close(m["train_loss"].numpy(), hist.train_loss, "train_loss")
    _close(m["acc"].numpy(), hist.acc, "acc")
    _close(m["acc_client_mean"].numpy(), hist.acc_client_mean,
           "acc_client_mean")
    # at these widths lr 0.05 overshoots from the first steps, in both
    # packages alike: the first round's mean loss is far above chance
    assert hist.train_loss[0] > 2 * math.log(62)


def test_simulator_run_on_cpu_history(syncov_data):
    """The port's own generator path: finite metrics in History's shape,
    eval_every subsampling, and a seeded run repeats exactly."""
    sim = Simulator(LOGREG_SYN, syncov_data, FLConfig(**LOGREG_FL),
                    device="cpu")
    h1 = sim.run(rounds=4, algorithm="fedp2p", seed=3, eval_every=2)
    h2 = sim.run(rounds=4, algorithm="fedp2p", seed=3, eval_every=2)
    assert len(h1.train_loss) == 4 and h1.acc_rounds == [2, 4]
    assert all(np.isfinite(h1.train_loss)) and 0.0 <= h1.best_acc <= 1.0
    assert (h1.train_loss, h1.acc) == (h2.train_loss, h2.acc)


def test_unported_options_raise(syncov_data):
    """What still raises (unknown codecs and mix paths), and what no longer
    does: the topology-aware protocol (ROADMAP item 7) and fault plans
    (item 10) build engines and run."""
    from repro_torch.core.topology import make_topology
    from repro_torch.faults import make_plan
    sim = Simulator(LOGREG_SYN, syncov_data, FLConfig(**LOGREG_FL),
                    device="cpu")
    # codecs and the gossip family are ported: they build and run
    for codec in ("bf16", "int8", "topk", "none"):
        assert sim.engine("fedp2p", codec=codec).proto.name == "fedp2p"
    assert len(sim.run(rounds=1, algorithm="gossip").train_loss) == 1
    assert len(sim.run(rounds=1, algorithm="gossip_async",
                       codec="int8").train_loss) == 1
    with pytest.raises(ValueError, match="unknown codec"):
        sim.engine("fedp2p", codec="zip")
    topo = make_topology(LOGREG_FL["num_clients"], seed=0)
    eng = DenseEngine(LOGREG_SYN, sim.data_dev, FLConfig(**LOGREG_FL),
                      sim.engine("fedp2p").proto, topology=topo,
                      device="cpu")
    assert eng.topology is topo
    hist = Simulator(LOGREG_SYN, syncov_data,
                     FLConfig(**LOGREG_FL, topology_aware=True),
                     device="cpu").run(rounds=1)
    assert len(hist.train_loss) == 1 and math.isfinite(hist.train_loss[0])
    plan = make_plan(6, 2, seed=0, drop_rate=0.3)
    eng = DenseEngine(LOGREG_SYN, sim.data_dev, FLConfig(**LOGREG_FL),
                      sim.engine("fedp2p").proto, faults=plan, device="cpu")
    assert eng.faults is plan
    hist = Simulator(LOGREG_SYN, syncov_data, FLConfig(**LOGREG_FL),
                     faults=plan, device="cpu").run(rounds=2)
    assert len(hist.dropped) == 2
    with pytest.raises(TypeError, match="FaultPlan"):
        Simulator(LOGREG_SYN, syncov_data, FLConfig(), faults=object(),
                  device="cpu")
    with pytest.raises(ValueError, match="unknown mix_path"):
        sim.engine("fedp2p", mix_path="sparsest")
