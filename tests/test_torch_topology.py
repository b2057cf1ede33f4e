"""The port's topology-aware FedP2P (the paper's §5 extension) against the
JAX package's:

* ``core.topology`` (``make_topology``, ``cluster_comm_time``,
  ``grid_cluster_assignment``) and ``core.partition.topology_partition``
  (given the seed JAX derives from its key): bit for bit;
* ``TopologyAwareFedP2P.partition`` on selections whose region keys tie
  (the stable sort): bit for bit, on a generator and against JAX's
  ``partition`` for the same selection; without a topology it is FedP2P's;
* ``comm_time`` with ``ctx.topology``: equal floats;
* ``Simulator.run("fedp2p_topo")`` and ``topology_aware=True`` with the
  simulator's own topology, mix_path auto and dense: a T=3 run against
  ``repro.core.simulator.Simulator.run`` with the draws made from the JAX
  key tree, rtol 1e-4 / atol 1e-5 (the codec-free tolerance of
  ``test_torch_engine.py``: the packages sum in other orders over dozens
  of SGD steps).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import protocols as jprotocols  # noqa: E402
from repro.config import FLConfig as JFLConfig  # noqa: E402
from repro.configs.paper_models import LOGREG_SYN as J_LOGREG  # noqa: E402
from repro.core import partition as jpartition  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.core.comm_model import CommParams as JCommParams  # noqa: E402
from repro.core.simulator import Simulator as JSimulator  # noqa: E402
from repro.protocols.context import make_context as j_make_context  # noqa: E402
from repro_torch import protocols  # noqa: E402
from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.configs.paper_models import LOGREG_SYN  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import partition, topology  # noqa: E402
from repro_torch.core.comm_model import CommParams  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.data.federated import pack_clients  # noqa: E402
from repro_torch.data.synthetic import syncov  # noqa: E402
from test_torch_engine import LOGREG_FL, T, run_draws  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


def _same_topology(a, b):
    for f in ("coords", "hops", "bandwidth"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("n,grid,seed", [(100, 8, 0), (37, 4, 3),
                                         (1, 8, 1), (256, 16, 7)])
def test_topology_bit_for_bit(n, grid, seed):
    topo = topology.make_topology(n, grid=grid, seed=seed)
    jtopo = jtopology.make_topology(n, grid=grid, seed=seed)
    _same_topology(topo, jtopo)
    rng = np.random.default_rng(seed)
    for L in (1, 3, 10):
        sel = rng.permutation(n)[:min(n, 30)]
        np.testing.assert_array_equal(
            topology.grid_cluster_assignment(topo, sel, L),
            jtopology.grid_cluster_assignment(jtopo, sel, L))
        members = sel[:max(1, len(sel) // L)]
        assert (topology.cluster_comm_time(topo, members, 4e6)
                == jtopology.cluster_comm_time(jtopo, members, 4e6))


@pytest.mark.parametrize("key_seed", [0, 1, 5])
def test_topology_partition_bit_for_bit(key_seed):
    jtopo = jtopology.make_topology(100, seed=key_seed)
    topo = topology.make_topology(100, seed=key_seed)
    key = jax.random.PRNGKey(key_seed)
    jsel, jids = jpartition.topology_partition(key, jtopo, 10, 10)
    # the seed JAX derives from its key (partition.py:46)
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    sel, ids = partition.topology_partition(seed, topo, 10, 10)
    np.testing.assert_array_equal(sel, jsel)
    np.testing.assert_array_equal(ids, jids)
    assert ids.dtype == jids.dtype == np.int32


@pytest.mark.parametrize("L,Q,grid", [(10, 10, 8), (5, 2, 2), (4, 6, 3)])
def test_topology_aware_partition_ties_bit_for_bit(L, Q, grid):
    """100 devices on grid x grid regions: many selected devices share a
    region key. The port's stable sort gives JAX's clusters for the same
    selection."""
    fl = FLConfig(num_clients=100, num_clusters=L, devices_per_cluster=Q)
    jfl = JFLConfig(num_clients=100, num_clusters=L, devices_per_cluster=Q)
    topo = topology.make_topology(100, grid=grid, seed=2)
    jtopo = jtopology.make_topology(100, grid=grid, seed=2)
    proto = protocols.get("fedp2p_topo")
    gen = torch.Generator().manual_seed(L)
    sel, ids = proto.partition(gen, fl, topo)
    keys = topo.coords[sel.numpy(), 0] * 1024 + topo.coords[sel.numpy(), 1]
    assert len(set(keys.tolist())) < L * Q          # the keys do tie
    assert sel.dtype == torch.int64 and ids.dtype == torch.int32
    assert sorted(ids.tolist()) == sorted(list(range(L)) * Q)
    # JAX's partition of the same selection: its select_participants is a
    # permutation of the key; hand it this selection instead
    jproto = jprotocols.get("fedp2p_topo")
    orig = jproto.select_participants
    try:
        jproto.select_participants = lambda key, fl: jax.numpy.asarray(
            sel.numpy())
        jsel, jids = jproto.partition(jax.random.PRNGKey(0), jfl, jtopo)
    finally:
        jproto.select_participants = orig
    np.testing.assert_array_equal(np.asarray(jsel), sel.numpy())
    np.testing.assert_array_equal(np.asarray(jids), ids.numpy())
    # the same draws from the same generator state without a topology:
    # FedP2P's random partition
    s2, i2 = proto.partition(torch.Generator().manual_seed(L), fl, None)
    s3, i3 = protocols.get("fedp2p").partition(
        torch.Generator().manual_seed(L), fl)
    assert torch.equal(s2, s3) and torch.equal(i2, i3)
    assert torch.equal(s2, sel)


@pytest.mark.parametrize("P,L", [(100, None), (100, 5.0), (300, None),
                                 (10, 3.0)])
def test_topology_aware_comm_time_matches_jax(P, L):
    jp = JCommParams(model_bytes=4e6, server_bw=1e8, device_bw=1e9)
    tp = CommParams(model_bytes=4e6, server_bw=1e8, device_bw=1e9)
    topo = topology.make_topology(100, seed=0)
    jtopo = jtopology.make_topology(100, seed=0)
    got = protocols.get("fedp2p_topo").comm_time(
        tp, P, L=L, ctx=protocols.make_context(topology=topo))
    want = jprotocols.get("fedp2p_topo").comm_time(
        jp, P, L=L, ctx=j_make_context(topology=jtopo))
    assert got == want
    # no topology in the context: FedP2P's analytic model
    assert (protocols.get("fedp2p_topo").comm_time(tp, P, L=L)
            == protocols.get("fedp2p").comm_time(tp, P, L=L))


@pytest.fixture(scope="module")
def syncov_data():
    return pack_clients(*syncov(num_clients=20, seed=0), 10, seed=0)


def _topo_draws(jfl, jtopo, rounds, n_max):
    """``Simulator.run(seed=0)``'s draws for fedp2p_topo: fedp2p_topo's
    selection is FedP2P's (one permutation of the round's k_sel), and its
    cluster ids come from JAX's own ``partition`` with the topology."""
    jproto = jprotocols.get("fedp2p_topo")
    draws = run_draws(jproto, jfl, 0, rounds, n_max)
    key, out = jax.random.PRNGKey(1), []
    for d in draws:
        key, kr = jax.random.split(key)
        k_sel = jax.random.split(kr, 4)[0]
        sel, ids = jproto.partition(k_sel, jfl, jtopo)
        np.testing.assert_array_equal(np.asarray(sel), d.sel.numpy())
        out.append(dataclasses.replace(
            d, cluster_ids=torch.tensor(np.asarray(ids), dtype=torch.int32)))
    return out


@pytest.mark.parametrize("mix_path", ["auto", "dense"])
@pytest.mark.parametrize("how", ["algorithm", "topology_aware"])
def test_fedp2p_topo_run_matches_jax(syncov_data, mix_path, how):
    """A T=3 run of fedp2p_topo: by name with a given topology, or through
    ``topology_aware=True`` with the topology each simulator builds itself
    (``make_topology(num_clients, seed=fl.seed)``)."""
    kw = dict(LOGREG_FL, mix_path=mix_path)
    if how == "topology_aware":
        kw["topology_aware"] = True
        algo, jtopo, topo = "fedp2p", None, None
    else:
        algo = "fedp2p_topo"
        jtopo = jtopology.make_topology(20, grid=3, seed=4)
        topo = topology.make_topology(20, grid=3, seed=4)
    jsim = JSimulator(J_LOGREG, syncov_data, JFLConfig(**kw), jtopo)
    hist = jsim.run(rounds=T, algorithm=algo, seed=0)
    sim = Simulator(LOGREG_SYN, syncov_data, FLConfig(**kw), topo,
                    device="cpu")
    engine = sim.engine(algo)
    assert engine.proto.name == "fedp2p_topo"
    _same_topology(sim.topology, jsim.topology)
    assert engine.topology is sim.topology
    draws = _topo_draws(JFLConfig(**kw), jsim.topology, T,
                        syncov_data.y.shape[1])
    params = params_from_jax(jax.tree.map(np.asarray, jsim.init_params(0)))
    _, m = engine.run_rounds(params, None, T, draws=draws)
    for name in ("train_loss", "acc", "acc_client_mean"):
        np.testing.assert_allclose(m[name].numpy(), getattr(hist, name),
                                   err_msg=name, **TOL)
    # the port's own generator path runs the same protocol end to end
    h = sim.run(rounds=2, algorithm=algo, seed=0)
    assert len(h.train_loss) == 2 and all(np.isfinite(h.train_loss))


def test_topology_aware_engine_draws_hop_aware_clusters(syncov_data):
    """``DenseEngine.draw_round`` hands the topology to ``partition``:
    every cluster of a draw is a run of the selection sorted by region."""
    fl = FLConfig(**dict(LOGREG_FL, topology_aware=True))
    sim = Simulator(LOGREG_SYN, syncov_data, fl, device="cpu")
    eng = sim.engine("fedp2p")
    d = eng.draw_round(torch.Generator().manual_seed(3))
    topo = sim.topology
    keys = (topo.coords[d.sel.numpy(), 0] * 1024
            + topo.coords[d.sel.numpy(), 1])
    order = np.argsort(keys, kind="stable")
    Q = fl.devices_per_cluster
    np.testing.assert_array_equal(d.cluster_ids.numpy()[order],
                                  np.repeat(np.arange(fl.num_clusters), Q))
