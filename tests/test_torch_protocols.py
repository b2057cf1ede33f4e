"""The port's protocol layer against the JAX package.

* ``fedp2p`` / ``fedavg`` ``mixing_spec`` (cluster ids, ``w_new``,
  ``w_old``) and ``mixing_matrix`` (= ``to_dense``) equal the JAX
  package's BIT FOR BIT, on both ``do_global_sync`` values, over random
  survive masks, masks with all-dead clusters and all-dead rounds. The
  counts are integer sample counts, as the data gives them, so the
  per-cluster sums are exact in any order;
* ``gossip`` / ``gossip_async``: the partner-map stacks
  (``_phase_perm_stack``, ``matching_perm_stack``) equal the JAX
  package's, and ``MatchingSpec.to_dense()`` equals both the port's and
  the JAX package's ``mixing_matrix`` BIT FOR BIT, at every matching
  index of gossip_async (every entry is a small dyadic rational, so the
  stage products are exact);
* the registry: the ported names, ``resolve`` raising for the JAX
  protocol not ported yet, unknown names raising; gossip_async raising
  without a drawn matching;
* ``partition`` / ``straggler_mask`` shapes and ranges on a generator, and
  ``comm_time`` / ``wire_model`` equal to the JAX package's.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import protocols as jprotocols  # noqa: E402
from repro.config import FLConfig as JFLConfig  # noqa: E402
from repro.core.comm_model import CommParams as JCommParams  # noqa: E402
from repro.protocols.async_gossip import (  # noqa: E402
    matching_perm_stack as j_matching_perm_stack,
)
from repro.protocols.gossip import (  # noqa: E402
    _phase_perm_stack as j_phase_perm_stack,
)
from repro_torch import protocols  # noqa: E402
from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core.comm_model import CommParams  # noqa: E402
from repro_torch.core.straggler import straggler_mask  # noqa: E402
from repro_torch.protocols.async_gossip import (  # noqa: E402
    matching_perm_stack,
)
from repro_torch.protocols.gossip import _phase_perm_stack  # noqa: E402


def _survive(rng, D, ids, L, mode):
    s = (rng.random(D) > 0.35).astype(np.float32)
    if mode == "dead_cluster":
        s[ids == rng.integers(0, L)] = 0.0
    elif mode == "all_dead":
        s[:] = 0.0
    return s


def _contexts(D, L, seed, sync, mode):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, L, D).astype(np.int32)
    survive = _survive(rng, D, ids, L, mode)
    counts = rng.integers(12, 121, D).astype(np.float32)
    jctx = jprotocols.make_context(
        key=jax.random.PRNGKey(seed), survive=jnp.asarray(survive),
        counts=jnp.asarray(counts), cluster_ids=jnp.asarray(ids),
        num_clusters=L, do_global_sync=sync)
    tctx = protocols.make_context(
        survive=torch.from_numpy(survive), counts=torch.from_numpy(counts),
        cluster_ids=torch.from_numpy(ids), num_clusters=L,
        do_global_sync=sync)
    return jctx, tctx


_JIT = {}


def _jitted(name, method):
    """The JAX protocol's method under jit, as its engines run it (one
    compile per shape rather than one per op)."""
    if (name, method) not in _JIT:
        _JIT[name, method] = jax.jit(getattr(jprotocols.get(name), method))
    return _JIT[name, method]


@pytest.mark.parametrize("name", ["fedp2p", "fedavg", "fedp2p_topo"])
@pytest.mark.parametrize("sync", [True, False])
@pytest.mark.parametrize("D,L", [(5, 2), (8, 3), (16, 4), (12, 12)])
@pytest.mark.parametrize("mode", ["random", "dead_cluster", "all_dead"])
def test_mixing_spec_and_to_dense_bitwise(name, sync, D, L, mode):
    jctx, tctx = _contexts(D, L, seed=D * 10 + L + sync, sync=sync,
                           mode=mode)
    jspec = _jitted(name, "mixing_spec")(jctx)
    tspec = protocols.get(name).mixing_spec(tctx)
    assert tspec.num_segments == jspec.num_segments
    for f in ("cluster_ids", "w_new", "w_old"):
        got, want = getattr(tspec, f).numpy(), np.asarray(getattr(jspec, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    jm = _jitted(name, "mixing_matrix")(jctx)
    tm = protocols.get(name).mixing_matrix(tctx)
    for got, want in zip(tm, jm):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # rows of M_new + M_old sum to 1: no update falls back to zeros
    np.testing.assert_allclose((tm[0] + tm[1]).sum(dim=1).numpy(), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("D", [1, 2, 3, 8, 9, 17, 64])
def test_perm_stacks_match_jax(D):
    np.testing.assert_array_equal(matching_perm_stack(D),
                                  j_matching_perm_stack(D))
    np.testing.assert_array_equal(_phase_perm_stack(D),
                                  j_phase_perm_stack(D))
    assert matching_perm_stack(D).dtype == np.int32


def _gossip_contexts(D, seed, r=None):
    rng = np.random.default_rng(seed)
    survive = (rng.random(D) > 0.35).astype(np.float32)
    jkw, tkw = {}, {}
    if r is not None:
        # a key whose randint(key, (), 0, R) is r: the JAX protocol draws
        # its matching from the key, the port is handed the index
        R = matching_perm_stack(D).shape[0]
        k = next(k for k in range(10_000) if int(jax.random.randint(
            jax.random.PRNGKey(k), (), 0, R)) == r)
        jkw["key"] = jax.random.PRNGKey(k)
        tkw["matching"] = torch.tensor(r, dtype=torch.int64)
    jctx = jprotocols.make_context(survive=jnp.asarray(survive), **jkw)
    tctx = protocols.make_context(survive=torch.from_numpy(survive), **tkw)
    return jctx, tctx


@pytest.mark.parametrize("D", [5, 8, 16])
def test_matching_spec_to_dense_bitwise(D):
    cases = [("gossip", None)] + [
        ("gossip_async", r) for r in range(matching_perm_stack(D).shape[0])]
    for name, r in cases:
        jctx, tctx = _gossip_contexts(D, seed=D + (r or 0), r=r)
        spec = protocols.get(name).mixing_spec(tctx)
        assert isinstance(spec, protocols.MatchingSpec)
        assert spec.perms.shape == (2 if r is None else 1, D)
        dense = spec.to_dense()
        port = protocols.get(name).mixing_matrix(tctx)
        jax_m = _jitted(name, "mixing_matrix")(jctx)
        for got, mine, want in zip(dense, port, jax_m):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{name} r={r}")
            np.testing.assert_array_equal(mine.numpy(), np.asarray(want),
                                          err_msg=f"{name} r={r}")
        np.testing.assert_allclose((dense[0] + dense[1]).sum(dim=1).numpy(),
                                   1.0, rtol=1e-6)


def test_registry_and_resolve():
    assert set(protocols.names()) == set(jprotocols.names()) == {
        "fedavg", "fedp2p", "fedp2p_topo", "gossip", "gossip_async"}
    assert protocols.resolve("fedp2p").name == "fedp2p"
    assert protocols.resolve("gossip_async").name == "gossip_async"
    assert protocols.resolve("fedp2p", topology_aware=True).name == \
        "fedp2p_topo"
    assert protocols.get("fedp2p_topo").needs_topology
    assert not protocols.get("fedp2p").needs_topology
    # no gossip_topo: the flag would do nothing, so it warns, as JAX's does
    with pytest.warns(UserWarning, match="no effect"):
        assert protocols.resolve("gossip",
                                 topology_aware=True).name == "gossip"
    with pytest.raises(ValueError, match="is stochastic"):
        protocols.get("gossip_async").mixing_spec(
            protocols.make_context(num_clients=4))
    with pytest.raises(ValueError, match="unknown protocol 'nope'"):
        protocols.get("nope")
    # both participation strategies are ported; unknown names still raise
    assert protocols.participation_names() == ("uniform", "pareto")
    assert protocols.get_participation("pareto").name == "pareto"
    with pytest.raises(ValueError, match="participation strategy"):
        protocols.get_participation("roundrobin")


@pytest.mark.parametrize("name", ["fedp2p", "fedavg", "gossip",
                                  "gossip_async", "fedp2p_topo"])
def test_partition_and_stragglers_on_a_generator(name):
    fl = FLConfig(num_clients=30, num_clusters=3, devices_per_cluster=4,
                  participation=7)
    proto = protocols.get(name)
    gen = torch.Generator().manual_seed(0)
    sel, cids = proto.partition(gen, fl)
    P = proto.num_participants(fl)
    assert sel.shape == (P,) and cids.shape == (P,)
    assert len(set(sel.tolist())) == P and 0 <= int(sel.min())
    assert int(sel.max()) < fl.num_clients
    assert cids.dtype == torch.int32
    assert sorted(set(cids.tolist())) == list(range(proto.num_clusters(fl)))
    assert straggler_mask(gen, P, 0.0).tolist() == [1.0] * P
    s = straggler_mask(gen, 2000, 0.3)
    assert set(s.unique().tolist()) <= {0.0, 1.0}
    assert 0.6 < float(s.mean()) < 0.8


@pytest.mark.parametrize("name", ["fedp2p", "fedavg", "gossip",
                                  "gossip_async", "fedp2p_topo"])
def test_comm_time_and_wire_model_match_jax(name):
    jp = JCommParams(model_bytes=4e6, server_bw=1e8, device_bw=1e9)
    tp = CommParams(model_bytes=4e6, server_bw=1e8, device_bw=1e9)
    for P in (10, 100):
        assert (protocols.get(name).comm_time(tp, P)
                == jprotocols.get(name).comm_time(jp, P))
        assert (protocols.get(name).comm_time(tp, P, L=5.0)
                == jprotocols.get(name).comm_time(jp, P, L=5.0))
    for sync in (True, False):
        assert (protocols.get(name).wire_model(100, 10, do_global_sync=sync)
                == jprotocols.get(name).wire_model(100, 10,
                                                   do_global_sync=sync))
    assert (protocols.get(name).num_participants(FLConfig())
            == jprotocols.get(name).num_participants(JFLConfig()))
