"""The port's sampled participation against the JAX package's: window
layouts, participation strategies, and ``SampledEngine`` rounds with the
same draws.

The draws of a sampled round come from the JAX key schedule of
``repro.protocols.engine.SampledEngine`` (outside jit, the same threefry
calls) and are handed to the port as ``RoundDraws``:

  kt = fold_in(key, t)                         round t (engine.py:1163, :969)
  k_sel, k_tr, k_str, k_mix = split(kt, 4)     (engine.py:900)
  sel = strategy.select(k_sel, D, K, fl)       the active ids over D
  cluster_ids = proto.mesh_cluster_ids(K, fl)  the static window layout
  survive = straggler_mask(k_str, K, rate)     (engine.py:719)
  keys = split(fold_in(k_tr, r), K)            per sub-round (engine.py:740)
  split(key_i, E) -> permutation(e, n_max)     per epoch
  k_r = fold_in(k_mix, r)                      mix r = 1..S (engine.py:724)
  randint(k_r, (), 0, R(K))                    gossip_async
  uniform(fold_in(k_r, 0x636F6465), ...)       int8 rounding

Covered: ``mesh_cluster_ids`` and ``validate_participation`` (values and
error texts) for every protocol; uniform selection and ``pareto_top_k`` on
shared arrays with ties; a full window (K == P == D) bit for bit against
the port's ``DenseEngine`` round for every protocol and mix path; 3
sampled rounds (D = 24 enrolled over 12 data clients, K = 8) against the
JAX ``SampledEngine`` for fedp2p, fedavg, gossip, gossip_async and the
int8 and topk wires, both store tiers, at rtol 1e-4 / atol 1e-5 on the
losses and the stored rows (the packages sum in other orders over a few
SGD steps); staleness exactly.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import protocols as jprotocols  # noqa: E402
from repro.config import FLConfig as JFLConfig  # noqa: E402
from repro.configs.paper_models import LOGREG_SYN as J_LOGREG  # noqa: E402
from repro.core.simulator import Simulator as JSimulator  # noqa: E402
from repro.core.straggler import straggler_mask as j_straggler  # noqa: E402
from repro.protocols.engine import (  # noqa: E402
    SampledEngine as JSampledEngine,
)
from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.configs.paper_models import LOGREG_SYN  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.partition import sample_participants  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.data.federated import pack_clients  # noqa: E402
from repro_torch.data.synthetic import syncov  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.protocols import (  # noqa: E402
    get, get_participation, participation_names, validate_participation,
)
from repro_torch.protocols.async_gossip import (  # noqa: E402
    matching_perm_stack,
)
from repro_torch.protocols.base import pareto_top_k  # noqa: E402
from repro_torch.protocols.engine import (  # noqa: E402
    DenseEngine, RoundDraws, SampledEngine,
)

RTOL, ATOL = 1e-4, 1e-5
PROTOCOLS = ("fedavg", "fedp2p", "gossip", "gossip_async")
#: the sampled runs: D = 24 enrolled over 12 data clients, K = 8
SAMPLED_FL = dict(num_clients=12, num_clusters=2, devices_per_cluster=4,
                  participation=8, local_epochs=2, batch_size=10, lr=0.05,
                  straggler_rate=0.3, num_enrolled=24,
                  participants_per_round=8)
T = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These runs are thousands of tiny CPU ops: one intra-op thread a
    process keeps them from spinning against the other test workers
    (results do not depend on it: every comparison is within one
    process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.partial(jax.jit, static_argnums=(0, 1, 3, 4))
def _jax_window_draws(proto, fl, kt, n_max, K):
    k_sel, k_tr, k_str, k_mix = jax.random.split(kt, 4)
    sel = jprotocols.get_participation(fl.participation_strategy).select(
        k_sel, fl.enrolled, K, fl)
    survive = j_straggler(k_str, K, fl.straggler_rate)

    def epochs(key):
        return jax.vmap(lambda e: jax.random.permutation(e, n_max))(
            jax.random.split(key, fl.local_epochs))

    subs = max(1, fl.sync_period)
    perms = [jax.vmap(epochs)(jax.random.split(jax.random.fold_in(k_tr, r),
                                               K)) for r in range(subs)]
    mix_keys = [jax.random.fold_in(k_mix, r) for r in range(1, subs + 1)]
    return sel, survive, jax.numpy.stack(perms), mix_keys


def window_draws(proto, fl, kt, n_max, int8=None) -> RoundDraws:
    """One sampled round's draws from the JAX round key ``kt``, exactly as
    the JAX ``SampledEngine`` draws them. ``int8`` = ``(codec,
    n_params)`` adds the int8 codec's rounding noise."""
    K = jprotocols.validate_participation(fl, proto)
    sel, survive, perms, mix_keys = _jax_window_draws(proto, fl, kt, n_max,
                                                      K)
    matching = noise = None
    if proto.name == "gossip_async":
        R = matching_perm_stack(K).shape[0]
        matching = torch.tensor([int(jax.random.randint(k, (), 0, R))
                                 for k in mix_keys], dtype=torch.int64)
    if int8 is not None:
        codec, n = int8
        shape = (K, codec.padded(n) // codec.chunk, codec.chunk)
        noise = torch.stack([torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(k, 0x636F6465), shape))).reshape(K, -1)
            for k in mix_keys])
    return RoundDraws(
        sel=torch.tensor(np.asarray(sel), dtype=torch.int64),
        cluster_ids=torch.from_numpy(proto.mesh_cluster_ids(K, fl)),
        survive=torch.tensor(np.asarray(survive), dtype=torch.float32),
        batch_perm=torch.tensor(np.asarray(perms), dtype=torch.int64),
        matching=matching, wire_noise=noise)


def sampled_run_draws(proto, fl, key, rounds, n_max, int8=None):
    """The draws of the JAX ``SampledEngine.run_rounds(key, rounds)`` at
    every depth: round t's key is ``fold_in(key, t)``."""
    return [window_draws(proto, fl, jax.random.fold_in(key, t), n_max, int8)
            for t in range(rounds)]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def store_rows(store, ids=None):
    """[D or len(ids), width] host rows of either tier of either package."""
    ids = np.arange(store.num_enrolled) if ids is None else np.asarray(ids)
    return np.asarray(store.gather(ids))


@pytest.fixture(scope="module")
def data12():
    return pack_clients(*syncov(num_clients=12, seed=0), 10, seed=0)


# ---- window layouts and participation --------------------------------------


@pytest.mark.parametrize("width", [1, 6, 8, 12, 30])
@pytest.mark.parametrize("algo", PROTOCOLS + ("fedp2p_topo",))
def test_mesh_cluster_ids_match_jax(algo, width):
    kw = dict(num_clusters=3)
    jproto, proto = jprotocols.get(algo), get(algo)
    try:
        want = jproto.mesh_cluster_ids(width, JFLConfig(**kw))
    except AssertionError:
        with pytest.raises(ValueError, match="equal clusters"):
            proto.mesh_cluster_ids(width, FLConfig(**kw))
        return
    got = proto.mesh_cluster_ids(width, FLConfig(**kw))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("enrolled,window,clusters", [
    (100, 10, 2), (100, 10, 3), (100, 2, 3), (24, 24, 3), (8, 0, 2),
    (12, 0, 5)])
@pytest.mark.parametrize("algo", PROTOCOLS + ("fedp2p_topo",))
def test_validate_participation_matches_jax(algo, enrolled, window,
                                            clusters):
    kw = dict(num_clients=12, num_enrolled=enrolled,
              participants_per_round=window, num_clusters=clusters,
              devices_per_cluster=2, participation=9)
    try:
        want = jprotocols.validate_participation(JFLConfig(**kw),
                                                 jprotocols.get(algo))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            validate_participation(FLConfig(**kw), get(algo))
        assert str(got.value) == str(e)
        return
    assert validate_participation(FLConfig(**kw), get(algo)) == want


def test_validate_participation_window_larger_than_population():
    kw = dict(num_clients=20, num_enrolled=0, participants_per_round=0,
              participation=30)
    with pytest.raises(ValueError) as want:
        jprotocols.validate_participation(JFLConfig(**kw),
                                          jprotocols.get("gossip"))
    with pytest.raises(ValueError) as got:
        validate_participation(FLConfig(**kw), get("gossip"))
    assert str(got.value) == str(want.value)


def test_uniform_is_sample_participants():
    fl = FLConfig()
    got = get_participation("uniform").select(
        torch.Generator().manual_seed(7), 100, 10, fl)
    want = sample_participants(torch.Generator().manual_seed(7), 100, 10)
    assert torch.equal(got, want)


def _pareto_jax(log_score, avail, gumbel, k):
    """The body of ``repro.protocols.base.ParetoParticipation.select``
    after its draws."""
    g = jax.numpy.asarray(log_score) + jax.numpy.asarray(gumbel)
    g = jax.numpy.where(jax.numpy.asarray(avail), g, g - 1e9)
    return np.asarray(jax.lax.top_k(g, k)[1])


@pytest.mark.parametrize("seed,rate", [(0, 0.1), (1, 0.3), (2, 1.0),
                                       (3, 0.02)])
def test_pareto_top_k_matches_jax(seed, rate):
    """Shared (log_score, avail, gumbel) arrays through the JAX expression
    and the port: with a pool smaller than K the unavailable keys tie
    (their f32 spacing at 1e9 is 64) and both take them lowest index
    first."""
    rng = np.random.default_rng(seed)
    D, K = 64, 12
    log_score = (-np.log(rng.uniform(1e-6, 1.0, D)) / 3).astype(np.float32)
    avail = rng.random(D) < rate
    gumbel = rng.gumbel(size=D).astype(np.float32)
    got = pareto_top_k(torch.from_numpy(log_score), torch.from_numpy(avail),
                       torch.from_numpy(gumbel), K)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  _pareto_jax(log_score, avail, gumbel, K))


def test_pareto_all_keys_tied():
    """Seven unavailable clients, every key -1e9: both take [0 1 2 3 4]
    (``torch.topk`` alone gives another order)."""
    zero = np.zeros(7, np.float32)
    none = np.zeros(7, bool)
    want = _pareto_jax(zero, none, zero, 5)
    np.testing.assert_array_equal(want, [0, 1, 2, 3, 4])
    got = pareto_top_k(torch.from_numpy(zero), torch.from_numpy(none),
                       torch.from_numpy(zero), 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pareto_selects_k_distinct_available_and_is_deterministic():
    fl = FLConfig(participation_rate=0.3)
    strat = get_participation("pareto")
    sel = strat.select(torch.Generator().manual_seed(3), 500, 64, fl)
    assert sel.shape == (64,) and len(set(sel.tolist())) == 64
    again = strat.select(torch.Generator().manual_seed(3), 500, 64, fl)
    assert torch.equal(sel, again)
    other = strat.select(torch.Generator().manual_seed(4), 500, 64, fl)
    assert not torch.equal(sel, other)
    # a pool of ~150 available clients covers K = 64: every winner is
    # available (the availability mask is the first draw of the round)
    gen = torch.Generator().manual_seed(3)
    avail = torch.rand((500,), generator=gen) < 0.3
    assert bool(avail[sel].all())


def test_unknown_participation_strategy_lists_registered():
    with pytest.raises(ValueError, match="uniform.*pareto"):
        get_participation("roundrobin")
    assert participation_names() == jprotocols.participation_names()


def test_flconfig_enrollment_validation():
    with pytest.raises(ValueError, match="num_enrolled must be >= 0"):
        FLConfig(num_enrolled=-1)
    with pytest.raises(ValueError, match="exceed"):
        FLConfig(num_enrolled=8, participants_per_round=9)
    assert FLConfig(num_enrolled=0).enrolled == FLConfig().num_clients
    assert FLConfig(num_enrolled=100).enrolled == 100


# ---- the window against the dense round, bit for bit ------------------------


def _full_fl(**kw):
    base = dict(num_clients=24, num_clusters=3, devices_per_cluster=8,
                participation=24, local_epochs=2, batch_size=10, lr=0.05,
                straggler_rate=0.3, num_enrolled=24,
                participants_per_round=24)
    base.update(kw)
    return FLConfig(**base)


@pytest.fixture(scope="module")
def data24():
    fl = _full_fl()
    data = pack_clients(*syncov(num_clients=24, seed=0), 10, seed=0)
    return Simulator(LOGREG_SYN, data, fl, device="cpu").data_dev


@pytest.mark.parametrize("mix_path", ["dense", "auto"])
@pytest.mark.parametrize("algo", PROTOCOLS)
def test_full_window_round_matches_dense_engine(data24, algo, mix_path):
    """K == P == D with uniform selection: one generator state gives both
    engines the same draws and a bit-identical round — mixed rows (store
    rows by client id, the dense rows by slot) and mean loss."""
    fl = _full_fl()
    dense = DenseEngine(LOGREG_SYN, data24, fl, get(algo), mix_path=mix_path,
                        device="cpu")
    params = dense.init_params(0)
    flat0, spec = dense._pack_params(params)
    d = dense.draw_round(torch.Generator().manual_seed(11))
    rows, losses, _ = dense._round_rows(spec, flat0, d, 0)
    se = SampledEngine(LOGREG_SYN, data24, fl, get(algo), mix_path=mix_path,
                       device="cpu")
    se.init_store(params)
    loss = se.round(torch.Generator().manual_seed(11), 0)
    assert torch.equal(se.store.flat[d.sel], rows)
    assert torch.equal(loss, losses.mean())
    assert np.all(se.store.staleness(0)[d.sel.numpy()] == 0)


def test_global_params_is_mean_packed_of_the_rows(data24):
    fl = _full_fl()
    dense = DenseEngine(LOGREG_SYN, data24, fl, get("fedavg"), device="cpu")
    params = dense.init_params(0)
    flat0, spec = dense._pack_params(params)
    d = dense.draw_round(torch.Generator().manual_seed(2))
    rows, _, _ = dense._round_rows(spec, flat0, d, 0)
    se = SampledEngine(LOGREG_SYN, data24, fl, get("fedavg"), device="cpu")
    se.init_store(params)
    se.round(draws=d)
    want = ops.unpack_tree(ops.mean_packed(rows, spec), spec)
    got = se.global_params()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_round_without_store_raises(data24):
    se = SampledEngine(LOGREG_SYN, data24, _full_fl(), get("fedavg"),
                       device="cpu")
    with pytest.raises(ValueError, match="init_store"):
        se.round(torch.Generator())
    with pytest.raises(ValueError, match="init_store"):
        se.run_rounds(torch.Generator(), 1)


def test_run_rounds_advances_staleness(data24):
    fl = _full_fl(participants_per_round=8, num_clusters=2)
    se = SampledEngine(LOGREG_SYN, data24, fl, get("fedp2p"), device="cpu")
    se.init_store(se.init_params(0))
    out = se.run_rounds(torch.Generator().manual_seed(0), 3)
    assert out["train_loss"].shape == (3,)
    assert np.isfinite(out["train_loss"]).all()
    touched = se.store.last_round >= 0
    assert 0 < touched.sum() <= 3 * 8
    assert set(se.store.last_round[touched].tolist()) <= {0, 1, 2}


def test_sampled_engine_defaults_to_the_card(data24):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SampledEngine(LOGREG_SYN, data24, _full_fl(), get("fedavg"))


# ---- 3 sampled rounds against the JAX SampledEngine -------------------------


def run_both(data, algo, *, codec=None, mix_path="auto", tier="auto",
             key=3, depth=1, rounds=T, faults=None, jfaults=None, **over):
    """One sampled run in each package with the same draws and initial
    params; returns (port engine, its metrics, JAX engine, its metrics)."""
    kw = dict(SAMPLED_FL, mix_path=mix_path, **over)
    jfl, fl = JFLConfig(**kw), FLConfig(**kw)
    jsim = JSimulator(J_LOGREG, data, jfl)
    jproto = jprotocols.get(algo)
    je = JSampledEngine(J_LOGREG, jsim.data_dev, jfl, jproto, codec=codec,
                        pipeline_depth=depth, faults=jfaults)
    jparams = je.init_params(0)
    je.init_store(jparams, tier=tier)
    jkey = jax.random.PRNGKey(key)
    jm = je.run_rounds(jkey, rounds)
    sim = Simulator(LOGREG_SYN, data, fl, device="cpu")
    se = SampledEngine(LOGREG_SYN, sim.data_dev, fl, get(algo), codec=codec,
                       pipeline_depth=depth, faults=faults, device="cpu")
    se.init_store(params_from_jax(jax.tree.map(np.asarray, jparams)),
                  tier=tier)
    int8 = None
    if codec == "int8":
        int8 = (se.codec, sum(v.numel() for v in se.init_params().values()))
    draws = sampled_run_draws(jproto, jfl, jkey, rounds, data.y.shape[1],
                              int8)
    m = se.run_rounds(None, rounds, draws=draws)
    return se, m, je, jm


@pytest.mark.parametrize("algo,codec,mix_path,tier", [
    ("fedp2p", None, "auto", "memory"),
    ("fedp2p", None, "dense", "checkpoint"),
    ("fedavg", None, "auto", "checkpoint"),
    ("gossip", None, "auto", "memory"),
    ("gossip_async", None, "auto", "memory"),
    ("gossip_async", None, "dense", "checkpoint"),
    ("fedp2p", "int8", "dense", "memory"),
    ("fedp2p", "int8", "auto", "checkpoint"),
    ("gossip", "topk", "auto", "checkpoint"),
    ("fedavg", "topk", "auto", "memory"),
])
def test_sampled_rounds_match_jax(data12, algo, codec, mix_path, tier):
    se, m, je, jm = run_both(data12, algo, codec=codec, mix_path=mix_path,
                             tier=tier)
    assert m["train_loss"].shape == (T,)
    _close(m["train_loss"], jm["train_loss"], "train_loss")
    np.testing.assert_array_equal(se.store.last_round, je.store.last_round)
    _close(store_rows(se.store), store_rows(je.store), "store rows")
    if se.codec is not None and se.codec.stateful:
        ids = np.arange(se.store.num_enrolled)
        _close(np.asarray(se.store.gather_residual(ids)),
               np.asarray(je.store.gather_residual(ids)), "residuals")
    if tier == "checkpoint":
        _close(se.store.consensus(), je.store.consensus(), "consensus")


def test_sampled_pareto_rounds_match_jax(data12):
    """The pareto strategy's ids come from the JAX key here (its static
    scores come from another generator in each package); the window
    rounds after them agree."""
    se, m, je, jm = run_both(data12, "fedavg", participation_strategy="pareto",
                             participation_rate=0.3)
    _close(m["train_loss"], jm["train_loss"], "train_loss")
    np.testing.assert_array_equal(se.store.last_round, je.store.last_round)
    _close(store_rows(se.store), store_rows(je.store), "store rows")
