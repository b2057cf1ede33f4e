"""The port's ``SampledEngine`` under fault plans (the sampled cases of
``tests/test_faults.py``, from the injector and the store-tier recovery
on), with the fault counters held to the JAX ``SampledEngine``'s on the
same plan and the same draws.

A deterministic ``FaultPlan`` (dropout, corrupted uploads in all three
modes, transient read errors, a stalled or dead prefetch worker) drives
the sampled driver, and (a) the store never absorbs a poisoned row, (b)
rejected clients get their cold retry through the requeue splice, (c)
the per-round counters ``dropped``, ``rejected_rows``, ``retries`` and
``prefetch_fallbacks`` equal JAX's at depths 1 and 2 on both tiers, and
(d) the faulted driver is depth-invariant on everything deterministic
(losses, dropped, rejected rows, store bytes, staleness).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import faults as jfaults  # noqa: E402
from repro_torch import faults as fault_lib  # noqa: E402
from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.configs.paper_models import LOGREG_SYN  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.data.federated import pack_clients  # noqa: E402
from repro_torch.data.synthetic import syncov  # noqa: E402
from repro_torch.faults import (  # noqa: E402
    FaultPlan, FaultSpec, InjectedReadError, make_plan,
)
from repro_torch.protocols import CheckpointStore, get  # noqa: E402
from repro_torch.protocols.engine import FAULT_COUNTERS, SampledEngine  # noqa: E402
from test_torch_sampled_engine import (  # noqa: E402
    RTOL, ATOL, run_both, store_rows,
)

D = 24
K = 8


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


def _fl(**kw):
    base = dict(num_clients=D, num_clusters=2, devices_per_cluster=8,
                participation=D, local_epochs=1, batch_size=10, lr=0.05,
                straggler_rate=0.3, num_enrolled=D,
                participants_per_round=K)
    base.update(kw)
    return FLConfig(**base)


@pytest.fixture(scope="module")
def data_dev():
    data = pack_clients(*syncov(num_clients=D, seed=0), 10, seed=0)
    return Simulator(LOGREG_SYN, data, _fl(), device="cpu").data_dev


@pytest.fixture(scope="module")
def data12():
    return pack_clients(*syncov(num_clients=12, seed=0), 10, seed=0)


def _engine(data_dev, *, faults=None, depth=1, tier="memory", algo="fedavg",
            codec=None, fl=None):
    se = SampledEngine(LOGREG_SYN, data_dev, fl or _fl(), get(algo),
                       codec=codec, pipeline_depth=depth, faults=faults,
                       device="cpu")
    se.init_store(se.init_params(0), tier=tier)
    return se


def _rows(se):
    return store_rows(se.store)


def _nan_all_plan():
    """Round 0 corrupts EVERY enrolled client — whatever window is drawn,
    all K rows come back poisoned."""
    return FaultPlan(specs=(
        FaultSpec(0, corrupt=tuple((c, "nan") for c in range(D))),))


# ---- the injector and the store tier's recovery ------------------------------


def test_checkpoint_read_retry_absorbs_injected_errors():
    st = CheckpointStore(np.zeros((4,), np.float32), 16, read_retries=3,
                         read_backoff=0.0)
    st.fault_injector = inj = fault_lib.FaultInjector(
        FaultPlan(specs=(FaultSpec(0, read_errors=2),)))
    inj.begin_round(0)
    assert st.gather(np.array([1, 2])).shape == (2, 4)
    assert st.read_retry_count == 2
    assert inj.counters["read_errors"] == 2


def test_checkpoint_read_error_raises_without_retries():
    st = CheckpointStore(np.zeros((4,), np.float32), 16)   # read_retries=0
    st.fault_injector = inj = fault_lib.FaultInjector(
        FaultPlan(specs=(FaultSpec(0, read_errors=1),)))
    inj.begin_round(0)
    with pytest.raises(InjectedReadError):
        st.gather(np.array([1]))


def test_checkpoint_overlay_rows_need_no_read():
    """Only cold rows are read: a window whose every row is in the overlay
    never calls the read hook."""
    st = CheckpointStore(np.zeros((4,), np.float32), 16)
    st.scatter(np.array([1, 2]), np.ones((2, 4), np.float32))
    st.fault_injector = inj = fault_lib.FaultInjector(
        FaultPlan(specs=(FaultSpec(0, read_errors=1),)))
    inj.begin_round(0)
    assert float(st.gather(np.array([2, 1])).sum()) == 8.0
    assert inj.counters["read_errors"] == 0


# ---- guard, requeue, counters --------------------------------------------------


@pytest.mark.parametrize("tier", ["memory", "checkpoint"])
def test_guard_keeps_poison_out_of_store_and_requeues(data_dev, tier):
    se = _engine(data_dev, faults=_nan_all_plan(), tier=tier)
    before = _rows(se).copy()
    se.round(torch.Generator().manual_seed(0), 0)
    after = _rows(se)
    assert np.all(np.isfinite(after))
    np.testing.assert_array_equal(after, before)
    assert len(se._retry_queue) == K
    assert np.all(se.store.last_round == -1)
    # the cold retry: round 1 is fault-free, the spliced-in clients train
    se.round(torch.Generator().manual_seed(1), 1)
    assert not se._retry_queue
    assert (se.store.last_round == 1).sum() == K
    assert np.any(_rows(se) != before)


def test_retry_splice_replaces_tail_slots(data_dev):
    se = _engine(data_dev, faults=_nan_all_plan())
    se._retry_queue = [20, 21, 22]
    out = se._splice_retries(np.arange(K, dtype=np.int64))
    np.testing.assert_array_equal(out[:K - 3], np.arange(K - 3))
    np.testing.assert_array_equal(np.sort(out[-3:]), [20, 21, 22])
    assert se._retry_queue == []
    se._retry_queue = [0, 21]
    out = se._splice_retries(np.arange(K, dtype=np.int64))
    assert list(out).count(0) == 1 and 21 in out
    # a queue longer than the window carries the rest over
    se._retry_queue = list(range(8, 8 + K + 3))
    out = se._splice_retries(np.arange(K, dtype=np.int64))
    assert len(set(out.tolist())) == K
    assert se._retry_queue == list(range(8 + K, 8 + K + 3))


@pytest.mark.parametrize("queue,ids", [
    ([20, 21, 22], list(range(K))),
    ([0, 21], list(range(K))),
    # a queued client drawn into a TAIL slot is passed over as retried,
    # then that slot goes to the next queued client: both packages drop
    # it from the window and from the queue alike
    ([3, 7, 30, 31], [9, 10, 11, 12, 13, 14, 15, 7]),
    (list(range(8, 8 + K + 3)), list(range(K))),
])
def test_retry_splice_matches_jax(data_dev, queue, ids):
    from repro.config import FLConfig as JFLConfig
    from repro.configs.paper_models import LOGREG_SYN as J_LOGREG
    from repro.core.simulator import Simulator as JSimulator
    from repro.protocols import get as jget
    from repro.protocols.engine import SampledEngine as JSampledEngine
    kw = dict(num_clients=D, num_clusters=2, devices_per_cluster=8,
              participation=D, num_enrolled=32, participants_per_round=K)
    data = pack_clients(*syncov(num_clients=D, seed=0), 10, seed=0)
    je = JSampledEngine(J_LOGREG, JSimulator(J_LOGREG, data, JFLConfig(
        **kw)).data_dev, JFLConfig(**kw), jget("fedavg"),
        faults=jfaults.FaultPlan(specs=(jfaults.FaultSpec(0, drop=(1,)),)))
    se = _engine(data_dev, faults=_nan_all_plan(), fl=_fl(**kw))
    je._retry_queue, se._retry_queue = list(queue), list(queue)
    want = je._splice_retries(np.asarray(ids, np.int32))
    got = se._splice_retries(np.asarray(ids, np.int64))
    np.testing.assert_array_equal(got, want)
    assert se._retry_queue == je._retry_queue


def test_fault_vectors_name_enrolled_ids(data_dev):
    se = _engine(data_dev, faults=_nan_all_plan())
    spec = FaultSpec(0, drop=(5, 99), corrupt=((7, "bitflip"),))
    drop, flag, mode = se._fault_vectors(spec, np.array([7, 1, 5, 3]))
    np.testing.assert_array_equal(drop, [0, 0, 1, 0])
    np.testing.assert_array_equal(flag, [1, 0, 0, 0])
    assert mode[0] == fault_lib.MODE_CODES["bitflip"]


def test_faults_none_metrics_are_the_pre_fault_dict(data_dev):
    ref = _engine(data_dev)
    out_ref = ref.run_rounds(torch.Generator().manual_seed(4), 3)
    se = _engine(data_dev, faults=FaultPlan())     # empty == disabled
    assert se.faults is None
    out = se.run_rounds(torch.Generator().manual_seed(4), 3)
    assert set(out) == set(out_ref) == {"train_loss"}
    np.testing.assert_array_equal(out["train_loss"], out_ref["train_loss"])


# ---- the counters against the JAX package ------------------------------------


def _plans(rounds, seed, **kw):
    args = dict(seed=seed, drop_rate=0.2, corrupt_rate=0.2,
                read_error_rate=1.0, **kw)
    return (make_plan(D, rounds, **args), jfaults.make_plan(D, rounds, **args))


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("tier", ["memory", "checkpoint"])
def test_faulted_counters_match_jax(data12, depth, tier):
    """The same plan and the same draws: every counter equal to JAX's,
    the losses and the stored rows at the sampled tolerance."""
    plan, jplan = _plans(4, 5, kill_prefetch_rounds=(2,))
    se, m, je, jm = run_both(data12, "fedp2p", tier=tier, depth=depth,
                             rounds=4, faults=plan, jfaults=jplan,
                             store_read_retries=3)
    for name in FAULT_COUNTERS:
        assert m[name].dtype == np.int64 and m[name].shape == (4,)
        np.testing.assert_array_equal(m[name], jm[name], err_msg=name)
    assert m["dropped"].sum() > 0 and m["rejected_rows"].sum() > 0
    if tier == "checkpoint":
        assert m["retries"].sum() > 0
        assert m["prefetch_fallbacks"].sum() == (depth > 1)
    np.testing.assert_allclose(m["train_loss"], jm["train_loss"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(se.store.last_round, je.store.last_round)
    np.testing.assert_allclose(store_rows(se.store), store_rows(je.store),
                               rtol=RTOL, atol=ATOL)
    assert se._retry_queue == je._retry_queue


def test_faulted_topk_counters_match_jax(data12):
    plan, jplan = _plans(3, 1)
    se, m, je, jm = run_both(data12, "fedavg", codec="topk",
                             tier="checkpoint", rounds=3, faults=plan,
                             jfaults=jplan)
    for name in FAULT_COUNTERS:
        np.testing.assert_array_equal(m[name], jm[name], err_msg=name)
    ids = np.arange(se.store.num_enrolled)
    np.testing.assert_allclose(
        np.asarray(se.store.gather_residual(ids)),
        np.asarray(je.store.gather_residual(ids)), rtol=RTOL, atol=ATOL)


def test_faulted_metrics_carry_counters(data_dev):
    plan = make_plan(D, 4, seed=1, drop_rate=0.3, corrupt_rate=0.3,
                     read_error_rate=1.0)
    se = _engine(data_dev, faults=plan, tier="checkpoint",
                 fl=_fl(store_read_retries=3))
    out = se.run_rounds(torch.Generator().manual_seed(2), 4)
    for name in FAULT_COUNTERS:
        assert out[name].shape == (4,) and out[name].dtype == np.int64
    assert out["dropped"].sum() > 0
    assert out["rejected_rows"].sum() > 0
    assert out["retries"].sum() > 0
    assert np.all(np.isfinite(_rows(se)))


# ---- depth and tier invariance under faults --------------------------------


def _chaos_plan(rounds=6):
    return make_plan(D, rounds, seed=5, drop_rate=0.2, corrupt_rate=0.2,
                     read_error_rate=1.0, kill_prefetch_rounds=(2,))


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("tier", ["memory", "checkpoint"])
def test_faulted_pipeline_matches_serial(data_dev, depth, tier):
    """Losses, dropped, rejected rows, store bytes and staleness are the
    same at every depth on both tiers. ``retries`` and
    ``prefetch_fallbacks`` count I/O events and may differ with depth on
    the cold tier (a prefetch may read a row cold that a serial gather
    finds in the overlay); the resident tier has neither."""
    fl = _fl(store_read_retries=3)
    ref = _engine(data_dev, faults=_chaos_plan(), tier=tier, fl=fl)
    out_ref = ref.run_rounds(torch.Generator().manual_seed(6), 6)
    se = _engine(data_dev, faults=_chaos_plan(), depth=depth, tier=tier,
                 fl=fl)
    out = se.run_rounds(torch.Generator().manual_seed(6), 6)
    for name in ("train_loss", "dropped", "rejected_rows"):
        np.testing.assert_array_equal(out[name], out_ref[name], err_msg=name)
    np.testing.assert_array_equal(_rows(se), _rows(ref))
    np.testing.assert_array_equal(se.store.last_round, ref.store.last_round)
    assert out_ref["prefetch_fallbacks"].sum() == 0
    assert out["prefetch_fallbacks"].sum() == (tier == "checkpoint")
    if tier == "memory":
        assert out["retries"].sum() == out_ref["retries"].sum() == 0


def test_worker_kill_falls_back_to_sync_gather(data_dev):
    plan = FaultPlan(specs=(FaultSpec(1, kill_prefetch=True),))
    se = _engine(data_dev, faults=plan, depth=2, tier="checkpoint")
    out = se.run_rounds(torch.Generator().manual_seed(7), 4)
    assert out["prefetch_fallbacks"].tolist() == [0, 1, 0, 0]
    assert se._injector.counters["worker_deaths"] == 1
    assert np.all(np.isfinite(out["train_loss"]))
    se.store.close()


def test_stuck_worker_times_out_into_sync_gather(data_dev):
    """A stalled (not dead) prefetch worker: ``prefetch_timeout`` bounds
    the wait and the round proceeds through the synchronous gather."""
    plan = FaultPlan(specs=(FaultSpec(1, prefetch_delay=1.5),))
    se = _engine(data_dev, faults=plan, depth=2, tier="checkpoint",
                 fl=_fl(prefetch_timeout=0.05))
    assert se.prefetch_timeout == 0.05
    out = se.run_rounds(torch.Generator().manual_seed(7), 4)
    assert out["prefetch_fallbacks"].sum() >= 1
    assert se._injector.counters["delays"] == 1
    assert np.all(np.isfinite(out["train_loss"]))
    se.store.close()


def test_faulted_stateful_codec_round(data_dev):
    """A rejected row reverts its codec residual alongside its params."""
    se = _engine(data_dev, faults=_nan_all_plan(), codec="topk")
    every = np.arange(D)
    res_before = se.store.gather_residual(every).clone()
    se.round(torch.Generator().manual_seed(8), 0)
    assert torch.equal(se.store.gather_residual(every), res_before)
    assert np.all(np.isfinite(_rows(se)))


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("tier", ["memory", "checkpoint"])
def test_all_stragglers_whole_run_survives(data_dev, depth, tier):
    """``straggler_rate=1.0``: no update survives any mix — the run ends
    with finite losses and the store keeps its enrollment bytes."""
    se = _engine(data_dev, depth=depth, tier=tier,
                 fl=_fl(straggler_rate=1.0))
    before = _rows(se).copy()
    out = se.run_rounds(torch.Generator().manual_seed(9), 3)
    assert np.all(np.isfinite(out["train_loss"]))
    np.testing.assert_array_equal(_rows(se), before)

