"""The port's fault layer against the JAX package's:

* ``make_plan`` / ``FaultPlan.dense_arrays`` / ``for_round`` / ``active``:
  the same seed gives the same plan and the same arrays, bit for bit;
* ``corrupt_flat`` (nan, inf, bitflip), ``guard_flat`` and
  ``corrupt_rows_np``: bit for bit (int32 views compared: NaN payloads
  included);
* ``FaultInjector``: the read-error budget and the prefetch kill fire once
  each;
* faulted ``DenseEngine`` runs against ``repro.core.simulator.Simulator``
  with a fault plan: fedavg, fedp2p and gossip x codec none and topk x
  mix_path auto and dense, a T=3 run with the draws made from the JAX key
  tree. The counters (``dropped``, ``rejected_rows``, ``retries``,
  ``prefetch_fallbacks``) are equal; train_loss and the accuracies at
  rtol 1e-4 / atol 1e-5, the codec-free tolerance of
  ``test_torch_engine.py`` (the packages sum in other orders over dozens
  of SGD steps); the final carry is finite;
* ``Simulator.run(faults=...)`` fills History's counters as JAX's does,
  and leaves them empty without a plan.
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import faults as jfaults  # noqa: E402
from repro import protocols as jprotocols  # noqa: E402
from repro.config import FLConfig as JFLConfig  # noqa: E402
from repro.configs.paper_models import LOGREG_SYN as J_LOGREG  # noqa: E402
from repro.core.simulator import Simulator as JSimulator  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.configs.paper_models import LOGREG_SYN  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.data.federated import pack_clients  # noqa: E402
from repro_torch.data.synthetic import syncov  # noqa: E402
from test_torch_engine import LOGREG_FL, T, run_draws  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
COUNTERS = ("dropped", "rejected_rows", "retries", "prefetch_fallbacks")


def _spec_fields(spec):
    return (spec.round_index, spec.drop, spec.corrupt, spec.read_errors,
            spec.prefetch_delay, spec.kill_prefetch)


PLAN_KW = [
    dict(seed=0, drop_rate=0.2, corrupt_rate=0.2),
    dict(seed=3, drop_rate=0.5, corrupt_rate=0.4, modes=("bitflip",)),
    dict(seed=7, corrupt_rate=0.3, read_error_rate=0.5,
         prefetch_delay=0.01, prefetch_delay_rate=0.5,
         kill_prefetch_rounds=(1, 4)),
    dict(seed=11),                                   # injects nothing
]


@pytest.mark.parametrize("kw", PLAN_KW)
def test_make_plan_and_dense_arrays_bit_for_bit(kw):
    plan = faults.make_plan(12, 6, **kw)
    jplan = jfaults.make_plan(12, 6, **kw)
    assert plan.seed == jplan.seed
    assert ([_spec_fields(s) for s in plan.specs]
            == [_spec_fields(s) for s in jplan.specs])
    for t in range(7):
        a, b = plan.for_round(t), jplan.for_round(t)
        assert (a is None) == (b is None)
        if a is not None:
            assert _spec_fields(a) == _spec_fields(b)
    for P in (5, 12, 20):
        for got, want in zip(plan.dense_arrays(6, P),
                             jplan.dense_arrays(6, P)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert (faults.active(plan) is None) == (jfaults.active(jplan) is None)
    assert plan == faults.make_plan(12, 6, **kw)
    assert hash(plan) == hash(faults.make_plan(12, 6, **kw))


def test_plan_guards():
    assert faults.active(None) is None
    assert faults.active(faults.FaultPlan()) is None
    with pytest.raises(TypeError, match="FaultPlan or None"):
        faults.active({"drop": 1})
    with pytest.raises(ValueError, match="unknown corrupt mode"):
        faults.FaultSpec(round_index=0, corrupt=((1, "zero"),))
    with pytest.raises(ValueError, match="drop_rate must lie"):
        faults.make_plan(4, 2, drop_rate=1.5)
    assert faults.MODE_CODES == jfaults.plan.MODE_CODES
    assert faults.CORRUPT_MODES == jfaults.CORRUPT_MODES


def _as_bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("flag_rows", [(), (0,), (1, 3), (0, 1, 2, 3, 4)])
def test_corrupt_and_guard_flat_bit_for_bit(flag_rows):
    rng = np.random.default_rng(len(flag_rows))
    x = rng.standard_normal((5, 33)).astype(np.float32)
    x[2, 7] = np.inf                       # a row already non-finite
    old = rng.standard_normal((5, 33)).astype(np.float32)
    flag = np.zeros(5, np.float32)
    mode = np.zeros(5, np.int32)
    for i, r in enumerate(flag_rows):
        flag[r] = 1.0
        mode[r] = i % 3                    # nan, inf, bitflip in turn
    x_in = torch.from_numpy(x.copy())
    got = faults.corrupt_flat(x_in, torch.from_numpy(flag),
                              torch.from_numpy(mode))
    np.testing.assert_array_equal(_as_bits(x_in.numpy()), _as_bits(x))
    want = jfaults.corrupt_flat(jax.numpy.asarray(x), jax.numpy.asarray(flag),
                                jax.numpy.asarray(mode))
    np.testing.assert_array_equal(_as_bits(got.numpy()), _as_bits(want))
    for fl in (None, flag):
        g, gbad = faults.guard_flat(
            got, torch.from_numpy(old),
            None if fl is None else torch.from_numpy(fl))
        w, wbad = jfaults.guard_flat(
            want, jax.numpy.asarray(old),
            None if fl is None else jax.numpy.asarray(fl))
        np.testing.assert_array_equal(_as_bits(g.numpy()), _as_bits(w))
        np.testing.assert_array_equal(gbad.numpy(), np.asarray(wbad))
    corrupt = [(r, faults.CORRUPT_MODES[i % 3])
               for i, r in enumerate(flag_rows)]
    np.testing.assert_array_equal(
        _as_bits(faults.corrupt_rows_np(x, corrupt)),
        _as_bits(jfaults.corrupt_rows_np(x, corrupt)))
    with pytest.raises(TypeError, match="float32"):
        faults.corrupt_flat(torch.from_numpy(x).double(),
                            torch.from_numpy(flag), torch.from_numpy(mode))


def test_bitflip_stays_finite_and_only_the_flag_catches_it():
    x = torch.linspace(-2, 2, 24).reshape(3, 8)
    flag = torch.tensor([0.0, 1.0, 0.0])
    mode = torch.full((3,), faults.MODE_CODES["bitflip"], dtype=torch.int32)
    bad = faults.corrupt_flat(x, flag, mode)
    assert torch.isfinite(bad).all() and not torch.equal(bad[1], x[1])
    assert torch.equal(bad[[0, 2]], x[[0, 2]])
    _, rejected = faults.guard_flat(bad, x)
    assert not rejected.any()
    guarded, rejected = faults.guard_flat(bad, x, flag)
    assert rejected.tolist() == [False, True, False]
    assert torch.equal(guarded, x)


def test_fault_injector_fires_each_fault_once():
    plan = faults.FaultPlan(specs=(
        faults.FaultSpec(round_index=0, read_errors=2),
        faults.FaultSpec(round_index=1, prefetch_delay=0.001,
                         kill_prefetch=True)))
    inj = faults.FaultInjector(plan)
    inj.begin_round(0)
    for _ in range(2):
        with pytest.raises(faults.InjectedReadError):
            inj.on_read()
    inj.on_read()                           # the budget is spent
    inj.on_prefetch()                       # nothing armed in round 0
    inj.begin_round(1)
    with pytest.raises(faults.InjectedWorkerDeath):
        inj.on_prefetch()
    inj.on_prefetch()                       # the kill is consumed
    assert inj.counters == {"read_errors": 2, "delays": 1,
                            "worker_deaths": 1}
    assert issubclass(faults.InjectedReadError, IOError)


@pytest.fixture(scope="module")
def syncov_data():
    return pack_clients(*syncov(num_clients=20, seed=0), 10, seed=0)


# P = 6 (fedp2p: 2 clusters x 3) or 5 (fedavg, gossip); plan ids >= P are
# ignored. Every round drops and corrupts someone; all three modes occur.
PLAN = dict(seed=5, drop_rate=0.25, corrupt_rate=0.3)


@pytest.mark.parametrize("algo", ["fedavg", "fedp2p", "gossip"])
@pytest.mark.parametrize("codec", [None, "topk"])
@pytest.mark.parametrize("mix_path", ["auto", "dense"])
def test_faulted_run_matches_jax(syncov_data, algo, codec, mix_path):
    kw = dict(LOGREG_FL, mix_path=mix_path)
    plan, jplan = (faults.make_plan(6, T, **PLAN),
                   jfaults.make_plan(6, T, **PLAN))
    modes = {m for s in plan.specs for _, m in s.corrupt}
    assert modes == set(faults.CORRUPT_MODES)
    jsim = JSimulator(J_LOGREG, syncov_data, JFLConfig(**kw), faults=jplan)
    hist = jsim.run(rounds=T, algorithm=algo, seed=0, codec=codec)
    sim = Simulator(LOGREG_SYN, syncov_data, FLConfig(**kw), faults=plan,
                    device="cpu")
    engine = sim.engine(algo, codec=codec)
    assert engine.faults is plan
    draws = run_draws(jprotocols.get(algo), JFLConfig(**kw), 0, T,
                      syncov_data.y.shape[1])
    params = params_from_jax(jax.tree.map(np.asarray, jsim.init_params(0)))
    final, m = engine.run_rounds(params, None, T, draws=draws)
    for name in COUNTERS:
        assert m[name].dtype == torch.int32
        assert m[name].tolist() == getattr(hist, name), name
    assert sum(hist.dropped) > 0 and sum(hist.rejected_rows) > 0
    for name in ("train_loss", "acc", "acc_client_mean"):
        np.testing.assert_allclose(m[name].numpy(), getattr(hist, name),
                                   err_msg=name, **TOL)
    assert all(torch.isfinite(v).all() for v in final.values())


def test_simulator_history_counters(syncov_data):
    """``Simulator.run(faults=...)`` on the port's own generator: the
    counters follow the plan (the dropped clients each round; rejected
    rows at least the flagged ones that were not dropped), as JAX's do;
    without a plan History's counters stay empty, and the engine cache
    keeps the plan in its key."""
    fl = FLConfig(**LOGREG_FL)
    plan = faults.make_plan(6, 4, **PLAN)
    sim = Simulator(LOGREG_SYN, syncov_data, fl, faults=plan, device="cpu")
    h = sim.run(rounds=4, algorithm="fedp2p", seed=1)
    drop, flag, _ = plan.dense_arrays(4, 6)
    assert h.dropped == drop.sum(axis=1).astype(int).tolist()
    assert h.retries == [0] * 4 and h.prefetch_fallbacks == [0] * 4
    assert all(r >= int(f.sum()) for r, f in zip(h.rejected_rows, flag))
    assert all(math.isfinite(v) for v in h.train_loss + h.acc)
    jsim = JSimulator(J_LOGREG, syncov_data, JFLConfig(**LOGREG_FL),
                      faults=jfaults.make_plan(6, 4, **PLAN))
    jh = jsim.run(rounds=4, algorithm="fedp2p", seed=1)
    assert h.dropped == jh.dropped
    clean = Simulator(LOGREG_SYN, syncov_data, fl, device="cpu")
    hc = clean.run(rounds=2, algorithm="fedp2p", seed=1)
    assert (hc.dropped, hc.rejected_rows, hc.retries,
            hc.prefetch_fallbacks) == ([], [], [], [])
    assert clean.faults is None
    assert Simulator(LOGREG_SYN, syncov_data, fl, faults=faults.FaultPlan(),
                     device="cpu").faults is None
    assert all(k[3] is plan for k in sim._engines)


def test_faults_none_runs_the_fault_free_program(syncov_data):
    """``faults=None`` and an empty plan give the fault-free run exactly,
    and a plan whose rounds lie past the run changes nothing but adds the
    (zero) counters."""
    fl = FLConfig(**LOGREG_FL)
    base = Simulator(LOGREG_SYN, syncov_data, fl, device="cpu").run(
        rounds=2, algorithm="fedp2p", seed=2)
    empty = Simulator(LOGREG_SYN, syncov_data, fl, faults=faults.FaultPlan(),
                      device="cpu").run(rounds=2, algorithm="fedp2p", seed=2)
    late = faults.FaultPlan(specs=(faults.FaultSpec(round_index=5,
                                                    drop=(0,)),))
    later = Simulator(LOGREG_SYN, syncov_data, fl, faults=late,
                      device="cpu").run(rounds=2, algorithm="fedp2p", seed=2)
    assert base.train_loss == empty.train_loss == later.train_loss
    assert base.acc == empty.acc == later.acc
    assert later.dropped == [0, 0] and later.rejected_rows == [0, 0]
