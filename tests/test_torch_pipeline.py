"""Pipelined ``SampledEngine`` rounds and the store's prefetch API (the
port's counterpart of ``tests/test_pipeline.py``).

``run_rounds`` at ``pipeline_depth`` 2 and 3 equals the depth-1 serial
loop bit for bit — store rows, the residual tier, losses and staleness —
on both store tiers, under natural id overlaps between rounds, under
forced full-window collisions (every round draws the same window, so
every row of every in-flight round rides the patch path) and with the
stateful ``topk`` wire's residuals; also with the interpreter switching
threads every microsecond. Plus: the cold tier's fetch thread and its
ordering (a prefetch queued behind a scatter reads the new rows), and the
``resident_flat`` / ``consensus`` readout. Runs on the CPU, where the
engine's streams are absent; the card's stream and pinned-buffer paths
are held to the same results by ``tests/test_torch_cuda.py``.
"""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import FLConfig
from repro_torch.configs.paper_models import LOGREG_SYN
from repro_torch.core.simulator import Simulator
from repro_torch.data.federated import pack_clients
from repro_torch.data.synthetic import syncov
from repro_torch.kernels import ops
from repro_torch.protocols import (
    CheckpointStore, ClientStateStore, MemoryStore, PrefetchHandle, get,
)
from repro_torch.protocols.engine import SampledEngine

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


def _engine(data_dev, depth, *, algo="gossip", codec=None, tier="auto"):
    se = SampledEngine(LOGREG_SYN, data_dev, _fl(), get(algo), codec=codec,
                       pipeline_depth=depth, device="cpu")
    se.init_store(se.init_params(0), tier=tier)
    return se


def _state(se):
    """Everything the store owns, as host arrays, for bit comparison."""
    st = se.store
    out = {"last_round": st.last_round.copy()}
    if isinstance(st, MemoryStore):
        out["flat"] = st.flat.numpy().copy()
        if st._residual is not None:
            out["residual"] = st._residual.numpy().copy()
    else:
        out["overlay"] = {c: r.copy() for c, r in st._overlay.items()}
        out["res_overlay"] = {c: r.copy()
                              for c, r in st._residual_overlay.items()}
    return out


def _assert_state_equal(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v)
            for c in v:
                np.testing.assert_array_equal(got[k][c], v[c])
        else:
            np.testing.assert_array_equal(got[k], v)


def _collide(se, rounds, seed):
    """``rounds`` draws of ``se`` whose windows are all ids 2..K+1."""
    gen = torch.Generator().manual_seed(seed)
    fixed = torch.arange(K, dtype=torch.int64) + 2
    return [dataclasses.replace(se.draw_round(gen), sel=fixed)
            for _ in range(rounds)]


# ---- depth semantics --------------------------------------------------------


def test_pipeline_depth_validation(data_dev):
    with pytest.raises(ValueError, match="pipeline_depth"):
        SampledEngine(LOGREG_SYN, data_dev, _fl(), get("fedavg"),
                      pipeline_depth=0, device="cpu")
    se = _engine(data_dev, 1)
    with pytest.raises(ValueError, match="pipeline_depth"):
        se.run_rounds(torch.Generator(), 1, pipeline_depth=-2)
    with pytest.raises(ValueError, match="generator or explicit draws"):
        se.run_rounds(None, 1)
    with pytest.raises(ValueError, match="1 RoundDraws for T=2"):
        se.run_rounds(None, 2, draws=_collide(se, 1, 0))
    assert se.run_rounds(torch.Generator(), 0)["train_loss"].shape == (0,)


def test_depth1_is_the_serial_round_loop(data_dev):
    ref = _engine(data_dev, 1)
    gen = torch.Generator().manual_seed(3)
    losses = [ref.round(gen, round_index=t) for t in range(4)]
    se = _engine(data_dev, 1)
    out = se.run_rounds(torch.Generator().manual_seed(3), 4)
    np.testing.assert_array_equal(out["train_loss"],
                                  torch.stack(losses).numpy())
    _assert_state_equal(_state(se), _state(ref))


# ---- pipelined == serial, bit for bit -----------------------------------------


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("tier", ["memory", "checkpoint"])
def test_pipelined_bit_exact_under_natural_overlap(data_dev, depth, tier):
    """K = 8 of D = 24 over 6 rounds: consecutive windows overlap (asserted,
    not assumed) and the pipelined store still matches serial exactly."""
    ref = _engine(data_dev, 1, tier=tier)
    out_ref = ref.run_rounds(torch.Generator().manual_seed(5), 6)
    gen = torch.Generator().manual_seed(5)
    ids = [ref.draw_round(gen).sel.numpy() for _ in range(6)]
    assert sum(len(np.intersect1d(ids[t], ids[t + 1])) for t in range(5))
    se = _engine(data_dev, depth, tier=tier)
    out = se.run_rounds(torch.Generator().manual_seed(5), 6)
    np.testing.assert_array_equal(out["train_loss"], out_ref["train_loss"])
    _assert_state_equal(_state(se), _state(ref))


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("tier", ["memory", "checkpoint"])
def test_pipelined_bit_exact_adversarial_full_collision(data_dev, depth,
                                                        tier):
    """Every round draws the SAME window: every row of every in-flight
    round conflicts and comes from the patch path."""
    ref = _engine(data_dev, 1, tier=tier)
    out_ref = ref.run_rounds(None, 5, draws=_collide(ref, 5, 9))
    se = _engine(data_dev, depth, tier=tier)
    out = se.run_rounds(None, 5, draws=_collide(se, 5, 9))
    np.testing.assert_array_equal(out["train_loss"], out_ref["train_loss"])
    _assert_state_equal(_state(se), _state(ref))
    assert sorted(np.flatnonzero(se.store.last_round >= 0)) == list(
        range(2, K + 2))


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("tier", ["memory", "checkpoint"])
def test_pipelined_topk_residual_bit_exact(data_dev, depth, tier):
    """The stateful ``topk`` wire's residual tier rides the same prefetch
    and patch discipline, collisions forced."""
    ref = _engine(data_dev, 1, algo="fedavg", codec="topk", tier=tier)
    out_ref = ref.run_rounds(None, 5, draws=_collide(ref, 5, 7))
    se = _engine(data_dev, depth, algo="fedavg", codec="topk", tier=tier)
    out = se.run_rounds(None, 5, draws=_collide(se, 5, 7))
    np.testing.assert_array_equal(out["train_loss"], out_ref["train_loss"])
    state = _state(se)
    _assert_state_equal(state, _state(ref))
    res = state.get("residual", state.get("res_overlay"))
    assert (np.abs(res).sum() if isinstance(res, np.ndarray)
            else sum(np.abs(r).sum() for r in res.values())) > 0


def test_pipelined_cold_tier_under_fast_thread_switching(data_dev):
    """The fetch thread and the scatters share the overlay: with the
    interpreter switching threads every microsecond, 8 pipelined rounds
    at depth 3 (half of them colliding in full) still equal serial."""
    ref = _engine(data_dev, 1, tier="checkpoint")
    gen = torch.Generator().manual_seed(2)
    draws = [ref.draw_round(gen) for _ in range(4)] + _collide(ref, 4, 2)
    out_ref = ref.run_rounds(None, 8, draws=draws)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        se = _engine(data_dev, 3, tier="checkpoint")
        out = se.run_rounds(None, 8, draws=draws)
    finally:
        sys.setswitchinterval(old)
    np.testing.assert_array_equal(out["train_loss"], out_ref["train_loss"])
    _assert_state_equal(_state(se), _state(ref))
    se.store.close()


# ---- the store's prefetch API ----------------------------------------------


def test_memory_prefetch_is_eager_and_reusable(data_dev):
    se = _engine(data_dev, 1, tier="memory")
    ids = np.array([3, 0, 5])
    h = se.store.prefetch(ids)
    assert isinstance(h, PrefetchHandle)
    np.testing.assert_array_equal(h.wait().numpy(),
                                  se.store.gather(ids).numpy())


def test_checkpoint_prefetch_runs_on_background_thread():
    st = CheckpointStore(np.zeros((4,), np.float32), 16)
    seen = {}
    orig = st.gather

    def spy(ids):
        seen["thread"] = threading.current_thread().name
        return orig(ids)

    st.gather = spy
    rows = st.prefetch(np.array([1, 2])).wait()
    assert rows.shape == (2, 4)
    assert seen["thread"].startswith("store-prefetch")
    st.close()


def test_checkpoint_prefetch_after_scatter_reads_post_scatter_rows(tmp_path):
    """A prefetch QUEUED behind the worker when a conflicting scatter lands
    observes the overlay row, not the stale ``load_leaves`` base row: the
    overlay is read per id at fetch time."""
    base = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    path = save_checkpoint(str(tmp_path), 0, {"state": base})
    st = CheckpointStore(path, 16)
    gate = threading.Event()
    blocker = st._fetch_pool().submit(gate.wait, 10.0)   # the one worker
    ids = np.array([2, 7])
    h = st.prefetch(ids)                      # queued behind the gate
    new = np.full((2, 4), -1.0, np.float32)
    st.scatter(ids, new)                      # lands BEFORE the fetch runs
    gate.set()
    assert blocker.result(timeout=10.0)
    np.testing.assert_array_equal(h.result(timeout=10.0).numpy(), new)
    np.testing.assert_array_equal(st.gather(np.array([3])).numpy(),
                                  base[[3]])
    st.close()


def test_checkpoint_write_back_runs_in_order_with_prefetches():
    """The cold tier's write-back goes to the fetch thread behind every job
    submitted before it; a prefetch submitted after it reads its rows
    (and residuals)."""
    st = CheckpointStore(np.zeros((4,), np.float32), 16)
    gate = threading.Event()
    blocker = st._fetch_pool().submit(gate.wait, 10.0)   # the one worker
    rows = np.full((2, 4), 3.0, np.float32)
    w = st.write_back(np.array([2, 7]), torch.from_numpy(rows),
                      np.ones((2, 4), np.float32))
    h = st.prefetch(np.array([7, 1]))
    r = st.prefetch_residual(np.array([2]))
    assert st.num_touched == 0                # all queued behind the gate
    gate.set()
    assert blocker.result(timeout=10.0)
    assert w.result(timeout=10.0) is None
    np.testing.assert_array_equal(h.result(timeout=10.0).numpy(),
                                  [[3.0] * 4, [0.0] * 4])
    np.testing.assert_array_equal(r.result(timeout=10.0).numpy(),
                                  np.ones((1, 4), np.float32))
    st.close()


def test_memory_write_back_scatters_at_once():
    st = MemoryStore(torch.zeros((6, 3)), residual=True)
    h = st.write_back(np.array([4]), torch.ones((1, 3)),
                      torch.full((1, 3), 2.0))
    assert h.result() is None
    assert float(st.flat[4].sum()) == 3.0
    assert float(st.gather_residual(np.array([4])).sum()) == 6.0


def test_checkpoint_scatter_takes_tensors():
    st = CheckpointStore(np.zeros((3,), np.float32), 8)
    st.scatter(np.array([0, 4]), torch.full((2, 3), 2.5))
    np.testing.assert_array_equal(st.gather(np.array([4])).numpy(),
                                  np.full((1, 3), 2.5, np.float32))


# ---- the readout contract ----------------------------------------------------


def test_resident_flat_contract(data_dev):
    mem = _engine(data_dev, 1, tier="memory").store
    assert mem.resident_flat() is mem.flat
    assert CheckpointStore(np.zeros((4,), np.float32),
                           16).resident_flat() is None
    assert ClientStateStore(4, 2).resident_flat() is None


def test_init_store_adopts_a_store_of_the_model_width(data_dev):
    se = SampledEngine(LOGREG_SYN, data_dev, _fl(), get("fedavg"),
                       device="cpu")
    params = se.init_params(0)
    width = sum(v.numel() for v in params.values())
    own = CheckpointStore(np.zeros((width,), np.float32), D)
    assert se.init_store(params, store=own) is own
    se.round(torch.Generator().manual_seed(0), 0)
    assert own.num_touched == K
    with pytest.raises(ValueError, match="does not match the packed"):
        se.init_store(params, store=CheckpointStore(
            np.zeros((width + 1,), np.float32), D))


def test_global_params_dispatches_on_resident_flat(data_dev):
    """Cold tier: ``global_params`` goes through ``consensus()``."""
    se = _engine(data_dev, 1, tier="checkpoint")
    se.round(torch.Generator().manual_seed(0), 0)
    got = ops.pack_tree({k: v[None] for k, v in
                         se.global_params().items()})[0][0]
    np.testing.assert_array_equal(got.numpy(), se.store.consensus())
    mem = _engine(data_dev, 1, tier="memory")
    mem.round(torch.Generator().manual_seed(0), 0)
    got = ops.pack_tree({k: v[None] for k, v in
                         mem.global_params().items()})[0][0]
    np.testing.assert_allclose(got.numpy(), se.store.consensus(), rtol=1e-5,
                               atol=1e-7)
