"""The port's client-state stores (``repro_torch.protocols.store``) against
the JAX package's (``repro.protocols.store``) on the same numpy rows: both
tiers' gather / scatter round trips, the residual tier, ``consensus``, id
validation, staleness, ``make_store``'s tiers by footprint, the fetch
worker's error and ``close()`` lifecycle, and partial-row reads of an npz
state file that the JAX package wrote. Gathers and scatters move rows
without arithmetic, so they are held bit for bit; ``consensus`` sums in
float64 in both (cold tier) or in f32 in other orders (memory tier, rtol
1e-6).
"""
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.protocols import store as jstore  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.protocols import (  # noqa: E402
    CheckpointStore, ClientStateStore, MemoryStore, make_store,
)
from repro_torch.protocols.store import (  # noqa: E402
    _LIVE_FETCH_POOLS, MEMORY_TIER_MAX_BYTES, PrefetchHandle,
)

D, W, K = 32, 7, 5


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


def _rows(seed=0, shape=(D, W)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ids():
    return np.array([4, 0, 31, 9, 4], np.int32)   # unordered + repeated


def _both(tier, base=None):
    """(the port's store, the JAX package's store) of one tier over the
    same rows (memory) or the same base row (checkpoint)."""
    if tier == "memory":
        return (MemoryStore(torch.from_numpy(_rows()), residual=True),
                jstore.MemoryStore(jnp.asarray(_rows()), residual=True))
    base = np.arange(W, dtype=np.float32) if base is None else base
    return CheckpointStore(base, D), jstore.CheckpointStore(base, D)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---- both tiers against the JAX package ------------------------------------


@pytest.mark.parametrize("tier", ["memory", "checkpoint"])
def test_gather_scatter_sequence_matches_jax(tier):
    """The same gathers and scatters (distinct ids, repeated ids across
    calls, unordered) give the same rows, residuals and staleness."""
    st, js = _both(tier)
    rng = np.random.default_rng(1)
    for t in range(4):
        ids = rng.choice(D, size=K, replace=False)
        _eq(st.gather(ids), js.gather(ids))
        _eq(st.gather_residual(ids), js.gather_residual(ids))
        new = _rows(10 + t, (K, W))
        res = _rows(20 + t, (K, W))
        st.scatter(ids, torch.from_numpy(new))
        js.scatter(ids, jnp.asarray(new))
        st.scatter_residual(ids, res)
        js.scatter_residual(ids, res)
        st.touch(ids, t)
        js.touch(ids, t)
    every = np.arange(D)
    _eq(st.gather(every), js.gather(every))
    _eq(st.gather_residual(every), js.gather_residual(every))
    _eq(st.staleness(5), js.staleness(5))
    np.testing.assert_allclose(st.consensus(), js.consensus(), rtol=1e-6)


def test_memory_gather_scatter_roundtrip():
    store = MemoryStore(torch.from_numpy(_rows()))
    ids = _ids()
    win = store.gather(ids)
    _eq(win, _rows()[ids])
    store.scatter(ids, win + 1.0)
    _eq(store.gather(ids[:4]), (win + 1.0)[:4])
    untouched = np.setdiff1d(np.arange(D), ids)
    _eq(store.flat[untouched], _rows()[untouched])


def test_memory_scatter_is_in_place():
    """The resident scatter writes into the state buffer itself
    (``index_copy_``), never into a copy of [D, width]."""
    store = MemoryStore(torch.from_numpy(_rows()))
    ptr = store.flat.data_ptr()
    store.scatter(np.array([3, 1]), torch.ones((2, W)))
    assert store.flat.data_ptr() == ptr
    _eq(store.flat[[3, 1]], np.ones((2, W), np.float32))


def test_memory_requires_packed_2d():
    with pytest.raises(ValueError, match=r"packed \[D, sum\(sizes\)\]"):
        MemoryStore(torch.zeros((D,)))


def test_memory_residual_gated():
    store = MemoryStore(torch.from_numpy(_rows()))
    with pytest.raises(ValueError, match="without residual=True"):
        store.gather_residual(_ids())
    with pytest.raises(ValueError, match="without residual=True"):
        store.scatter_residual(_ids(), np.zeros((K, W), np.float32))
    store = MemoryStore(torch.from_numpy(_rows()), residual=True)
    _eq(store.gather_residual(_ids()), np.zeros((K, W), np.float32))
    store.scatter_residual(_ids()[:2], np.ones((2, W), np.float32))
    assert float(store.gather_residual(np.array([4]))[0, 0]) == 1.0


@pytest.mark.parametrize("ids,err", [
    (np.array([0, D]), IndexError),           # out of range
    (np.array([-1]), IndexError),
    (np.array([[0, 1]]), ValueError),         # not 1-D
])
@pytest.mark.parametrize("tier", ["memory", "checkpoint"])
def test_store_id_validation_matches_jax(tier, ids, err):
    st, js = _both(tier)
    with pytest.raises(err) as want:
        js.gather(ids)
    with pytest.raises(err) as got:
        st.gather(ids)
    assert str(got.value) == str(want.value)
    with pytest.raises(err):
        st.touch(ids, 0)


def test_checkpoint_overlay_gather_scatter():
    base = np.arange(W, dtype=np.float32)
    store = CheckpointStore(base, D)
    ids = _ids()
    _eq(store.gather(ids), np.broadcast_to(base, (K, W)))
    rows = _rows(1, (K, W))
    store.scatter(ids, rows)
    assert store.num_touched == 4                  # id 4 written twice
    got = np.asarray(store.gather(ids))
    _eq(got[0], rows[4])                           # the LAST write wins
    _eq(got[1:4], rows[1:4])
    _eq(store.gather(np.array([7])), base[None])


def test_checkpoint_consensus_matches_jax():
    base = np.ones((W,), np.float32)
    st, js = _both("checkpoint", base)
    for s in (st, js):
        s.scatter(np.array([0, 1]), np.full((2, W), 3.0, np.float32))
    want = (2 * 3.0 + (D - 2) * 1.0) / D
    np.testing.assert_allclose(st.consensus(), np.full((W,), want),
                               rtol=1e-6)
    _eq(st.consensus(), js.consensus())
    assert st.consensus().dtype == np.float32


def test_checkpoint_scatter_shape_mismatch():
    store = CheckpointStore(np.zeros((W,), np.float32), D)
    with pytest.raises(ValueError, match="does not match"):
        store.scatter(np.array([0, 1]), np.zeros((2, W + 1)))


def test_checkpoint_rejects_non_row_base():
    with pytest.raises(ValueError, match=r"\[sum\(sizes\)\] row"):
        CheckpointStore(np.zeros((2, W), np.float32), D)


def test_checkpoint_base_from_a_tensor_on_its_device():
    store = CheckpointStore(torch.arange(W, dtype=torch.float32), D)
    win = store.gather(np.array([2, 3]))
    assert isinstance(win, torch.Tensor) and win.device.type == "cpu"
    _eq(win, np.broadcast_to(np.arange(W, dtype=np.float32), (2, W)))


def test_checkpoint_npz_written_by_jax_reads_partial_rows(tmp_path):
    """A state file the JAX package's ``CheckpointStore.save`` wrote: the
    port's path-backed store reads the rows it asks for
    (``load_leaves``) and equals the JAX store over that file."""
    base = np.arange(W, dtype=np.float32)
    js = jstore.CheckpointStore(base, D)
    rows = _rows(3, (2, W))
    js.scatter(np.array([3, 8]), rows)
    path = js.save(str(tmp_path), 0)
    cold = CheckpointStore(path, D)
    jcold = jstore.CheckpointStore(path, D)
    assert cold.width == W and cold.dtype == np.float32
    ids = np.array([3, 7, 8, 31])
    _eq(cold.gather(ids), jcold.gather(ids))
    _eq(cold.gather(ids)[[0, 2]], rows)
    with pytest.raises(NotImplementedError, match="full +pass"):
        cold.consensus()


def test_checkpoint_save_round_trips_through_jax(tmp_path):
    st = CheckpointStore(np.arange(W, dtype=np.float32), D)
    st.scatter(np.array([5]), np.full((1, W), 2.0, np.float32))
    path = st.save(str(tmp_path), 1)
    _eq(jstore.CheckpointStore(path, D).gather(np.arange(D)),
        st.gather(np.arange(D)))


def test_checkpoint_residual_defaults_zero():
    store = CheckpointStore(np.zeros((W,), np.float32), D)
    ids = _ids()
    _eq(store.gather_residual(ids), np.zeros((K, W), np.float32))
    store.scatter_residual(ids[:1], np.ones((1, W)))
    assert float(store.gather_residual(ids[:1]).sum()) == W


# ---- staleness --------------------------------------------------------------


def test_staleness_counters():
    store = MemoryStore(torch.from_numpy(_rows()))
    _eq(store.staleness(0), np.ones(D, np.int32))
    store.touch(np.array([1, 2]), 0)
    store.touch(np.array([2]), 3)
    s = store.staleness(4)
    assert s[1] == 4 and s[2] == 1 and s[0] == 5
    assert s.dtype == np.int32


def test_base_contract():
    base = ClientStateStore(4, 2)
    assert base.resident_flat() is None
    with pytest.raises(NotImplementedError):
        base.consensus()
    with pytest.raises(ValueError, match="num_enrolled must be positive"):
        ClientStateStore(0, 2)


# ---- make_store tiering ----------------------------------------------------


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("over", [False, True])
def test_make_store_tiers_match_jax(over, residual):
    """Small D stays resident; one client over the line (the residual's
    f32 bytes count towards it) goes cold, in both packages."""
    per = W * (8 if residual else 4)
    d = MEMORY_TIER_MAX_BYTES // per + 1 if over else D
    row = np.zeros((W,), np.float32)
    st = make_store(torch.from_numpy(row), d, residual=residual)
    js = jstore.make_store(jnp.asarray(row), d, residual=residual)
    assert type(st).__name__ == type(js).__name__
    assert isinstance(st, CheckpointStore if over else MemoryStore)
    assert st.num_enrolled == d
    assert MEMORY_TIER_MAX_BYTES == jstore.MEMORY_TIER_MAX_BYTES


def test_make_store_forced_tiers_and_errors():
    row = torch.zeros((W,))
    assert isinstance(make_store(row, D, tier="checkpoint"), CheckpointStore)
    mem = make_store(row, D, tier="memory")
    assert isinstance(mem, MemoryStore) and mem.flat.is_contiguous()
    with pytest.raises(ValueError, match="unknown store tier"):
        make_store(row, D, tier="cold")
    with pytest.raises(ValueError, match="base_row"):
        make_store(torch.zeros((2, W)), D)


def test_memory_tier_line_at_full_cnn_width():
    """At CNN-FEMNIST's width (246,590 f32) ``tier="auto"`` goes cold
    above 2,177 clients."""
    row = torch.zeros((1,))
    width = 246_590
    assert MEMORY_TIER_MAX_BYTES // (width * 4) == 2177
    small = make_store(row.expand(width), 2, tier="auto")
    assert isinstance(small, MemoryStore)
    big = make_store(row.expand(width), 2178, tier="auto")
    assert isinstance(big, CheckpointStore) and big.num_enrolled == 2178


# ---- prefetch and the fetch worker's lifecycle ------------------------------


def _poll(pred, timeout=5.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_memory_prefetch_is_eager_and_reusable():
    store = MemoryStore(torch.from_numpy(_rows()))
    ids = np.array([3, 0, 5])
    h = store.prefetch(ids)
    assert isinstance(h, PrefetchHandle)
    _eq(h.wait(), store.gather(ids))
    assert h.result() is h.wait()


def test_worker_error_collected_via_result_is_not_rethrown():
    st = CheckpointStore(np.zeros((W,), np.float32), D)

    def boom(ids):
        raise ValueError("fetch exploded")

    st.gather = boom
    h = st.prefetch(np.array([1]))
    with pytest.raises(ValueError, match="fetch exploded"):
        h.result()
    del st.gather
    _eq(st.prefetch(np.array([2])).result(), np.zeros((1, W), np.float32))
    st.close()


def test_worker_error_collected_before_its_callback_is_not_rethrown():
    """``result()`` can return before the worker thread runs the future's
    done-callback (the future wakes its waiters first): the error it
    raised to the caller is not kept for a rethrow at the next use."""
    st = CheckpointStore(np.zeros((W,), np.float32), D)
    err = ValueError("collected first")
    st._consume_worker_error(err)          # result() saw it first
    fut = Future()
    fut.set_exception(err)
    st._on_fetch_done(fut)                 # then the callback ran
    assert st.prefetch(np.array([2])).result().shape == (1, W)
    st.close()


def test_uncollected_worker_error_rethrows_on_next_use():
    st = CheckpointStore(np.zeros((W,), np.float32), D)

    def boom(ids):
        raise ValueError("lost in the worker")

    st.gather = boom
    st.prefetch(np.array([0]))                    # handle dropped
    assert _poll(lambda: st._worker_error is not None)
    del st.gather
    with pytest.raises(RuntimeError, match="never collected"):
        st.prefetch(np.array([1]))
    assert st.prefetch(np.array([1])).result().shape == (1, W)
    st.close()


def test_close_is_idempotent_and_pool_restarts_lazily():
    st = CheckpointStore(np.zeros((W,), np.float32), D)
    st.prefetch(np.array([0])).result()
    pool = st._executor
    assert pool in _LIVE_FETCH_POOLS
    st.close()
    assert st._executor is None and pool not in _LIVE_FETCH_POOLS
    st.close()
    _eq(st.prefetch(np.array([3])).result(), np.zeros((1, W), np.float32))
    assert st._executor is not None
    st.close()


def test_prefetch_validates_ids_on_the_caller():
    st = CheckpointStore(np.zeros((W,), np.float32), D)
    with pytest.raises(IndexError, match="out of range"):
        st.prefetch(np.array([D]))
    assert st._executor is None                   # nothing was submitted


def test_gather_rows_seams_match_jax_errors():
    from repro.kernels import ops as jops
    flat = torch.zeros((4, 3))
    cases = [
        (lambda m, f: m.gather_rows(f(np.zeros((4,), np.float32)), [0]),
         "pack_tree"),
        (lambda m, f: m.gather_rows(f(np.zeros((4, 3), np.float32)),
                                    np.array([[0]])), "1-D"),
        (lambda m, f: m.scatter_rows(f(np.zeros((4, 3), np.float32)),
                                     np.array([0]),
                                     f(np.zeros((1, 2), np.float32))),
         "TreeSpec"),
        (lambda m, f: m.scatter_rows(f(np.zeros((4, 3), np.float32)),
                                     np.array([0, 1]),
                                     f(np.zeros((1, 3), np.float32))),
         "ids"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match):
            call(jops, jnp.asarray)
        with pytest.raises(ValueError, match=match):
            call(ops, torch.from_numpy)
    out = ops.scatter_rows(flat, np.array([2]), torch.ones((1, 3)))
    _eq(out[2], np.ones(3))
    _eq(flat, np.zeros((4, 3)))                   # not modified
    _eq(ops.gather_rows(out, np.array([2, 0])), np.asarray(out)[[2, 0]])


def test_dev_seams_validate_and_scatter_in_place():
    flat = torch.arange(12.0).reshape(4, 3)
    with pytest.raises(ValueError, match="packed"):
        ops.gather_rows_dev(torch.zeros((4,)), [0])
    with pytest.raises(ValueError, match="1-D"):
        ops.gather_rows_dev(flat, np.array([[0]]))
    with pytest.raises(ValueError, match="width"):
        ops.scatter_rows_dev(flat, [0], torch.zeros((1, 2)))
    with pytest.raises(ValueError, match="ids"):
        ops.scatter_rows_dev(flat, [0, 1], torch.zeros((1, 3)))
    _eq(ops.gather_rows_dev(flat, np.array([2, 0])),
        np.arange(12.0, dtype=np.float32).reshape(4, 3)[[2, 0]])
    out = ops.scatter_rows_dev(flat, np.array([1]), torch.ones((1, 3)))
    assert out is flat
    _eq(flat[1], np.ones(3))
    _eq(flat[0], [0.0, 1.0, 2.0])
