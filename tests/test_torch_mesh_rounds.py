"""The port's ``MeshEngine`` and its mesh on ``torch.distributed``, without
JAX (the rank workers of the multi-process tests live here too, so the
spawned ranks import no JAX):

* ``run_rounds`` against driving ``round_fn`` (``core.fedp2p
  .make_federated_round``'s) round by round with the same draws, exactly (T 5, sync_period 2: sync at t = 1, 3 and none in the
  tail; stragglers; gossip_async's drawn matchings);
* a chunked ``run_rounds`` threads topk's residual: two threaded T/2
  chunks give the T-round run exactly, a dropped residual does not; a
  wrong T raises;
* ``make_mesh`` / ``make_mesh_info`` on a gloo world of one rank: a model
  axis raises, a wrong rank count raises; a ``MeshEngine`` round on that
  world (``psum_mix`` over one rank) against the one-device round at D 1;
* ``run_ranks``: a rank that raises fails the call with its traceback, a
  world that hangs fails at its timeout;
* ``packed_view`` and ``federated_rows`` keep the state one packed buffer.

Each rendezvous is a ``file://`` store under the test's ``tmp_path``, so
parallel test workers never share one.
"""
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.config import FLConfig, MeshConfig
from repro_torch.configs import get_config
from repro_torch.core.fedp2p import (
    broadcast_to_clients, federated_rows, make_federated_round,
)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.mesh import (
    Mesh, make_debug_mesh, make_mesh, run_ranks,
)
from repro_torch.models.model import build_model
from repro_torch.protocols.engine import MeshDraws, MeshEngine
from repro_torch.sharding.rules import make_mesh_info

ARCH = "qwen2-1.5b"
STEPS, B, S = 1, 2, 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its models are tiny,
    and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_model():
    cfg = get_config(ARCH).reduced(num_layers=1, max_d_model=64)
    return build_model(cfg)


def tiny_params():
    return tiny_model().init(0, device="cpu")


def token_batches(shape, seed, vocab):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, vocab, shape, np.int32))
            for k in ("tokens", "labels")}


def to_numpy(tree):
    return [x.detach().cpu().numpy() for x in kernel_ops.tree_flatten(tree)[0]]


def draws_of(case, device="cpu"):
    """A ``MeshDraws`` from a case's numpy fields."""
    def t(a, dtype=None):
        return None if a is None else torch.as_tensor(a, dtype=dtype).to(
            device)
    noise = case.get("noise")
    if isinstance(noise, (list, tuple)):
        noise = tuple(t(u) for u in noise)
    else:
        noise = t(noise)
    return MeshDraws(survive=t(case["survive"], torch.float32),
                     matching=t(case.get("matching"), torch.int64),
                     wire_noise=noise)


# ---------------------------------------------------------------------------
# rank workers (run by run_ranks in spawned processes)
# ---------------------------------------------------------------------------

def mesh_worker(rank, world, payload):
    """One rank of the mesh: for each mix case, ``MeshEngine.mix`` on this
    rank's rows of the payload's f_new / f_old; for each round case,
    ``round_fn`` on its rows of the state and batches. -> the rows as
    numpy, per case (a round's: its rows, its loss and a stateful codec's
    residual rows)."""
    torch.set_num_threads(1)
    device = payload.get("device", "cpu")
    if device != "cpu":
        torch.cuda.set_device(0)
    info = make_mesh_info(None, make_debug_mesh(data=world, model=1))
    fl = FLConfig(**payload["fl"])
    counts = torch.as_tensor(payload["counts"])
    out = {"mix": [], "rounds": []}
    f_new = broadcast_rows(payload["f_new"], info, device)
    f_old = broadcast_rows(payload["f_old"], info, device)
    flat_new, flat_old, spec = kernel_ops.pack_tree_pair(f_new, f_old)
    for case in payload["mix_cases"]:
        eng = MeshEngine(None, fl, world, 1, algorithm=case["algo"],
                         counts=counts, codec=case["codec"],
                         mesh_info=info, device=device)
        got = eng.mix(flat_new, flat_old, spec, draws_of(case, device),
                      do_global_sync=case["sync"])
        out["mix"].append(to_numpy(got[0]))
    if payload.get("round_cases"):
        model = tiny_model()
        params = model.init(0, device=device)
        fp = federated_rows(broadcast_to_clients(params, world), info)
        batch = federated_rows(payload["batch"], info)
        for case in payload["round_cases"]:
            eng = MeshEngine(model, fl, world, STEPS,
                             algorithm=case["algo"], counts=counts,
                             codec=case["codec"], mesh_info=info,
                             device=device)
            res = eng.round_fn(fp, batch, draws_of(case, device),
                               do_global_sync=case["sync"])
            out["rounds"].append((to_numpy(res[0]), float(res[1]),
                                  to_numpy(res[2]) if len(res) > 2
                                  else None))
    return out


def broadcast_rows(tree, info, device):
    """This rank's rows of a numpy [D, ...] tree, packed, on ``device``."""
    leaves, treedef = kernel_ops.tree_flatten(tree)
    full = kernel_ops.tree_unflatten(
        treedef, [torch.as_tensor(x).to(device) for x in leaves])
    flat, spec = kernel_ops.pack_tree(full)
    return federated_rows(kernel_ops.unpack_tree(flat, spec), info)


def failing_worker(rank, world):
    if rank == 1:
        raise RuntimeError("rank one fails on purpose")
    return rank


def hanging_worker(rank, world):
    if rank == 1:
        time.sleep(120)
    return rank


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def _engine(algo, D, codec="none", **fl):
    return MeshEngine(tiny_model(), FLConfig(num_clusters=2, lr=0.05, **fl),
                      D, STEPS, algorithm=algo, codec=codec, device="cpu",
                      counts=torch.arange(1.0, D + 1.0))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(
        kernel_ops.tree_flatten(a)[0], kernel_ops.tree_flatten(b)[0]))


@pytest.mark.parametrize("algo", ["fedp2p", "gossip_async"])
def test_run_rounds_matches_round_fn(algo):
    D, T, sp = 4, 5, 2
    eng = _engine(algo, D, sync_period=sp, straggler_rate=0.4)
    fp0 = broadcast_to_clients(tiny_params(), D)
    bt = token_batches((T, D, STEPS, B, S), 9, 512)
    fp_run, losses = eng.run_rounds(fp0, torch.Generator().manual_seed(5),
                                    T, bt)
    round_fn = make_federated_round(
        tiny_model(), eng.fl, D, STEPS, algorithm=algo,
        counts=torch.arange(1.0, D + 1.0), device="cpu")
    gen, fp, want = torch.Generator().manual_seed(5), fp0, []
    syncs = []
    for t in range(T):
        d = eng.draw_round(gen, fp)
        sync = (t + 1) % sp == 0 and t < (T // sp) * sp
        syncs.append(sync)
        fp, loss = round_fn(fp, {k: v[t] for k, v in bt.items()}, d,
                            do_global_sync=sync, round_index=t)
        want.append(loss)
    assert syncs == [False, True, False, True, False]
    assert torch.equal(losses, torch.stack(want))
    assert _equal(fp_run, fp)


def test_chunked_run_rounds_threads_topk_residual():
    D, T = 4, 4
    eng = _engine("fedp2p", D, codec="topk")
    fp0 = broadcast_to_clients(tiny_params(), D)
    bt = token_batches((T, D, STEPS, B, S), 3, 512)
    half = {k: v[:T // 2] for k, v in bt.items()}
    rest = {k: v[T // 2:] for k, v in bt.items()}
    gen = torch.Generator().manual_seed(1)
    fp_full, loss_full, st_full = eng.run_rounds(fp0, gen, T, bt)
    gen = torch.Generator().manual_seed(1)
    fp1, loss1, st1 = eng.run_rounds(fp0, gen, T // 2, half)
    assert float(st1.abs().max()) > 0.0            # feedback mass captured
    fp_thr, loss2, st_thr = eng.run_rounds(fp1, gen, T - T // 2, rest,
                                           codec_state=st1)
    assert _equal(fp_thr, fp_full) and torch.equal(st_thr, st_full)
    assert torch.equal(torch.cat([loss1, loss2]), loss_full)
    fp_drop, _, _ = eng.run_rounds(fp1, torch.Generator().manual_seed(1),
                                   T - T // 2, rest)
    assert not _equal(fp_drop, fp_full)            # the residual matters
    with pytest.raises(ValueError, match="expected T=5"):
        eng.run_rounds(fp0, gen, 5, bt)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_of_one_rank(world_of_one):
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(MeshConfig(data=2, model=1))
    with pytest.raises(NotImplementedError, match="model=2"):
        make_mesh_info(None, Mesh(shape=(1, 2), axis_names=("data",
                                                             "model")))
    info = make_mesh_info(None, make_debug_mesh(data=1))
    assert (info.rank, info.world_size, info.dp_axes, info.clients) == (
        0, 1, ("data",), (0,))
    model = tiny_model()
    params = model.init(0, device="cpu")
    bt = token_batches((1, STEPS, B, S), 4, 512)
    fl = FLConfig(num_clusters=1, lr=0.05)
    draws = MeshDraws(survive=torch.ones(1))
    for algo in ("fedp2p", "fedavg", "gossip"):
        outs = []
        for mesh_info in (info, None):
            eng = MeshEngine(model, fl, 1, STEPS, algorithm=algo,
                             mesh_info=mesh_info, device="cpu")
            outs.append(eng.round_fn(broadcast_to_clients(params, 1), bt,
                                     draws))
        (fm, lm), (f1, l1) = outs
        assert torch.equal(lm, l1)
        for a, b in zip(to_numpy(fm), to_numpy(f1)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_run_ranks_reports_a_failed_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        run_ranks(failing_worker, 2, init_method=f"file://{tmp_path}/f",
                  timeout=120)


def test_run_ranks_times_out(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        run_ranks(hanging_worker, 2, init_method=f"file://{tmp_path}/h",
                  timeout=4)
    assert time.monotonic() - t0 < 30


def test_packed_view_and_rows():
    fp = broadcast_to_clients(tiny_params(), 4)
    flat, spec = kernel_ops.packed_view(fp)
    f_new, f_old, spec2 = kernel_ops.pack_tree_pair(fp, fp)
    assert f_new.data_ptr() == flat.data_ptr() and spec2 == spec
    leaves = kernel_ops.tree_flatten(fp)[0]
    loose = kernel_ops.tree_unflatten(spec.treedef,
                                      [x.clone() for x in leaves])
    assert kernel_ops.packed_view(loose) is None
    sliced = kernel_ops.tree_unflatten(spec.treedef, [x[:2] for x in leaves])
    assert kernel_ops.packed_view(sliced) is None     # rows of a view

    class Info:
        clients = (2,)
    rows = federated_rows(fp, Info())
    rflat, rspec = kernel_ops.packed_view(rows)
    assert torch.equal(rflat, flat[2:3]) and rspec == spec
    bt = token_batches((3, 4, STEPS, B, S), 0, 512)
    assert torch.equal(federated_rows(bt, Info(), axis=1)["tokens"],
                       bt["tokens"][:, 2:3])
    assert federated_rows(fp, None) is fp
