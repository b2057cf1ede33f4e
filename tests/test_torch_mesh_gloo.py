"""``psum_mix`` on a mesh of 8 ranks: one ``gloo`` world of 8 CPU
processes (``launch.mesh.run_ranks``, its rendezvous a ``file://`` store
under ``tmp_path``, a 240 s timeout), spawned once for the module, runs
every case; the JAX results are computed once here, in the test process,
and the ranks import no JAX (their worker is
``test_torch_mesh_rounds.mesh_worker``). As the JAX package's 8-device
test (``tests/test_sharding_and_dryrun.py:128``), with random non-uniform
counts:

* the mix alone, for every protocol (fedp2p, fedp2p_topo, fedavg, gossip,
  gossip_async) x survive (all ones, stragglers) x sync (on, off) x codec
  (none, int8: the per-leaf wire of the mesh, its noise JAX's
  ``fold_in(key, i)``), each rank's mixed row gathered into [D, ...]:
  against JAX's dense oracle on the same post-wire f_new (JAX's jitted
  ``wire_tree``) and against the port's one-device mix of the port's
  post-wire f_new, rtol 1e-5, atol 1e-6;
* whole ``round_fn`` rounds on the mesh (reduced qwen2-1.5b, one client a
  rank, one local step) against the port's one-device ``MeshEngine``
  round: fedp2p with and without the sync and with stragglers, fedavg,
  gossip, gossip_async, and topk's error feedback (the one-device
  reference: the same local training, ``feedback_wire_tree`` per leaf,
  then the codec-free mix); rtol 1e-5, atol 1e-6 (f32 rounding of the same
  arithmetic in another thread count), the losses at 1e-6.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import compression as jcompression  # noqa: E402
from repro_torch import compression  # noqa: E402
from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core.fedp2p import broadcast_to_clients  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.protocols.async_gossip import matching_perm_stack  # noqa: E402
from repro_torch.protocols.engine import MeshEngine  # noqa: E402
from test_torch_mesh_engine import (  # noqa: E402
    COUNTS, D, FL, PROTOCOLS, STRAGGLERS, jax_mix, leaves, mix_trees,
    torch_tree,
)
from test_torch_mesh_rounds import (  # noqa: E402
    B, S, STEPS, draws_of, mesh_worker, tiny_model, token_batches,
)

ONES = np.ones(D, np.float32)
INT8 = compression.get("int8")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its models are tiny,
    and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf_noise(tree, key):
    out = []
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        n = int(np.prod(leaf.shape[1:]))
        shape = (D, INT8.padded(n) // INT8.chunk, INT8.chunk)
        out.append(np.array(jax.random.uniform(
            jax.random.fold_in(key, i), shape)).reshape(D, -1))
    return out


def _matching(algo, key):
    if algo != "gossip_async":
        return None
    R = matching_perm_stack(D).shape[0]
    return int(jax.random.randint(key, (), 0, R))


MIX_CASES = [(algo, survive, sync, codec) for algo in PROTOCOLS
             for survive in ("ones", "stragglers") for sync in (True, False)
             for codec in ("none", "int8")]


def _mix_cases(f_new, f_old):
    cases, jax_want = [], []
    jwire = jax.jit(functools.partial(jcompression.wire_tree,
                                      jcompression.get("int8")))
    for i, (algo, survive, sync, codec) in enumerate(MIX_CASES):
        key = jax.random.PRNGKey(200 + i)
        survive = ONES if survive == "ones" else STRAGGLERS
        case = {"algo": algo, "survive": survive, "sync": sync,
                "codec": codec, "matching": _matching(algo, key)}
        new = f_new
        if codec == "int8":
            case["noise"] = _leaf_noise(f_new, key)
            new = jwire(f_new, f_old, key=key)
        cases.append(case)
        jax_want.append(jax_mix(algo, "dense", "none", new, f_old, survive,
                                sync, key))
    return cases, jax_want


def _one_device_mix(case, f_new, f_old):
    """The port's one-device mix of the post-wire f_new."""
    new = torch_tree(f_new)
    if case["codec"] == "int8":
        new = compression.wire_tree(INT8, new, torch_tree(f_old),
                                    u=[torch.from_numpy(u)
                                       for u in case["noise"]])
    flat_new, flat_old, spec = kernel_ops.pack_tree_pair(
        new, torch_tree(f_old))
    eng = MeshEngine(None, FLConfig(**FL), D, 1, algorithm=case["algo"],
                     counts=torch.from_numpy(COUNTS), device="cpu")
    case = {**case, "noise": None}
    return eng.mix(flat_new, flat_old, spec, draws_of(case),
                   do_global_sync=case["sync"])[0]


ROUND_CASES = [
    {"algo": "fedp2p", "survive": STRAGGLERS, "sync": True},
    {"algo": "fedp2p", "survive": ONES, "sync": False},
    {"algo": "fedavg", "survive": STRAGGLERS, "sync": True},
    {"algo": "gossip", "survive": STRAGGLERS, "sync": True},
    {"algo": "gossip_async", "survive": ONES, "sync": True, "matching": 3},
    {"algo": "fedp2p", "survive": STRAGGLERS, "sync": True,
     "codec": "topk"},
]


def _one_device_round(case, params, batch):
    fl = FLConfig(**FL)
    codec = case.get("codec", "none")
    eng = MeshEngine(tiny_model(), fl, D, STEPS, algorithm=case["algo"],
                     counts=torch.from_numpy(COUNTS), device="cpu")
    fp = broadcast_to_clients(params, D)
    if codec == "none":
        return eng.round_fn(fp, batch, draws_of(case),
                            do_global_sync=case["sync"])
    flat_old, spec = kernel_ops.packed_view(fp)
    flat_new, losses = eng._local_train(flat_old, spec, batch)
    f_new = kernel_ops.unpack_tree(flat_new, spec)
    f_old = kernel_ops.unpack_tree(flat_old, spec)
    c = compression.get(codec)
    tx, res = compression.feedback_wire_tree(
        c, f_new, f_old, compression.init_feedback_state(c, f_new))
    tx_flat = kernel_ops.pack_tree(tx)[0]
    out = eng.mix(tx_flat, flat_old, spec, draws_of(case),
                  do_global_sync=case["sync"])
    return out[0], losses.mean(), res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    f_new, f_old = mix_trees(11)
    mix_cases, jax_want = _mix_cases(f_new, f_old)
    batch = token_batches((D, STEPS, B, S), 21, 512)
    round_cases = [{"codec": "none", **c} for c in ROUND_CASES]
    payload = {"fl": FL, "counts": COUNTS, "f_new": f_new, "f_old": f_old,
               "mix_cases": mix_cases, "round_cases": round_cases,
               "batch": batch}
    rdzv = tmp_path_factory.mktemp("rdzv") / "store"
    outs = run_ranks(mesh_worker, D, (payload,), backend="gloo",
                     init_method=f"file://{rdzv}", timeout=240)
    return {"outs": outs, "f_new": f_new, "f_old": f_old,
            "mix_cases": mix_cases, "jax_want": jax_want,
            "round_cases": round_cases, "batch": batch}


def _gather(per_rank):
    """One case's leaves of every rank, stacked into [D, ...] leaves."""
    return [np.concatenate([r[j] for r in per_rank])
            for j in range(len(per_rank[0]))]


@pytest.mark.parametrize("i", range(len(MIX_CASES)),
                         ids=["-".join(map(str, c)) for c in MIX_CASES])
def test_psum_mix_matches_the_dense_oracle_and_one_device(world, i):
    case = world["mix_cases"][i]
    what = "-".join(map(str, MIX_CASES[i]))
    got = _gather([o["mix"][i] for o in world["outs"]])
    want = _one_device_mix(case, world["f_new"], world["f_old"])
    for g, w, j in zip(got, leaves(want),
                       jax.tree.leaves(world["jax_want"][i])):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   err_msg=f"one device: {what}")
        np.testing.assert_allclose(g, np.asarray(j), rtol=1e-5, atol=1e-6,
                                   err_msg=f"JAX: {what}")


@pytest.mark.parametrize("i", range(len(ROUND_CASES)))
def test_mesh_round_matches_one_device(world, i):
    case = world["round_cases"][i]
    what = f"{case['algo']} codec={case['codec']} sync={case['sync']}"
    want = _one_device_round(case, tiny_model().init(0, device="cpu"),
                             world["batch"])
    rows = [o["rounds"][i] for o in world["outs"]]
    got = _gather([r[0] for r in rows])
    for g, w in zip(got, leaves(want[0])):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=what)
    if case["codec"] == "topk":
        res = _gather([r[2] for r in rows])
        for g, w in zip(res, leaves(want[2])):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what} residual")
    assert all(r[1] == rows[0][1] for r in rows)
    np.testing.assert_allclose(rows[0][1], float(want[1]), rtol=1e-6,
                               err_msg=what)
