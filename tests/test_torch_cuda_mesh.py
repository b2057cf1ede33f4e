"""The federated LM slice on the card (marker ``cuda``; skips elsewhere; no
JAX). Run it on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda_mesh.py

* the four mix kernels at the federated LM shapes: mamba2-130m's P with
  D 8 and qwen2-1.5b's at 22 layers with D 4 (D x P past 2^31), f32,
  against their plain versions column block by column block
  (fed_mix_matching bit for bit; the others at 1e-5, their sums taken in
  other orders);
* a ``MeshEngine`` round on 2 ranks spawned on the card (gloo with CUDA
  tensors), fedp2p with a straggler and gossip_async, against the
  one-card round on the same draws (rtol 1e-5, atol 1e-6). The int8 wire
  on the mesh is held in ``chip_smoke.py``'s mesh phase;
* serving on the model axis: 2 ranks on the card (gloo), a reduced-width
  dense GQA config at head_dim 128 drawn by ``init_local_params``, its
  prefill logits and greedy tokens (``generate_on_mesh``) against the
  one-card run of the same seed (rtol 1e-4; tokens equal), each rank's
  flash_attention launched once a layer; and ``moe_ffn_ep`` on 2 ranks on
  the card against the one-card gather path where nothing drops, and
  against the one-card routing of each slice where tokens drop.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import backend, ref
from repro_torch.kernels.fed_mix import fed_mix
from repro_torch.kernels.fed_mix_q import fed_mix_q
from repro_torch.kernels.fed_mix_sparse import (
    fed_mix_matching, fed_mix_segment,
)
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import build_model
from test_torch_mesh_rounds import (
    B, S, STEPS, mesh_worker, to_numpy, token_batches,
)

pytestmark = pytest.mark.cuda
COLUMNS = 1 << 26


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    backend.use_full_f32()
    return torch.Generator(device="cuda").manual_seed(0)


def _params(arch, layers):
    """A client's parameter count at ``layers`` layers (the layers are
    alike: two small inits give it)."""
    sizes = []
    for n in (1, 2):
        cfg = dataclasses.replace(get_config(arch), num_layers=n)
        p = build_model(cfg).init(0, device="cuda")
        sizes.append(sum(v.numel() for v in _leaves(p)))
    return sizes[0] + (layers - 1) * (sizes[1] - sizes[0])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _close_by_blocks(got, plain, p, align=1, exact=False):
    step = COLUMNS // align * align
    for c0 in range(0, p, step):
        c1 = min(p, c0 + step)
        want = plain(c0, c1)
        if exact:
            assert torch.equal(got[:, c0:c1], want), (c0, c1)
        else:
            torch.testing.assert_close(got[:, c0:c1], want, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("arch,layers,d,nclu", [("mamba2-130m", 24, 8, 4),
                                                ("qwen2-1.5b", 22, 4, 2)])
def test_mix_kernels_at_the_federated_shapes(cuda, arch, layers, d, nclu):
    p = _params(arch, layers)
    kw = dict(device="cuda", generator=cuda)
    xn = torch.randn((d, p), **kw)
    xo = torch.randn((d, p), **kw)
    for nseg in (1, nclu):
        ids = torch.randint(0, nseg, (d,), dtype=torch.int32, **kw)
        wn, wo = torch.rand(d, **kw) / d, torch.rand(d, **kw) / d
        got = fed_mix_segment(ids, wn, wo, xn, xo, num_segments=nseg)
        _close_by_blocks(got, lambda a, b: ref.fed_mix_segment_ref(
            ids, wn, wo, xn[:, a:b].contiguous(), xo[:, a:b].contiguous(),
            num_segments=nseg), p)
        del got
    survive = (torch.rand(d, **kw) > 0.3).float()
    ring = torch.tensor([[1, 0, 3, 2, 5, 4, 7, 6][:d]], dtype=torch.int32,
                        device="cuda")
    got = fed_mix_matching(ring, survive, xn, xo)
    _close_by_blocks(got, lambda a, b: ref.fed_mix_matching_ref(
        ring, survive, xn[:, a:b].contiguous(), xo[:, a:b].contiguous()), p,
        exact=True)
    del got
    mn = torch.rand((d, d), **kw)
    mo = torch.rand((d, d), **kw)
    tot = (mn + mo).sum(dim=1, keepdim=True)
    mn, mo = mn / tot, mo / tot
    got = fed_mix(mn, mo, xn, xo)
    _close_by_blocks(got, lambda a, b: ref.fed_mix_ref(
        mn, mo, xn[:, a:b].contiguous(), xo[:, a:b].contiguous()), p)
    del got, xn
    chunk = 256
    pq = p + (-p) % chunk
    q = torch.randint(-127, 128, (d, pq), dtype=torch.int8, **kw)
    sc = 1e-4 * (torch.rand((d, pq // chunk), **kw) + 0.5)
    got = fed_mix_q(mn, mo, q, sc, xo, chunk=chunk)
    _close_by_blocks(got, lambda a, b: ref.fed_mix_q_ref(
        mn, mo, q[:, a:(b if b < p else pq)].contiguous(),
        sc[:, a // chunk:-(-b // chunk)].contiguous(),
        xo[:, a:b].contiguous(), chunk=chunk), p, align=chunk)


def test_two_rank_mesh_round_on_the_card(cuda, tmp_path):
    """2 ranks, one client each, gloo with CUDA tensors (NCCL refuses two
    ranks on one card), against the one-card round."""
    from repro_torch.config import FLConfig
    from repro_torch.core.fedp2p import broadcast_to_clients
    from repro_torch.protocols.engine import MeshDraws, MeshEngine
    from test_torch_mesh_rounds import tiny_model
    D = 2
    fl = dict(num_clusters=1, lr=0.05)
    counts = np.array([3.0, 5.0], np.float32)
    batch = token_batches((D, STEPS, B, S), 5, 512)
    cases = [{"algo": "fedp2p", "codec": "none", "survive": [1.0, 0.0],
              "sync": True},
             {"algo": "gossip_async", "codec": "none", "survive": [1.0, 1.0],
              "sync": True, "matching": 0}]
    payload = {"device": "cuda", "fl": fl, "counts": counts,
               "f_new": {"x": np.zeros((D, 1), np.float32)},
               "f_old": {"x": np.zeros((D, 1), np.float32)},
               "mix_cases": [], "round_cases": cases, "batch": batch}
    outs = run_ranks(mesh_worker, D, (payload,), backend="gloo",
                     init_method=f"file://{tmp_path}/rdzv", timeout=300)
    model = tiny_model()
    params = model.init(0, device="cuda")
    for i, case in enumerate(cases):
        eng = MeshEngine(model, FLConfig(**fl), D, STEPS,
                         algorithm=case["algo"],
                         counts=torch.from_numpy(counts), device="cuda")
        want, loss = eng.round_fn(
            broadcast_to_clients(params, D),
            {k: v.cuda() for k, v in batch.items()},
            MeshDraws(survive=torch.tensor(case["survive"]),
                      matching=(torch.tensor(case["matching"])
                                if "matching" in case else None)),
            do_global_sync=case["sync"])
        got = [np.concatenate([o["rounds"][i][0][j] for o in outs])
               for j in range(len(outs[0]["rounds"][i][0]))]
        for g, w in zip(got, to_numpy(want)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(outs[0]["rounds"][i][1], float(loss),
                                   rtol=1e-6)


def test_two_rank_model_axis_serving_on_the_card(cuda, tmp_path):
    from repro_torch.launch.serve import _generate
    from test_torch_model_axis_ranks import card_config, card_serving_worker
    cfg = card_config()
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 127)).astype(np.int32)
    outs = run_ranks(card_serving_worker, 2, ({"prompts": prompts,
                                              "new": 5},), backend="gloo",
                     init_method=f"file://{tmp_path}/rdzv", timeout=600)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    cache = model.make_cache(2, 132, device="cuda")
    from repro_torch.launch.steps import build_prefill_step
    logits, _ = build_prefill_step(model)(
        params, {"tokens": torch.from_numpy(prompts).long().cuda()}, cache)
    want = _generate(cfg, prompts, max_new_tokens=5, temperature=0.0,
                     window=0, seed=0, verbose=False, device="cuda",
                     params=params, generator=None)
    scale = float(logits.abs().max())
    for out in outs:
        np.testing.assert_allclose(
            out["prefill_logits"],
            logits[:, -1].float().cpu().numpy(), rtol=1e-4,
            atol=1e-4 * scale)
        assert np.array_equal(out["tokens"], want["tokens"])
        assert out["flash_launches"] == cfg.num_layers


def test_moe_ffn_ep_on_the_card(cuda, tmp_path):
    """EP on 2 ranks of the card against the one-card gather path run on
    each rank's slice of the tokens (the per-slice semantics: its own
    routing and capacity), at capacity factor 0.5 (tokens drop) and 8."""
    from repro_torch.convert import params_to_numpy
    from repro_torch.models import moe
    from test_torch_model_axis_ranks import card_moe_worker, moe_config
    cfg = moe_config(0.5)
    gen = torch.Generator().manual_seed(5)
    p = params_to_numpy(moe.init_moe(gen, cfg))
    x = np.random.default_rng(6).standard_normal(
        (4, 64, cfg.d_model)).astype(np.float32)
    outs = run_ranks(card_moe_worker, 2, ({"p": p, "x": x,
                                          "cfs": (0.5, 8.0)},),
                     backend="gloo", init_method=f"file://{tmp_path}/rdzv",
                     timeout=600)
    pc = {k: (torch.from_numpy(v).cuda() if not isinstance(v, dict) else
              {a: torch.from_numpy(b).cuda() for a, b in v.items()})
          for k, v in p.items()}
    xs = torch.from_numpy(x).cuda().reshape(2, 128, cfg.d_model)
    for cf in (0.5, 8.0):
        c = moe_config(cf)
        dropped = False
        for rank, out in enumerate(outs):
            y, kept, _ = out[cf]
            want, _ = moe._moe_ffn_gather(pc, xs[rank][None], c)
            _, idx, _ = moe.route(pc["router"], xs[rank], c)
            keep = moe.dispatch_indices(idx, c.num_experts,
                                        moe.moe_capacity(c, 128))[2]
            assert np.array_equal(kept[0], keep.cpu().numpy())
            dropped |= not kept[0].all()
            np.testing.assert_allclose(
                y.reshape(-1, c.d_model)[rank * 128:(rank + 1) * 128],
                want[0].cpu().numpy(), rtol=3e-4, atol=3e-5)
        assert dropped == (cf < 1.0)
