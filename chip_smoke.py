#!/usr/bin/env python3
"""On-card check of the PyTorch port (``src/repro_torch``) on one CUDA GPU.

    python3 chip_smoke.py

It takes no arguments. Phases, in order; any failure raises and the script
exits non-zero:

  env       the card, its power limit, and the parallel nvcc build of every
            kernel (one nvcc per source, all started together);
  kernels   each CUDA kernel against its plain PyTorch version on the card,
            at the main path's shapes and at ragged ones, f32 and bf16
            (fed_mix_matching bit for bit, on its rounding-tree route at
            S <= 3, its stage loop at S = 4 and its device-memory path);
            fed_mix and fed_mix_q with a diverged client's inf, NaN and
            f32-maximum values, flash_attention with inf and NaN in V, K
            and Q at keys in tiles it skips and in tiles it visits, and
            ssd_scan with inf and NaN in x, dt, B and C at rows above the
            diagonal of skipped and of visited tiles (inf and NaN where the
            plain version has them); flash_attention at Hymba's prefill
            shapes and the JAX kernel tests' sweep, and at head_dim 160,
            192, 256 (gemma-2b's MQA shape, with inf and NaN too) and
            512, and with v's head_dim apart from q's and k's: DeepSeek-V2's
            MLA prefill (192, 128; with inf and NaN too), (24, 16), (64,
            32), (96, 128) and (320, 256); ssd_scan at Hymba's and
            mamba2-130m's; the backward
            kernels (flash_attention_bwd, flash_attention_bwd_128,
            flash_attention_bwd_256, flash_attention_bwd_vd, ssd_scan_bwd)
            against the plain version's autograd at
            Hymba's, qwen2-1.5b's and DBRX's (hd 128), gemma-2b's (hd
            256), DeepSeek-V2's (192, 128) and mamba2-130m's training
            shapes (flash in f32 and bf16), two backward calls bit for
            bit, and an inf or NaN in each input (flash at hd 128 and 256
            too)
            (flash: q, k, v, dO; the SSD: x, dt, B, C, dY) giving the
            plain autograd's inf and NaN; the wgmma forward's row
            log-sum-exp against the plain one; first of all, while the
            card holds nothing else, the four mix kernels at the
            federated LM rows' shapes (mamba2-130m's P at D 8,
            qwen2-1.5b's at FED_QWEN_LAYERS layers and D 4, D x P past
            2^31), column block by column block, and flash and the SSD
            pair at those rows' client shapes too;
  reference the port on the card (kernels) against the port on the CPU
            (plain versions) on a small CNN run with the same draws,
            gossip, gossip_async, the int8/topk wire, fedp2p_topo and a
            faulted fedp2p run (its counters equal) included, a checkpoint
            round trip of the card's final params (bit for bit), the
            sampled window (``SampledEngine``: the small CNN with D = 24
            enrolled over its 12 data clients, K = 8, fedp2p and gossip;
            every stored row and the losses at rtol 1e-4) and, at D == P
            == K = 8 with cuDNN pinned, the window against
            ``DenseEngine``'s round bit for bit,
            reduced Hymba's prefill and greedy decode, reduced Hymba's,
            deepseek-v2-236b's and dbrx-132b's training (the step-1 loss
            and every gradient leaf, then 3 AdamW steps' losses; the MoE
            routing of step 1 equal), reduced deepseek-v2-236b and
            dbrx-132b's prefill and 8 greedy decode steps (logits, tokens,
            and every MoE layer's routing equal on the two devices), and
            reduced gemma-2b (at head_dim 256), nemotron-4-15b, yi-34b,
            chameleon-34b (at head_dim 128) and musicgen-medium served the
            same way, gemma, nemotron and musicgen trained the same way;
            federated LM rounds (``MeshEngine``) of reduced mamba2-130m
            (five protocols), 3 rounds on the same draws and weights;
  main_path ``Simulator.run`` on CNN-FEMNIST at the paper's full width
            (246,590 params x 100 clients): fedp2p, fedp2p with
            sync_period=2, fedavg, fedp2p on mix_path="dense", fedp2p
            with the JAX package's Table-1 participation (10 of 100),
            fedp2p_topo (``topology_aware=True``) at the default and at
            the Table-1 participation, fedp2p under a fault plan (drops,
            nan/inf/bitflip uploads; the counters held to the plan),
            gossip, gossip_async with sync_period=2, gossip on
            mix_path="dense", fedp2p with the int8 wire on "dense" and on
            "auto", gossip with the topk wire, ``ops.fed_aggregate_tree``
            and ``aggregation.cluster_then_global`` over one fedp2p
            round's client models, and Table-1-style best-accuracy rows of
            fedp2p, fedp2p_topo and fedavg (printed, not gated); then
            sampled participation at the same width with cuDNN pinned
            (``sampled_main_path``): fedp2p over D = 10,000 resident
            clients (9.86 GB of state on the card), K = 100, 3 rounds at
            pipeline depths 1 and 2 from fresh stores; fedp2p over D =
            10^6 on the checkpoint tier at depths 1, 2 and 3 and its
            global model from ``consensus()``; gossip with the topk
            wire over 10,000 resident clients at depths 1 and 2; fedavg
            with pareto selection over 10^6 at availability 0.1 (K
            distinct ids, all available); fedp2p over 1,000 cold clients
            under a fault plan with read errors and a dead prefetch
            worker at depths 1 and 2 (rows, drops, rejections and
            retries equal; the fallback at depth 2) — every depth bit
            for bit with depth 1; then
            ``serve.generate`` on Hymba-1.5B at full width (seeded
            weights, made once; B = 4, prompts of 384 and 1920 tokens,
            16 greedy tokens); then ``generate``'s body
            (``serve._generate``) on deepseek-v2-236b cut to 3 layers
            (the leading dense layer and 2 MoE layers; prompts of 512 and
            2048) and dbrx-132b cut to 2 (a prompt of 2048), every width
            published, B = 4, 16 greedy tokens, one flash_attention launch
            a layer; then the same on gemma-2b and nemotron-4-15b whole,
            yi-34b cut to 25 layers and chameleon-34b to 20 (a prompt of
            2048), and musicgen-medium whole through ``Model.prefill`` /
            ``Model.decode`` (1500 seeded frame embeddings, a [4, 64,
            1536] context, 15 decode frames); then ``run_lm_training`` on
            Hymba-1.5B at
            full width (B 2 x 1920 tokens, 4 steps with remat off and 2
            with remat on; every backward kernel launched 32 times a
            step), one step's device-time split, and the CLI's
            ``--mode lm --arch mamba2-130m --full --steps 20`` as a
            subprocess; then the train step of deepseek-v2-236b (2
            layers, 32 of 160 routed experts) and dbrx-132b (1 layer, 6
            of 16; its backward at hd 128) at every published width, B 1 x
            2048, 3 steps, with a step's split, and ``run_lm_training``
            on both reduced; then
            the train step of gemma-2b cut to 16 layers (B 1 x 2048, the
            hd-256 backward) and musicgen-medium whole (B 1 x 1500
            frames), 3 steps each; then federated LM training through
            ``MeshEngine`` (``fed_main_path``): mamba2-130m whole at D 8
            (fedp2p with stragglers and sync_period 2, fedavg, gossip,
            gossip_async, dense, int8 on dense, topk's residual threaded
            over two calls) and qwen2-1.5b cut to FED_QWEN_LAYERS layers
            at D 4: each run driven with the launch counters set to 0
            just before it and read just after;
  timing    each kernel's mean time at the main path's shape beside its
            plain version (the FL rows with the L2 evicted before every
            call), its bound (the product kernels' at the
            split-f32 tensor-core rate, with the CUDA cores' f32 rate
            beside it) and its library yardstick (ssd_scan also at
            mamba2-130m's shape; flash_attention's two non-finite
            launches alone, at every serving and training shape of the
            main path beside SDPA: gemma-2b's hd 256 at B 4 and B 1,
            nemotron's, yi's and chameleon's GQA at 128, musicgen's MHA
            at 64, DeepSeek-V2's MLA (192, 128);
            fed_mix_matching at S = 2 and 1; the backward kernels at
            Hymba's, DeepSeek-V2's, DBRX's, gemma-2b's and musicgen's
            training shapes beside the plain autograd and, for flash,
            SDPA's backward), two
            rounds' split between local
            training, mixing and the wire (at SPLIT_EPOCHS local epochs), the Hymba prefill's
            device time by kernel, and a sampled cold-tier round (D =
            10^6) split into store gather, window and scatter, with the
            share of the store's time that depths 2 and 3 hide (printed,
            not gated); the mix kernels at the federated LM's P beside
            their bytes bound, and a federated mamba2-130m round's split
            between local training and the mix;
  mesh      ``psum_mix`` of every protocol on MESH_RANKS spawned ranks on
            the one card (gloo, CUDA tensors, a mamba2-130m client each),
            the int8 wire too, against the one-card mix; one round on an
            nccl world of one rank (a spawned process) against the
            one-card round.

Each phase prints one JSON line. The run ends with the kernel summary
line, the ``nvidia-smi`` name/power-limit line, and then
``{"ok": true, "device": {...}}`` as the last line. Needs the repository's
``src/`` beside this file and a CUDA device; without either it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# An f32 matrix product to f32 accuracy on the TF32 tensor cores takes
# three TF32 products (split-f32, kernels/csrc/tf32x3.cuh): the product
# kernels' bound counts their flops at a third of the TF32 rate, and
# the timing rows report the bound at the CUDA cores' f32 rate beside it
# (bound_ffma_ms).
SPLIT_F32_FLOP_PER_S = TF32_FLOP_PER_S / 3
# A product on bf16 operands: the card's dense bf16 tensor-core rate,
# whatever the kernel issues (flash_attention_bwd_vd reads bf16 through
# its TF32 products).
BF16_FLOP_PER_S = 989e12

# (name, source, TPU kernel it replaces), in the summary line's order
KERNELS = (
    ("fed_mix_segment", "src/repro_torch/kernels/csrc/fed_mix_segment.cu",
     "src/repro/kernels/fed_mix_sparse.py:85"),
    ("fed_mix", "src/repro_torch/kernels/csrc/fed_mix.cu",
     "src/repro/kernels/fed_mix.py:66"),
    ("fed_mix_matching", "src/repro_torch/kernels/csrc/fed_mix_matching.cu",
     "src/repro/kernels/fed_mix_sparse.py:156"),
    ("fed_mix_q", "src/repro_torch/kernels/csrc/fed_mix_q.cu",
     "src/repro/kernels/fed_mix_q.py:72"),
    ("fed_aggregate", "src/repro_torch/kernels/csrc/fed_aggregate.cu",
     "src/repro/kernels/fed_aggregate.py:36"),
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:70"),
    ("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
     "src/repro/kernels/ssd_scan.py:71"),
    # the backward kernels have no Pallas counterpart: the JAX package
    # computes these gradients in jnp (flash: the custom VJP; SSD: autodiff
    # of ssd_chunked)
    ("flash_attention_bwd",
     "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
     "src/repro/models/attention.py:138"),
    # at vd = hd in (64, 128] (DBRX's and qwen2's 128) and (128, 256]
    # (gemma-2b's 256): the same VJP, one source at two head widths
    ("flash_attention_bwd_128",
     "src/repro_torch/kernels/csrc/flash_attention_bwd_256.cu",
     "src/repro/models/attention.py:138"),
    ("flash_attention_bwd_256",
     "src/repro_torch/kernels/csrc/flash_attention_bwd_256.cu",
     "src/repro/models/attention.py:138"),
    # at v's own head_dim (MLA): JAX differentiates its jnp attention_core
    ("flash_attention_bwd_vd",
     "src/repro_torch/kernels/csrc/flash_attention_bwd_vd.cu",
     "src/repro/models/mla.py:104"),
    ("ssd_scan_bwd", "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
     "src/repro/models/ssm.py:104"),
)

# the main path's mix: 100 participants x the FEMNIST CNN's 246,590 params
MAIN_D, MAIN_P = 100, 246_590
# the int8 record of that buffer: P rounded up to whole chunks of 256
CHUNK = 256
MAIN_PQ = MAIN_P + (-MAIN_P) % CHUNK
# max |kernel - plain| <= ATOL + RTOL * |plain|, elementwise. f32: the two
# sum in different orders (row order vs atomics / cuBLAS), a few ulp of
# O(1) values. bf16: one bf16 rounding step of O(1) outputs (2^-6 at
# [2, 4)), as the JAX package's tests allow (3e-2).
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (3e-2, 3e-2)}

# Hymba-1.5B's serving path (configs/hymba_1_5b.py): B 4; 25 query and 5
# kv heads of 64, 128 meta tokens, window 1024; 50 SSM heads of 64, state
# 16, chunk 128. Prompts of 384 and 1920 tokens make S + M = 512 (inside
# the window) and 2048 (past it: ring decode).
LM_ARCH, LM_B, LM_NEW = "hymba-1.5b", 4, 16
LM_HQ, LM_HKV, LM_HD, LM_META, LM_WINDOW = 25, 5, 64, 128, 1024
LM_PROMPTS = (384, 1920)
LM_S = LM_PROMPTS[1] + LM_META
# gemma-2b's attention (configs/gemma_2b.py): 8 query heads and one kv head
# of 256 (MQA), causal, no window: flash_fwd_kernel_wgmma256 forward,
# flash_attention_bwd_256 backward.
WIDE_HQ, WIDE_HKV, WIDE_HD = 8, 1, 256
# DeepSeek-V2's MLA prefill (configs/deepseek_v2_236b.py): 128 heads, q/k
# 192 (nope 128 + rope 64), v 128, causal; B 4 at 2048 positions.
MLA_H, MLA_HD, MLA_VD = 128, 192, 128
# The MoE/MLA serving main path: (arch, layers kept, prompt lengths) at
# every published width, depth the only cut (B 4, 16 greedy tokens).
MOE_RUNS = (("deepseek-v2-236b", 3, (512, 2048)),
            ("dbrx-132b", 2, (2048,)))
# (atol, rtol) of flash_attention against its plain version. f32: an
# online softmax over 64-key tiles against a one-shot softmax; bf16 as
# above.
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (3e-2, 3e-2)}
# ssd_scan against its plain version, f32: rtol 1e-4 and an atol of
# SSD_ATOL_SCALE times the plain output's largest |value|. The cumsum of
# dt·A reaches ~100 over a chunk and is taken in another order; exp of its
# differences carries ~1e-5 of relative error in either order, and a chunk
# sums hundreds of such terms. Each case also reports both versions' error
# against the plain version computed in float64.
SSD_RTOL, SSD_ATOL_SCALE = 1e-4, 5e-4
# The backward kernels against the plain version's autograd on the card, at
# the forward's tolerances: flash's gradients at FLASH_TOL; each SSD
# gradient at rtol SSD_RTOL and an atol of SSD_ATOL_SCALE times that
# gradient's largest |value|. Each case also reports both versions' error
# against the plain version's autograd in float64.
# Hymba-1.5B's training main path (run_lm_training at full width): B 2,
# 1920 tokens (2048 positions with the 128 meta tokens, past the window of
# 1024), 4 steps with remat off, then 2 with remat on.
TRAIN_B, TRAIN_SEQ, TRAIN_STEPS, TRAIN_REMAT_STEPS = 2, 1920, 4, 2
# the step-1 loss of random weights: ln V plus about sigma^2 / 2 for
# logits of unit spread; within 1.5 of ln(32001)
TRAIN_LOSS0_SLACK = 1.5
# The MoE/MLA training main path: (arch, layers kept, routed experts
# kept) at every published width, B 1 x 2048 tokens, 3 AdamW steps, remat
# off. The functional AdamW's update holds 28 B a parameter (the params,
# the clipped gradients, m and v, and the new m, v and updates; then the
# new params in the gradients' place), so the routed experts are cut to
# what fits the card's 80 GB with ~10 GB to spare.
MOE_TRAIN_RUNS = (("deepseek-v2-236b", 2, 32), ("dbrx-132b", 1, 6))
MOE_TRAIN_B, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 1, 2048, 3
# The dense and VLM serving main path: (arch, layers kept) at every
# published width, f32, B 4, a prompt of 2048, 16 greedy tokens; depth cut
# where the f32 weights pass ~60 GB (yi-34b: 25 of 60 layers, 59.4 GB;
# chameleon-34b: 20 of 48, 59.7 GB; whole they are 138 and 137 GB).
DENSE_RUNS = (("gemma-2b", 18), ("nemotron-4-15b", 32), ("yi-34b", 25),
              ("chameleon-34b", 20))
DENSE_PROMPT = 2048
# musicgen-medium at full depth, through Model.prefill / Model.decode: its
# stub frontend's seeded frame embeddings (d 1536) and a conditioning
# context of [B, 64, 1536]; 1500 frames, MusicGen's 30 s at 50 Hz.
AUDIO_ARCH, AUDIO_FRAMES = "musicgen-medium", 1500
# Training the dense and audio configs, f32 AdamW (28 B a parameter at
# the update), B 1, 3 steps, remat off: gemma-2b cut to 16 of 18 layers
# (2.29 B params, 64 GB at the update) at 2048 tokens, through the hd-256
# backward; musicgen-medium whole (1.82 B, 51 GB) at 1500 frames.
DENSE_TRAIN_RUNS = (("gemma-2b", 16, 2048), ("musicgen-medium", 48, 1500))
# Federated LM training through MeshEngine (f32 SGD, remat on as in the
# JAX package's MeshEngine): (arch, D clients, L clusters). mamba2-130m
# whole (0.52 GB a client); qwen2-1.5b at every published width, its
# depth cut to FED_QWEN_LAYERS of 28 layers (1.26 B parameters, 5.1 GB a
# client): one round holds the state, the trained rows and the mixed rows
# of D 4 clients, 3 x 4 x 5.1 = 60.6 GB, where the whole model's 74 GB
# would leave the card no room for training. B 4 x 512 tokens, 2 local
# steps a client a round; the counts |D_i| drawn from FED_COUNTS_SEED.
FED_MAMBA = ("mamba2-130m", 8, 4)
FED_QWEN = ("qwen2-1.5b", 4, 2)
FED_QWEN_LAYERS = 22
FED_B, FED_SEQ, FED_STEPS = 4, 512, 2
FED_COUNTS_SEED = 17
# the mesh phase: ranks on the one card, one mamba2-130m client each
MESH_RANKS = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(label, fn, *args):
    """``fn(*args)``, its wall seconds printed to stderr under ``label``
    (a phase's parts: where the run's time limit goes)."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"chip_smoke: {label} took {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def segment_inputs(torch, d, p, num_segments, dtype, seed):
    """A fedp2p-like segment mix: random clusters, straggler mask and
    integer sample counts; within each segment the w_new weights of the
    survivors sum to 1, dead segments keep their old rows' mean."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", generator=g)
    ids = torch.randint(0, num_segments, (d,), dtype=torch.int32, **kw)
    survive = (torch.rand(d, **kw) > 0.3).float()
    counts = torch.randint(12, 121, (d,), **kw).float()
    w = survive * counts
    seg_tot = torch.zeros(num_segments, device="cuda").index_add_(
        0, ids.long(), w)
    seg_n = torch.zeros(num_segments, device="cuda").index_add_(
        0, ids.long(), torch.ones(d, device="cuda"))
    w_new = w / torch.clamp_min(seg_tot[ids.long()], 1e-12)
    w_old = (seg_tot[ids.long()] == 0).float() / torch.clamp_min(
        seg_n[ids.long()], 1.0)
    x_new = torch.randn((d, p), **kw).to(dtype)
    x_old = torch.randn((d, p), **kw).to(dtype)
    return ids, w_new, w_old, x_new, x_old


def dense_inputs(torch, d, p, dtype, seed):
    """Random convex (M_new, M_old): the rows of M_new + M_old sum to 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", generator=g)
    mn = torch.rand((d, d), **kw)
    mo = torch.rand((d, d), **kw)
    tot = (mn + mo).sum(dim=1, keepdim=True)
    x_new = torch.randn((d, p), **kw).to(dtype)
    x_old = torch.randn((d, p), **kw).to(dtype)
    return mn / tot, mo / tot, x_new, x_old


def matching_inputs(torch, d, p, stages, dtype, seed):
    """Gossip's two ring phases (stages=2) or random round-robin matchings
    of gossip_async (stages=1), a straggler mask, random rows."""
    from repro_torch.protocols.async_gossip import matching_perm_stack
    from repro_torch.protocols.gossip import _phase_perm_stack
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", generator=g)
    if stages == 2:
        perms = torch.from_numpy(_phase_perm_stack(d)).cuda()
    else:
        stack = torch.from_numpy(matching_perm_stack(d)).cuda()
        perms = stack[torch.randint(0, stack.shape[0], (stages,), **kw)]
    survive = (torch.rand(d, **kw) > 0.3).float()
    return (perms.contiguous(), survive, torch.randn((d, p), **kw).to(dtype),
            torch.randn((d, p), **kw).to(dtype))


def quant_inputs(torch, d, p, chunk, x_dtype, seed):
    """A convex (M_new, M_old) pair, the int8 record (stochastic rounding)
    of a round delta of a few 1e-2, and an X_old of O(1)."""
    from repro_torch.compression import Int8Codec
    mn, mo, _, xo = dense_inputs(torch, d, p, torch.float32, seed)
    codec = Int8Codec(chunk=chunk)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    delta = 0.01 * torch.randn((d, p), device="cuda", generator=g)
    u = torch.rand((d, codec.padded(p)), device="cuda", generator=g)
    enc = codec.encode(delta, u=u)
    return mn, mo, enc.values, enc.scales, xo.to(x_dtype)


def aggregate_inputs(torch, n, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.rand(n, device="cuda", generator=g)
    return (torch.randn((n, d), device="cuda", generator=g).to(dtype),
            w / w.sum())


def attention_inputs(torch, b, hq, hkv, s, hd, dtype, seed, vd=None):
    """q, k, v as the model hands them to the kernel: [B, S, H, hd]
    projections viewed as [B, H, S, hd]; v at ``vd`` (default hd)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [(torch.randn((b, s, h, d), device="cuda", generator=g) * 0.5)
            .to(dtype).transpose(1, 2)
            for h, d in ((hq, hd), (hkv, hd), (hkv, vd or hd))]


def ssd_inputs(torch, b, s, h, p, n, seed, with_state):
    """x, B and C as slices of one conv output (the mixer's layout), dt
    after softplus, A < 0; and an initial state or None."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", generator=g)
    u = torch.randn((b, s, h * p + 2 * n), **kw) * 0.5
    x = u[..., :h * p].unflatten(-1, (h, p))
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), **kw))
    A = -torch.exp(torch.randn(h, **kw) * 0.3)
    init = torch.randn((b, h, p, n), **kw) if with_state else None
    return (x, dt, A, u[..., h * p:h * p + n], u[..., h * p + n:]), init


def flash_mask(torch, s, window, num_meta):
    """[S, S] bool: key j visible to query i (the kernel's mask)."""
    i = torch.arange(s, device="cuda")[:, None]
    j = torch.arange(s, device="cuda")[None, :]
    mask = j <= i
    if window > 0:
        mask &= ((i - j) < window) | (j < num_meta)
    return mask


def place_non_finite(torch, x):
    """A diverged client's values in x (in place): inf, -inf, NaN and +-the
    dtype's largest finite value in columns of their own, and inf beside
    -inf in one column."""
    big = torch.finfo(x.dtype).max
    d = x.shape[0]
    for r, c, v in ((3, 5, math.inf), (7, 11, -math.inf), (1, 17, math.nan),
                    (2, 23, big), (5, 29, -big), (0, 31, math.inf),
                    (d - 1, 31, -math.inf)):
        x[r % d, c] = v
    return x


def compare_non_finite(torch, got, want, tol=None):
    """(max abs err over the finite outputs, tolerance, ok): NaN where the
    plain version has NaN, the same infinities, the finite outputs within
    the usual tolerance."""
    atol, rtol = tol or TOL[str(want.dtype).replace("torch.", "")]
    g, w = got.float(), want.float()
    fin = torch.isfinite(w)
    err = (g - w).abs()[fin]
    ok = (torch.equal(torch.isnan(g), torch.isnan(w))
          and torch.equal(g[torch.isinf(w)], w[torch.isinf(w)])
          and bool(torch.isfinite(g[fin]).all())
          and bool((err <= atol + rtol * w.abs()[fin]).all()))
    return float(err.max()) if err.numel() else 0.0, atol, rtol, ok


def compare(torch, got, want, tol=None):
    """(max abs err, tolerance at that element, ok) in the output dtype."""
    atol, rtol = tol or TOL[str(want.dtype).replace("torch.", "")]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = atol + rtol * w.abs()
    ok = bool((err <= bound).all()) and bool(torch.isfinite(g).all())
    return float(err.max()) if err.numel() else 0.0, atol, rtol, ok


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env(torch, backend, state):
    t0 = time.perf_counter()
    seconds = backend.build()
    wall = time.perf_counter() - t0
    state["smi"] = nvidia_smi()
    emit({"phase": "env", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": state["smi"],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": seconds, "build_wall_seconds": round(wall, 3)})


def phase_kernels(torch, state):
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_aggregate import fed_aggregate
    from repro_torch.kernels.fed_mix import fed_mix
    from repro_torch.kernels.fed_mix_q import fed_mix_q
    from repro_torch.kernels.fed_mix_sparse import (
        fed_mix_matching, fed_mix_segment,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    # the federated LM shapes first, while the card holds nothing else
    rows = fed_kernel_cases(torch)
    failed = [r for r in rows if not r["ok"]]
    seg_cases = [(MAIN_D, MAIN_P, 1, f32), (MAIN_D, MAIN_P, 10, f32),
                 (MAIN_D, MAIN_P, 1, bf16), (MAIN_D, MAIN_P, 10, bf16),
                 (37, 1000, 37, f32), (37, 1000, 37, bf16),
                 (37, 1001, 37, bf16),       # odd P: one column a thread
                 (7, 130, 3, f32), (1, 1, 1, f32), (100, 1000, 100, f32),
                 (2048, 999, 2048, f32),     # [L, P] device-memory path
                 (1000, 130, 1000, f32),     # the same, two columns a thread
                 (4096, 257, 7, bf16)]
    for i, (d, p, nseg, dt) in enumerate(seg_cases):
        ids, wn, wo, xn, xo = segment_inputs(torch, d, p, nseg, dt, seed=i)
        got = fed_mix_segment(ids, wn, wo, xn, xo, num_segments=nseg)
        torch.cuda.synchronize()
        want = ref.fed_mix_segment_ref(ids, wn, wo, xn, xo,
                                       num_segments=nseg)
        err, atol, rtol, ok = compare(torch, got, want)
        ok = ok and got.dtype == xn.dtype and got.shape == xn.shape
        rows.append({"kernel": "fed_mix_segment", "D": d, "P": p, "L": nseg,
                     "dtype": str(dt)[6:], "max_abs_err": err,
                     "atol": atol, "rtol": rtol, "ok": ok})
        failed += [] if ok else [rows[-1]]
    # + the tensor-core kernel's tile edges: D around its 16-row tiles and
    # 128-row blocks, P = 0..3 mod 4 (rows off 16-byte alignment)
    dense_cases = [(MAIN_D, MAIN_P, f32), (MAIN_D, MAIN_P, bf16),
                   (37, 1000, f32), (37, 1000, bf16), (7, 130, f32),
                   (1, 1, f32), (300, 5001, f32), (16, 4096, f32),
                   (113, 4097, f32), (128, 4098, bf16), (112, 4099, f32),
                   (MAIN_D, MAIN_P + 1, bf16)]
    for i, (d, p, dt) in enumerate(dense_cases):
        mn, mo, xn, xo = dense_inputs(torch, d, p, dt, seed=100 + i)
        got = fed_mix(mn, mo, xn, xo)
        torch.cuda.synchronize()
        want = ref.fed_mix_ref(mn, mo, xn, xo)
        err, atol, rtol, ok = compare(torch, got, want)
        ok = ok and got.dtype == xn.dtype and got.shape == xn.shape
        rows.append({"kernel": "fed_mix", "D": d, "P": p,
                     "dtype": str(dt)[6:], "max_abs_err": err,
                     "atol": atol, "rtol": rtol, "ok": ok})
        failed += [] if ok else [rows[-1]]
    # bit for bit: every operation is one rounding in the plain order;
    # the rounding tree at S <= 3, the stage loop at S = 4
    match_cases = [(MAIN_D, MAIN_P, 2, f32), (MAIN_D, MAIN_P, 2, bf16),
                   (MAIN_D, MAIN_P, 1, f32), (MAIN_D, MAIN_P, 1, bf16),
                   (9, 1001, 2, f32),            # odd D: byes
                   (1, 1, 1, f32), (17, 513, 2, bf16),
                   (MAIN_D, 63, 2, f32),         # below one tile
                   (MAIN_D, 4099, 3, f32), (MAIN_D, 4099, 0, bf16),
                   (MAIN_D, 4099, 4, f32), (37, 130, 4, bf16),
                   (300, 1001, 3, f32),          # a narrower tile
                   (2048, 999, 2, f32),          # device-memory path
                   (4096, 257, 1, f32)]
    for i, (d, p, stages, dt) in enumerate(match_cases):
        args = matching_inputs(torch, d, p, stages, dt, seed=200 + i)
        got = fed_mix_matching(*args)
        torch.cuda.synchronize()
        want = ref.fed_mix_matching_ref(*args)
        ok = (torch.equal(got, want) and got.dtype == dt
              and got.shape == (d, p))
        err = float((got.float() - want.float()).abs().max())
        rows.append({"kernel": "fed_mix_matching", "D": d, "P": p,
                     "S": stages, "dtype": str(dt)[6:], "max_abs_err": err,
                     "atol": 0.0, "rtol": 0.0, "bitwise": ok, "ok": ok})
        failed += [] if ok else [rows[-1]]
    # (D, P, chunk, x_old dtype): the main path, the JAX kernel tests'
    # cases (tests/test_compression.py), a bf16 X_old
    # + the kernel's two routes: chunk 16 and 48 dequantize in the
    # fragment load, 192 folds the scale into M_new; D = 300 takes row
    # blocks and K in chunks of M
    q_cases = [(MAIN_D, MAIN_P, CHUNK, f32), (6, 700, 256, f32),
               (16, 4096, 256, f32), (17, 513, 128, f32), (1, 129, 64, f32),
               (40, 300, 128, f32), (17, 513, 128, bf16),
               (MAIN_D, 4099, 16, f32), (MAIN_D, 4099, 192, bf16),
               (300, 513, 48, f32), (MAIN_D, MAIN_P, CHUNK, bf16)]
    for i, (d, p, chunk, dt) in enumerate(q_cases):
        args = quant_inputs(torch, d, p, chunk, dt, seed=300 + i)
        got = fed_mix_q(*args, chunk=chunk)
        torch.cuda.synchronize()
        want = ref.fed_mix_q_ref(*args, chunk=chunk)
        err, atol, rtol, ok = compare(torch, got, want)
        ok = ok and got.dtype == dt and got.shape == (d, p)
        rows.append({"kernel": "fed_mix_q", "D": d, "P": p,
                     "Pq": args[2].shape[1], "chunk": chunk,
                     "dtype": str(dt)[6:], "max_abs_err": err,
                     "atol": atol, "rtol": rtol, "ok": ok})
        failed += [] if ok else [rows[-1]]
    rows += non_finite_cases(torch)
    failed += [r for r in rows if r.get("non_finite") and not r["ok"]]
    agg_cases = [(MAIN_D, MAIN_P, f32), (MAIN_D, MAIN_P, bf16),
                 (3, 1000, f32), (3, 1000, bf16), (8, 4096, f32),
                 (8, 4096, bf16), (1, 1, f32)]
    for i, (n, d, dt) in enumerate(agg_cases):
        x, w = aggregate_inputs(torch, n, d, dt, seed=400 + i)
        got = fed_aggregate(x, w)
        torch.cuda.synchronize()
        want = ref.fed_aggregate_ref(x, w)
        err, atol, rtol, ok = compare(torch, got, want)
        ok = ok and got.dtype == dt and got.shape == (d,)
        rows.append({"kernel": "fed_aggregate", "D": n, "P": d,
                     "dtype": str(dt)[6:], "max_abs_err": err,
                     "atol": atol, "rtol": rtol, "ok": ok})
        failed += [] if ok else [rows[-1]]
    rows += lm_kernel_cases(torch)
    rows += lm_backward_cases(torch)
    failed += [r for r in rows if r["kernel"] in (
        "flash_attention", "ssd_scan", "flash_attention_bwd",
        "flash_attention_bwd_128", "flash_attention_bwd_256",
        "flash_attention_bwd_vd", "ssd_scan_bwd") and not r["ok"]]
    # the summary line's error: the main path's shape, f32
    for name, _, _ in KERNELS:
        state.setdefault("max_abs_err", {})[name] = max(
            r["max_abs_err"] for r in rows
            if r["kernel"] == name and main_case(r))
    emit({"phase": "kernels", "cases": rows})
    if failed:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{failed}")


def non_finite_cases(torch):
    """fed_mix and fed_mix_q with a diverged client's values in X (and, for
    the int8 wire, non-finite scales), flash_attention and ssd_scan with
    inf and NaN where they skip tiles and where they do not, against the
    plain version: inf and NaN where it has them, the finite outputs at
    the usual tolerance."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_mix import fed_mix
    from repro_torch.kernels.fed_mix_q import fed_mix_q
    rows = lm_non_finite_cases(torch)
    for i, dt in enumerate((torch.float32, torch.bfloat16)):
        mn, mo, xn, xo = dense_inputs(torch, MAIN_D, MAIN_P, dt, seed=700 + i)
        place_non_finite(torch, xn)
        place_non_finite(torch, xo[:, 40:])
        got = fed_mix(mn, mo, xn, xo)
        torch.cuda.synchronize()
        err, atol, rtol, ok = compare_non_finite(
            torch, got, ref.fed_mix_ref(mn, mo, xn, xo))
        rows.append({"kernel": "fed_mix", "D": MAIN_D, "P": MAIN_P,
                     "dtype": str(dt)[6:], "non_finite": True,
                     "max_abs_err": err, "atol": atol, "rtol": rtol,
                     "ok": ok})
    for i, (chunk, dt) in enumerate(((CHUNK, torch.float32),
                                     (CHUNK, torch.bfloat16),
                                     (48, torch.float32))):
        mn, mo, q, sc, xo = quant_inputs(torch, MAIN_D, MAIN_P, chunk, dt,
                                         seed=710 + i)
        place_non_finite(torch, xo)
        sc[4, 2], sc[9, 3] = math.inf, math.nan
        got = fed_mix_q(mn, mo, q, sc, xo, chunk=chunk)
        torch.cuda.synchronize()
        err, atol, rtol, ok = compare_non_finite(
            torch, got, ref.fed_mix_q_ref(mn, mo, q, sc, xo, chunk=chunk))
        rows.append({"kernel": "fed_mix_q", "D": MAIN_D, "P": MAIN_P,
                     "chunk": chunk, "dtype": str(dt)[6:],
                     "non_finite": True, "max_abs_err": err, "atol": atol,
                     "rtol": rtol, "ok": ok})
    return rows


def lm_non_finite_cases(torch):
    """flash_attention at Hymba's 2048-position prefill (window 1024 with
    the 128 meta tokens, and a full layer), f32 and bf16, with inf and NaN
    in V at the last key (above the diagonal of every earlier query tile),
    at key 300 (outside the window of rows 1324 on: query tiles 21-31 skip
    its tile), at key 5 (a meta token, visible to every row) and key 1500,
    in K at key 900 and in Q at row 1000. ssd_scan at Hymba's and
    mamba2-130m's shapes, one call with inf and NaN in x and dt and one in
    B and C, each at row 100 of the first chunk (a source tile the output
    pass skips for rows 0-63) or row 30 (inside the diagonal tile), one
    batch element each."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    inf, nan = math.inf, math.nan
    rows = []
    for window in (LM_WINDOW, 0):
        for i, dt in enumerate((torch.float32, torch.bfloat16)):
            q, k, v = attention_inputs(torch, LM_B, LM_HQ, LM_HKV, LM_S,
                                       LM_HD, dt, seed=720 + i)
            v[0, 1, LM_S - 1, 3], v[1, 0, LM_S - 1, 7] = inf, nan
            v[2, 2, 300, 11], v[3, 4, 300, 13] = -inf, nan
            v[0, 3, 5, 17], v[1, 2, 1500, 19] = nan, inf
            k[2, 0, 900, 2], q[3, 7, 1000, 9] = inf, inf
            got = flash_attention(q, k, v, window=window, num_meta=LM_META)
            torch.cuda.synchronize()
            name = str(dt)[6:]
            err, atol, rtol, ok = compare_non_finite(
                torch, got, ref.flash_attention_ref(
                    q, k, v, window=window, num_meta=LM_META),
                FLASH_TOL[name])
            rows.append({"kernel": "flash_attention", "B": LM_B, "S": LM_S,
                         "window": window, "num_meta": LM_META,
                         "dtype": name, "non_finite": True,
                         "max_abs_err": err, "atol": atol, "rtol": rtol,
                         "ok": ok})
    # gemma-2b's shape (hd 256: both warpgroups' 128 columns), causal: V at
    # the last key in each half, at key 300 and a visited key 5, K and Q
    for i, dt in enumerate((torch.float32, torch.bfloat16)):
        q, k, v = attention_inputs(torch, LM_B, WIDE_HQ, WIDE_HKV, LM_S,
                                   WIDE_HD, dt, seed=740 + i)
        v[0, 0, LM_S - 1, 3], v[1, 0, LM_S - 1, 200] = inf, nan
        v[2, 0, 300, 11], v[3, 0, 300, 140] = -inf, nan
        v[0, 0, 5, 250], k[2, 0, 900, 130] = nan, inf
        q[3, 7, 1000, 9] = inf
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        name = str(dt)[6:]
        err, atol, rtol, ok = compare_non_finite(
            torch, got, ref.flash_attention_ref(q, k, v), FLASH_TOL[name])
        rows.append({"kernel": "flash_attention", "B": LM_B, "S": LM_S,
                     "hd": WIDE_HD, "window": 0, "num_meta": 0,
                     "dtype": name, "non_finite": True,
                     "max_abs_err": err, "atol": atol, "rtol": rtol,
                     "ok": ok})
    # MLA's (hd, vd) = (192, 128), 16 heads, causal and with a window and
    # meta tokens: V at the last key, at key 300 (outside the window of
    # later rows) and at visited keys 5 and 1500, K past v's width
    # (column 150) and Q
    for window, meta in ((0, 0), (LM_WINDOW, LM_META)):
        for i, dt in enumerate((torch.float32, torch.bfloat16)):
            q, k, v = attention_inputs(torch, 2, 16, 16, LM_S, MLA_HD, dt,
                                       seed=750 + i, vd=MLA_VD)
            v[0, 1, LM_S - 1, 3], v[1, 0, LM_S - 1, 127] = inf, nan
            v[0, 2, 300, 11], v[1, 4, 300, 64] = -inf, nan
            v[0, 3, 5, 17], v[1, 2, 1500, 19] = nan, inf
            k[0, 0, 900, 150], q[1, 7, 1000, 129] = inf, inf
            got = flash_attention(q, k, v, window=window, num_meta=meta)
            torch.cuda.synchronize()
            name = str(dt)[6:]
            err, atol, rtol, ok = compare_non_finite(
                torch, got, ref.flash_attention_ref(
                    q, k, v, window=window, num_meta=meta), FLASH_TOL[name])
            rows.append({"kernel": "flash_attention", "B": 2, "S": LM_S,
                         "hd": MLA_HD, "vd": MLA_VD, "window": window,
                         "num_meta": meta, "dtype": name, "non_finite": True,
                         "max_abs_err": err, "atol": atol, "rtol": rtol,
                         "ok": ok})
    for h, p, n, chunk in ((50, 64, 16, 128), (24, 64, 128, 256)):
        for j, names in enumerate((("x", "dt"), ("B", "C"))):
            args, _ = ssd_inputs(torch, LM_B, LM_S, h, p, n, 730 + j, False)
            x, dts, _, B, C = args
            where = {"x": lambda bb, r, v: x.__setitem__((bb, r, 1, 3), v),
                     "dt": lambda bb, r, v: dts.__setitem__((bb, r, 1), v),
                     "B": lambda bb, r, v: B.__setitem__((bb, r, 5), v),
                     "C": lambda bb, r, v: C.__setitem__((bb, r, 5), v)}
            for bb, (name, r, v) in enumerate(
                    ((names[0], 100, inf), (names[0], 30, nan),
                     (names[1], 100, inf), (names[1], 30, nan))):
                where[name](bb, r, v)
            y, st = ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            y_ref, st_ref = ref.ssd_chunked(*args, chunk)
            scale = float(y_ref[torch.isfinite(y_ref)].abs().max())
            err, atol, rtol, ok_y = compare_non_finite(
                torch, y, y_ref, (SSD_ATOL_SCALE * scale, SSD_RTOL))
            st_scale = float(st_ref[torch.isfinite(st_ref)].abs().max())
            _, _, _, ok_s = compare_non_finite(
                torch, st, st_ref, (SSD_ATOL_SCALE * st_scale, SSD_RTOL))
            rows.append({"kernel": "ssd_scan", "b": LM_B, "S": LM_S, "h": h,
                         "p": p, "n": n, "chunk": chunk,
                         "non_finite_in": list(names), "initial_state": False,
                         "dtype": "float32", "non_finite": True,
                         "max_abs_err": err, "atol": atol, "rtol": rtol,
                         "ok": ok_y and ok_s})
    return rows


def main_case(row):
    """Whether a kernels-phase row is at the main path's shape, f32."""
    if row.get("non_finite") or "bitwise_repeat" in row:
        return False
    if row["kernel"] == "flash_attention_bwd":
        return (row["B"], row["S"], row["hd"], row["window"],
                row["dtype"]) == (TRAIN_B, LM_S, LM_HD, LM_WINDOW, "float32")
    if row["kernel"] == "flash_attention_bwd_128":     # DBRX's training
        return (row["B"], row["Hq"], row["S"], row["hd"], row["dtype"]) == (
            MOE_TRAIN_B, 48, MOE_TRAIN_SEQ, 128, "float32")
    if row["kernel"] == "flash_attention_bwd_256":     # gemma-2b's training
        return (row["B"], row["Hq"], row["S"], row["hd"], row["dtype"]) == (
            1, WIDE_HQ, 2048, WIDE_HD, "float32")
    if row["kernel"] == "flash_attention_bwd_vd":
        return (row["B"], row["S"], row["hd"], row["vd"], row["dtype"]) == (
            MOE_TRAIN_B, MOE_TRAIN_SEQ, MLA_HD, MLA_VD, "float32")
    if row.get("lse"):
        return False
    if row["kernel"] == "ssd_scan_bwd":
        return (row["b"], row["S"], row["h"], row["initial_state"]) == (
            TRAIN_B, LM_S, 50, False)
    if row["kernel"] == "flash_attention":
        return (row["B"], row["S"], row["hd"], row["window"],
                row["dtype"]) == (LM_B, LM_S, LM_HD, LM_WINDOW, "float32")
    if row["kernel"] == "ssd_scan":
        return (row["b"], row["S"], row["h"], row["dtype"],
                row["initial_state"]) == (LM_B, LM_S, 50, "float32", True)
    return ((row["D"], row["P"], row["dtype"]) == (MAIN_D, MAIN_P, "float32")
            and row.get("chunk", CHUNK) == CHUNK
            and not row.get("non_finite"))


def cut_config(arch, layers):
    """``arch``'s published config with its depth cut to ``layers``."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), num_layers=layers)


def serving_configs():
    """(config, prompt lengths) of the serving runs after Hymba's:
    MOE_RUNS' and DENSE_RUNS' depth-cut configs and musicgen's (its
    prompt in frames)."""
    from repro_torch.configs import get_config
    return ([(cut_config(a, n), lens) for a, n, lens in MOE_RUNS]
            + [(cut_config(a, n), (DENSE_PROMPT,)) for a, n in DENSE_RUNS]
            + [(get_config(AUDIO_ARCH), (AUDIO_FRAMES,))])


def serving_flash_cases():
    """(B, Hq, Hkv, S, hd, window, num_meta, vd) of every flash_attention
    call that the prefills of ``serving_configs`` make, read from the
    configs: MLA expands the latent to every head at q/k's nope + rope and
    v's own head_dim; GQA keeps its kv heads at head_dim; the leading dense
    layers run at window 0, the stacked layers at their own."""
    from repro_torch.models.transformer import layer_windows
    cases = []
    for cfg, prompt_lens in serving_configs():
        if cfg.use_mla:
            hq = hkv = cfg.num_heads
            hd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            vd = cfg.v_head_dim
        else:
            hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            vd = hd
        m = cfg.num_meta_tokens
        windows = [0] * cfg.first_dense_layers + layer_windows(cfg)
        for prompt_len in prompt_lens:
            for w in windows:
                case = (LM_B, hq, hkv, prompt_len + m, hd, w, m, vd)
                if case not in cases:
                    cases.append(case)
    return cases


def lm_kernel_cases(torch):
    """flash_attention at Hymba's prefill shapes (S + M = 512 and 2048,
    window 0 and 1024, 128 meta tokens), the JAX kernel tests' sweep and a
    ragged S, head_dim 160-512, every shape of the MoE/MLA serving main
    path after Hymba's (``serving_flash_cases``: the MoE/MLA, dense, VLM
    and audio configs), and v's head_dim apart from q's and k's
    ((24, 16), (64, 32), (96, 128), (320, 256)); ssd_scan at Hymba's and mamba2-130m's shapes, the JAX sweep
    and a small chunk, with and without an initial state. Each against its
    plain version on the card."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    flash_cases = [(LM_B, LM_HQ, LM_HKV, s, LM_HD, w, LM_META)
                   for s in (LM_PROMPTS[0] + LM_META, LM_S)
                   for w in (0, LM_WINDOW)]
    flash_cases += [(2, 4, 2, 256, 64, w, 0) for w in (0, 96)]
    flash_cases += [(1, 2, 1, 512, 128, w, 0) for w in (0, 96)]
    flash_cases += [(2, 3, 3, 128, 32, w, 0) for w in (0, 96)]
    flash_cases += [(2, 4, 2, 200, 64, 64, 8)]           # ragged S
    flash_cases += [(FED_B, 12, 2, FED_SEQ, 128, 0, 0)]   # federated qwen2
    # head_dim > 128: gemma-2b's MQA at 2048 positions, GQA with a window
    # and meta tokens, hd 160 and 192 (flash_fwd_kernel_wgmma256, padded to
    # 256), hd 512 (the wide kernel's four slices)
    flash_cases += [(LM_B, WIDE_HQ, WIDE_HKV, LM_S, WIDE_HD, 0, 0),
                    (2, 4, 2, 300, 256, 96, 16), (2, 4, 1, 200, 160, 0, 0),
                    (2, 6, 2, 256, 192, 64, 5), (1, 2, 1, 333, 512, 0, 0),
                    (1, 4, 2, 200, 512, 64, 4)]
    flash_cases = [c + (c[4],) for c in flash_cases]
    # every shape the serving main path after Hymba's gives the kernel
    # (DeepSeek-V2's (192, 128) at 512 and 2048 tokens, DBRX's GQA 48/8 at
    # 128, gemma-2b's MQA at 256, nemotron's, yi's and chameleon's GQA
    # 48/8, 56/8 and 64/8 at 128, musicgen's MHA 24/24 at 64); v's
    # head_dim apart from q's and k's at the reduced MLA config's (24, 16),
    # and (64, 32), (96, 128), (320, 256) with GQA 4/1, a window and meta
    # tokens
    flash_cases += serving_flash_cases()
    flash_cases += [(2, 4, 4, 70, 24, 0, 0, 16)]
    flash_cases += [(2, 4, 1, 300, hd, 96, 16, vd)
                    for hd, vd in ((64, 32), (96, 128), (320, 256))]
    for i, (b, hq, hkv, s, hd, w, meta, vd) in enumerate(flash_cases):
        for dt in (f32, bf16):
            q, k, v = attention_inputs(torch, b, hq, hkv, s, hd, dt,
                                       seed=500 + i, vd=vd)
            got = flash_attention(q, k, v, window=w, num_meta=meta)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, window=w,
                                           num_meta=meta)
            name = str(dt)[6:]
            err, atol, rtol, ok = compare(torch, got, want,
                                          FLASH_TOL[name])
            ok = ok and got.dtype == dt and got.shape == (b, hq, s, vd)
            rows.append({"kernel": "flash_attention", "B": b, "Hq": hq,
                         "Hkv": hkv, "S": s, "hd": hd, "vd": vd, "window": w,
                         "num_meta": meta, "dtype": name,
                         "max_abs_err": err, "atol": atol, "rtol": rtol,
                         "ok": ok})
            del q, k, v, got, want
    ssd_cases = [(LM_B, LM_S, 50, 64, 16, 128),             # Hymba
                 (LM_B, LM_PROMPTS[0] + LM_META, 50, 64, 16, 128),
                 (LM_B, LM_S, 24, 64, 128, 256),            # mamba2-130m
                 (FED_B, FED_SEQ, 24, 64, 128, 256),        # its clients
                 (2, 128, 3, 16, 32, 32), (1, 256, 2, 64, 128, 64),
                 (2, 64, 1, 8, 16, 16),                     # the JAX sweep
                 (2, 100, 4, 16, 16, 20),                   # a small chunk
                 (2, 192, 3, 64, 8, 96),                    # n = 8, 96 rows
                 (1, 300, 5, 48, 24, 100)]                  # n = 24, 100 rows
    for i, (b, s, h, p, n, chunk) in enumerate(ssd_cases):
        for with_state in (False, True):
            args, init = ssd_inputs(torch, b, s, h, p, n, 600 + i,
                                    with_state)
            y, st = ssd_scan(*args, chunk=chunk, initial_state=init)
            torch.cuda.synchronize()
            y_ref, st_ref = ref.ssd_chunked(*args, chunk,
                                            initial_state=init)
            y64, st64 = ref.ssd_chunked(
                *[a.double() for a in args], chunk,
                initial_state=None if init is None else init.double())
            scale = float(y_ref.abs().max())
            err_y, atol, rtol, ok_y = compare(
                torch, y, y_ref, (SSD_ATOL_SCALE * scale, SSD_RTOL))
            err_s, _, _, ok_s = compare(
                torch, st, st_ref,
                (SSD_ATOL_SCALE * float(st_ref.abs().max()), SSD_RTOL))
            rows.append({"kernel": "ssd_scan", "b": b, "S": s, "h": h,
                         "p": p, "n": n, "chunk": chunk,
                         "initial_state": with_state, "dtype": "float32",
                         "max_abs_err": max(err_y, err_s),
                         "max_abs_err_state": err_s, "y_scale": scale,
                         "f64_err_kernel": float((y - y64).abs().max()),
                         "f64_err_plain": float((y_ref - y64).abs().max()),
                         "atol": atol, "rtol": rtol, "ok": ok_y and ok_s
                         and y.shape == args[0].shape})
    return rows


def flash_grads(torch, fn, q, k, v, dout, window, num_meta):
    """(out, dq, dk, dv) of ``fn`` (the kernel's wrapper or the plain
    version) by autograd, on copies of q, k, v that keep their layout."""
    qq, kk, vv = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(qq, kk, vv, window=window, num_meta=num_meta)
    out.backward(dout)
    torch.cuda.synchronize()
    return out.detach(), qq.grad, kk.grad, vv.grad


def ssd_grads(torch, fn, args, init, dy, dfinal, chunk):
    """(dx, d(dt), dA, dB, dC, d(initial state)) of ``fn`` (the kernel's
    wrapper or ``ref.ssd_chunked``) by autograd of sum(y·dy) (+ sum(final ·
    dfinal)); x, B and C stay slices of one conv output, as in the mixer."""
    x, dts, A, B, C = args
    h, p, n = x.shape[2], x.shape[3], B.shape[2]
    u = torch.cat([x.flatten(2), B, C], dim=-1).detach().requires_grad_(True)
    leaves = [u] + [t.detach().clone().requires_grad_(True) for t in (dts, A)]
    ii = None if init is None else init.detach().clone().requires_grad_(True)
    xx = u[..., :h * p].unflatten(-1, (h, p))
    if fn is None:
        from repro_torch.kernels import ref
        y, fin = ref.ssd_chunked(xx, leaves[1], leaves[2], u[..., h * p:h * p + n],
                                 u[..., h * p + n:], chunk, initial_state=ii)
    else:
        y, fin = fn(xx, leaves[1], leaves[2], u[..., h * p:h * p + n],
                    u[..., h * p + n:], chunk=chunk, initial_state=ii)
    loss = (y * dy.to(y.dtype)).sum()
    if dfinal is not None:
        loss = loss + (fin * dfinal.to(fin.dtype)).sum()
    loss.backward()
    torch.cuda.synchronize()
    g = u.grad
    return [g[..., :h * p].unflatten(-1, (h, p)), leaves[1].grad,
            leaves[2].grad, g[..., h * p:h * p + n], g[..., h * p + n:],
            None if ii is None else ii.grad]


def nan_mismatch(torch, got, want):
    """(positions where NaN differs, where +inf or -inf differs)."""
    return (int((torch.isnan(got) != torch.isnan(want)).sum()),
            int((torch.isposinf(got) != torch.isposinf(want)).sum()
                + (torch.isneginf(got) != torch.isneginf(want)).sum()))


def lm_backward_cases(torch):
    """The backward kernels against the plain version's autograd on the
    card: flash at Hymba's training layers (B 2, 25/5 heads of 64, 2048
    positions, window 1024 and a full layer, 128 meta tokens), qwen2-1.5b's
    head_dim 128 (12/2 heads), DBRX's (B 1, 48/8 of 128, 2048 positions:
    ``flash_attention_bwd_128``), an MQA layer, a ragged S, head_dim 32
    (reduced Hymba's), musicgen-medium's training shape (B 1, 24/24 heads
    of 64, 1500 frames: 23 full tiles and a 28-row one) and head_dim 256
    (gemma-2b's MQA training shape, and a ragged one with GQA, a window and
    meta tokens), f32 and bf16, each with the training forward's output
    (its log-sum-exp instantiation) held to the plain one as well; at v's
    own head_dim
    (``flash_attention_bwd_vd``) DeepSeek-V2's training shape (B 1, 128
    heads, 2048 positions, (192, 128)), a ragged S, the reduced config's
    (24, 16), (192, 128) with a window and meta tokens and (64, 32) with
    GQA 4/1, f32 and bf16, beside the wgmma forward's log-sum-exp against
    the plain one; the SSD at Hymba's (50 heads of 64,
    state 16, chunk 128) and mamba2-130m's (24 heads of 64, state 128, chunk
    256, and chunk 128 at the CLI's 128 tokens) shapes and two ragged ones,
    without an initial state (the final state's cotangent unused, as in
    training) and with one (the final state's cotangent random). Then a
    bit-for-bit repeat of two backward calls of each kernel, and the
    non-finite cases (gated): an inf or NaN in each input of each kernel,
    held to the plain autograd's inf and NaN positions."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        _launch, bwd_route, flash_attention, flash_attention_bwd,
        flash_attention_bwd_vd,
    )
    from repro_torch.kernels.ssd_scan import _launch as ssd_launch
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    flash_cases = [(TRAIN_B, LM_HQ, LM_HKV, LM_S, LM_HD, w, LM_META)
                   for w in (LM_WINDOW, 0)]
    flash_cases += [(TRAIN_B, 12, 2, LM_S, 128, 0, 0),      # qwen2-1.5b
                    (FED_B, 12, 2, FED_SEQ, 128, 0, 0),     # its clients
                    (MOE_TRAIN_B, 48, 8, MOE_TRAIN_SEQ, 128, 0, 0),  # DBRX
                    (TRAIN_B, 8, 1, 1024, 64, 0, 0),        # MQA
                    (2, 4, 2, 200, 64, 64, 8),              # ragged S
                    (2, 4, 2, 128, 32, 64, 8),              # reduced Hymba
                    (1, WIDE_HQ, WIDE_HKV, 2048, WIDE_HD, 0, 0),  # gemma-2b
                    (2, 4, 2, 300, 256, 96, 16),            # hd 256, ragged
                    (1, 24, 24, AUDIO_FRAMES, 64, 0, 0)]    # musicgen-medium
    flash_cases = [c + (c[4],) for c in flash_cases]
    # v's own head_dim: DeepSeek-V2's training shape, a ragged S, reduced
    # deepseek-v2's (24, 16), a window and meta tokens, GQA
    flash_cases += [(MOE_TRAIN_B, MLA_H, MLA_H, MOE_TRAIN_SEQ, MLA_HD, 0, 0,
                     MLA_VD),
                    (2, 4, 4, 200, MLA_HD, 0, 0, MLA_VD),
                    (2, 4, 4, 70, 24, 0, 0, 16),
                    (1, 2, 2, 300, MLA_HD, 96, 16, MLA_VD),
                    (2, 4, 1, 150, 64, 48, 5, 32)]
    for i, (b, hq, hkv, s, hd, w, meta, vd) in enumerate(flash_cases):
        kernel = bwd_route(hd, vd)
        for dt in (f32, bf16):
            q, k, v = attention_inputs(torch, b, hq, hkv, s, hd, dt,
                                       seed=800 + i, vd=vd)
            g = torch.Generator(device="cuda").manual_seed(850 + i)
            dout = torch.randn((b, hq, s, vd), device="cuda",
                               generator=g).to(dt)
            got = flash_grads(torch, flash_attention, q, k, v, dout, w, meta)
            want = flash_grads(torch, ref.flash_attention_ref, q, k, v, dout,
                               w, meta)
            w64 = flash_grads(torch, ref.flash_attention_ref,
                              *[t.double() for t in (q, k, v, dout)], w, meta)
            name = str(dt)[6:]
            # the training forward's output (its log-sum-exp
            # instantiation) too
            err_o, _, _, ok = compare(torch, got[0], want[0],
                                      FLASH_TOL[name])
            errs = {}
            for j, gname in enumerate(("dq", "dk", "dv"), start=1):
                err, atol, rtol, ok_g = compare(torch, got[j], want[j],
                                                FLASH_TOL[name])
                ok = ok and ok_g and got[j].dtype == dt
                errs[gname] = {"max_abs_err": err, "scale": float(
                    want[j].float().abs().max()),
                    "f64_err_kernel": float((got[j].double() - w64[j]).abs().max()),
                    "f64_err_plain": float((want[j].double() - w64[j]).abs().max())}
            rows.append({"kernel": kernel, "B": b, "Hq": hq,
                         "Hkv": hkv, "S": s, "hd": hd, "vd": vd, "window": w,
                         "num_meta": meta, "dtype": name,
                         "max_abs_err": max(e["max_abs_err"]
                                            for e in errs.values()),
                         "grads": errs, "forward_max_abs_err": err_o,
                         "atol": atol, "rtol": rtol, "ok": ok})
            del q, k, v, dout, got, want, w64
    # the wgmma forward's log-sum-exp (what K2 reads) and the ones at hd 256
    # and 128 (what the backward at 256 and 128 reads) against the plain
    # one: logsumexp of each row's visible scaled scores, in float64
    for i, (b, hq, s, hd, vd, w, meta) in enumerate((
            (MOE_TRAIN_B, MLA_H, MOE_TRAIN_SEQ, MLA_HD, MLA_VD, 0, 0),
            (2, 4, 70, 24, 16, 0, 0), (1, 2, 300, 160, 64, 96, 16),
            (1, WIDE_HQ, 512, WIDE_HD, WIDE_HD, 0, 0),     # wgmma256
            (1, 6, 333, 128, 128, 64, 8))):                # wgmma128
        for dt in (f32, bf16):
            q, k, v = attention_inputs(torch, b, hq, hq, s, hd, dt,
                                       seed=870 + i, vd=vd)
            lse = torch.empty((b, hq, s), device="cuda")
            out = _launch(q, k, v, w, meta, lse=lse)
            same = torch.equal(out, _launch(q, k, v, w, meta, lse=None))
            scores = torch.einsum("bhid,bhjd->bhij", q.double(),
                                  k.double()) * hd ** -0.5
            want = torch.logsumexp(scores.masked_fill(
                ~flash_mask(torch, s, w, meta), -math.inf), dim=-1)
            err, atol, rtol, ok = compare(torch, lse, want.float(),
                                          FLASH_TOL["float32"])
            rows.append({"kernel": "flash_attention", "lse": True, "B": b,
                         "Hq": hq, "S": s, "hd": hd, "vd": vd, "window": w,
                         "num_meta": meta, "dtype": str(dt)[6:],
                         "max_abs_err": err, "atol": atol, "rtol": rtol,
                         "output_equals_serving": same, "ok": ok and same})
            del q, k, v, scores, want
    ssd_cases = [(TRAIN_B, LM_S, 50, 64, 16, 128),         # Hymba
                 (TRAIN_B, LM_S, 24, 64, 128, 256),        # mamba2-130m
                 (FED_B, FED_SEQ, 24, 64, 128, 256),       # its clients
                 (8, 128, 24, 64, 128, 128),               # its CLI's batch
                 (2, 100, 4, 16, 16, 20),                  # a small chunk
                 (1, 300, 5, 48, 24, 100)]                 # ragged tiles
    for i, (b, s, h, p, n, chunk) in enumerate(ssd_cases):
        for with_state in (False, True):
            args, init = ssd_inputs(torch, b, s, h, p, n, 900 + i, with_state)
            g = torch.Generator(device="cuda").manual_seed(950 + i)
            dy = torch.randn((b, s, h, p), device="cuda", generator=g)
            dfin = (torch.randn((b, h, p, n), device="cuda", generator=g)
                    if with_state else None)
            got = ssd_grads(torch, ssd_scan, args, init, dy, dfin, chunk)
            want = ssd_grads(torch, None, args, init, dy, dfin, chunk)
            w64 = ssd_grads(torch, None, [a.double() for a in args],
                            None if init is None else init.double(),
                            dy.double(), None if dfin is None
                            else dfin.double(), chunk)
            errs, ok = {}, True
            for gname, gg, ww, w6 in zip(("dx", "ddt", "dA", "dB", "dC",
                                          "dinit"), got, want, w64):
                if ww is None:
                    continue
                scale = float(ww.abs().max())
                err, atol, rtol, ok_g = compare(
                    torch, gg, ww, (SSD_ATOL_SCALE * scale, SSD_RTOL))
                ok = ok and ok_g
                errs[gname] = {"max_abs_err": err, "scale": scale,
                               "f64_err_kernel": float((gg.double() - w6).abs().max()),
                               "f64_err_plain": float((ww.double() - w6).abs().max())}
            rows.append({"kernel": "ssd_scan_bwd", "b": b, "S": s, "h": h,
                         "p": p, "n": n, "chunk": chunk,
                         "initial_state": with_state, "dtype": "float32",
                         "max_abs_err": max(e["max_abs_err"]
                                            for e in errs.values()),
                         "grads": errs, "rtol": SSD_RTOL,
                         "atol_scale": SSD_ATOL_SCALE, "ok": ok})
    # two calls, the same bits (no float atomics)
    q, k, v = attention_inputs(torch, TRAIN_B, LM_HQ, LM_HKV, LM_S, LM_HD, f32,
                               seed=990)
    lse = torch.empty((TRAIN_B, LM_HQ, LM_S), device="cuda")
    out = _launch(q, k, v, LM_WINDOW, LM_META, lse=lse)
    dout = torch.randn_like(out)
    r1, r2 = [flash_attention_bwd(q, k, v, out, dout, lse, window=LM_WINDOW,
                                  num_meta=LM_META) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(r1, r2))
    rows.append({"kernel": "flash_attention_bwd", "bitwise_repeat": same,
                 "max_abs_err": 0.0, "ok": same})
    q, k, v = attention_inputs(torch, 1, WIDE_HQ, 2, 512, WIDE_HD, f32,
                               seed=993)
    lse = torch.empty((1, WIDE_HQ, 512), device="cuda")
    out = _launch(q, k, v, 0, 0, lse=lse)
    dout = torch.randn_like(out)
    r1, r2 = [flash_attention_bwd(q, k, v, out, dout, lse) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(r1, r2))
    rows.append({"kernel": "flash_attention_bwd_256", "hd": WIDE_HD,
                 "bitwise_repeat": same, "max_abs_err": 0.0, "ok": same})
    q, k, v = attention_inputs(torch, 1, 48, 8, 512, 128, f32, seed=994)
    lse = torch.empty((1, 48, 512), device="cuda")
    out = _launch(q, k, v, 0, 0, lse=lse)
    dout = torch.randn_like(out)
    r1, r2 = [flash_attention_bwd(q, k, v, out, dout, lse) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(r1, r2))
    rows.append({"kernel": "flash_attention_bwd_128", "hd": 128,
                 "bitwise_repeat": same, "max_abs_err": 0.0, "ok": same})
    for hq, hkv in ((16, 16), (16, 4)):
        q, k, v = attention_inputs(torch, 2, hq, hkv, 1024, MLA_HD,
                                   f32, seed=992, vd=MLA_VD)
        lse = torch.empty((2, hq, 1024), device="cuda")
        out = _launch(q, k, v, 0, 0, lse=lse)
        dout = torch.randn_like(out)
        r1, r2 = [flash_attention_bwd_vd(q, k, v, out, dout, lse)
                  for _ in range(2)]
        same = all(torch.equal(a, b) for a, b in zip(r1, r2))
        rows.append({"kernel": "flash_attention_bwd_vd", "Hq": hq,
                     "Hkv": hkv, "bitwise_repeat": same, "max_abs_err": 0.0,
                     "ok": same})
    for h, p, n, chunk in ((50, 64, 16, 128), (24, 64, 128, 256)):
        args, _ = ssd_inputs(torch, TRAIN_B, LM_S, h, p, n, 991, False)
        y, _, ws = ssd_launch(*args, chunk, None)
        dy = torch.randn_like(y)
        r1, r2 = [ssd_scan_bwd(*args, ws, dy, None, chunk=chunk)[:5]
                  for _ in range(2)]
        same = all(torch.equal(a, b) for a, b in zip(r1, r2))
        rows.append({"kernel": "ssd_scan_bwd", "h": h, "n": n,
                     "bitwise_repeat": same, "max_abs_err": 0.0, "ok": same})
    # non-finite inputs: each gradient's inf and NaN where the plain
    # autograd has them, its finite values at the finite cases' tolerance.
    # Flash at Hymba's window layer: a query row whose masked keys lie in
    # tiles the dK pass skips, a key the dQ pass skips for early and late
    # rows, a V entry and a dO row; the SSD at Hymba's and mamba2-130m's
    # shapes with the value at row 100 of a chunk (a tile the passes skip
    # for rows 0-63) or, for dY, row 30.
    flash_sites = (("q", (0, 7, 1500, 5)), ("k", (1, 2, 600, 9)),
                   ("v", (0, 3, 1200, 20)), ("dO", (1, 12, 40, 7)))
    for i, (tensor, index) in enumerate(flash_sites):
        for val in (math.inf, math.nan):
            q, k, v = attention_inputs(torch, TRAIN_B, LM_HQ, LM_HKV, LM_S,
                                       LM_HD, f32, seed=995 + i)
            dout = torch.randn((TRAIN_B, LM_HQ, LM_S, LM_HD), device="cuda")
            {"q": q, "k": k, "v": v, "dO": dout}[tensor][index] = val
            got = flash_grads(torch, flash_attention, q, k, v, dout,
                              LM_WINDOW, LM_META)
            want = flash_grads(torch, ref.flash_attention_ref, q, k, v, dout,
                               LM_WINDOW, LM_META)
            rows.append(non_finite_row(
                torch, "flash_attention_bwd", f"{val} in {tensor}{index}",
                ("dq", "dk", "dv"), got[1:], want[1:],
                lambda w: FLASH_TOL["float32"]))
    # hd 256 (flash_attention_bwd_256, 8-word masks), 448 positions, GQA
    # 4/2, window 96, 16 meta tokens: columns past 128 in tiles the passes
    # skip and visit
    wide_sites = (("q", (0, 1, 300, 200)), ("k", (0, 1, 100, 130)),
                  ("k", (0, 0, 5, 250)), ("v", (0, 1, 200, 140)),
                  ("dO", (0, 2, 40, 255)), ("dO", (0, 3, 400, 7)))
    for i, (tensor, index) in enumerate(wide_sites):
        for val in (math.inf, math.nan):
            q, k, v = attention_inputs(torch, 1, 4, 2, 448, WIDE_HD, f32,
                                       seed=1020 + i)
            dout = torch.randn((1, 4, 448, WIDE_HD), device="cuda")
            {"q": q, "k": k, "v": v, "dO": dout}[tensor][index] = val
            got = flash_grads(torch, flash_attention, q, k, v, dout, 96, 16)
            want = flash_grads(torch, ref.flash_attention_ref, q, k, v, dout,
                               96, 16)
            rows.append(non_finite_row(
                torch, "flash_attention_bwd_256", f"hd 256: {val} in "
                f"{tensor}{index}", ("dq", "dk", "dv"), got[1:], want[1:],
                lambda w: FLASH_TOL["float32"]))
    # hd 128 (flash_attention_bwd_128), 320 positions, GQA 14/2 (group 7),
    # window 70, 9 meta tokens: in tiles the passes skip and visit
    sites_128 = (("q", (0, 13, 300, 120)), ("k", (0, 1, 90, 65)),
                 ("v", (0, 1, 100, 127)), ("dO", (0, 4, 10, 100)))
    for i, (tensor, index) in enumerate(sites_128):
        for val in (math.inf, math.nan):
            q, k, v = attention_inputs(torch, 1, 14, 2, 320, 128, f32,
                                       seed=1040 + i)
            dout = torch.randn((1, 14, 320, 128), device="cuda")
            {"q": q, "k": k, "v": v, "dO": dout}[tensor][index] = val
            got = flash_grads(torch, flash_attention, q, k, v, dout, 70, 9)
            want = flash_grads(torch, ref.flash_attention_ref, q, k, v, dout,
                               70, 9)
            rows.append(non_finite_row(
                torch, "flash_attention_bwd_128", f"hd 128: {val} in "
                f"{tensor}{index}", ("dq", "dk", "dv", "o"),
                got[1:] + got[:1], want[1:] + want[:1],
                lambda w: FLASH_TOL["float32"]))
    # K2 at (192, 128), 448 positions, window 96, 16 meta tokens: a q row
    # (column 150: the third dK slice) whose masked keys lie in tiles the
    # dK/dV pass skips, keys the dQ pass skips for later rows (one a meta
    # token at column 170), a v entry, dO rows
    vd_sites = (("q", (0, 1, 300, 150)), ("k", (0, 2, 100, 9)),
                ("k", (0, 1, 5, 170)), ("v", (0, 3, 200, 20)),
                ("dO", (0, 0, 40, 100)), ("dO", (0, 2, 400, 7)))
    for i, (tensor, index) in enumerate(vd_sites):
        for val in (math.inf, math.nan):
            q, k, v = attention_inputs(torch, 1, 4, 4, 448, MLA_HD, f32,
                                       seed=1000 + i, vd=MLA_VD)
            dout = torch.randn((1, 4, 448, MLA_VD), device="cuda")
            {"q": q, "k": k, "v": v, "dO": dout}[tensor][index] = val
            got = flash_grads(torch, flash_attention, q, k, v, dout, 96, 16)
            want = flash_grads(torch, ref.flash_attention_ref, q, k, v, dout,
                               96, 16)
            rows.append(non_finite_row(
                torch, "flash_attention_bwd_vd", f"{val} in {tensor}{index}",
                ("dq", "dk", "dv"), got[1:], want[1:],
                lambda w: FLASH_TOL["float32"]))
    for h, p, n, chunk in ((50, 64, 16, 128), (24, 64, 128, 256)):
        for i, tensor in enumerate(("x", "dt", "B", "C", "dY")):
            args, _ = ssd_inputs(torch, TRAIN_B, LM_S, h, p, n, 996 + i,
                                 False)
            dy = torch.randn((TRAIN_B, LM_S, h, p), device="cuda")
            row = 30 if tensor == "dY" else 100
            target = {"x": (args[0], (0, row, 1, 3)),
                      "dt": (args[1], (1, row, 1)),
                      "B": (args[3], (0, row, 5)),
                      "C": (args[4], (1, row, 5)),
                      "dY": (dy, (0, row, 1, 3))}[tensor]
            target[0][target[1]] = math.inf
            got = ssd_grads(torch, ssd_scan, args, None, dy, None, chunk)
            want = ssd_grads(torch, None, args, None, dy, None, chunk)
            rows.append(non_finite_row(
                torch, "ssd_scan_bwd", f"inf in {tensor}{target[1]}",
                ("dx", "ddt", "dA", "dB", "dC"), got[:5], want[:5],
                lambda w: (SSD_ATOL_SCALE * finite_scale(torch, w),
                           SSD_RTOL), h=h, n=n))
    return rows


def finite_scale(torch, t):
    """The largest finite |value| of ``t`` (1 where none is finite)."""
    fin = t[torch.isfinite(t)]
    return float(fin.abs().max()) if fin.numel() else 1.0


def non_finite_row(torch, kernel, what, names, got, want, tol, **extra):
    """A gated kernels-phase row: for each gradient, NaN, +inf and -inf at
    the plain autograd's places and the finite values within ``tol(want)``
    = (atol, rtol)."""
    grads, ok, worst = {}, True, 0.0
    for gname, g, w in zip(names, got, want):
        nan_mis, inf_mis = nan_mismatch(torch, g, w)
        atol, rtol = tol(w)
        fin = torch.isfinite(w) & torch.isfinite(g)
        err = (g.float() - w.float()).abs()[fin]
        bound_ = atol + rtol * w.float().abs()[fin]
        ok_g = (nan_mis, inf_mis) == (0, 0) and bool((err <= bound_).all())
        e = float(err.max()) if err.numel() else 0.0
        worst = max(worst, e)
        grads[gname] = {"nan_mismatch": nan_mis, "inf_mismatch": inf_mis,
                        "non_finite": int((~torch.isfinite(w)).sum()),
                        "max_abs_err": e, "ok": ok_g}
        ok = ok and ok_g
    return {"kernel": kernel, "non_finite": what, **extra,
            "max_abs_err": worst, "grads": grads, "ok": ok}


def femnist_setup(full: bool):
    from repro_torch.config import FLConfig
    from repro_torch.configs.paper_models import CNN_FEMNIST, PaperNetConfig
    from repro_torch.data.federated import pseudo_femnist_federated
    if full:
        data = pseudo_femnist_federated(100, num_classes=62, seed=0)
        return CNN_FEMNIST, data, dict(lr=0.05)
    net = PaperNetConfig(name="cnn-small", kind="cnn", image_size=28,
                         channels=1, hidden=8, num_classes=10)
    data = pseudo_femnist_federated(12, per_client=20, num_classes=10, seed=1)
    return net, data, dict(num_clients=12, num_clusters=2,
                           devices_per_cluster=4, participation=4,
                           local_epochs=2, lr=0.05, straggler_rate=0.25)


def fault_plan(num_clients, rounds, seed):
    """A fault plan that drops clients and corrupts uploads in all three
    modes (nan, inf, bitflip) within ``rounds`` rounds; the first seed
    from ``seed`` on whose draw shows every mode."""
    from repro_torch.faults import CORRUPT_MODES, make_plan
    for s in range(seed, seed + 100):
        plan = make_plan(num_clients, rounds, seed=s, drop_rate=0.1,
                         corrupt_rate=0.1)
        modes = {m for spec in plan.specs for _, m in spec.corrupt}
        if modes == set(CORRUPT_MODES) and any(sp.drop for sp in plan.specs):
            return plan
    raise RuntimeError("no fault plan with every corrupt mode")


def phase_reference(torch, state):
    """The port on the card against the port on the CPU: same data, same
    initial weights, same draws (gossip_async's matchings and the int8
    wire's rounding noise included). Tolerance: train_loss rtol 1e-4
    (cuDNN and the kernels sum in other orders than the CPU over a few
    dozen SGD steps); accuracy within one test sample. The topology-aware
    protocol runs on the topology each simulator builds from the config's
    seed; the faulted fedp2p run (drops and all three corrupt modes) also
    holds its counters equal on both. The card's final params of the last
    run go through a checkpoint round trip, bit for bit."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.config import FLConfig
    from repro_torch.core.simulator import Simulator
    net, data, kw = femnist_setup(full=False)
    rows = []
    n_test = float(data.test_mask.sum())
    plan = fault_plan(kw["num_clusters"] * kw["devices_per_cluster"], 2, 0)
    final = None
    for algo, mix_path, sync, codec, faults in (
            ("fedp2p", "auto", 2, None, None),
            ("fedavg", "auto", 1, None, None),
            ("fedp2p", "dense", 1, None, None),
            ("gossip", "auto", 2, None, None),
            ("gossip_async", "auto", 1, None, None),
            ("fedp2p", "dense", 1, "int8", None),
            ("gossip", "auto", 1, "topk", None),
            ("fedp2p_topo", "auto", 1, None, None),
            ("fedp2p", "auto", 1, None, plan)):
        fl = FLConfig(sync_period=sync, mix_path=mix_path, **kw)
        out = {}
        sims = {dev: Simulator(net, data, fl, faults=faults, device=dev)
                for dev in ("cpu", "cuda")}
        eng = {dev: s.engine(algo, codec=codec) for dev, s in sims.items()}
        gen = torch.Generator(device="cpu").manual_seed(7)
        draws = [eng["cpu"].draw_round(gen) for _ in range(2)]
        for dev, e in eng.items():   # the engine moves the draws over
            final, m = e.run_rounds(sims[dev].init_params(0), None, 2,
                                    draws=draws)
            out[dev] = {k: v.cpu().tolist() for k, v in m.items()}
        lc, lg = out["cpu"]["train_loss"], out["cuda"]["train_loss"]
        ac, ag = out["cpu"]["acc"], out["cuda"]["acc"]
        ok = (all(abs(a - b) <= 1e-4 * abs(a) + 1e-6 for a, b in zip(lc, lg))
              and all(abs(a - b) <= 1.0 / n_test + 1e-6
                      for a, b in zip(ac, ag))
              and all(math.isfinite(v) for v in lg + ag))
        row = {"algorithm": algo, "mix_path": mix_path, "sync_period": sync,
               "codec": codec, "loss_cpu": lc, "loss_cuda": lg,
               "acc_cpu": ac, "acc_cuda": ag}
        if faults is not None:
            names = ("dropped", "rejected_rows", "retries",
                     "prefetch_fallbacks")
            row["counters_cpu"] = {n: out["cpu"][n] for n in names}
            row["counters_cuda"] = {n: out["cuda"][n] for n in names}
            drop = faults.dense_arrays(2, len(draws[0].sel))[0]
            ok = (ok and row["counters_cpu"] == row["counters_cuda"]
                  and out["cuda"]["dropped"]
                  == drop.sum(axis=1).astype(int).tolist()
                  and all(torch.isfinite(v).all() for v in final.values()))
        rows.append({**row, "ok": ok})
        if not ok:
            emit({"phase": "reference", "runs": rows})
            raise AssertionError(f"port on the card disagrees with the CPU "
                                 f"reference: {rows[-1]}")
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    save_checkpoint(str(ckpt), 2, final, metadata={"run": "faulted fedp2p"})
    back, _ = load_checkpoint(str(ckpt), final, device="cuda")
    same = all(torch.equal(back[k], v) and back[k].dtype == v.dtype
               and back[k].device == v.device for k, v in final.items())
    rows.append({"checkpoint_round_trip": "card params -> npz -> card",
                 "leaves": len(final), "ok": same})
    if not same:
        emit({"phase": "reference", "runs": rows})
        raise AssertionError("checkpoint round trip changed the params")
    sampled = sampled_reference(torch)
    rows += sampled
    if not all(r["ok"] for r in sampled):
        emit({"phase": "reference", "runs": rows})
        raise AssertionError(f"the sampled window on the card disagrees: "
                             f"{[r for r in sampled if not r['ok']]}")
    lm_rows = [lm_reference(torch), lm_train_reference(torch)]
    lm_rows += [moe_reference(torch, arch) for arch, _, _ in MOE_RUNS]
    lm_rows += [moe_train_reference(torch, "deepseek-v2-236b",
                                    "flash_attention_bwd_vd"),
                moe_train_reference(torch, "dbrx-132b",
                                    "flash_attention_bwd")]
    lm_rows += dense_reference(torch)
    lm_rows += fed_reference(torch)
    rows += lm_rows
    emit({"phase": "reference", "runs": rows})
    bad = [r for r in lm_rows if not r["ok"]]
    if bad:
        raise AssertionError(f"port on the card disagrees with the CPU "
                             f"reference: {bad}")


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def lm_reference(torch):
    """Reduced Hymba (two layers, width 256, GQA kept with
    num_kv_heads=2) on the card against the port on the CPU: the same
    seeded weights (drawn on the CPU), the same 70-token prompts (78
    positions with the 8 meta tokens, past the window of 64, in a cache of
    78 slots that decode then rings over: meta pinning and ring decode),
    prefill logits and 8 greedy decode steps (``serve_on_both``)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(LM_ARCH).reduced(), num_kv_heads=2)
    row = serve_on_both(torch, cfg, 70 + cfg.num_meta_tokens)
    return {"model": f"{LM_ARCH} reduced, num_kv_heads=2", **row}


def moe_reference(torch, arch):
    """Reduced ``arch`` (``cfg.reduced()``: two layers, width 256, 4
    experts; deepseek-v2's MLA at (24, 16) with q_lora_rank 0 and its
    leading dense layer) on the card against the port on the CPU as
    ``serve_on_both`` holds it, and every MoE layer's routing (expert ids
    and kept assignments) equal on the two devices in every step."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    orig, routes = moe.dispatch_indices, {"cpu": [], "cuda": []}

    def recording(idx, num_experts, capacity):
        out = orig(idx, num_experts, capacity)
        routes[idx.device.type].append((idx.cpu(), out[2].cpu()))
        return out

    moe.dispatch_indices = recording
    try:
        row = serve_on_both(torch, get_config(arch).reduced(), 78)
    finally:
        moe.dispatch_indices = orig
    rc, rg = routes["cpu"], routes["cuda"]
    same = len(rc) == len(rg) > 0 and all(
        torch.equal(ic, ig) and torch.equal(kc, kg)
        for (ic, kc), (ig, kg) in zip(rc, rg))
    return {"model": f"{arch} reduced", **row, "moe_layer_calls": len(rg),
            "routing_equal": same, "ok": row["ok"] and same}


def serve_on_both(torch, cfg, buf):
    """``cfg``'s seeded weights drawn on the CPU, then on each of the CPU
    and the card a prefill of the same 70-token prompts (B 2) into a cache
    of ``buf`` slots and 8 greedy decode steps (audio: 70 seeded frame
    embeddings and a conditioning context, then 8 seeded frames; its
    tokens each codebook's argmax). Tolerance: logits within rtol 1e-4 and
    1e-4 of their scale (the kernels and cuBLAS sum in other orders than
    the CPU's plain versions); equal tokens."""
    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models.model import build_model
    model = build_model(cfg)
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    audio = cfg.family == "audio"
    if audio:
        batch = {"embeds": rng.standard_normal((2, 70, cfg.d_model)),
                 "cross_context": rng.standard_normal(
                     (2, cfg.cross_context_len, cfg.cross_context_dim))}
        frames = rng.standard_normal((8, 2, 1, cfg.d_model))
        batch = {k: torch.from_numpy(v).float() for k, v in batch.items()}
        frames = torch.from_numpy(frames).float()
    else:
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 70)))}
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(params, dev)
        cache = model.make_cache(2, buf, device=dev,
                                 cross_len=cfg.cross_context_len
                                 if audio else 0)
        logits, cache = prefill(p, {k: v.to(dev) for k, v in batch.items()},
                                cache)
        steps, toks = [logits[:, -1]], []
        for i in range(8):
            toks.append(serve._sample(steps[-1], 0.0, None))
            step_in = ({"embed": frames[i].to(dev)} if audio
                       else {"token": toks[-1][:, None]})
            logits, cache = decode(p, cache, step_in)
            steps.append(logits)
        out[dev] = (torch.stack(steps).cpu(), torch.stack(toks).cpu())
    (lc, tc), (lg, tg) = out["cpu"], out["cuda"]
    err = float((lg - lc).abs().max())
    bound = 1e-4 * float(lc.abs().max())
    ok = (bool(torch.isfinite(lg).all()) and torch.equal(tc, tg)
          and bool(((lg - lc).abs() <= bound + 1e-4 * lc.abs()).all()))
    return {"prompt": 70, "decode_steps": 8, "max_abs_err_logits": err,
            "logits_scale": float(lc.abs().max()),
            "tokens_cpu": tc.transpose(0, 1).tolist(),
            "tokens_cuda": tg.transpose(0, 1).tolist(),
            "ok": ok}


def lm_train_reference(torch):
    """Training on the card against training on the CPU: reduced Hymba (two
    layers, width 128, GQA kept with num_kv_heads=2), 120 tokens a row (128
    positions with the 8 meta tokens, past the window of 64)
    (``train_on_both``)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(
        get_config(LM_ARCH).reduced(num_layers=2, max_d_model=128),
        num_kv_heads=2)
    row = train_on_both(torch, cfg, 120, ("flash_attention", "ssd_scan",
                                          "flash_attention_bwd",
                                          "ssd_scan_bwd"))
    return {"model": f"{LM_ARCH} reduced (2 layers, width 128), "
                     "num_kv_heads=2", **row}


def moe_train_reference(torch, arch, backward):
    """Training reduced ``arch`` (``cfg.reduced()``: two layers, width 256,
    4 experts; deepseek-v2's MLA at (24, 16) through ``backward``,
    flash_attention_bwd_vd) on the card against the CPU as
    ``train_on_both`` holds it, 96 tokens a row, and every MoE layer's
    routing (expert ids and kept assignments) of step 1's forward equal on
    the two devices."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    orig, routes = moe.dispatch_indices, {"cpu": [], "cuda": []}

    def recording(idx, num_experts, capacity):
        out = orig(idx, num_experts, capacity)
        routes[idx.device.type].append((idx.cpu(), out[2].cpu()))
        return out

    moe.dispatch_indices = recording
    try:
        row = train_on_both(torch, get_config(arch).reduced(), 96,
                            ("flash_attention", backward), routes=routes)
    finally:
        moe.dispatch_indices = orig
    rc, rg = routes["cpu"], routes["cuda"]
    same = len(rc) == len(rg) > 0 and all(
        torch.equal(ic, ig) and torch.equal(kc, kg)
        for (ic, kc), (ig, kg) in zip(rc, rg))
    return {"model": f"{arch} reduced", **row, "moe_layer_calls": len(rg),
            "routing_equal_step1": same, "ok": row["ok"] and same}


def dense_reference(torch):
    """The dense, VLM and audio configs reduced (two layers, width 256) on
    the card against the port on the CPU: gemma-2b at its published
    head_dim 256 (MQA 4/1: flash_fwd_kernel_wgmma256 and
    flash_attention_bwd_256), nemotron-4-15b, yi-34b and chameleon-34b at
    their published head_dim 128 with GQA kept (``num_kv_heads=2``:
    flash_fwd_kernel_wgmma128 and flash_attention_bwd_128) and
    musicgen-medium; each served as ``serve_on_both`` holds it (78 cache
    slots), and gemma-2b, nemotron-4-15b and musicgen-medium trained as
    ``train_on_both`` holds it (96 tokens or frames a row)."""
    import dataclasses

    from repro_torch.configs import get_config
    rows = []
    for arch, _ in DENSE_RUNS:
        keep = ({"head_dim": 256} if arch == "gemma-2b"
                else {"head_dim": 128, "num_kv_heads": 2})
        cfg = dataclasses.replace(get_config(arch).reduced(), **keep)
        rows.append({"model": f"{arch} reduced, {keep}",
                     **serve_on_both(torch, cfg, 78)})
        if arch in ("gemma-2b", "nemotron-4-15b"):   # the backward at 256, 128
            bwd = ("flash_attention_bwd_256" if arch == "gemma-2b"
                   else "flash_attention_bwd_128")
            rows.append({"model": f"{arch} reduced, {keep}",
                         **train_on_both(torch, cfg, 96,
                                         ("flash_attention", bwd))})
    cfg = get_config(AUDIO_ARCH).reduced()
    rows.append({"model": f"{AUDIO_ARCH} reduced",
                 **serve_on_both(torch, cfg, 78)})
    rows.append({"model": f"{AUDIO_ARCH} reduced",
                 **train_on_both(torch, cfg, 96, ("flash_attention",
                                                  "flash_attention_bwd"))})
    return rows


def train_on_both(torch, cfg, seq, kernels, routes=None):
    """``cfg`` trained on the CPU and on the card from the same weights
    (drawn on the CPU), B 2 x ``seq`` tokens of the synthetic stream
    (audio: seeded frame embeddings, a conditioning context and labels of
    its 4 codebooks).
    Tolerances: the step-1 loss at rtol 1e-5; every gradient leaf at step 1
    within 1e-4 of the leaf's largest |value| (the kernels, cuBLAS and the
    MoE gathers' index-accumulates sum in other orders than the CPU's
    plain versions); the losses of 3 AdamW steps at rtol 1e-3; each of
    ``kernels`` launched on the card. ``routes``: {device: list} that a
    recording router fills, cut here to step 1's loss and gradient."""
    from repro_torch.config import TrainConfig
    from repro_torch.data.lm import token_stream_batches
    from repro_torch.kernels.ops import tree_flatten
    from repro_torch.launch.steps import _loss_and_grad, build_train_step
    from repro_torch.models.model import build_model
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    if cfg.family == "audio":
        g = torch.Generator().manual_seed(0)
        batches = [{"embeds": torch.randn((2, seq, cfg.d_model), generator=g),
                    "cross_context": torch.randn(
                        (2, cfg.cross_context_len, cfg.cross_context_dim),
                        generator=g),
                    "labels": torch.randint(
                        0, cfg.vocab_size, (2, seq, cfg.num_codebooks),
                        generator=g)} for _ in range(3)]
    else:
        stream = token_stream_batches(cfg.vocab_size, 2, seq, seed=0)
        batches = [{k: torch.from_numpy(v) for k, v in next(stream).items()}
                   for _ in range(3)]
    counters = launch_counters()
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(params, dev)
        bs = [{k: v.to(dev) for k, v in b.items()} for b in batches]
        for fn in counters.values():
            fn.launches = 0
        loss, _, grads = _loss_and_grad(model, False)(p, bs[0])
        step1 = None if routes is None else len(routes[dev])
        step, opt = build_train_step(model, TrainConfig(lr=3e-3, remat=False))
        st, losses = opt.init(p), []
        for b in bs:
            p, st, m = step(p, st, b)
            losses.append(float(m["loss"]))
        if routes is not None:
            del routes[dev][step1:]           # step 1's forward only
        out[dev] = (float(loss), [g.cpu() for g in tree_flatten(grads)[0]],
                    losses, {k: counters[k].launches for k in kernels})
    (lc, gc, sc, _), (lg, gg, sg, launches) = out["cpu"], out["cuda"]
    leaf_err = [float((a - b).abs().max() / max(1e-30, float(b.abs().max())))
                for a, b in zip(gg, gc)]
    ok = (math.isfinite(lg) and abs(lg - lc) <= 1e-5 * abs(lc)
          and max(leaf_err) <= 1e-4
          and all(abs(a - b) <= 1e-3 * abs(b) for a, b in zip(sg, sc))
          and all(v > 0 for v in launches.values()))
    return {"train": f"3 AdamW steps, B 2 x {seq}",
            "loss_step1_cpu": lc, "loss_step1_cuda": lg,
            "grad_leaf_max_rel_err": max(leaf_err), "grad_leaves": len(gc),
            "losses_cpu": sc, "losses_cuda": sg,
            "launches_cuda": launches, "ok": ok}


def launch_counters():
    """{kernel name: its wrapper}, each wrapper carrying ``.launches``."""
    from repro_torch.kernels.fed_aggregate import fed_aggregate
    from repro_torch.kernels.fed_mix import fed_mix
    from repro_torch.kernels.fed_mix_q import fed_mix_q
    from repro_torch.kernels.fed_mix_sparse import (
        fed_mix_matching, fed_mix_segment,
    )
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_128,
        flash_attention_bwd_256, flash_attention_bwd_vd,
    )
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    return {"fed_mix_segment": fed_mix_segment, "fed_mix": fed_mix,
            "fed_mix_matching": fed_mix_matching, "fed_mix_q": fed_mix_q,
            "fed_aggregate": fed_aggregate,
            "flash_attention": flash_attention, "ssd_scan": ssd_scan,
            "flash_attention_bwd": flash_attention_bwd,
            "flash_attention_bwd_128": flash_attention_bwd_128,
            "flash_attention_bwd_256": flash_attention_bwd_256,
            "flash_attention_bwd_vd": flash_attention_bwd_vd,
            "ssd_scan_bwd": ssd_scan_bwd}


def expected(**counts):
    """An expected-launch dict naming every kernel (0 unless given)."""
    return {name: counts.get(name, 0) for name, _, _ in KERNELS}


def aggregate_run(torch, sim):
    """``ops.fed_aggregate_tree`` over the [P, ...] client models of one
    fedp2p round (``_round_rows``, made before the counters are reset),
    weighted by the participants' sample counts / their sum. Returns
    (drive, check): the call to count, and the comparison of its result
    with the plain version on the card."""
    from repro_torch.kernels import ops, ref
    eng = sim.engine("fedp2p")
    flat, spec = eng._pack_params(sim.init_params(0))
    draws = eng.draw_round(torch.Generator(device="cuda").manual_seed(5))
    rows, _, _ = eng._round_rows(spec, flat, draws)
    counts = sim.data_dev["counts"][draws.sel]
    w = counts / counts.sum()
    tree = ops.unpack_tree(rows, spec)
    out = {}

    def drive():
        out["tree"] = ops.fed_aggregate_tree(tree, w)

    def check():
        got = ops.pack_tree({k: v[None] for k, v in out["tree"].items()})[0]
        err, atol, rtol, ok = compare(torch, got[0],
                                      ref.fed_aggregate_ref(rows, w))
        return {"max_abs_err": err, "atol": atol, "rtol": rtol,
                "ok": ok and got.shape == (1, rows.shape[1])}

    return drive, check


def cluster_run(torch, sim):
    """``core.aggregation.cluster_then_global`` (the paper's two-stage
    ``Aggregate(·)``) over the [P, ...] client models of one fedp2p round
    (``_round_rows``, made before the counters are reset): the
    participants' sample counts, their 10 clusters, the round's survive
    mask. Returns (drive, check): the call to count (one ``fed_aggregate``
    launch), and the comparison of its result with the same function on
    the CPU (the plain version)."""
    from repro_torch.core import aggregation
    from repro_torch.kernels import ops
    eng = sim.engine("fedp2p")
    flat, spec = eng._pack_params(sim.init_params(0))
    draws = eng.draw_round(torch.Generator(device="cuda").manual_seed(6))
    rows, _, _ = eng._round_rows(spec, flat, draws)
    args = (sim.data_dev["counts"][draws.sel], draws.cluster_ids,
            eng.proto.num_clusters(sim.fl), draws.survive)
    tree = ops.unpack_tree(rows, spec)
    out = {}

    def drive():
        out["tree"] = aggregation.cluster_then_global(tree, *args)

    def check():
        want = aggregation.cluster_then_global(
            {k: v.cpu() for k, v in tree.items()},
            *[a.cpu() if hasattr(a, "cpu") else a for a in args])
        got = ops.pack_tree({k: v[None] for k, v in out["tree"].items()})[0]
        ref_flat = ops.pack_tree({k: v[None] for k, v in want.items()})[0]
        err, atol, rtol, ok = compare(torch, got[0].cpu(), ref_flat[0])
        return {"max_abs_err": err, "atol": atol, "rtol": rtol,
                "ok": ok and bool(torch.isfinite(got).all())}

    return drive, check


# ---------------------------------------------------------------------------
# sampled participation (SampledEngine over a ClientStateStore)
# ---------------------------------------------------------------------------

#: the small CNN's sampled runs: D = 24 enrolled over its 12 data clients,
#: K = 8 (its 2 clusters of 4)
SAMPLED_SMALL = dict(num_enrolled=24, participants_per_round=8)
#: the full-width sampled runs' enrollments
SAMPLED_MEMORY_D, SAMPLED_COLD_D, SAMPLED_FAULTED_D = 10_000, 1_000_000, 1_000


class cudnn_pinned:
    """cuDNN's deterministic algorithms for a with-block (its defaults
    vary between runs of the same round), restored after."""

    def __init__(self, torch):
        self.cudnn = torch.backends.cudnn

    def __enter__(self):
        self.saved = (self.cudnn.deterministic, self.cudnn.benchmark)
        self.cudnn.deterministic, self.cudnn.benchmark = True, False

    def __exit__(self, *exc):
        self.cudnn.deterministic, self.cudnn.benchmark = self.saved


def sampled_engine(torch, net, data, fl, algo, device, codec=None, depth=1,
                   faults=None):
    from repro_torch.core.simulator import Simulator
    from repro_torch.protocols import get
    from repro_torch.protocols.engine import SampledEngine
    data_dev = Simulator(net, data, fl, device=device).data_dev
    return SampledEngine(net, data_dev, fl, get(algo), codec=codec,
                         pipeline_depth=depth, faults=faults, device=device)


def close_rows(torch, got, want, rtol=1e-4, atol=1e-5):
    """(max |got - want|, within rtol/atol of want) for two tensors."""
    got, want = got.double().cpu(), want.double().cpu()
    diff = (got - want).abs()
    ok = bool((diff <= atol + rtol * want.abs()).all()) and bool(
        torch.isfinite(got).all())
    return float(diff.max()), ok


def sampled_reference(torch):
    """The sampled window on the card against the CPU, and against the
    dense round. (1) the small CNN, D = 24 enrolled over 12 data clients,
    K = 8: the same draws (made on the CPU) through the CPU and the card,
    fedp2p and gossip, 2 rounds; every stored row and the losses at rtol
    1e-4. (2) D == P == K = 8 on the card with cuDNN pinned: the sampled
    window and ``DenseEngine._round_rows`` of one draw set, bit for
    bit."""
    import numpy as np
    from repro_torch.config import FLConfig
    from repro_torch.models.paper_nets import init_paper_net
    from repro_torch.protocols.engine import DenseEngine
    net, data, kw = femnist_setup(full=False)
    params = init_paper_net(torch.Generator().manual_seed(0), net)
    fl = FLConfig(**kw, **SAMPLED_SMALL)
    rows = []
    for algo in ("fedp2p", "gossip"):
        eng = {dev: sampled_engine(torch, net, data, fl, algo, dev)
               for dev in ("cpu", "cuda")}
        gen = torch.Generator().manual_seed(3)
        draws = [eng["cpu"].draw_round(gen) for _ in range(2)]
        out = {}
        for dev, e in eng.items():
            e.init_store(tree_to(params, dev))
            m = e.run_rounds(None, 2, draws=draws)
            out[dev] = (m["train_loss"],
                        e.store.gather(np.arange(e.num_enrolled)).cpu())
        err, ok = close_rows(torch, out["cuda"][1], out["cpu"][1])
        ok = ok and np.allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                                atol=1e-6)
        rows.append({"sampled": algo, "enrolled": fl.enrolled,
                     "window": eng["cuda"].window,
                     "loss_cpu": out["cpu"][0].tolist(),
                     "loss_cuda": out["cuda"][0].tolist(),
                     "rows_max_abs_err": err, "ok": ok})
    full = FLConfig(**{**kw, "num_clients": 8, "participation": 8,
                       "num_enrolled": 8, "participants_per_round": 8})
    for algo in ("fedp2p", "gossip"):
        with cudnn_pinned(torch):
            se = sampled_engine(torch, net, data, full, algo, "cuda")
            dense = DenseEngine(net, se.data_dev, full, se.proto,
                                device="cuda")
            d = dense.draw_round(torch.Generator(device="cuda").manual_seed(9))
            flat, spec = dense._pack_params(tree_to(params, "cuda"))
            want, losses, _ = dense._round_rows(spec, flat, d)
            se.init_store(tree_to(params, "cuda"))
            loss = se.round(draws=d)
            same = (torch.equal(se.store.flat[d.sel], want)
                    and torch.equal(loss, losses.mean()))
        rows.append({"sampled_vs_dense": algo, "enrolled": 8, "window": 8,
                     "bit_for_bit": same, "ok": same})
    return rows


def store_digest(torch, store, base):
    """What a bit-for-bit comparison of two runs' stores needs, without
    keeping a second [D, width] buffer: the staleness vector, the touched
    clients' rows (and residuals), and whether every untouched row of a
    resident buffer still holds the enrollment row ``base``."""
    import numpy as np
    touched = np.flatnonzero(store.last_round >= 0)
    out = {"last_round": store.last_round.copy(),
           "rows": store.gather(touched).cpu()}
    if store.resident_flat() is None:
        out["overlay_ids"] = sorted(store._overlay)
        out["overlay"] = torch.from_numpy(np.stack(
            [store._overlay[c] for c in out["overlay_ids"]]))
        if store._residual_overlay:
            out["res"] = torch.from_numpy(np.stack(
                [store._residual_overlay[c] for c in out["overlay_ids"]
                 if c in store._residual_overlay]))
        return out
    flat, untouched = store.resident_flat(), store.last_round < 0
    mask = torch.from_numpy(untouched).to(flat.device)
    same = True
    for i in range(0, flat.shape[0], 1000):    # 1000-row chunks
        chunk = flat[i:i + 1000][mask[i:i + 1000]]
        same = same and bool((chunk == base).all())
    out["untouched_is_base"] = same
    if store._residual is not None:
        out["res"] = store.gather_residual(touched).cpu()
    return out


def same_digest(torch, a, b):
    import numpy as np
    if set(a) != set(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif isinstance(x, np.ndarray):
            if not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return a.get("untouched_is_base", True)


def sampled_depth_runs(torch, net, data, fl, algo, tier, depths, rounds,
                       params, *, codec=None, faults=None, seed=11):
    """``rounds`` sampled rounds at each pipeline depth, each from a fresh
    store and a fresh card generator of one seed; returns per depth the
    metrics, the store digest, the host seconds, the windows' device
    seconds (CUDA events around each window on its stream, read after the
    run: no synchronization inside it) and the engine's last store (the
    previous one freed before the next is made)."""
    from repro_torch.kernels import ops
    out = []
    base = ops.pack_tree({k: v[None] for k, v in params.items()})[0][0]
    for depth in depths:
        se = sampled_engine(torch, net, data, fl, algo, "cuda", codec=codec,
                            depth=depth, faults=faults)
        se.init_store(params, tier=tier)
        events, window = [], se._window

        def timed_window(*args, _window=window, _events=events, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            res = _window(*args, **kwargs)
            end.record()
            _events.append((start, end))
            return res

        se._window = timed_window
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = se.run_rounds(gen, rounds)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        window_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
        # the card's idle time between one window and the next: a round's
        # exposed time once the pipeline is full
        gaps = [b[1].elapsed_time(a[0]) / 1e3
                for b, a in zip(events, events[1:])]
        digest = store_digest(torch, se.store, base)
        out.append({"depth": depth, "metrics": m, "digest": digest,
                    "seconds": secs, "window_seconds": window_s,
                    "gap_seconds": gaps, "engine": se})
        se.store.close()
        if depth != depths[-1]:
            del se
            out[-1]["engine"] = None
            torch.cuda.empty_cache()
    return out


def sampled_main_path(torch, counters, totals, state):
    """The sampled engine at CNN-FEMNIST's full width (246,590 params; the
    100 data clients serve id % 100), cuDNN pinned so that depths can be
    compared bit for bit: each run's launch counters set to 0 just before
    its rounds and read just after.
      sampled_memory      fedp2p, D = 10,000 resident (9.86 GB), K = 100:
                          3 rounds at depth 1, then 3 at depth 2 from a
                          fresh store; rows, losses, staleness equal;
      sampled_cold        fedp2p, D = 10^6 on the checkpoint tier: 3
                          rounds at depths 1, 2 and 3, equal; the global
                          model from ``consensus()``;
      sampled_gossip_topk gossip with the topk wire, D = 10,000 resident
                          (its residuals resident too), K = 100: depths 1
                          and 2, equal;
      sampled_pareto      fedavg, pareto selection at rate 0.1, D = 10^6
                          cold, K = 100, 2 rounds: K distinct ids, all
                          available;
      sampled_faulted     fedp2p on the checkpoint tier, D = 1,000, under
                          drops, corrupt uploads, a read error every round
                          and a dead prefetch worker in round 1: depths 1
                          and 2 store the same rows and count the same
                          drops, rejections and retries; the fallback
                          comes at depth 2 only (depth 1 has no prefetch).
    """
    import numpy as np
    from repro_torch.config import FLConfig
    from repro_torch.faults import make_plan
    from repro_torch.kernels import ops
    net, data, kw = femnist_setup(full=True)
    from repro_torch.models.paper_nets import init_paper_net
    params = init_paper_net(torch.Generator().manual_seed(0), net,
                            device="cuda")
    plan = make_plan(SAMPLED_FAULTED_D, 3, seed=2, drop_rate=0.05,
                     corrupt_rate=0.05, read_error_rate=1.0,
                     kill_prefetch_rounds=(1,))
    runs = [  # label, FLConfig overrides, algo, tier, codec, depths,
        #       rounds, faults, expected launches
        ("sampled_memory", {"num_enrolled": SAMPLED_MEMORY_D}, "fedp2p",
         "memory", None, (1, 2), 3, None, expected(fed_mix_segment=6)),
        ("sampled_cold", {"num_enrolled": SAMPLED_COLD_D}, "fedp2p",
         "checkpoint", None, (1, 2, 3), 3, None,
         expected(fed_mix_segment=9)),
        ("sampled_gossip_topk", {"num_enrolled": SAMPLED_MEMORY_D,
                                 "participation": 100}, "gossip", "memory",
         "topk", (1, 2), 2, None, expected(fed_mix_matching=4)),
        ("sampled_faulted", {"num_enrolled": SAMPLED_FAULTED_D}, "fedp2p",
         "checkpoint", None, (1, 2), 3, plan, expected(fed_mix_segment=6)),
    ]
    rows = []
    with cudnn_pinned(torch):
        for label, over, algo, tier, codec, depths, rounds, faults, expect \
                in runs:
            fl = FLConfig(**{**kw, "participants_per_round": 100, **over})
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            res = sampled_depth_runs(torch, net, data, fl, algo, tier,
                                     depths, rounds, params, codec=codec,
                                     faults=faults)
            got = {k: fn.launches for k, fn in counters.items()}
            for k in totals:
                totals[k] += got[k]
            ref = res[0]
            losses = [r["metrics"]["train_loss"].tolist() for r in res]
            same = all(same_digest(torch, r["digest"], ref["digest"])
                       and r["metrics"]["train_loss"].tolist() == losses[0]
                       for r in res[1:])
            finite = all(np.isfinite(v).all() for v in losses)
            row = {"run": label, "protocol": algo, "tier": tier,
                   "codec": codec, "enrolled": fl.enrolled,
                   "window": res[-1]["engine"].window, "rounds": rounds,
                   "depths": list(depths), "train_loss": losses,
                   "touched": int((ref["digest"]["last_round"] >= 0).sum()),
                   "seconds_per_round": {
                       r["depth"]: r["seconds"] / rounds for r in res},
                   "window_device_s_per_round": {
                       r["depth"]: r["window_seconds"] / rounds
                       for r in res},
                   # what the host adds to a round beyond its window's
                   # device time (store, draws, patching, dispatch waits)
                   "exposed_s_per_round": {
                       r["depth"]: (r["seconds"] - r["window_seconds"])
                       / rounds for r in res},
                   "gap_s_between_windows": {
                       r["depth"]: r["gap_seconds"] for r in res},
                   "bit_for_bit": same, "launches": got,
                   "expected_launches": expect}
            ok = same and finite and got == expect
            se = res[-1]["engine"]
            if label == "sampled_cold":
                g = se.global_params()
                flat = ops.pack_tree({k: v[None] for k, v in g.items()})[0]
                cons = torch.from_numpy(se.store.consensus())
                row["global_from_consensus"] = bool(
                    torch.equal(flat[0].cpu(), cons)
                    and torch.isfinite(flat).all())
                ok = ok and row["global_from_consensus"]
                state["sampled_cold"] = {
                    k: row[k] for k in ("seconds_per_round",
                                        "window_device_s_per_round",
                                        "exposed_s_per_round")}
            if faults is not None:
                ms = [r["metrics"] for r in res]
                names = ("dropped", "rejected_rows", "retries",
                         "prefetch_fallbacks")
                row["counters"] = {r["depth"]: {n: r["metrics"][n].tolist()
                                                for n in names} for r in res}
                ok = (ok and all(np.array_equal(m[n], ms[0][n])
                                 for m in ms[1:] for n in names[:3])
                      and ms[0]["prefetch_fallbacks"].sum() == 0
                      and ms[1]["prefetch_fallbacks"].tolist() == [0, 1, 0]
                      and ms[0]["retries"].sum() >= 1
                      and ms[0]["dropped"].sum() >= 1
                      and ms[0]["rejected_rows"].sum() >= 1
                      and all(np.isfinite(r).all()
                              for r in se.store._overlay.values()))
            row["ok"] = bool(ok)
            rows.append(row)
            del res, se
            torch.cuda.empty_cache()
            if not ok:
                return rows
        rows.append(sampled_pareto_run(torch, net, data, kw, params,
                                       counters, totals))
    torch.cuda.empty_cache()
    return rows


def sampled_pareto_run(torch, net, data, kw, params, counters, totals):
    """fedavg with pareto selection over D = 10^6 cold clients at
    availability 0.1, K = 100, 2 rounds: each round's ids are distinct and
    every one was available (the availability mask is the first draw of a
    round; it is drawn again from a copy of the generator's state)."""
    import numpy as np
    from repro_torch.config import FLConfig
    fl = FLConfig(**{**kw, "num_enrolled": SAMPLED_COLD_D,
                     "participation": 100,
                     "participation_strategy": "pareto",
                     "participation_rate": 0.1})
    se = sampled_engine(torch, net, data, fl, "fedavg", "cuda")
    se.init_store(params, tier="checkpoint")
    gen = torch.Generator(device="cuda").manual_seed(13)
    draws, checks = [], []
    for _ in range(2):
        copy = torch.Generator(device="cuda")
        copy.set_state(gen.get_state())
        avail = torch.rand((fl.enrolled,), generator=copy,
                           device="cuda") < fl.participation_rate
        d = se.draw_round(gen)
        draws.append(d)
        ids = d.sel.cpu().numpy()
        checks.append({"distinct": len(set(ids.tolist())) == se.window,
                       "all_available": bool(avail[d.sel].all()),
                       "pool": int(avail.sum())})
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    m = se.run_rounds(None, 2, draws=draws)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in counters.items()}
    for k in totals:
        totals[k] += got[k]
    expect = expected(fed_mix_segment=2)
    ok = (all(c["distinct"] and c["all_available"] for c in checks)
          and np.isfinite(m["train_loss"]).all() and got == expect)
    se.store.close()
    return {"run": "sampled_pareto", "protocol": "fedavg",
            "tier": "checkpoint", "enrolled": fl.enrolled,
            "window": se.window, "rounds": 2, "selection": checks,
            "train_loss": m["train_loss"].tolist(),
            "seconds_per_round": secs / 2, "launches": got,
            "expected_launches": expect, "ok": bool(ok)}


def sampled_split(torch, state):
    """One sampled fedp2p round on the cold tier at D = 10^6, K = 100,
    split: the store gather (host seconds to the window on the card,
    synchronized), the window (device ms by CUDA events, and host
    seconds), the scatter (host seconds: the pinned copy back and the
    overlay write); 2 rounds at depth 1 with cuDNN pinned, after a warm
    round. Then 5 rounds at each of depths 1, 2 and 3 from fresh stores,
    the host's pinned-buffer cache warm from the runs before: a round's
    exposed time (wall seconds less its window's device seconds, which
    vary by several % from run to run; it includes the pipeline's fill
    and drain), the card's idle gaps between consecutive windows (a
    round's exposed time once the pipeline is full) and the share of
    depth 1's mean gap that depth d hides, 1 - gap(d) / gap(1)."""
    from repro_torch.config import FLConfig
    from repro_torch.models.paper_nets import init_paper_net
    net, data, kw = femnist_setup(full=True)
    fl = FLConfig(**{**kw, "num_enrolled": SAMPLED_COLD_D,
                     "participants_per_round": 100})
    params = init_paper_net(torch.Generator().manual_seed(0), net,
                            device="cuda")
    parts = {"gather_s": [], "window_ms": [], "window_host_s": [],
             "scatter_s": []}
    with cudnn_pinned(torch):
        se = sampled_engine(torch, net, data, fl, "fedp2p", "cuda")
        se.init_store(params, tier="checkpoint")
        gather, window, scatter = se.store.gather, se._window, \
            se.store.scatter

        def timed_gather(ids):
            t0 = time.perf_counter()
            out = gather(ids)
            torch.cuda.synchronize()
            parts["gather_s"].append(time.perf_counter() - t0)
            return out

        def timed_window(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            out = window(*args, **kwargs)
            end.record()
            end.synchronize()
            parts["window_host_s"].append(time.perf_counter() - t0)
            parts["window_ms"].append(start.elapsed_time(end))
            return out

        def timed_scatter(ids, rows):
            t0 = time.perf_counter()
            scatter(ids, rows)
            parts["scatter_s"].append(time.perf_counter() - t0)

        se.store.gather, se._window, se.store.scatter = \
            timed_gather, timed_window, timed_scatter
        se.run_rounds(torch.Generator(device="cuda").manual_seed(1), 3)
    mean = {k: sum(v[1:]) / len(v[1:]) for k, v in parts.items()}
    out = {"enrolled": fl.enrolled, "window": se.window,
           "rounds_timed": len(parts["gather_s"]) - 1, **mean,
           "store_s": mean["gather_s"] + mean["scatter_s"],
           "main_path_by_depth": state.get("sampled_cold")}
    del se
    steady = {}
    with cudnn_pinned(torch):
        for depth in (1, 2, 3):
            r = sampled_depth_runs(torch, net, data, fl, "fedp2p",
                                   "checkpoint", (depth,), 5, params,
                                   seed=21)[0]
            steady[depth] = {
                "s_per_round": r["seconds"] / 5,
                "window_device_s_per_round": r["window_seconds"] / 5,
                "exposed_s_per_round": (r["seconds"] - r["window_seconds"])
                / 5,
                "gap_s": r["gap_seconds"],
                "mean_gap_s": sum(r["gap_seconds"]) / len(r["gap_seconds"])}
            del r
            torch.cuda.empty_cache()
    out["steady"] = steady
    out["hidden_share"] = {
        d: 1.0 - steady[d]["mean_gap_s"] / steady[1]["mean_gap_s"]
        for d in (2, 3)}
    torch.cuda.empty_cache()
    return out


def phase_main_path(torch, state):
    from repro_torch.config import FLConfig
    from repro_torch.core.simulator import Simulator
    net, data, kw = femnist_setup(full=True)
    # gossip's participants: FLConfig.participation (default 10); 100 here,
    # the width of the fedp2p runs' mix
    g100 = {"participation": 100}
    # the JAX package's Table-1 participation for this net
    # (benchmarks/accuracy.py: L=5, Q=2, 10 participants; FedAvg's 10 is
    # FLConfig's default participation)
    table1 = {"num_clusters": 5, "devices_per_cluster": 2,
              "participation": 10}
    plan = fault_plan(100, 2, 1)
    runs = [  # (label, FLConfig overrides, run kwargs, expected launches)
        ("fedp2p", {}, dict(rounds=3, algorithm="fedp2p"),
         expected(fed_mix_segment=3)),
        ("fedp2p_sync2", {"sync_period": 2},
         dict(rounds=2, algorithm="fedp2p"), expected(fed_mix_segment=4)),
        ("fedavg", {}, dict(rounds=5, algorithm="fedavg"),
         expected(fed_mix_segment=5)),
        ("fedp2p_dense", {}, dict(rounds=2, algorithm="fedp2p",
                                  mix_path="dense"), expected(fed_mix=2)),
        ("fedp2p_table1", table1,
         dict(rounds=5, algorithm="fedp2p"), expected(fed_mix_segment=5)),
        # the topology-aware protocol through FLConfig.topology_aware, on
        # the topology the simulator builds (make_topology(100, seed=0))
        ("fedp2p_topo", {"topology_aware": True},
         dict(rounds=2, algorithm="fedp2p"), expected(fed_mix_segment=2)),
        ("fedp2p_topo_table1", {**table1, "topology_aware": True},
         dict(rounds=5, algorithm="fedp2p"), expected(fed_mix_segment=5)),
        # a fault plan: drops and nan, inf and bitflip uploads
        ("fedp2p_faulted", {"faults": plan},
         dict(rounds=2, algorithm="fedp2p"), expected(fed_mix_segment=2)),
        ("gossip", g100, dict(rounds=2, algorithm="gossip"),
         expected(fed_mix_matching=2)),
        ("gossip_async_sync2", {**g100, "sync_period": 2},
         dict(rounds=2, algorithm="gossip_async"),
         expected(fed_mix_matching=4)),
        ("gossip_dense", g100, dict(rounds=1, algorithm="gossip",
                                    mix_path="dense"), expected(fed_mix=1)),
        ("fedp2p_int8_dense", {}, dict(rounds=2, algorithm="fedp2p",
                                       codec="int8", mix_path="dense"),
         expected(fed_mix_q=2)),
        ("fedp2p_int8", {}, dict(rounds=2, algorithm="fedp2p",
                                 codec="int8"),
         expected(fed_mix_segment=2)),
        ("gossip_topk", g100, dict(rounds=2, algorithm="gossip",
                                   codec="topk"),
         expected(fed_mix_matching=2)),
        ("aggregate", {}, "aggregate", expected(fed_aggregate=1)),
        ("cluster_then_global", {}, "cluster_then_global",
         expected(fed_aggregate=1)),
    ]
    counters = launch_counters()
    totals = expected()
    results = []
    n_params = None
    t_fl = time.perf_counter()
    for label, over, run_kw, expect in runs:
        over = dict(over)
        faults = over.pop("faults", None)
        fl = FLConfig(**{**kw, **over})
        sim = Simulator(net, data, fl, faults=faults)
        if n_params is None:
            n_params = sum(v.numel() for v in sim.init_params(0).values())
        if isinstance(run_kw, str):
            drive, check = {"aggregate": aggregate_run,
                            "cluster_then_global": cluster_run}[run_kw](
                                torch, sim)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        if isinstance(run_kw, str):
            drive()
        else:
            hist = sim.run(**run_kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counters.items()}
        for k in totals:
            totals[k] += got[k]
        if isinstance(run_kw, str):
            row = {"run": label, "participants": fl.num_clusters
                   * fl.devices_per_cluster, "seconds": round(secs, 4),
                   **check(), "launches": got, "expected_launches": expect}
            finite = row["ok"]
        else:
            finite = all(math.isfinite(v) for v in
                         hist.train_loss + hist.acc + hist.acc_client_mean)
            row = {"run": label, "rounds": run_kw["rounds"],
                   "participants": sim.engine(run_kw["algorithm"]).proto
                   .num_participants(fl),
                   "sync_period": fl.sync_period,
                   "mix_path": run_kw.get("mix_path", fl.mix_path),
                   "codec": run_kw.get("codec", fl.codec),
                   "train_loss": hist.train_loss, "acc": hist.acc,
                   "acc_client_mean": hist.acc_client_mean,
                   "seconds": round(secs, 3),
                   "seconds_per_round": round(secs / run_kw["rounds"], 3),
                   "launches": got, "expected_launches": expect,
                   "finite": finite}
            if sim.engine(run_kw["algorithm"]).proto.needs_topology:
                row["protocol"] = "fedp2p_topo"
            if faults is not None:
                P = row["participants"]
                drop, flag, _ = faults.dense_arrays(run_kw["rounds"], P)
                row.update(dropped=hist.dropped,
                           rejected_rows=hist.rejected_rows,
                           plan_dropped=drop.sum(axis=1).astype(int).tolist(),
                           plan_flagged=flag.sum(axis=1).astype(int).tolist())
                finite = finite and hist.dropped == row["plan_dropped"] and all(
                    r >= f for r, f in zip(hist.rejected_rows,
                                           row["plan_flagged"]))
                row["finite"] = finite
        results.append(row)
        if not finite or got != expect:
            emit({"phase": "main_path", "params_per_client": n_params,
                  "runs": results})
            raise AssertionError(f"main path run {label!r} failed: {row}")
    print(f"chip_smoke: main_path/fl took {time.perf_counter() - t_fl:.1f} "
          "s", file=sys.stderr, flush=True)
    sampled = timed("main_path/sampled", sampled_main_path, torch,
                    counters, totals, state)
    if not all(r["ok"] for r in sampled):
        emit({"phase": "main_path", "params_per_client": n_params,
              "runs": results, "sampled": sampled})
        raise AssertionError(f"sampled run failed: {sampled[-1]}")
    lm_rows = timed("main_path/serve_hymba", lm_main_path, torch, counters,
                    totals, state)
    lm_rows += timed("main_path/serve_moe", moe_main_path, torch, counters,
                     totals)
    lm_rows += timed("main_path/serve_dense", dense_main_path, torch,
                     counters, totals)
    lm_rows += timed("main_path/serve_audio", audio_main_path, torch,
                     counters, totals)
    train_rows = timed("main_path/train_hymba", lm_train_main_path, torch,
                       counters, totals, state)
    train_rows += timed("main_path/train_moe", moe_train_main_path, torch,
                        counters, totals)
    train_rows += timed("main_path/train_dense", dense_train_main_path,
                        torch, counters, totals)
    fed_rows = timed("main_path/federated", fed_main_path, torch, counters,
                     totals)
    state["federated"] = fed_rows
    state["launches"] = totals
    emit({"phase": "main_path", "params_per_client": n_params,
          "runs": results, "sampled": sampled, "serving": lm_rows,
          "training": train_rows, "federated": fed_rows,
          "table1": table1_rows(results)})
    bad = [r for r in lm_rows + train_rows + fed_rows if not r["ok"]]
    if bad:
        raise AssertionError(f"serving, training or federated run failed: "
                             f"{bad}")


def table1_rows(results):
    """Table-1-style rows at the Table-1 participation (10 of 100): each
    protocol's best accuracy over the rounds run. Printed, not gated: a few
    rounds of one seed say little about the ranking."""
    by_label = {r["run"]: r for r in results}
    rows = []
    for proto, label in (("fedp2p", "fedp2p_table1"),
                         ("fedp2p_topo", "fedp2p_topo_table1"),
                         ("fedavg", "fedavg")):
        r = by_label[label]
        rows.append({"protocol": proto, "participants": r["participants"],
                     "rounds": r["rounds"], "best_acc": max(r["acc"]),
                     "seconds_per_round": r["seconds_per_round"]})
    return rows


def lm_main_path(torch, counters, totals, state):
    """``serve.generate`` on Hymba-1.5B at full width through the entry
    point: seeded weights drawn on the card once, B = 4, each prompt
    length once, 16 greedy tokens. Each run is one prefill (32 layers:
    32 flash_attention and 32 ssd_scan launches) and 15 decode steps (no
    kernel launches: plain PyTorch)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    cfg = get_config(LM_ARCH)
    params = build_model(cfg).init(0, device="cuda")
    n_params = sum(v.numel() for v in tree_leaves(params))
    expect = expected(flash_attention=cfg.num_layers,
                      ssd_scan=cfg.num_layers)
    rows = []
    for prompt_len in LM_PROMPTS:
        prompts = np.random.default_rng(prompt_len).integers(
            0, cfg.vocab_size, (LM_B, prompt_len)).astype(np.int32)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = serve.generate(LM_ARCH, prompts, reduced=False,
                             max_new_tokens=LM_NEW, params=params)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counters.items()}
        for k in totals:
            totals[k] += got[k]
        toks = out["tokens"]
        ok = (out["logits_finite"] and toks.shape == (LM_B, LM_NEW)
              and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
              and got == expect)
        rows.append({"run": f"serve_{LM_ARCH}", "params": n_params,
                     "batch": LM_B, "prompt": prompt_len,
                     "positions": prompt_len + cfg.num_meta_tokens,
                     "new_tokens": LM_NEW, "prefill_s": out["prefill_s"],
                     "decode_ms_per_token":
                         out["decode_s_per_token"] * 1e3,
                     "seconds": round(secs, 3),
                     "logits_finite": out["logits_finite"],
                     "tokens_head": toks[:, :6].tolist(), "launches": got,
                     "expected_launches": expect, "ok": ok})
    return rows


def generate_run(torch, counters, totals, cfg, params, prompt_len, expect):
    """One ``serve._generate`` run (``generate``'s body, which takes a
    depth-cut config) of seeded prompts, B = 4, 16 greedy tokens, driven
    with the launch counters set to 0 just before it and read just after:
    (its output, the seconds, the launches, ok)."""
    import numpy as np

    from repro_torch.launch import serve
    prompts = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (LM_B, prompt_len)).astype(np.int32)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = serve._generate(cfg, prompts, max_new_tokens=LM_NEW,
                          temperature=0.0, window=0, seed=0, verbose=False,
                          device=None, params=params, generator=None)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in counters.items()}
    for k in totals:
        totals[k] += got[k]
    toks = out["tokens"]
    ok = (out["logits_finite"] and toks.shape == (LM_B, LM_NEW)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
          and got == expect)
    return out, prompts, secs, got, ok


def weight_read_bytes(cfg, params):
    """The decode's weight-read bound's bytes: every weight read once a
    token, but the embedding table's gathered rows (an untied table; a
    tied one is read whole for the logits) and the cross-attention's key
    and value projections (decode reads the cached keys and values)."""
    n = sum(v.numel() for v in tree_leaves(params))
    if "embed" in params and not cfg.tie_embeddings:
        n -= params["embed"]["table"].numel()
    if cfg.cross_attend:
        n -= sum(params["layers"]["cross"][w].numel() for w in ("wk", "wv"))
    return 4 * n


def moe_main_path(torch, counters, totals):
    """The MoE/MLA serving path at every published width, through
    ``serve._generate`` (``generate_run``): seeded f32 weights drawn on the
    card once per model (the first freed before the second is drawn), B =
    4, 16 greedy tokens. Every layer's prefill attention is one
    flash_attention launch (deepseek-v2's MLA at (192, 128), its leading
    dense layer included; dbrx's GQA 48/8 at 128); decode launches no
    kernel. ``decode_bound_ms``: every weight but the embedding table read
    once a token (the capacity of 8 slots runs every expert at decode);
    ``expert_read_ms`` the experts' share of it."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    rows = []
    for arch, layers, prompt_lens in MOE_RUNS:
        cfg = cut_config(arch, layers)
        torch.cuda.reset_peak_memory_stats()
        params = build_model(cfg).init(0, device="cuda")
        n_params = sum(v.numel() for v in tree_leaves(params))
        experts = 4 * sum(params["layers"]["moe"][w].numel()
                          for w in ("w_in", "w_gate", "w_out"))
        expect = expected(flash_attention=layers)
        for prompt_len in prompt_lens:
            out, prompts, secs, got, ok = generate_run(
                torch, counters, totals, cfg, params, prompt_len, expect)
            rows.append({
                "run": f"serve_{arch}", "params": n_params,
                "param_bytes": 4 * n_params,
                "reduced": {"num_layers": [get_config(arch).num_layers,
                                           layers]},
                "batch": LM_B, "prompt": prompt_len, "new_tokens": LM_NEW,
                "prefill_s": out["prefill_s"],
                "decode_ms_per_token": out["decode_s_per_token"] * 1e3,
                "decode_bound_ms": weight_read_bytes(cfg, params)
                / HBM_BYTES_PER_S * 1e3,
                "expert_read_ms": experts / HBM_BYTES_PER_S * 1e3,
                "seconds": round(secs, 3),
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "logits_finite": out["logits_finite"],
                "tokens_head": out["tokens"][:, :6].tolist(),
                "launches": got, "expected_launches": expect, "ok": ok})
        # one prefill at the longest prompt and one decode step under
        # torch.profiler (not counted: the counters were read above)
        rows[-1]["device_split"] = kernel_split(
            torch, build_model(cfg), params,
            torch.from_numpy(prompts).cuda(), prompt_len + LM_NEW,
            decode=True)
        del params
        torch.cuda.empty_cache()
    return rows


def dense_main_path(torch, counters, totals):
    """The dense and VLM serving path at every published width
    (``DENSE_RUNS``: gemma-2b and nemotron-4-15b whole, yi-34b and
    chameleon-34b cut in depth to ~60 GB of f32 weights), through
    ``serve._generate`` (``generate_run``): seeded weights drawn on the card,
    each model freed before the next, B 4, a prompt of 2048, 16 greedy
    tokens. Each layer's prefill attention is one flash_attention launch
    (gemma's MQA at head_dim 256 on flash_fwd_kernel_wgmma256; the others'
    GQA at 128 on flash_fwd_kernel_wgmma128); decode launches none.
    chameleon's prompt is mixed text and image token ids of its unified
    vocabulary (its image tokenizer is a stub in the JAX package too).
    ``decode_bound_ms``: ``weight_read_bytes`` over the memory rate."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    rows = []
    for arch, layers in DENSE_RUNS:
        cfg = cut_config(arch, layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = build_model(cfg).init(0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(v.numel() for v in tree_leaves(params))
        expect = expected(flash_attention=layers)
        out, _, secs, got, ok = generate_run(
            torch, counters, totals, cfg, params, DENSE_PROMPT, expect)
        full = get_config(arch).num_layers
        rows.append({
            "run": f"serve_{arch}", "params": n_params,
            "param_bytes": 4 * n_params,
            "reduced": ({"num_layers": [full, layers]} if layers < full
                        else {}),
            "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
            "batch": LM_B, "prompt": DENSE_PROMPT, "new_tokens": LM_NEW,
            "init_s": init_s, "prefill_s": out["prefill_s"],
            "decode_ms_per_token": out["decode_s_per_token"] * 1e3,
            "decode_bound_ms": weight_read_bytes(cfg, params)
            / HBM_BYTES_PER_S * 1e3,
            "seconds": round(secs, 3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "logits_finite": out["logits_finite"],
            "tokens_head": out["tokens"][:, :6].tolist(), "launches": got,
            "expected_launches": expect, "ok": ok})
        del params
    torch.cuda.empty_cache()
    return rows


def audio_inputs(torch, cfg, b, frames, seed, labels=False):
    """musicgen's stub frontend on the card: seeded frame embeddings [b,
    frames, d] and a conditioning context [b, 64, 1536] (``labels``: the
    4 codebooks' seeded labels [b, frames, 4])."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"embeds": torch.randn((b, frames, cfg.d_model), device="cuda",
                                   generator=g),
             "cross_context": torch.randn(
                 (b, cfg.cross_context_len, cfg.cross_context_dim),
                 device="cuda", generator=g)}
    if labels:
        batch["labels"] = torch.randint(
            0, cfg.vocab_size, (b, frames, cfg.num_codebooks),
            device="cuda", generator=g)
    return batch


def audio_main_path(torch, counters, totals):
    """musicgen-medium at full width and depth through ``Model.prefill`` and
    ``Model.decode`` (the audio batch schema: ``generate`` takes tokens,
    and audio serves on embeddings, as in the JAX package): seeded weights
    drawn on the card, B 4, 1500 frames of seeded embeddings and a
    [4, 64, 1536] conditioning context, then 15 decode steps each fed the
    next seeded frame, driven with the launch counters set to 0 just
    before and read just after. The prefill is one flash_attention launch a
    layer (MHA 24/24 at 64; the cross-attention over 64 positions is plain,
    as in JAX), decode none. Logits [4, 1, 4, 2048], then [4, 4, 2048];
    each codebook's greedy token in range."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models.model import build_model
    cfg = get_config(AUDIO_ARCH)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, device="cuda")
    n_params = sum(v.numel() for v in tree_leaves(params))
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    batch = audio_inputs(torch, cfg, LM_B, AUDIO_FRAMES, seed=0)
    g = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.randn((LM_NEW - 1, LM_B, 1, cfg.d_model), device="cuda",
                         generator=g)
    cache = model.make_cache(LM_B, AUDIO_FRAMES + LM_NEW, device="cuda",
                             cross_len=cfg.cross_context_len)
    expect = expected(flash_attention=cfg.num_layers)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cache)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    shapes_ok = logits.shape == (LM_B, 1, cfg.num_codebooks, cfg.vocab_size)
    steps = [logits[:, -1]]
    t1 = time.perf_counter()
    for frame in frames:
        logits, cache = decode(params, cache, {"embed": frame})
        shapes_ok = shapes_ok and logits.shape == (
            LM_B, cfg.num_codebooks, cfg.vocab_size)
        steps.append(logits)
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t1) / (LM_NEW - 1)
    got = {k: fn.launches for k, fn in counters.items()}
    for k in totals:
        totals[k] += got[k]
    stacked = torch.stack(steps)
    toks = torch.argmax(stacked, dim=-1)           # [16, B, 4]
    finite = bool(torch.isfinite(stacked).all())
    cross_written = bool((cache["cross_k"].abs().amax(dim=(1, 2, 3, 4))
                          > 0).all())
    ok = (finite and shapes_ok and cross_written and got == expect
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size)
    row = {"run": f"serve_{AUDIO_ARCH}", "params": n_params,
           "param_bytes": 4 * n_params, "reduced": {},
           "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
           "batch": LM_B, "frames": AUDIO_FRAMES,
           "cross_context": [LM_B, cfg.cross_context_len,
                             cfg.cross_context_dim],
           "new_frames": LM_NEW, "prefill_s": t_prefill,
           "decode_ms_per_token": t_decode * 1e3,
           "decode_bound_ms": weight_read_bytes(cfg, params)
           / HBM_BYTES_PER_S * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "logits_finite": finite, "cross_kv_written": cross_written,
           "tokens_head": toks[:6, 0].tolist(), "launches": got,
           "expected_launches": expect, "ok": ok}
    del params, cache, batch, stacked, steps, logits
    torch.cuda.empty_cache()
    return [row]


def lm_train_main_path(torch, counters, totals, state):
    """``run_lm_training`` on Hymba-1.5B at full width through the entry
    point: B 2 x 1920 tokens (2048 positions with the meta tokens), its own
    TrainConfig (AdamW, lr 3e-3) with remat off for 4 steps, then with remat
    on for 2; each run driven with the launch counters set to 0 just before
    it and read just after. A step is 32 layers: 32 launches of each
    forward kernel (64 with remat: the backward recomputes each layer) and
    32 of each backward kernel. Then one step under torch.profiler for the
    device-time split, and the CLI's default run (mamba2-130m at full
    width, 20 steps) as a subprocess."""
    import os

    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    cfg = get_config(LM_ARCH)
    layers = cfg.num_layers
    torch.cuda.empty_cache()
    rows = []
    for label, steps, remat in (("plain", TRAIN_STEPS, False),
                                ("remat", TRAIN_REMAT_STEPS, True)):
        tc = TrainConfig(lr=3e-3, schedule="warmup_cosine",
                         warmup_steps=max(10, steps // 10), total_steps=steps,
                         remat=remat)
        fwd = layers * steps * (2 if remat else 1)
        expect = expected(flash_attention=fwd, ssd_scan=fwd,
                          flash_attention_bwd=layers * steps,
                          ssd_scan_bwd=layers * steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = train.run_lm_training(LM_ARCH, reduced=False, batch=TRAIN_B,
                                    seq_len=TRAIN_SEQ, steps=steps,
                                    train_cfg=tc, verbose=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counters.items()}
        for k in totals:
            totals[k] += got[k]
        later = out["step_seconds"][1:]
        s_step = sum(later) / len(later)
        losses = out["losses"]
        ok = (all(math.isfinite(v) for v in losses) and got == expect
              and abs(losses[0] - math.log(cfg.vocab_size))
              <= TRAIN_LOSS0_SLACK)
        rows.append({"run": f"train_{LM_ARCH}_{label}", "remat": remat,
                     "batch": TRAIN_B, "tokens": TRAIN_SEQ,
                     "positions": TRAIN_SEQ + LM_META, "steps": steps,
                     "losses": losses, "ln_vocab": math.log(cfg.vocab_size),
                     "step_seconds": out["step_seconds"],
                     "seconds_per_step": s_step,
                     "tokens_per_second": TRAIN_B * TRAIN_SEQ / s_step,
                     "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "seconds": secs, "launches": got,
                     "expected_launches": expect, "ok": ok})
    plain, remat = rows
    same = abs(remat["losses"][0] - plain["losses"][0]) <= 1e-5 * abs(
        plain["losses"][0])
    remat["step1_loss_equals_plain"] = same
    remat["ok"] = remat["ok"] and same
    rows.append({"run": "train_step_split", **train_split(torch)})
    rows[-1]["ok"] = True
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mode", "lm",
         "--arch", "mamba2-130m", "--full", "--steps", "20"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=600)
    last = cli.stdout.strip().splitlines()[-1] if cli.stdout.strip() else ""
    parts = last.split()
    a = b = math.nan
    if len(parts) == 4 and parts[0] == "loss" and parts[2] == "->":
        a, b = float(parts[1]), float(parts[3])
    rows.append({"run": "cli: python -m repro_torch.launch.train --mode lm "
                        "--arch mamba2-130m --full --steps 20",
                 "exit": cli.returncode, "last_line": last,
                 "stderr_tail": cli.stderr[-400:] if cli.returncode else "",
                 "ok": cli.returncode == 0 and math.isfinite(a)
                 and math.isfinite(b) and b < a})
    return rows


def moe_train_main_path(torch, counters, totals):
    """The MoE/MLA training path at every published width: the train step
    that ``run_lm_training`` runs (``build_train_step`` with its own
    TrainConfig: AdamW, lr 3e-3, warmup cosine, remat off), driven as
    ``run_lm_training``'s loop drives it on a config the entry point
    cannot take: ``MOE_TRAIN_RUNS``' depth and routed-expert cuts of
    deepseek-v2-236b and dbrx-132b, seeded f32 weights drawn on the card,
    B 1 x 2048 tokens of the synthetic stream, 3 steps, each model freed
    before the next. A step launches flash_attention once a layer and its
    backward (deepseek-v2's MLA: flash_attention_bwd_vd at (192, 128);
    dbrx's GQA 48/8 at 128: flash_attention_bwd_128) once a layer. Then one
    step under torch.profiler (``step_split``), and ``run_lm_training`` on
    each arch's reduced config through the entry point (4 layers, width
    256; 2 steps of B 2 x 64), every run with the counters set to 0 just
    before it and read just after."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.lm import token_stream_batches
    from repro_torch.kernels.flash_attention import bwd_route
    from repro_torch.launch import train
    rows = []
    steps, b, seq = MOE_TRAIN_STEPS, MOE_TRAIN_B, MOE_TRAIN_SEQ
    for arch, layers, experts in MOE_TRAIN_RUNS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers,
                                  num_experts=experts)
        bwd = ("flash_attention_bwd_vd" if cfg.use_mla
               else bwd_route(cfg.head_dim, cfg.head_dim))
        expect = expected(**{"flash_attention": layers * steps,
                             bwd: layers * steps})
        stream = token_stream_batches(cfg.vocab_size, b, seq, seed=0)
        row = train_steps_run(
            torch, counters, totals, cfg, steps, expect,
            lambda: {k: torch.from_numpy(v).cuda()
                     for k, v in next(stream).items()})
        row.update(run=f"train_{arch}",
                   reduced={"num_layers": [full.num_layers, layers],
                            "num_experts": [full.num_experts, experts]},
                   top_k=cfg.num_experts_per_tok, batch=b, tokens=seq,
                   tokens_per_second=b * seq / row["seconds_per_step"])
        rows.append(row)
    for arch, _, _ in MOE_TRAIN_RUNS:
        layers = 4                       # run_lm_training's reduced depth
        bwd = ("flash_attention_bwd_vd" if get_config(arch).use_mla
               else "flash_attention_bwd")
        expect = expected(**{"flash_attention": layers * 2,
                             bwd: layers * 2})
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        out = train.run_lm_training(arch, steps=2, batch=2, seq_len=64,
                                    verbose=False)
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in counters.items()}
        for k in totals:
            totals[k] += got[k]
        rows.append({"run": f"run_lm_training({arch!r}, reduced=True, "
                            "steps=2, batch=2, seq_len=64)",
                     "losses": out["losses"], "launches": got,
                     "expected_launches": expect,
                     "ok": all(math.isfinite(v) for v in out["losses"])
                     and got == expect})
    return rows


def train_steps_run(torch, counters, totals, cfg, steps, expect,
                    next_batch):
    """The train step that ``run_lm_training`` runs (``build_train_step``
    with its own TrainConfig: AdamW, lr 3e-3, warmup cosine, remat off) on
    ``cfg`` (a cut the entry point cannot take), driven as its loop drives
    it: seeded f32 weights drawn on the card, ``steps`` steps on
    ``next_batch()``'s batches, with the launch counters set to 0 just
    before and read just after (``expect``). Then one step under
    torch.profiler (``step_split``). The weights are freed before it
    returns. -> the row."""
    from repro_torch.config import TrainConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import build_model
    model = build_model(cfg)
    step_fn, opt = build_train_step(model, TrainConfig(
        lr=3e-3, schedule="warmup_cosine", warmup_steps=10,
        total_steps=steps, remat=False))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    live = {"p": model.init(0, device="cuda")}
    live["s"] = opt.init(live["p"])
    n_params = sum(v.numel() for v in tree_leaves(live["p"]))
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    losses, step_seconds = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        t_step = time.perf_counter()
        batch = next_batch()
        live["p"], live["s"], m = step_fn(live["p"], live["s"], batch)
        losses.append(float(m["loss"]))
        step_seconds.append(time.perf_counter() - t_step)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in counters.items()}
    for k in totals:
        totals[k] += got[k]
    peak = torch.cuda.max_memory_allocated() / 1e9
    later = step_seconds[1:]
    s_step = sum(later) / len(later)
    ok = (all(math.isfinite(v) for v in losses) and got == expect
          and abs(losses[0] - math.log(cfg.vocab_size)) <= TRAIN_LOSS0_SLACK)
    row = {"params": n_params, "remat": False, "steps": steps,
           "losses": losses, "ln_vocab": math.log(cfg.vocab_size),
           "step_seconds": step_seconds, "seconds_per_step": s_step,
           "peak_memory_gb": peak, "seconds": secs, "launches": got,
           "expected_launches": expect, "ok": ok}
    batch = next_batch()
    row["device_split"] = step_split(
        torch, step_fn, live, batch,
        {"flash_fwd_ms": "flash_fwd_kernel", "flash_bwd_ms": "flash_bwd_"})
    del live, batch, m
    torch.cuda.empty_cache()
    return row


def dense_train_main_path(torch, counters, totals):
    """Training the dense and audio configs at every published width
    (``DENSE_TRAIN_RUNS``: gemma-2b cut to 16 of 18 layers at 2048 tokens,
    musicgen-medium whole at 1500 frames; B 1, 3 AdamW steps) through
    ``train_steps_run``. gemma's batches are the synthetic token stream;
    musicgen's the audio schema's (seeded frame embeddings, a [1, 64,
    1536] context, labels [1, 1500, 4]), which ``run_lm_training``'s
    token stream cannot give. A step launches flash_attention once a layer
    and a backward kernel once a layer (gemma's MQA at head_dim 256:
    flash_attention_bwd_256; musicgen's MHA at 64: flash_attention_bwd)."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm import token_stream_batches
    from repro_torch.kernels.flash_attention import bwd_route
    rows = []
    steps = MOE_TRAIN_STEPS
    for arch, layers, seq in DENSE_TRAIN_RUNS:
        cfg = cut_config(arch, layers)
        expect = expected(**{"flash_attention": layers * steps,
                             bwd_route(cfg.head_dim, cfg.head_dim):
                             layers * steps})
        if cfg.family == "audio":
            seeds = iter(range(100, 100 + steps + 1))

            def next_batch(cfg=cfg, seq=seq, seeds=seeds):
                return audio_inputs(torch, cfg, 1, seq, next(seeds),
                                    labels=True)
        else:
            stream = token_stream_batches(cfg.vocab_size, 1, seq, seed=0)

            def next_batch(stream=stream):
                return {k: torch.from_numpy(v).cuda()
                        for k, v in next(stream).items()}
        row = train_steps_run(torch, counters, totals, cfg, steps, expect,
                              next_batch)
        full = get_config(arch).num_layers
        row.update(run=f"train_{arch}",
                   reduced=({"num_layers": [full, layers]} if layers < full
                            else {}),
                   heads=[cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
                   batch=1, tokens=seq, tokens_per_second=seq
                   / row["seconds_per_step"])
        rows.append(row)
    return rows


def step_split(torch, step_fn, live, batch, kernels):
    """One train step (its params and optimizer state in ``live``, updated)
    under torch.profiler: the summed device time of its kernels, split
    into the matrix products (cuBLAS), the hand-written kernels
    (``kernels``: {part: a substring of their names}), the optimizer
    (every kernel under ``train_step.optimizer``: clipping and AdamW) and
    the rest (elementwise, norms, the conv, the CE; the MoE routing,
    dispatch and gathers)."""
    def run():
        live["p"], live["s"], _ = step_fn(live["p"], live["s"], batch)

    per, opt_ms = profiled(torch, run, "train_step.optimizer")
    total = sum(per.values())
    parts = {"matmul_ms": sum(v for k, v in per.items() if any(
                 w in k.lower() for w in ("gemm", "cutlass", "xmma",
                                          "cublas"))),
             **{part: named_ms(per, name) for part, name in kernels.items()},
             "optimizer_ms": opt_ms}
    parts["rest_ms"] = total - sum(parts.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms": total, **parts,
            "shares": {k[:-3]: v / total for k, v in parts.items()},
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def train_split(torch):
    """One Hymba-1.5B train step at full width (B 2 x 1920 tokens, remat
    off, the step warmed up once) split as ``step_split`` splits it, with
    flash forward and backward and SSD forward and backward apart."""
    import numpy as np

    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import build_model
    model = build_model(get_config(LM_ARCH))
    step, opt = build_train_step(model, TrainConfig(lr=3e-3, remat=False))
    live = {"p": model.init(0, device="cuda")}
    live["s"] = opt.init(live["p"])
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, (TRAIN_B, TRAIN_SEQ))).cuda()
        for k in ("tokens", "labels")}
    live["p"], live["s"], _ = step(live["p"], live["s"], batch)
    torch.cuda.synchronize()
    out = step_split(torch, step, live, batch,
                     {"flash_fwd_ms": "flash_fwd_kernel",
                      "flash_bwd_ms": "flash_bwd_",
                      "ssd_fwd_ms": "ssd_scan_kernel",
                      "ssd_bwd_ms": "ssd_bwd_kernel"})
    del live
    torch.cuda.empty_cache()
    return out


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# federated LM training (MeshEngine): its kernels, reference, main path,
# mesh and timing
# ---------------------------------------------------------------------------

def fed_params(torch, arch, layers, dev="cuda"):
    """Parameters a client of ``arch`` at ``layers`` layers holds (every
    width published): the stacked layers are alike, so two small inits
    give the count at any depth."""
    from repro_torch.models.model import build_model
    sizes = []
    for n in (1, 2):
        p = build_model(cut_config(arch, n)).init(0, device=dev)
        sizes.append(sum(v.numel() for v in tree_leaves(p)))
        del p
    return sizes[0] + (layers - 1) * (sizes[1] - sizes[0])


def fed_counts(d):
    """The non-uniform per-client weights |D_i| of the federated runs."""
    import numpy as np
    return np.random.default_rng(FED_COUNTS_SEED).integers(
        1, 9, d).astype(np.float32)


def fed_batches(torch, vocab, rounds, d, steps, b, s, dev="cuda"):
    """[rounds, D, steps, B, S] token and label batches, client c on its
    own synthetic stream (seed 100 + c), as ``run_federated_training``
    stages them."""
    import numpy as np

    from repro_torch.data.lm import token_stream_batches
    streams = [token_stream_batches(vocab, b, s, seed=100 + c)
               for c in range(d)]
    staged = [[[next(streams[c]) for _ in range(steps)] for c in range(d)]
              for _ in range(rounds)]
    return {k: torch.from_numpy(np.stack([[np.stack([x[k] for x in client])
                                           for client in rnd]
                                          for rnd in staged])).to(dev)
            for k in ("tokens", "labels")}


# columns a plain mix takes at a time where the whole buffer's plain
# version would not fit beside the kernel's (``chunked_compare``)
COMPARE_COLUMNS = 1 << 26


def chunked_compare(torch, got, plain, p, align=1, tol=None, bitwise=False):
    """``got`` [D, p] against ``plain(c0, c1)``, the plain version on the
    columns [c0, c1) (the mixes are column-wise), COMPARE_COLUMNS at a
    time (``align`` divides each boundary): the plain version of a
    [D, 10^9] buffer needs room the card has not. -> (max abs err, atol,
    rtol, ok)."""
    step = COMPARE_COLUMNS // align * align
    err, ok, atol, rtol = 0.0, True, 0.0, 0.0
    for c0 in range(0, p, step):
        c1 = min(p, c0 + step)
        want = plain(c0, c1)
        part = got[:, c0:c1]
        if bitwise:
            ok = ok and torch.equal(part, want)
            e = float((part.float() - want.float()).abs().max())
        else:
            e, atol, rtol, o = compare(torch, part, want, tol)
            ok = ok and o
        err = max(err, e)
        del want
    return err, atol, rtol, ok


def fed_kernel_cases(torch):
    """The four mix kernels at the federated LM rows' shapes: mamba2-130m's
    P (D 8: fedp2p's L = 1 and 4, gossip's S = 2 and gossip_async's S = 1,
    the dense and the int8 products) and qwen2-1.5b's at FED_QWEN_LAYERS
    layers (D 4: D x P past 2^31), f32, each against its plain version on
    the card, column block by column block (``chunked_compare``);
    fed_mix_matching bit for bit. The int8 record is drawn directly
    (values in [-127, 127], positive scales): encoding a [4, 10^9] delta
    would need four times its size."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_mix import fed_mix
    from repro_torch.kernels.fed_mix_q import fed_mix_q
    from repro_torch.kernels.fed_mix_sparse import (
        fed_mix_matching, fed_mix_segment,
    )
    from repro_torch.configs import get_config
    f32 = torch.float32
    rows = []
    for (arch, d, nclu), layers in ((FED_MAMBA, None),
                                    (FED_QWEN, FED_QWEN_LAYERS)):
        layers = layers or get_config(arch).num_layers
        p = fed_params(torch, arch, layers)
        torch.cuda.empty_cache()
        base = {"arch": arch, "layers": layers, "D": d, "P": p,
                "dtype": "float32"}
        for nseg in (1, nclu):
            ids, wn, wo, xn, xo = segment_inputs(torch, d, p, nseg, f32,
                                                 seed=1400 + nseg)
            got = fed_mix_segment(ids, wn, wo, xn, xo, num_segments=nseg)
            torch.cuda.synchronize()
            err, atol, rtol, ok = chunked_compare(
                torch, got, lambda a, b: ref.fed_mix_segment_ref(
                    ids, wn, wo, xn[:, a:b].contiguous(),
                    xo[:, a:b].contiguous(), num_segments=nseg), p)
            rows.append({"kernel": "fed_mix_segment", **base, "L": nseg,
                         "max_abs_err": err, "atol": atol, "rtol": rtol,
                         "ok": ok and got.shape == (d, p)})
            del ids, wn, wo, xn, xo, got
        for stages in (2, 1):
            perms, sv, xn, xo = matching_inputs(torch, d, p, stages, f32,
                                                seed=1410 + stages)
            got = fed_mix_matching(perms, sv, xn, xo)
            torch.cuda.synchronize()
            err, _, _, ok = chunked_compare(
                torch, got, lambda a, b: ref.fed_mix_matching_ref(
                    perms, sv, xn[:, a:b].contiguous(),
                    xo[:, a:b].contiguous()), p, bitwise=True)
            rows.append({"kernel": "fed_mix_matching", **base, "S": stages,
                         "max_abs_err": err, "atol": 0.0, "rtol": 0.0,
                         "bitwise": ok, "ok": ok and got.shape == (d, p)})
            del perms, sv, xn, xo, got
        mn, mo, xn, xo = dense_inputs(torch, d, p, f32, seed=1420)
        got = fed_mix(mn, mo, xn, xo)
        torch.cuda.synchronize()
        err, atol, rtol, ok = chunked_compare(
            torch, got, lambda a, b: ref.fed_mix_ref(
                mn, mo, xn[:, a:b].contiguous(), xo[:, a:b].contiguous()), p)
        rows.append({"kernel": "fed_mix", **base, "max_abs_err": err,
                     "atol": atol, "rtol": rtol,
                     "ok": ok and got.shape == (d, p)})
        del xn, got
        g = torch.Generator(device="cuda").manual_seed(1430)
        pq = p + (-p) % CHUNK
        q = torch.randint(-127, 128, (d, pq), device="cuda", generator=g,
                          dtype=torch.int8)
        sc = 1e-4 * (torch.rand((d, pq // CHUNK), device="cuda",
                                generator=g) + 0.5)
        got = fed_mix_q(mn, mo, q, sc, xo, chunk=CHUNK)
        torch.cuda.synchronize()
        err, atol, rtol, ok = chunked_compare(
            torch, got, lambda a, b: ref.fed_mix_q_ref(
                mn, mo, q[:, a:b if b < p else pq].contiguous(),
                sc[:, a // CHUNK:-(-b // CHUNK)].contiguous(),
                xo[:, a:b].contiguous(), chunk=CHUNK), p, align=CHUNK)
        rows.append({"kernel": "fed_mix_q", **base, "Pq": pq,
                     "chunk": CHUNK, "max_abs_err": err, "atol": atol,
                     "rtol": rtol, "ok": ok and got.shape == (d, p)})
        del mn, mo, q, sc, xo, got
        torch.cuda.empty_cache()
    return rows


def fed_reference(torch):
    """Federated LM rounds on the card against the CPU, through
    ``MeshEngine.run_rounds``: the JAX package's reduced cut (2 layers,
    width 128) of mamba2-130m for fedp2p (sync_period 2), fedp2p_topo,
    fedavg, gossip and gossip_async; D 4 in 2 clusters, non-uniform counts, 2 local steps of B 2 x 64 tokens, a
    quarter of the clients straggling, 3 rounds with the same draws
    (drawn on the CPU, gossip_async's matchings included) and the same
    weights (drawn on the CPU). Tolerances as the training rows': the
    losses at rtol 1e-3, every parameter leaf within 1e-4 of its largest
    |value|; the card's run launches its kernels."""
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.core.fedp2p import broadcast_to_clients
    from repro_torch.kernels.ops import tree_flatten
    from repro_torch.models.model import build_model
    from repro_torch.protocols.engine import MeshEngine
    d, nclu, steps, rounds = 4, 2, 2, 3
    counters = launch_counters()
    rows = []
    for arch, algo, sp in (("mamba2-130m", "fedp2p", 2),
                           ("mamba2-130m", "fedp2p_topo", 1),
                           ("mamba2-130m", "fedavg", 1),
                           ("mamba2-130m", "gossip", 1),
                           ("mamba2-130m", "gossip_async", 1)):
        cfg = get_config(arch).reduced(num_layers=2, max_d_model=128)
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        fl = FLConfig(num_clusters=nclu, lr=5e-3, sync_period=sp,
                      straggler_rate=0.25)
        bt = fed_batches(torch, cfg.vocab_size, rounds, d, steps, 2, 64,
                         dev="cpu")
        engines = {dev: MeshEngine(model, fl, d, steps, algorithm=algo,
                                   counts=fed_counts(d), device=dev)
                   for dev in ("cpu", "cuda")}
        gen = torch.Generator(device="cpu").manual_seed(3)
        fp = broadcast_to_clients(params, d)
        draws = [engines["cpu"].draw_round(gen, fp) for _ in range(rounds)]
        out = {}
        for dev, eng in engines.items():
            for fn in counters.values():
                fn.launches = 0
            f, losses = eng.run_rounds(broadcast_to_clients(
                tree_to(params, dev), d), None, rounds,
                {k: v.to(dev) for k, v in bt.items()}, draws=draws)
            out[dev] = ([x.cpu() for x in tree_flatten(f)[0]],
                        losses.cpu().tolist(),
                        {k: c.launches for k, c in counters.items()
                         if c.launches})
        (fc, lc, _), (fg, lg, launches) = out["cpu"], out["cuda"]
        leaf_err = [float((a - b).abs().max()
                          / max(1e-30, float(b.abs().max())))
                    for a, b in zip(fg, fc)]
        ok = (all(math.isfinite(v) for v in lg)
              and all(abs(a - b) <= 1e-3 * abs(b) for a, b in zip(lg, lc))
              and max(leaf_err) <= 1e-4 and bool(launches))
        rows.append({"federated": f"{arch} reduced (2 layers, width 128)",
                     "algorithm": algo, "sync_period": sp, "clients": d,
                     "rounds": rounds, "losses_cpu": lc, "losses_cuda": lg,
                     "param_leaf_max_rel_err": max(leaf_err),
                     "launches_cuda": launches, "ok": ok})
    return rows


def fed_run(torch, counters, totals, engine, live, bt, rounds, expect,
            label, vocab, mode="run_rounds"):
    """One federated run on the card from ``live["params"]`` broadcast to
    the engine's clients, with the launch counters set to 0 just before
    and read just after (``expect``). ``mode``: "run_rounds", one
    ``MeshEngine.run_rounds`` call; "threaded", two, the stateful codec's
    residual carried from the first to the second; "round_fn", the rounds
    one ``round_fn`` call each (as ``core.fedp2p.make_federated_round``
    gives it), ``live["params"]`` dropped once broadcast: a round then
    holds three [D, sum(sizes)] buffers, where ``run_rounds``' caller
    keeps the first state alive through the call (a fourth). The first
    round's loss is held near ln ``vocab`` (random weights). -> the
    row."""
    from repro_torch.core.fedp2p import broadcast_to_clients
    from repro_torch.kernels.ops import tree_flatten
    d = engine.num_clients_dev
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fp = broadcast_to_clients(live["params"], d)
    if mode == "round_fn":
        del live["params"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    if mode == "threaded":
        half = {k: v[:rounds // 2] for k, v in bt.items()}
        rest = {k: v[rounds // 2:] for k, v in bt.items()}
        fp, l1, cstate = engine.run_rounds(fp, gen, rounds // 2, half)
        residual = float(cstate.abs().max())
        fp, l2, cstate = engine.run_rounds(fp, gen, rounds - rounds // 2,
                                           rest, codec_state=cstate)
        losses = torch.cat([l1, l2])
    elif mode == "round_fn":
        sp, losses = max(1, engine.fl.sync_period), []
        for t in range(rounds):
            fp, loss = engine.round_fn(
                fp, {k: v[t] for k, v in bt.items()},
                engine.draw_round(gen, fp),
                do_global_sync=(t + 1) % sp == 0, round_index=t)
            losses.append(loss)
        losses = torch.stack(losses)
    else:
        out = engine.run_rounds(fp, gen, rounds, bt)
        fp, losses = out[:2]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in counters.items()}
    for k in totals:
        totals[k] += got[k]
    losses = losses.cpu().tolist()
    finite = all(bool(torch.isfinite(x).all())
                 for x in tree_flatten(fp)[0])
    ok = (finite and all(math.isfinite(v) for v in losses)
          and abs(losses[0] - math.log(vocab)) <= TRAIN_LOSS0_SLACK
          and got == expect)
    row = {"run": label, "algorithm": engine.proto.name,
           "mix_path": engine.mix_path,
           "codec": engine.codec.name if engine.codec else "none",
           "sync_period": engine.fl.sync_period,
           "straggler_rate": engine.fl.straggler_rate, "clients": d,
           "rounds": rounds, "driven_by": mode, "losses": losses,
           "ln_vocab": math.log(vocab),
           "seconds": secs, "seconds_per_round": secs / rounds,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "params_finite": finite, "launches": got,
           "expected_launches": expect}
    if mode == "threaded":
        row["residual_after_first_call"] = residual
        ok = ok and residual > 0
    row["ok"] = ok
    del fp
    return row


def fed_main_path(torch, counters, totals):
    """Federated LM training on the card through ``MeshEngine`` (remat on,
    f32 SGD at lr 5e-3, non-uniform counts ``fed_counts``, B 4 x 512
    tokens, 2 local steps a client a round): mamba2-130m whole (24 layers,
    d_model 768; D 8 clients in L 4 clusters) with fedp2p at sync_period 2
    and a quarter of the clients straggling (4 rounds), fedavg, gossip,
    gossip_async, fedp2p on mix_path="dense" (``fed_mix``) and with the
    int8 wire on it (``fed_mix_q``), 2 rounds each, and topk's error
    feedback over two ``run_rounds`` calls of one round, the residual
    carried; then qwen2-1.5b at every published width cut to
    FED_QWEN_LAYERS of 28 layers (D 4 in L 2, fedp2p at sync_period 2, 2
    rounds of ``round_fn``: see ``fed_run``). A client step launches the
    SSD (or flash) forward twice a layer (remat recomputes it) and its
    backward once; a round, its protocol's mix kernel once."""
    import dataclasses

    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import bwd_route
    from repro_torch.models.model import build_model
    from repro_torch.protocols.engine import MeshEngine
    rows = []
    arch, d, nclu = FED_MAMBA
    cfg = get_config(arch)
    model = build_model(cfg)
    live = {"params": model.init(0, device="cuda")}
    n_params = sum(v.numel() for v in tree_leaves(live["params"]))
    per_round = cfg.num_layers * d * FED_STEPS
    runs = [  # (label, algorithm, FLConfig overrides, mix_path, codec,
              #  rounds, the mix kernel)
        ("fedp2p_sync2_stragglers", "fedp2p",
         dict(sync_period=2, straggler_rate=0.25), "auto", "none", 4,
         "fed_mix_segment"),
        ("fedavg", "fedavg", {}, "auto", "none", 2, "fed_mix_segment"),
        ("gossip", "gossip", {}, "auto", "none", 2, "fed_mix_matching"),
        ("gossip_async", "gossip_async", {}, "auto", "none", 2,
         "fed_mix_matching"),
        ("fedp2p_dense", "fedp2p", {}, "dense", "none", 2, "fed_mix"),
        ("fedp2p_int8_dense", "fedp2p", {}, "dense", "int8", 2,
         "fed_mix_q"),
        ("fedp2p_topk_threaded", "fedp2p", {}, "auto", "topk", 2,
         "fed_mix_segment")]
    bt = fed_batches(torch, cfg.vocab_size, 4, d, FED_STEPS, FED_B, FED_SEQ)
    for label, algo, over, mix_path, codec, rounds, mix in runs:
        fl = FLConfig(num_clusters=nclu, lr=5e-3, **over)
        eng = MeshEngine(model, fl, d, FED_STEPS, algorithm=algo,
                         counts=fed_counts(d), codec=codec,
                         mix_path=mix_path, device="cuda")
        expect = expected(**{"ssd_scan": 2 * per_round * rounds,
                             "ssd_scan_bwd": per_round * rounds,
                             mix: rounds})
        row = fed_run(torch, counters, totals, eng, live,
                      {k: v[:rounds] for k, v in bt.items()}, rounds,
                      expect, f"federated_{arch}_{label}", cfg.vocab_size,
                      "threaded" if label.endswith("threaded")
                      else "run_rounds")
        row.update(arch=arch, params_per_client=n_params, batch=FED_B,
                   tokens=FED_SEQ, local_steps=FED_STEPS)
        rows.append(row)
    del live, bt
    torch.cuda.empty_cache()
    arch, d, nclu = FED_QWEN
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=FED_QWEN_LAYERS)
    model = build_model(cfg)
    live = {"params": model.init(0, device="cuda")}
    n_params = sum(v.numel() for v in tree_leaves(live["params"]))
    rounds = 2
    per_round = cfg.num_layers * d * FED_STEPS
    eng = MeshEngine(model, FLConfig(num_clusters=nclu, lr=5e-3,
                                     sync_period=2), d, FED_STEPS,
                     algorithm="fedp2p", counts=fed_counts(d),
                     device="cuda")
    expect = expected(**{"flash_attention": 2 * per_round * rounds,
                         bwd_route(cfg.head_dim, cfg.head_dim):
                             per_round * rounds,
                         "fed_mix_segment": rounds})
    bt = fed_batches(torch, cfg.vocab_size, rounds, d, FED_STEPS, FED_B,
                     FED_SEQ)
    row = fed_run(torch, counters, totals, eng, live, bt, rounds, expect,
                  f"federated_{arch}_fedp2p_sync2", cfg.vocab_size,
                  "round_fn")
    row.update(arch=arch, params_per_client=n_params,
               reduced={"num_layers": [full.num_layers, FED_QWEN_LAYERS]},
               batch=FED_B, tokens=FED_SEQ, local_steps=FED_STEPS)
    rows.append(row)
    del live, bt, eng
    torch.cuda.empty_cache()
    return rows


def mesh_rank(rank, world, cases, seed):
    """One rank of the mesh phase (spawned by ``run_ranks``, gloo, every
    rank on card 0): f_new and f_old of ``world`` mamba2-130m clients drawn
    from ``seed`` on the card, the same on every rank; for each case this
    rank's rows mixed by ``psum_mix`` (``MeshEngine.mix`` on the mesh)
    against its rows of the one-card ``MeshEngine`` mix of all of them (on
    the same post-wire f_new for int8: the mesh's wire is per leaf). ->
    [(max abs err, ok)] a case."""
    import torch
    torch.cuda.set_device(0)
    from repro_torch import compression
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.core.fedp2p import broadcast_to_clients
    from repro_torch.kernels import backend
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import build_model
    from repro_torch.protocols.engine import MeshDraws, MeshEngine
    from repro_torch.sharding.rules import make_mesh_info
    backend.use_full_f32()
    info = make_mesh_info(None, make_debug_mesh(data=world))
    params = build_model(get_config(FED_MAMBA[0])).init(0, device="cuda")
    flat, spec = kernel_ops.packed_view(broadcast_to_clients(params, world))
    del params
    g = torch.Generator(device="cuda").manual_seed(seed)
    old = flat + 0.01 * torch.randn(flat.shape, device="cuda", generator=g)
    new = old + 0.01 * torch.randn(old.shape, device="cuda", generator=g)
    del flat
    rows = list(info.clients)
    int8 = compression.get("int8")
    fl = FLConfig(num_clusters=2, lr=5e-3)
    counts = torch.from_numpy(fed_counts(world))
    out = []
    for algo, survive, sync, codec, matching in cases:
        draws = MeshDraws(survive=torch.tensor(survive),
                          matching=None if matching is None
                          else torch.tensor(matching))
        want_new = new
        if codec == "int8":
            u = [torch.rand((world, int8.padded(n)), device="cuda",
                            generator=g) for n in spec.sizes]
            draws = MeshDraws(survive=draws.survive, matching=draws.matching,
                              wire_noise=tuple(u))
            want_new = kernel_ops.pack_tree(compression.wire_tree(
                int8, kernel_ops.unpack_tree(new, spec),
                kernel_ops.unpack_tree(old, spec), u=u))[0]
        one = MeshEngine(None, fl, world, 1, algorithm=algo, counts=counts,
                         device="cuda")
        want = kernel_ops.packed_view(one.mix(
            want_new, old, spec, MeshDraws(survive=draws.survive,
                                           matching=draws.matching),
            do_global_sync=sync)[0])[0][rows]
        del want_new
        eng = MeshEngine(None, fl, world, 1, algorithm=algo, counts=counts,
                         codec=codec, mesh_info=info, device="cuda")
        got = kernel_ops.packed_view(eng.mix(
            new[rows].contiguous(), old[rows].contiguous(), spec, draws,
            do_global_sync=sync)[0])[0]
        err, atol, rtol, ok = compare(torch, got, want, (1e-6, 1e-5))
        out.append((err, ok))
        del want, got, draws
        torch.cuda.empty_cache()
    return out


def nccl_round_rank(rank, world):
    """A fedp2p round of mamba2-130m whole at D 1 (2 local steps of B 4 x
    512) on an nccl world of one rank (spawned by ``run_ranks``):
    ``psum_mix`` over the process group against the one-card round from
    the same weights. -> the row."""
    import torch
    torch.cuda.set_device(0)
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.core.fedp2p import broadcast_to_clients
    from repro_torch.kernels import backend
    from repro_torch.kernels.ops import tree_flatten
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import build_model
    from repro_torch.protocols.engine import MeshDraws, MeshEngine
    from repro_torch.sharding.rules import make_mesh_info
    backend.use_full_f32()
    info = make_mesh_info(None, make_debug_mesh(data=1))
    cfg = get_config(FED_MAMBA[0])
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    bt = fed_batches(torch, cfg.vocab_size, 1, 1, FED_STEPS, FED_B, FED_SEQ)
    bt = {k: v[0] for k, v in bt.items()}
    fl = FLConfig(num_clusters=1, lr=5e-3)
    outs = []
    for mesh_info in (info, None):
        eng = MeshEngine(model, fl, 1, FED_STEPS, algorithm="fedp2p",
                         mesh_info=mesh_info, device="cuda")
        f, loss = eng.round_fn(broadcast_to_clients(params, 1), bt,
                               MeshDraws(survive=torch.ones(1)))
        outs.append(([x.float() for x in tree_flatten(f)[0]], float(loss)))
    (fm, lm), (f1, l1) = outs
    leaf_err = max(float((a - b).abs().max()
                         / max(1e-30, float(b.abs().max())))
                   for a, b in zip(fm, f1))
    return {"run": "nccl world of 1: fedp2p round, mamba2-130m",
            "loss_mesh": lm, "loss_one_card": l1,
            "param_leaf_max_rel_err": leaf_err,
            "ok": leaf_err <= 1e-4 and abs(lm - l1) <= 1e-4 * abs(l1)
            and math.isfinite(lm)}


def phase_mesh(torch, state):
    """The protocols' ``psum_mix`` on a mesh of MESH_RANKS ranks on the one
    card (``launch.mesh.run_ranks``: spawned processes, ``gloo`` with CUDA
    tensors — NCCL refuses two ranks on one device), one mamba2-130m
    client each, against the one-card ``MeshEngine`` mix on the same
    f_new and f_old at the JAX package's single-device tolerance (rtol
    1e-5, atol 1e-6): fedp2p, fedp2p_topo, fedavg, gossip and gossip_async
    with every client surviving and the global sync, and with stragglers
    and without it; the int8 wire (per leaf, on the card) on fedp2p and
    gossip_async. A rank that fails fails the phase. Then one round on an
    ``nccl`` world of one rank (``nccl_round_rank``, a spawned process:
    this one never joins a process group), against the one-card round
    (every parameter leaf within 1e-4 of its scale: cuDNN's convolution
    algorithms vary from run to run). The phase runs last: the timing
    phase's profiler windows come before any rank is started."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.protocols.async_gossip import matching_perm_stack
    world = MESH_RANKS
    ones = [1.0] * world
    strag = [0.0, 1.0, 1.0, 0.0][:world]
    r = matching_perm_stack(world).shape[0] - 1
    cases = []
    for algo in ("fedp2p", "fedp2p_topo", "fedavg", "gossip",
                 "gossip_async"):
        m = r if algo == "gossip_async" else None
        cases += [(algo, ones, True, "none", m),
                  (algo, strag, False, "none", m)]
    cases += [("fedp2p", strag, True, "int8", None),
              ("gossip_async", strag, True, "int8", 0)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    per_rank = run_ranks(mesh_rank, world, (cases, 5), backend="gloo",
                         timeout=600)
    secs = time.perf_counter() - t0
    rows = []
    for i, (algo, survive, sync, codec, m) in enumerate(cases):
        errs = [res[i][0] for res in per_rank]
        rows.append({"algorithm": algo, "survive": survive, "sync": sync,
                     "codec": codec, "matching": m, "max_abs_err": max(errs),
                     "atol": 1e-6, "rtol": 1e-5,
                     "ok": all(res[i][1] for res in per_rank)})
    # one round over NCCL, world size 1, in a process of its own
    nccl_row = run_ranks(nccl_round_rank, 1, backend="nccl",
                         timeout=600)[0]
    torch.cuda.empty_cache()
    emit({"phase": "mesh", "ranks": world, "backend": "gloo",
          "spawn_and_cases_seconds": secs, "cases": rows, "nccl": nccl_row})
    bad = [r for r in rows if not r["ok"]] + (
        [] if nccl_row["ok"] else [nccl_row])
    if bad:
        raise AssertionError(f"psum_mix on the mesh disagrees: {bad}")


def fed_timing(torch):
    """The mix kernels at mamba2-130m's P (D 8; fed_mix_segment at L = 1,
    fed_mix_matching at S = 2 as on the FL rows; fed_mix_segment also at
    qwen2-1.5b's FED_QWEN_LAYERS-layer P, D 4), each call after an L2
    flush and between CUDA events (``call_ms``: a profiler window once
    held fed_mix's redo pass but not its kernel here), beside their bytes
    bound (their plain versions are timed at the FL rows' shape); then
    one federated
    mamba2-130m round (fedp2p, D 8, 2 local steps of B 4 x 512) under
    torch.profiler, split into local training and the mix, with its host
    seconds."""
    from repro_torch.config import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.core.fedp2p import broadcast_to_clients
    from repro_torch.kernels.fed_mix import fed_mix
    from repro_torch.kernels.fed_mix_q import fed_mix_q
    from repro_torch.kernels.fed_mix_sparse import (
        fed_mix_matching, fed_mix_segment,
    )
    from repro_torch.models.model import build_model
    from repro_torch.protocols.engine import MeshEngine
    f32 = torch.float32
    rows = []
    arch, d, nclu = FED_MAMBA
    p = fed_params(torch, arch, get_config(arch).num_layers)
    for nseg in (1,):
        ids, wn, wo, xn, xo = segment_inputs(torch, d, p, nseg, f32, seed=7)
        byts = 3 * d * p * 4 + 3 * d * 4
        b_ms, b_by = bound(byts, 4 * d * p)
        rows.append({
            "name": "fed_mix_segment", "arch": arch, "D": d, "P": p,
            "L": nseg,
            "ms": call_ms(torch, lambda: fed_mix_segment(
                ids, wn, wo, xn, xo, num_segments=nseg)),
            "bytes": byts, "bound_ms": b_ms, "bound_by": b_by})
        del ids, wn, wo, xn, xo
    for stages in (2,):
        perms, sv, xn, xo = matching_inputs(torch, d, p, stages, f32, seed=8)
        byts = 3 * d * p * 4 + (stages + 1) * d * 4
        b_ms, b_by = bound(byts, (3 + 2 * stages) * d * p)
        rows.append({
            "name": "fed_mix_matching", "arch": arch, "D": d, "P": p,
            "S": stages,
            "ms": call_ms(torch, lambda: fed_mix_matching(perms, sv, xn,
                                                          xo)),
            "bytes": byts, "bound_ms": b_ms, "bound_by": b_by})
        del perms, sv, xn, xo
    mn, mo, xn, xo = dense_inputs(torch, d, p, f32, seed=9)
    byts = 3 * d * p * 4 + 2 * d * d * 4
    flops = 4 * d * d * p
    rows.append({
        "name": "fed_mix", "arch": arch, "D": d, "P": p,
        "ms": call_ms(torch, lambda: fed_mix(mn, mo, xn, xo)),
        "bytes": byts, **product_bounds(byts, flops)})
    del xn
    g = torch.Generator(device="cuda").manual_seed(10)
    pq = p + (-p) % CHUNK
    q = torch.randint(-127, 128, (d, pq), device="cuda", generator=g,
                      dtype=torch.int8)
    sc = 1e-4 * (torch.rand((d, pq // CHUNK), device="cuda", generator=g)
                 + 0.5)
    byts = q.numel() + sc.numel() * 4 + 2 * d * p * 4 + 2 * d * d * 4
    flops = 4 * d * d * p + q.numel()
    rows.append({
        "name": "fed_mix_q", "arch": arch, "D": d, "P": p, "Pq": pq,
        "ms": call_ms(torch, lambda: fed_mix_q(mn, mo, q, sc, xo,
                                               chunk=CHUNK)),
        "bytes": byts, **product_bounds(byts, flops)})
    del mn, mo, q, sc, xo
    torch.cuda.empty_cache()
    arch_q, d_q, _ = FED_QWEN
    p_q = fed_params(torch, arch_q, FED_QWEN_LAYERS)
    ids, wn, wo, xn, xo = segment_inputs(torch, d_q, p_q, 1, f32, seed=11)
    byts = 3 * d_q * p_q * 4 + 3 * d_q * 4
    b_ms, b_by = bound(byts, 4 * d_q * p_q)
    rows.append({
        "name": "fed_mix_segment", "arch": arch_q, "layers": FED_QWEN_LAYERS,
        "D": d_q, "P": p_q, "L": 1,
        "ms": call_ms(torch, lambda: fed_mix_segment(
            ids, wn, wo, xn, xo, num_segments=1), reps=3, warmup=1),
        "bytes": byts, "bound_ms": b_ms, "bound_by": b_by})
    del ids, wn, wo, xn, xo
    torch.cuda.empty_cache()
    for r in rows:
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
    # one round's split
    cfg = get_config(arch)
    model = build_model(cfg)
    eng = MeshEngine(model, FLConfig(num_clusters=nclu, lr=5e-3), d,
                     FED_STEPS, algorithm="fedp2p", counts=fed_counts(d),
                     device="cuda")
    fp = broadcast_to_clients(model.init(0, device="cuda"), d)
    bt = fed_batches(torch, cfg.vocab_size, 1, d, FED_STEPS, FED_B, FED_SEQ)
    bt = {k: v[0] for k, v in bt.items()}
    gen = torch.Generator(device="cuda").manual_seed(12)

    def one_round():
        return eng.round_fn(fp, bt, eng.draw_round(gen, fp))

    one_round()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_round()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    per, _ = profiled(torch, one_round, None)
    total = sum(per.values())
    mix = sum(v for k, v in per.items() if "segment_mix_kernel" in k)
    ssd = sum(v for k, v in per.items()
              if "ssd_scan_kernel" in k or "ssd_bwd_kernel" in k)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    split = {"arch": arch, "clients": d, "local_steps": FED_STEPS,
             "batch": FED_B, "tokens": FED_SEQ, "host_seconds": host_s,
             "device_ms": total, "mix_ms": mix,
             "local_training_ms": total - mix, "ssd_kernels_ms": ssd,
             "mix_share_of_device": mix / total,
             "device_busy_share_of_host": total / 1e3 / host_s,
             "top_kernels_ms": [[k[:90], v] for k, v in top]}
    del fp, eng, bt
    torch.cuda.empty_cache()
    return rows, split


# torch.profiler on the card has handed back, once in a run of dozens of
# windows, a window with no device kernel in it; such a window is profiled
# again, up to PROFILE_TRIES times, and each empty one is counted here and
# printed with the timing phase
PROFILE_TRIES = 3
PROFILER_NOTES = {"empty_windows": 0, "event_timed": 0}
EVENT_TIMED = "(whole call, CUDA events: torch.profiler recorded no kernel)"


def profiled(torch, fn, label):
    """Run ``fn`` under torch.profiler: ({kernel name: device ms}, the
    device ms of every kernel under the ``record_function`` events named
    ``label``). A ``record_function`` also leaves a span on the device's
    timeline (a user annotation, not a kernel): it is counted in neither.
    A window with no device kernel is run again, up to ``PROFILE_TRIES``
    windows in all; the last one's result is returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per = {}
        for evt in prof.key_averages():
            if (evt.device_type == DeviceType.CUDA
                    and evt.device_time_total > 0
                    and not getattr(evt, "is_user_annotation", False)
                    and evt.key != label):
                per[evt.key] = (per.get(evt.key, 0.0)
                                + evt.device_time_total / 1e3)
        if per:
            break
        PROFILER_NOTES["empty_windows"] += 1
        print(f"chip_smoke: torch.profiler recorded no device kernels "
              f"(window {attempt} of {PROFILE_TRIES})", file=sys.stderr,
              flush=True)
    return per, sum(e.device_time_total for e in prof.events()
                    if e.name == label
                    and e.device_type == DeviceType.CPU) / 1e3


# Between the timed calls of a kernel whose inputs would otherwise stay
# partly in the 50 MB L2 (the FL kernels' ~100-300 MB), a scratch buffer of
# twice the L2 is written: each call then reads its inputs from device
# memory, as the main path's round does after local training. The flush's
# own kernel is a fill of a uint8 buffer, which no timed call launches, and
# is left out of the times by that name.
L2_FLUSH_BYTES = 2 * 50 * 2**20
L2_FLUSH_KERNEL = "FillFunctor<unsigned char>"
_L2_SCRATCH = []


def l2_flush(torch):
    """Write L2_FLUSH_BYTES of scratch (allocated once): evicts the L2."""
    if not _L2_SCRATCH:
        _L2_SCRATCH.append(torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                       device="cuda"))
    _L2_SCRATCH[0].fill_(1)


def device_ms(torch, fn, reps=20, warmup=3, flush=False):
    """Call ``fn`` ``warmup`` times, then ``reps`` times under
    torch.profiler; returns {kernel name: device ms per call}. Only the
    device's own kernel events are read: a CPU op's "self device time"
    repeats its kernels'. With ``flush`` the L2 is evicted before every
    call (``l2_flush``) and the flush's kernel is left out. If every
    window came back empty, the ``reps`` calls are timed between CUDA
    events instead (each call alone when flushing) and the one entry is
    keyed ``EVENT_TIMED``: a sum over the dict (a plain or library time)
    still reads it, ``named_ms`` finds no kernel in it and raises."""
    def run():
        if flush:
            l2_flush(torch)
        return fn()

    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    per, _ = profiled(torch, lambda: [run() for _ in range(reps)], None)
    per = {k: v for k, v in per.items() if L2_FLUSH_KERNEL not in k}
    if not per:
        PROFILER_NOTES["event_timed"] += 1
        total = 0.0
        for _ in range(reps if flush else 1):
            if flush:
                l2_flush(torch)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            start.record()
            for _ in range(1 if flush else reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        per = {EVENT_TIMED: total}
    return {k: v / reps for k, v in per.items()}


def call_ms(torch, fn, reps=5, warmup=2):
    """The device ms of one call of ``fn`` between CUDA events, each call
    after an L2 flush, averaged over ``reps``: for calls of one kernel (and
    at most a few microseconds of its redo pass) at sizes where a
    profiler window has been seen to drop the kernel's events."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        l2_flush(torch)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def named_ms(per, name):
    """Device ms of the kernels in ``per`` whose name contains ``name``."""
    hits = [v for k, v in per.items() if name in k]
    if not hits:
        raise RuntimeError(f"no device kernel named like {name!r}: "
                           f"{sorted(per)[:8]}")
    return sum(hits)


def bound(byts, flops, flop_rate=F32_FLOP_PER_S):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the flops over ``flop_rate``."""
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def product_rate(bf16=False):
    """(FLOP/s, its name): the card's peak for a product's operand type."""
    return ((BF16_FLOP_PER_S, "bf16 tensor cores (989 TFLOP/s)") if bf16
            else (SPLIT_F32_FLOP_PER_S, "split-f32 (3xTF32, 165 TFLOP/s)"))


def product_bounds(byts, flops, bf16=False):
    """A matrix-product kernel's bound at the tensor cores' rate for its
    operands (split-f32 for f32, bf16's own for bf16), and at the CUDA
    cores' f32 rate beside it."""
    rate, rate_name = product_rate(bf16)
    b_ms, b_by = bound(byts, flops, rate)
    return {"bound_ms": b_ms, "bound_by": b_by, "bound_rate": rate_name,
            "bound_ffma_ms": bound(byts, flops)[0]}


def phase_timing(torch, state):
    """Kernel times are device times from torch.profiler (the kernel's
    own launches, mean over 20 calls; fed_mix's and fed_mix_q's include
    their redo pass, also given alone as redo_ms); plain and library
    times are the device time of every kernel they launch. The FL rows'
    inputs (99-296 MB) are larger than the 50 MB L2, but part of them
    stays there from one call to the next (a GEMV once read fed_aggregate's
    98.6 MB at 5.3 TB/s, past HBM's 3.35): so every call of these rows,
    kernel, plain and library, runs after ``l2_flush`` and reads its
    inputs from device memory."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_aggregate import fed_aggregate
    from repro_torch.kernels.fed_mix import fed_mix
    from repro_torch.kernels.fed_mix_q import fed_mix_q
    from repro_torch.kernels.fed_mix_sparse import (
        fed_mix_matching, fed_mix_segment,
    )
    t_start = time.perf_counter()
    d, p = MAIN_D, MAIN_P
    rows = []
    for nseg in (1, 10):
        ids, wn, wo, xn, xo = segment_inputs(torch, d, p, nseg,
                                             torch.float32, seed=1)
        byts = 3 * d * p * 4 + 3 * d * 4
        flops = 4 * d * p
        b_ms, b_by = bound(byts, flops)

        def call():
            return fed_mix_segment(ids, wn, wo, xn, xo, num_segments=nseg)

        def plain():
            return ref.fed_mix_segment_ref(ids, wn, wo, xn, xo,
                                           num_segments=nseg)

        rows.append({
            "name": "fed_mix_segment", "L": nseg,
            "ms": named_ms(device_ms(torch, call, flush=True),
                           "segment_mix_kernel"),
            "plain_ms": sum(device_ms(torch, plain, flush=True).values()),
            "bytes": byts, "flops": flops, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "library": "none: no single PyTorch call computes a segment "
                       "sum gathered back to the rows"})
    mn, mo, xn, xo = dense_inputs(torch, d, p, torch.float32, seed=2)
    m_cat = torch.cat([mn, mo], dim=1).contiguous()
    x_cat = torch.cat([xn, xo], dim=0).contiguous()
    byts = 3 * d * p * 4 + 2 * d * d * 4
    flops = 4 * d * d * p
    per = device_ms(torch, lambda: fed_mix(mn, mo, xn, xo), flush=True)
    rows.append({
        "name": "fed_mix", "ms": named_ms(per, "dense_mix_kernel"),
        "redo_ms": named_ms(per, "dense_mix_kernel_redo"),
        "plain_ms": sum(device_ms(
            torch, lambda: ref.fed_mix_ref(mn, mo, xn, xo),
            flush=True).values()),
        "bytes": byts, "flops": flops, **product_bounds(byts, flops),
        "library_ms": sum(device_ms(
            torch, lambda: torch.mm(m_cat, x_cat), flush=True).values()),
        "library": "torch.mm([D, 2D] @ [2D, P]) on pre-stacked operands, "
                   "TF32 off"})
    for stages in (2, 1):
        perms, sv, xn, xo = matching_inputs(torch, d, p, stages,
                                            torch.float32, seed=3)
        byts = 3 * d * p * 4 + (stages + 1) * d * 4
        flops = (3 + 2 * stages) * d * p
        b_ms, b_by = bound(byts, flops)
        rows.append({
            "name": "fed_mix_matching", "S": stages,
            "ms": named_ms(device_ms(
                torch, lambda: fed_mix_matching(perms, sv, xn, xo),
                flush=True),
                "matching_tree_kernel"),
            "plain_ms": sum(device_ms(
                torch, lambda: ref.fed_mix_matching_ref(perms, sv, xn, xo),
                flush=True).values()),
            "bytes": byts, "flops": flops, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "library": "none: no single PyTorch call substitutes stragglers "
                       "and averages rows with their partners"})
    mn, mo, q, sc, xo = quant_inputs(torch, d, p, CHUNK, torch.float32,
                                     seed=4)
    byts = q.numel() + sc.numel() * 4 + 2 * d * p * 4 + 2 * d * d * 4
    flops = 4 * d * d * p + q.numel()        # the products + the dequant
    per = device_ms(torch,
                    lambda: fed_mix_q(mn, mo, q, sc, xo, chunk=CHUNK),
                    flush=True)
    rows.append({
        "name": "fed_mix_q", "Pq": q.shape[1],
        "ms": named_ms(per, "quant_mix_kernel"),
        "redo_ms": named_ms(per, "quant_mix_kernel_redo"),
        "plain_ms": sum(device_ms(
            torch, lambda: ref.fed_mix_q_ref(mn, mo, q, sc, xo,
                                             chunk=CHUNK),
            flush=True).values()),
        "bytes": byts, "flops": flops, **product_bounds(byts, flops),
        "library_ms": None,
        "library": "none: no single PyTorch call dequantizes an int8 "
                   "record inside a matrix product"})
    x, w = aggregate_inputs(torch, d, p, torch.float32, seed=5)
    byts = d * p * 4 + d * 4 + p * 4
    flops = 2 * d * p
    b_ms, b_by = bound(byts, flops)
    rows.append({
        "name": "fed_aggregate",
        "ms": named_ms(device_ms(torch, lambda: fed_aggregate(x, w),
                                 flush=True), "aggregate_kernel"),
        "plain_ms": sum(device_ms(
            torch, lambda: ref.fed_aggregate_ref(x, w), flush=True).values()),
        "bytes": byts, "flops": flops, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": sum(device_ms(torch, lambda: w @ x,
                                    flush=True).values()),
        "library": "w @ x ([N] @ [N, D], one cuBLAS GEMV), TF32 off"})
    print(f"chip_smoke: timing/fl_kernels took "
          f"{time.perf_counter() - t_start:.1f} s", file=sys.stderr,
          flush=True)
    rows += timed("timing/lm_timing", lm_timing, torch)
    state["timing"] = rows
    fed_rows, fed_split = timed("timing/fed_timing", fed_timing, torch)
    emit({"phase": "timing", "kernels": rows,
          "federated_kernels": fed_rows, "federated_round_split": fed_split,
          "round_split": timed("timing/round_split", round_split, torch),
          "round_split_int8_dense": timed("timing/round_split_int8_dense",
                                          round_split_int8_dense, torch),
          "prefill_split": timed("timing/prefill_split", prefill_split,
                                 torch),
          "sampled_split": timed("timing/sampled_split", sampled_split,
                                 torch, state),
          "profiler": dict(PROFILER_NOTES),
          "nvidia_smi": state["smi"]})


def lm_timing(torch):
    """The LM kernels at Hymba's 2048-position prefill (B 4): flash on a
    window layer (1024, 30 of the 32 layers) and a full layer (layers 0
    and 16), ssd_scan on the SSM heads (then at mamba2-130m's: 24 heads of
    64, state 128, chunk 256; ``design_bytes`` is what the kernel's three
    passes move, beside the bound's bytes). Flash's operations count the
    visible (query, key) pairs only, 4·hd flops each (Q·K and P·V); its
    bytes q, k, v read and o written once. The SSD's operations: per
    chunk of q rows, the causal half of C·Bᵀ (2n a pair) and of its
    product with x·dt (2p a pair), and the carried state's two products
    (2pn a row each); its bytes x, dt, B, C and the initial state read,
    y and the final state written once. The library yardstick for flash
    is one ``scaled_dot_product_attention`` call with ``enable_gqa`` and
    the boolean mask, TF32 off; no one PyTorch call computes the SSD
    scan."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    f32 = torch.float32
    rows = []
    q, k, v = attention_inputs(torch, LM_B, LM_HQ, LM_HKV, LM_S, LM_HD, f32,
                               seed=7)
    for window in (LM_WINDOW, 0):
        mask = flash_mask(torch, LM_S, window, LM_META)
        pairs = int(mask.sum())
        flops = 4 * LM_HD * pairs * LM_B * LM_HQ
        byts = 4 * LM_S * LM_HD * LM_B * (2 * LM_HQ + 2 * LM_HKV)

        def call():
            return flash_attention(q, k, v, window=window, num_meta=LM_META)

        def plain():
            return ref.flash_attention_ref(q, k, v, window=window,
                                           num_meta=LM_META)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)

        per = device_ms(torch, call)
        rows.append({
            "name": "flash_attention", "S": LM_S, "window": window,
            "num_meta": LM_META, "visible_pairs_per_head": pairs,
            "ms": named_ms(per, "flash_fwd_kernel"),
            "nonfinite_ms": named_ms(per, "flash_fwd_kernel_vflags")
                          + named_ms(per, "flash_fwd_kernel_nanfix"),
            "plain_ms": sum(device_ms(torch, plain, reps=5).values()),
            "bytes": byts, "flops": flops, **product_bounds(byts, flops),
            "library_ms": sum(device_ms(torch, library).values()),
            "library": "scaled_dot_product_attention(enable_gqa=True, "
                       "boolean mask), TF32 off",
            "library_max_abs_err": float((library() - call()).abs().max())})
    # gemma-2b's attention at 2048 positions (B 4, 8 query heads and one kv
    # head of 256, causal: flash_fwd_kernel_wgmma256), then the other
    # serving and training shapes of the main path: gemma-2b's training
    # forward (B 1), nemotron-4-15b's (and dbrx-132b's), yi-34b's and
    # chameleon-34b's GQA at 128 (B 4; flash_fwd_kernel_wgmma128), dbrx's
    # training forward (B 1) and musicgen-medium's MHA at 64 (B 4, 1500
    # frames)
    for b, hq, hkv, s, hd, model in (
            (LM_B, WIDE_HQ, WIDE_HKV, LM_S, WIDE_HD, "gemma-2b serving"),
            (1, WIDE_HQ, WIDE_HKV, LM_S, WIDE_HD, "gemma-2b training"),
            (LM_B, 48, 8, DENSE_PROMPT, 128, "nemotron-4-15b serving"),
            (LM_B, 56, 8, DENSE_PROMPT, 128, "yi-34b serving"),
            (LM_B, 64, 8, DENSE_PROMPT, 128, "chameleon-34b serving"),
            (MOE_TRAIN_B, 48, 8, MOE_TRAIN_SEQ, 128, "dbrx-132b training"),
            (LM_B, 24, 24, AUDIO_FRAMES, 64, "musicgen-medium serving")):
        rows.append(flash_forward_row(torch, b, hq, hkv, s, hd, model))
    rows.append(mla_flash_timing(torch))
    # Hymba's SSM heads, then mamba2-130m's (the summary line takes the
    # first row of a name: Hymba's)
    for h, p, n, chunk in ((50, 64, 16, 128), (24, 64, 128, 256)):
        args, init = ssd_inputs(torch, LM_B, LM_S, h, p, n, 8, True)
        nc = LM_S // chunk
        tri = chunk * (chunk + 1) // 2
        flops = LM_B * h * nc * (tri * (2 * n + 2 * p) + 4 * chunk * p * n)
        byts = 4 * (2 * LM_B * LM_S * h * p + LM_B * LM_S * h
                    + 2 * LM_B * LM_S * n + 2 * LM_B * h * p * n)
        # what the three passes move: x read by each state-column group of
        # the chunk-state pass and by each of its chunk's row tiles at or
        # below it, B once by pass 1 and by the same row tiles, C once, dt
        # by every block of both passes, y written; the [b, h, nc, p, n]
        # f32 workspace written by pass 1, read and rewritten by pass 2 and
        # read by every row tile of pass 3
        n_rt = -(-chunk // 64)
        n8 = -(-n // 8)
        groups = -(-n8 // (2 if n8 <= 2 else 4 if n8 <= 4 else 8))
        reads = sum(min(chunk, 64 * (rt + 1)) for rt in range(n_rt)) / chunk
        ws = 4 * LM_B * h * nc * p * n
        design = (4 * LM_B * LM_S * h * p * (groups + reads + 1)
                  + 4 * LM_B * LM_S * n * (1 + reads + 1)
                  + 4 * LM_B * LM_S * h * (groups + n_rt)
                  + (3 + n_rt) * ws + 2 * 4 * LM_B * h * p * n)
        per = device_ms(
            torch, lambda: ssd_scan(*args, chunk=chunk, initial_state=init))
        rows.append({
            "name": "ssd_scan", "S": LM_S, "h": h, "p": p, "n": n,
            "chunk": chunk, "ms": named_ms(per, "ssd_scan_kernel"),
            "passes_ms": {w: named_ms(per, f"ssd_scan_kernel_{w}")
                          for w in ("local", "carry", "output")},
            "nonfinite_ms": None,
            "nonfinite": "no launch of its own: the non-finite masks are "
                         "written by the chunk-state pass (zeros on finite "
                         "input) and read by the output pass, inside "
                         "passes_ms",
            "plain_ms": sum(device_ms(
                torch,
                lambda: ref.ssd_chunked(*args, chunk, initial_state=init),
                reps=5).values()),
            "bytes": byts, "flops": flops, **product_bounds(byts, flops),
            "design_bytes": design,
            "design_bytes_ms": design / HBM_BYTES_PER_S * 1e3,
            "library_ms": None,
            "library": "none: no single PyTorch call computes the chunked "
                       "SSD scan"})
    return rows + lm_backward_timing(torch)


def flash_forward_row(torch, b, hq, hkv, s, hd, model):
    """flash_attention at one causal shape with vd = hd (no window, no
    meta tokens): the call's device time (``ms``: every launch), its
    attention kernel's alone (``kernel_ms``: the launch that
    ``forward_route`` names, with K's and Vᵀ's images at 256 in
    ``images_ms``), the plain version's and SDPA's (boolean mask,
    ``enable_gqa``, TF32 off). Operations: the visible pairs' Q·Kᵀ and P·V,
    4·hd flops each; bytes q, k, v read and o written once. On the wgmma
    routes the design computes whole tiles on the diagonal
    (``design_flops``, the scores once per tile pair: 64 x 64 at 256, 128
    query rows x 64 keys at 128)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention, forward_route,
    )
    q, k, v = attention_inputs(torch, b, hq, hkv, s, hd, torch.float32,
                               seed=9)
    mask = flash_mask(torch, s, 0, 0)
    pairs = int(mask.sum())
    flops = 4 * hd * pairs * b * hq
    byts = 4 * s * hd * b * (2 * hq + 2 * hkv)
    route = forward_route(hd, hd)
    kernel = {"mma": "flash_fwd_kernel<",
              "wgmma128": "flash_fwd_kernel_wgmma128",
              "wgmma256": "flash_fwd_kernel_wgmma256"}[route]
    # the key tiles of 64 that each query tile visits (128 rows a tile on
    # the hd-128 route, 64 on the others)
    rows_t = 128 if route == "wgmma128" else 64
    tiles = sum(min((qt * rows_t + rows_t - 1) // 64, (s - 1) // 64) + 1
                for qt in range(-(-s // rows_t)))
    per = device_ms(torch, lambda: flash_attention(q, k, v))
    row = {
        "name": "flash_attention", "model": model, "B": b, "S": s, "hd": hd,
        "heads": [hq, hkv], "window": 0, "num_meta": 0, "route": route,
        "visible_pairs_per_head": pairs,
        "ms": named_ms(per, "flash_fwd_kernel"),
        "kernel_ms": named_ms(per, kernel),
        "nonfinite_ms": named_ms(per, "flash_fwd_kernel_vflags")
                      + named_ms(per, "flash_fwd_kernel_nanfix"),
        "plain_ms": sum(device_ms(
            torch, lambda: ref.flash_attention_ref(q, k, v), reps=5).values()),
        "bytes": byts, "flops": flops, **product_bounds(byts, flops),
        "library_ms": sum(device_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)).values()),
        "library": "scaled_dot_product_attention(enable_gqa=True, "
                   "boolean mask), TF32 off"}
    if route in ("wgmma128", "wgmma256"):
        design = b * hq * tiles * rows_t * 64 * 4 * hd
        row.update(images_ms=named_ms(per, f"flash_fwd_kernel_image{hd}"),
                   design_flops=design, design_bound_ms=bound(
                       byts, design, SPLIT_F32_FLOP_PER_S)[0])
    del q, k, v
    return row


def mla_flash_timing(torch):
    """flash_attention at DeepSeek-V2's MLA prefill: B 4, 128 heads, q/k
    192 and v 128, 2048 positions, causal, f32; the attention is
    flash_fwd_kernel_wgmma (``wgmma_kernel_ms``: its launch alone).
    Operations: the visible pairs' Q·Kᵀ (2·192 a pair) and P·V (2·128);
    bytes q, k, v read and o written once. Library yardstick: one scaled_dot_product_attention call
    (is_causal, v of 128), TF32 off."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = attention_inputs(torch, LM_B, MLA_H, MLA_H, LM_S, MLA_HD,
                               torch.float32, seed=11, vd=MLA_VD)
    pairs = LM_S * (LM_S + 1) // 2
    flops = LM_B * MLA_H * pairs * 2 * (MLA_HD + MLA_VD)
    byts = 4 * LM_B * MLA_H * LM_S * (2 * MLA_HD + 2 * MLA_VD)
    per = device_ms(torch, lambda: flash_attention(q, k, v))
    return {
        "name": "flash_attention", "S": LM_S, "hd": MLA_HD, "vd": MLA_VD,
        "heads": [MLA_H, MLA_H], "window": 0, "num_meta": 0,
        "visible_pairs_per_head": pairs,
        "ms": named_ms(per, "flash_fwd_kernel"),
        "wgmma_kernel_ms": named_ms(per, "flash_fwd_kernel_wgmma"),
        "nonfinite_ms": named_ms(per, "flash_fwd_kernel_vflags")
                      + named_ms(per, "flash_fwd_kernel_nanfix"),
        "plain_ms": sum(device_ms(
            torch, lambda: ref.flash_attention_ref(q, k, v), reps=3,
            warmup=1).values()),
        "bytes": byts, "flops": flops, **product_bounds(byts, flops),
        "library_ms": sum(device_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)).values()),
        "library": "scaled_dot_product_attention(is_causal=True), v of 128, "
                   "TF32 off",
        "library_max_abs_err": float((F.scaled_dot_product_attention(
            q, k, v, is_causal=True) - flash_attention(q, k, v)).abs().max())}


def lm_backward_timing(torch):
    """The backward kernels at Hymba-1.5B's training shapes (B 2, 2048
    positions): flash on a window layer and a full layer, then at
    qwen2-1.5b's (12/2 heads of 128, full causal, no meta tokens); at v's
    own head_dim (``flash_attention_bwd_vd``) DeepSeek-V2's training shape
    (B 1, 128 heads, 2048 positions, (192, 128)) in f32 and in bf16, and
    the flash backward at DBRX's (B 1, GQA 48/8 of 128, 2048:
    ``flash_attention_bwd_128``, timed before qwen2's so that the summary
    line's row of that name is DBRX's, the main path's shape), at
    gemma-2b's (B 1, MQA 8/1 at hd 256, 2048: ``flash_attention_bwd_256``)
    and at musicgen-medium's (B 1, MHA 24/24 at 64, 1500 frames); the SSD
    on Hymba's SSM heads, then at mamba2-130m's. Kernel times are the device time of
    every launch of one call (``passes_ms`` by launch); plain times the
    device time of the plain version's autograd backward alone
    (``torch.autograd.grad`` on a kept graph). Flash's operations: the
    function's five products per visible pair and query head, 2·hd flops
    each for S, dK and dQ and 2·vd for dP and dV; both two-pass designs
    compute S and dP twice, once a pass, the one at vd != hd at its padded
    widths (``design_flops``, ``design_bound_ms``). Its bytes: q, k, v, o,
    dO (in the row's dtype) and lse read, dq, dk, dv written once. Its
    bounds take the tensor cores' peak for the row's operands: split-f32
    for f32, the bf16 rate for bf16 (``bound_rate``). The
    library yardstick is the backward of ``scaled_dot_product_attention``
    (vd = hd: the boolean mask and ``enable_gqa``; MLA: ``is_causal``),
    TF32 off, and its kernels' names say which backend ran. The SSD's operations, per chunk of q rows: per head
    the causal halves of W = dY·xdᵀ and (G∘L)ᵀ·dY (2p a pair each) and
    four products with the [p, n] states (2pn a row each: Σ e^a dY⊗C,
    dY·S_in, B·dstᵀ, xd·dst; da's state terms reuse the second and third
    at 2n or 2p a row, left out); once G = C·Bᵀ (2n a pair), and dcb·B and
    dcbᵀ·C on the head sum dcb = Σ_h W∘L (2n each); the design computes
    whole 64 x 64 tile pairs (``design_flops``). Its bytes: x, dt, B, C, dY and the saved
    incoming states read, dx, d(dt), dB, dC written once. No one PyTorch
    call computes either gradient of the SSD."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        _bwd_vd_widths, _launch, bwd_route, flash_attention_bwd,
        flash_attention_bwd_vd,
    )
    from repro_torch.kernels.ssd_scan import _launch as ssd_launch
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd
    f32 = torch.float32
    b, s = TRAIN_B, LM_S
    rows = []
    mla = (MOE_TRAIN_B, MOE_TRAIN_SEQ, MLA_H, MLA_H, MLA_HD, MLA_VD, 0, 0)
    for b, s, hq, hkv, hd, vd, window, meta, dt in (
            (b, s, LM_HQ, LM_HKV, LM_HD, LM_HD, LM_WINDOW, LM_META, f32),
            (b, s, LM_HQ, LM_HKV, LM_HD, LM_HD, 0, LM_META, f32),
            (MOE_TRAIN_B, MOE_TRAIN_SEQ, 48, 8, 128, 128, 0, 0, f32),  # DBRX
            (b, s, 12, 2, 128, 128, 0, 0, f32),               # qwen2-1.5b
            mla + (f32,), mla + (torch.bfloat16,),
            # gemma-2b: MQA 8/1 at hd 256 (flash_attention_bwd_256)
            (1, 2048, WIDE_HQ, WIDE_HKV, WIDE_HD, WIDE_HD, 0, 0, f32),
            # musicgen-medium: MHA 24/24 at hd 64, 1500 frames
            (1, AUDIO_FRAMES, 24, 24, 64, 64, 0, 0, f32)):
        bf16 = dt == torch.bfloat16
        q, k, v = attention_inputs(torch, b, hq, hkv, s, hd, dt, seed=17,
                                   vd=vd)
        dout = torch.randn((b, hq, s, vd), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(18)).to(dt)
        lse = torch.empty((b, hq, s), device="cuda")
        out = _launch(q, k, v, window, meta, lse=lse)
        mask = flash_mask(torch, s, window, meta)
        pairs = int(mask.sum())
        flops = 2 * (3 * hd + 2 * vd) * pairs * b * hq
        byts = (dt.itemsize * s * b * (hq * (2 * hd + 2 * vd)
                                       + hkv * (2 * hd + 2 * vd))
                + 4 * b * hq * s)
        if vd == hd:
            name, bwd = bwd_route(hd, vd), flash_attention_bwd
            width = name.rsplit("_", 1)[1]     # 128 or 256: the wgmma routes
            pass_names = (("prep", "dkdv", "reduce", "dq")
                          if name == "flash_attention_bwd"
                          else ("vd_prep", f"{width}_image", f"{width}_dkdv",
                                f"{width}_dq")
                          + (("vd_reduce",) if hq != hkv else ()))
            # seven products of 2·hd a pair: S and dP once in each pass
            design = 14 * hd * pairs * b * hq
        else:
            name, bwd = "flash_attention_bwd_vd", flash_attention_bwd_vd
            pass_names = ("vd_prep", "vd_dkdv_wgmma", "vd_dq_wgmma") + (
                ("vd_reduce",) if hq != hkv else ())
            # at the padded widths: the dK/dV pass S, dP, dK and dV, the dQ
            # pass S, dP and dQ (2,304 flops a pair at (192, 128))
            hp, vp = _bwd_vd_widths(hd, vd)
            design = (8 * hp + 6 * vp) * pairs * b * hq
        per = device_ms(torch, lambda: bwd(
            q, k, v, out, dout, lse, window=window, num_meta=meta))
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        o_plain = ref.flash_attention_ref(*leaves, window=window,
                                          num_meta=meta)
        lib = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        if vd == hd:
            o_lib = F.scaled_dot_product_attention(*lib, attn_mask=mask,
                                                   enable_gqa=True)
            lib_name = ("scaled_dot_product_attention(enable_gqa=True, "
                        "boolean mask) backward, TF32 off")
        else:
            o_lib = F.scaled_dot_product_attention(*lib, is_causal=True)
            lib_name = ("scaled_dot_product_attention(is_causal=True) "
                        f"backward, v of 128, {str(dt)[6:]}, TF32 off")
        per_lib = device_ms(torch, lambda: torch.autograd.grad(
            o_lib, lib, dout, retain_graph=True))
        names = " ".join(per_lib).lower()
        rows.append({
            "name": name, "dtype": str(dt)[6:], "B": b, "S": s, "Hq": hq,
            "Hkv": hkv, "hd": hd, "vd": vd, "window": window,
            "num_meta": meta, "visible_pairs_per_head": pairs,
            "ms": named_ms(per, "flash_bwd_"),
            "passes_ms": {w: named_ms(per, f"flash_bwd_{w}_kernel")
                          for w in pass_names},
            "plain_ms": sum(device_ms(torch, lambda: torch.autograd.grad(
                o_plain, leaves, dout, retain_graph=True), reps=5).values()),
            "bytes": byts, "flops": flops,
            "design_flops": design,
            **product_bounds(byts, flops, bf16),
            "design_bound_ms": bound(byts, design, product_rate(bf16)[0])[0],
            "library_ms": sum(per_lib.values()),
            "library": lib_name,
            "library_backend": ("efficient attention (cutlass fmha)"
                                if "fmha" in names or "efficient" in names
                                else "flash" if "flash" in names
                                else "math (matmuls and softmax)"),
            "library_kernels": sorted(per_lib, key=lambda k: -per_lib[k])[:4]})
        del leaves, o_plain, lib, o_lib, q, k, v, dout, lse, out
    b, s = TRAIN_B, LM_S
    for h, p, n, chunk in ((50, 64, 16, 128), (24, 64, 128, 256)):
        args, _ = ssd_inputs(torch, b, s, h, p, n, 19, False)
        y, _, ws = ssd_launch(*args, chunk, None)
        dy = torch.randn_like(y)
        nc = s // chunk
        tri = chunk * (chunk + 1) // 2
        # the function: per head W·L and (G∘L)ᵀ·dY (2p a pair each) and the
        # four state products (2pn a row); per chunk G (2n a pair) and, on
        # the head sum dcb = Σ_h W∘L, dcb·B and dcbᵀ·C (2n each)
        flops = b * nc * (h * (tri * 4 * p + 8 * chunk * p * n)
                          + tri * 6 * n)
        # the design: the same products over whole 64 x 64 tile pairs
        tiles = -(-chunk // 64)
        tri_t = tiles * (tiles + 1) // 2 * 64 * 64
        design = b * nc * (h * (tri_t * 4 * p + 8 * chunk * p * n)
                           + tri_t * 6 * n)
        byts = 4 * (3 * b * s * h * p + 2 * b * s * h + 4 * b * s * n
                    + b * h * nc * p * n + h)
        per = device_ms(torch, lambda: ssd_scan_bwd(*args, ws, dy, None,
                                                    chunk=chunk))
        leaves = [t.detach().clone().requires_grad_(True) for t in args]
        y_plain, _ = ref.ssd_chunked(*leaves, chunk)
        rows.append({
            "name": "ssd_scan_bwd", "B": b, "S": s, "h": h, "p": p, "n": n,
            "chunk": chunk, "ms": named_ms(per, "ssd_bwd_kernel"),
            "passes_ms": {w: named_ms(per, f"ssd_bwd_kernel_{w}")
                          for w in ("state", "carry", "g", "rows", "cols",
                                    "dcb", "chain", "reduce")},
            "plain_ms": sum(device_ms(torch, lambda: torch.autograd.grad(
                y_plain, leaves, dy, retain_graph=True), reps=5).values()),
            "bytes": byts, "flops": flops, **product_bounds(byts, flops),
            "design_flops": design,
            "design_bound_ms": bound(byts, design, SPLIT_F32_FLOP_PER_S)[0],
            "library_ms": None,
            "library": "none: no single PyTorch call computes the chunked "
                       "SSD scan's gradient"})
        del leaves, y_plain
    return rows


def prefill_split(torch):
    """One Hymba-1.5B prefill at full width (B 4, 2048 positions, seeded
    weights drawn on the card) under torch.profiler: the summed device time
    of its kernels, split into flash_attention, ssd_scan, the matrix
    products (cuBLAS) and the rest (norms, rope, the conv, elementwise)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    model = build_model(get_config(LM_ARCH))
    params = model.init(0, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (LM_B, LM_PROMPTS[1]))).cuda()
    buf = max(model.cfg.sliding_window + LM_META, LM_S)
    return kernel_split(torch, model, params, tokens, buf)


def kernel_split(torch, model, params, tokens, buf, decode=False):
    """One prefill of ``tokens`` into a cache of ``buf`` slots (then, with
    ``decode``, one greedy decode step) under torch.profiler: the summed
    device time of its kernels, split into flash_attention, ssd_scan, the
    matrix products (cuBLAS) and the rest (norms, rope, the conv, the MoE
    router and dispatch, elementwise)."""
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    prefill, step = build_prefill_step(model), build_decode_step(model)
    cache = {}

    def run():
        cache["c"] = model.make_cache(tokens.shape[0], buf)
        return prefill(params, {"tokens": tokens}, cache["c"])

    def split(per):
        total = sum(per.values())
        flash = sum(v for k, v in per.items() if "flash_fwd_kernel" in k)
        ssd = sum(v for k, v in per.items() if "ssd_scan_kernel" in k)
        gemm = sum(v for key, v in per.items()
                   if any(w in key.lower() for w in ("gemm", "cutlass", "xmma",
                                                     "cublas")))
        top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
        return {"device_ms": total, "flash_attention_ms": flash,
                "flash_share": flash / total, "ssd_scan_ms": ssd,
                "ssd_share": ssd / total, "matmul_ms": gemm,
                "matmul_share": gemm / total,
                "rest_ms": total - flash - ssd - gemm,
                "top_kernels_ms": [[key[:90], v] for key, v in top]}

    out = split(device_ms(torch, run, reps=1, warmup=1))
    if decode:
        logits, _ = run()
        token = {"token": torch.argmax(logits[:, -1], dim=-1)[:, None]}
        out["decode_step"] = split(device_ms(
            torch, lambda: step(params, cache["c"], token), reps=1,
            warmup=1))
    return out


# local epochs of the profiled rounds of ``round_split`` and
# ``round_split_int8_dense`` (the main path's rounds take FLConfig's 20):
# a profiled round's events, digested again for each window that comes
# back empty, took 90 s a split at 20
SPLIT_EPOCHS = 5


def round_split(torch):
    """One full-width fedp2p round (at SPLIT_EPOCHS local epochs) under
    torch.profiler: the summed device time of its kernels, split into the
    mix kernel, the convolution kernels (local training's bulk) and the
    rest."""
    from repro_torch.config import FLConfig
    from repro_torch.core.simulator import Simulator
    net, data, kw = femnist_setup(full=True)
    sim = Simulator(net, data, FLConfig(local_epochs=SPLIT_EPOCHS, **kw))
    eng = sim.engine("fedp2p")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = sim.init_params(0)
    per = device_ms(torch, lambda: eng.run_rounds(params, gen, 1), reps=1,
                    warmup=1)                            # warm up cuDNN
    total = sum(per.values())
    mix = sum(v for k, v in per.items() if "segment_mix_kernel" in k)
    conv = sum(v for k, v in per.items()
               if any(w in k.lower() for w in ("conv", "xmma", "winograd",
                                               "cudnn", "implicit")))
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    return {"device_ms": total, "mix_kernel_ms": mix,
            "mix_share_of_device": mix / total,
            "convolution_ms": conv,
            "convolution_share_of_device": conv / total,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def round_split_int8_dense(torch):
    """One full-width fedp2p round (at SPLIT_EPOCHS local epochs) with the
    int8 wire on mix_path="dense" under torch.profiler: the summed device time of its kernels, split
    into the fed_mix_q kernel, the codec's own elementwise kernels (every
    kernel launched inside ``ops.wire_flat``: the delta, the absmax
    scales, the stochastic rounding, the residual split), the convolution
    kernels and the rest."""
    from torch.profiler import record_function

    from repro_torch.config import FLConfig
    from repro_torch.core.simulator import Simulator
    from repro_torch.kernels import ops
    net, data, kw = femnist_setup(full=True)
    sim = Simulator(net, data, FLConfig(mix_path="dense",
                                        local_epochs=SPLIT_EPOCHS, **kw))
    eng = sim.engine("fedp2p", codec="int8")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = sim.init_params(0)
    wire = ops.wire_flat

    def traced_wire(*args, **kwargs):
        with record_function("codec_wire"):
            return wire(*args, **kwargs)

    eng.run_rounds(params, gen, 1)                       # warm up cuDNN
    torch.cuda.synchronize()
    ops.wire_flat = traced_wire
    try:
        per, wire_ms = profiled(torch, lambda: eng.run_rounds(params, gen, 1),
                                "codec_wire")
    finally:
        ops.wire_flat = wire
    total = sum(per.values())
    mix = sum(v for k, v in per.items() if "quant_mix_kernel" in k)
    conv = sum(v for k, v in per.items()
               if any(w in k.lower() for w in ("conv", "xmma", "winograd",
                                               "cudnn", "implicit")))
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    return {"device_ms": total, "fed_mix_q_ms": mix,
            "fed_mix_q_share_of_device": mix / total,
            "codec_wire_ms": wire_ms,
            "codec_wire_share_of_device": wire_ms / total,
            "convolution_ms": conv,
            "convolution_share_of_device": conv / total,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def kernel_summary(state):
    # each kernel's summary row: the first timing row of its name
    # (fed_mix_segment at L = 1, fed_mix_matching at S = 2)
    timing = {}
    for r in state["timing"]:
        timing.setdefault(r["name"], r)
    launches, errs = state["launches"], state["max_abs_err"]
    out = []
    for name, src, rep in KERNELS:
        t = timing[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"],
                    "library_ms": t["library_ms"]})
    return {"kernels": out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import backend
    except ImportError as exc:
        print(f"chip_smoke: the port is missing beside this script "
              f"({exc}); run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    backend.use_full_f32()

    state = {}
    # each phase's wall time goes to stderr (the build is in env's)
    for phase, args in ((phase_env, (torch, backend, state)),
                        (phase_kernels, (torch, state)),
                        (phase_reference, (torch, state)),
                        (phase_main_path, (torch, state)),
                        (phase_timing, (torch, state)),
                        (phase_mesh, (torch, state))):
        t0 = time.perf_counter()
        phase(*args)
        print(f"chip_smoke: {phase.__name__} took "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
    emit(kernel_summary(state))
    print(state["smi"], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
