#!/usr/bin/env python3
"""Device times of the port's kernels from one source tree, for comparing
two trees on one card.

    python3 scripts/torch_kernel_ab.py --src DIR [--label NAME] [--out FILE]

Imports ``repro_torch`` from ``DIR`` (a checkout's ``src/``; its kernels
build into that checkout's ``build/``) and times, with ``chip_smoke.py``'s
inputs and its ``device_ms`` (torch.profiler, mean of 20 calls after 3
warm-up calls), the summed device time of every kernel one call launches:

* ``flash_attention`` at Hymba-1.5B's 2048-position prefill (B 4, 25/5
  heads of 64, 128 meta tokens), window 1024 and a full layer, at
  gemma-2b's (B 4, 8/1 heads of 256, causal; null where the tree's
  wrapper refuses head_dim 256; and at B 1, its training forward), at
  the dense models' GQA at 128 (B 4, 2048 positions, causal:
  nemotron-4-15b's 48/8, which is also dbrx-132b's, yi-34b's 56/8 and
  chameleon-34b's 64/8), each beside ``scaled_dot_product_attention``
  (boolean mask, ``enable_gqa``), and at DeepSeek-V2's MLA prefill (B 4,
  128 heads, q/k 192, v 128, causal; null where the tree's wrapper
  needs v's head_dim to be q's);
* ``ssd_scan`` at Hymba's SSM heads (50 x 64, state 16, chunk 128, an
  initial state);
* ``fed_mix_matching`` at the FL main shape (D = 100, P = 246,590, f32),
  S = 2 (gossip's ring) and S = 1 (gossip_async);
* ``scaled_dot_product_attention`` at the MLA shape above (is_causal,
  TF32 off): the library yardstick in the same run;
* one Hymba-1.5B serving prefill at full width (B 4, 1920 tokens: 2048
  positions; seeded weights drawn on the card; mean of 3 after one
  warm-up), and one of deepseek-v2-236b cut to 3 layers (every width
  published, B 4 x 2048 tokens, f32, seeded weights; the prefill's three
  flash_attention launches as ``flash_ms``);

and, on the host clock around synchronized work, ``Simulator.run``'s
seconds per round of fedp2p on CNN-FEMNIST at full width (100 clients,
default ``FLConfig`` with lr 0.05): one warm-up round, then 3 rounds.

``--set backward`` times instead, at ``chip_smoke.py``'s training shapes,
the backward kernels (each call's launches, split by launch):

* ``flash_attention_bwd`` at Hymba-1.5B's training layers (B 2, 25/5
  heads of 64, 2048 positions, 128 meta tokens), window 1024 and a full
  layer, from the forward's output and log-sum-exp;
* ``flash_attention_bwd`` at qwen2-1.5b's (B 2, 12/2 heads of 128, 2048
  positions, causal), DBRX's (B 1, 48/8 of 128) and gemma-2b's (B 1, 8/1
  of 256) training shapes (``flash_attention_bwd_128`` and ``_256``
  where the tree has them), each beside the backward of
  ``scaled_dot_product_attention`` (boolean mask, ``enable_gqa``) on the
  same inputs;
* ``flash_attention_bwd_vd`` at DeepSeek-V2's training shape (B 1, 128
  heads, 2048 positions, q/k 192, v 128, causal), f32 and bf16, each
  beside the backward of ``scaled_dot_product_attention(is_causal=True)``
  on the same inputs (TF32 off), its launches by name (the tree's own:
  ``dkdv_wgmma`` and ``dq_wgmma`` since the wgmma design, ``dkdv`` and
  ``dq`` before it);
* ``ssd_scan_bwd`` at Hymba's SSM heads (50 x 64, state 16, chunk 128)
  and mamba2-130m's (24 x 64, state 128, chunk 256), B 2 x 2048;
* the Hymba-1.5B serving prefill above (its kernels are the forward's);
* Hymba-1.5B's train step at full width (B 2 x 1920 tokens, f32 AdamW,
  remat off): seconds per step on the host clock (mean of steps 2-4 of
  ``run_lm_training``), tokens per second and the peak device memory.

``--kernels-only`` leaves out the model-level rows (the prefills,
fedp2p's rounds, the train step).

``--set ptxas`` prints instead ptxas' registers, stack frame and spills
for each kernel (and out-of-line block) of the tree's
``flash_attention.cu``, ``flash_attention_bwd.cu`` and, where the tree
has them, ``flash_attention_bwd_vd.cu`` and ``flash_attention_bwd_256.cu``
(``nvcc -Xptxas -v`` for sm_90a
with the build's flags; names as mangled, e.g. ``IfLi128E`` is f32 at
head_dim 128, ``IfLi3EE`` f32 with three 64-column chunks of hd,
``IfLi192ELi128E`` f32 at (hd, vd) = (192, 128)), with ptxas' warnings (a wgmma serialized, a spill);
it needs no card (``IfLi192ELi128E`` is f32 at (hd, vd) = (192, 128)).

Run it once per tree in turns (parent, change, change, parent) inside one
call to compare two versions; each run prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def fedp2p_seconds_per_round(torch, rounds=3):
    import time

    from repro_torch.config import FLConfig
    from repro_torch.configs.paper_models import CNN_FEMNIST
    from repro_torch.core.simulator import Simulator
    from repro_torch.data.federated import pseudo_femnist_federated
    sim = Simulator(CNN_FEMNIST, pseudo_femnist_federated(100, num_classes=62,
                                                          seed=0),
                    FLConfig(lr=0.05))
    sim.run(rounds=1, algorithm="fedp2p")           # warm up cuDNN
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(rounds=rounds, algorithm="fedp2p")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / rounds


def hymba_prefill_ms(torch, cs):
    """{"ms": summed device time of one prefill's kernels, ...}."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.model import build_model
    model = build_model(get_config(cs.LM_ARCH))
    params = model.init(0, device="cuda")
    prefill = build_prefill_step(model)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (cs.LM_B, cs.LM_PROMPTS[1]))).cuda()

    def run():
        prefill(params, {"tokens": tokens},
                model.make_cache(cs.LM_B, cs.LM_S))

    per = cs.device_ms(torch, run, reps=3, warmup=1)
    return {"ms": sum(per.values()),
            "flash_ms": sum(v for k, v in per.items()
                            if "flash_fwd_kernel" in k)}


def deepseek_prefill_ms(torch, cs, layers=3, prompt=2048):
    """One prefill of deepseek-v2-236b cut to ``layers`` (every width
    published; seeded f32 weights drawn on the card; B 4 x ``prompt``
    tokens): {"ms": summed device time of its kernels, "flash_ms": its
    flash_attention launches'}, mean of 3 after one warm-up."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.model import build_model
    model = build_model(dataclasses.replace(get_config("deepseek-v2-236b"),
                                            num_layers=layers))
    params = model.init(0, device="cuda")
    prefill = build_prefill_step(model)
    tokens = torch.from_numpy(np.random.default_rng(prompt).integers(
        0, model.cfg.vocab_size, (cs.LM_B, prompt))).cuda()

    def run():
        prefill(params, {"tokens": tokens}, model.make_cache(cs.LM_B, prompt))

    per = cs.device_ms(torch, run, reps=3, warmup=1)
    del params
    return {"ms": sum(per.values()),
            "flash_ms": sum(v for k, v in per.items()
                            if "flash_fwd_kernel" in k),
            "layers": layers, "prompt": prompt}


def ptxas_usage(backend):
    """ptxas' resource report for the tree's flash_attention.cu,
    flash_attention_bwd.cu and flash_attention_bwd_vd.cu (where the tree
    has it): {file: {function: {"registers", "stack",
    "spill_stores", "spill_loads"}}} for the kernels and their out-of-line
    full-split blocks, and under "warnings" ptxas' notes on them (a wgmma
    serialized, for one)."""
    import re
    import tempfile
    report = {}
    for src in ("flash_attention", "flash_attention_bwd",
                "flash_attention_bwd_vd", "flash_attention_bwd_256"):
        if not (backend.CSRC / f"{src}.cu").exists():
            continue
        with tempfile.TemporaryDirectory() as tmp:
            proc = subprocess.run(
                [backend.nvcc(), *[f for f in backend.NVCC_FLAGS
                                   if f not in ("-shared", "-Xcompiler",
                                                "-fPIC")],
                 "-cubin", "-Xptxas", "-v", "-o", f"{tmp}/k.cubin",
                 str(backend.CSRC / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        out = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v {src}.cu failed:\n"
                               f"{out[-4000:]}")
        usage, name, notes = {}, None, []
        for line in out.splitlines():
            if "warning" in line.lower() or "performance" in line.lower():
                notes.append(line.strip()[:300])
            m = re.search(r"(?:entry function '|Function properties for )"
                          r"([\w$.]+)", line)
            if m:
                name = m.group(1)
                continue
            if name is None or not re.search(r"flash|dkdv|dq_|image", name):
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                usage.setdefault(name, {}).update(
                    stack=int(m.group(1)), spill_stores=int(m.group(2)),
                    spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                usage.setdefault(name, {})["registers"] = int(m.group(1))
        report[f"{src}.cu"] = {**usage, "warnings": notes}
    return report


def mla_backward_rows(torch, cs, launch, bwd_vd):
    """K2 (``flash_attention_bwd_vd``) and SDPA's backward at DeepSeek-V2's
    training shape, f32 and bf16: {key: {"ms", "kernels_ms"}}."""
    import torch.nn.functional as F
    rows = {}
    b, h, s = cs.MOE_TRAIN_B, cs.MLA_H, cs.MOE_TRAIN_SEQ
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt)[6:]
        q, k, v = cs.attention_inputs(torch, b, h, h, s, cs.MLA_HD, dt,
                                      seed=17, vd=cs.MLA_VD)
        dout = torch.randn((b, h, s, cs.MLA_VD), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(18)).to(dt)
        lse = torch.empty((b, h, s), device="cuda")
        out = launch(q, k, v, 0, 0, lse=lse)
        per = cs.device_ms(torch, lambda: bwd_vd(q, k, v, out, dout, lse))
        rows[f"flash_bwd_vd_mla_{tag}"] = {
            "ms": sum(per.values()),
            "kernels_ms": {k_[:60]: v_ for k_, v_ in per.items()}}
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        o_lib = F.scaled_dot_product_attention(*leaves, is_causal=True)
        per = cs.device_ms(torch, lambda: torch.autograd.grad(
            o_lib, leaves, dout, retain_graph=True))
        rows[f"sdpa_bwd_mla_{tag}"] = {
            "ms": sum(per.values()),
            "kernels_ms": {k_[:60]: v_ for k_, v_ in per.items()}}
        del q, k, v, dout, lse, out, leaves, o_lib
    return rows


def causal_backward_rows(torch, cs, launch, bwd, tag, b, hq, hkv, hd):
    """The flash backward and SDPA's at one causal training shape (2048
    positions), f32: {"flash_bwd_<tag>", "sdpa_bwd_<tag>": {"ms",
    "kernels_ms"}}."""
    import torch.nn.functional as F
    rows = {}
    s = 2048
    q, k, v = cs.attention_inputs(torch, b, hq, hkv, s, hd, torch.float32,
                                  seed=17)
    dout = torch.randn((b, hq, s, hd), device="cuda",
                       generator=torch.Generator(
                           device="cuda").manual_seed(18))
    lse = torch.empty((b, hq, s), device="cuda")
    out = launch(q, k, v, 0, 0, lse=lse)
    per = cs.device_ms(torch, lambda: bwd(q, k, v, out, dout, lse))
    rows[f"flash_bwd_{tag}"] = {
        "ms": sum(per.values()),
        "kernels_ms": {k_[:60]: v_ for k_, v_ in per.items()}}
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(
        *leaves, attn_mask=cs.flash_mask(torch, s, 0, 0), enable_gqa=True)
    per = cs.device_ms(torch, lambda: torch.autograd.grad(
        o_lib, leaves, dout, retain_graph=True))
    rows[f"sdpa_bwd_{tag}"] = {
        "ms": sum(per.values()),
        "kernels_ms": {k_[:60]: v_ for k_, v_ in per.items()}}
    return rows


def backward_rows(torch, cs, kernels_only=False):
    """The backward kernels' device times and one train step's."""
    import time

    from repro_torch.config import TrainConfig
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import (
        _launch, flash_attention_bwd, flash_attention_bwd_vd,
    )
    from repro_torch.kernels.ssd_scan import _launch as ssd_launch
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd
    from repro_torch.launch import train
    backend.build([name for name in backend.KERNELS
                   if name.startswith(("flash", "ssd"))])
    rows = {}
    b, s = cs.TRAIN_B, cs.LM_S
    for key, hq, hkv, hd, window, meta in (
            (f"flash_bwd_window{cs.LM_WINDOW}", cs.LM_HQ, cs.LM_HKV, cs.LM_HD,
             cs.LM_WINDOW, cs.LM_META),
            ("flash_bwd_window0", cs.LM_HQ, cs.LM_HKV, cs.LM_HD, 0,
             cs.LM_META)):
        q, k, v = cs.attention_inputs(torch, b, hq, hkv, s, hd,
                                      torch.float32, seed=17)
        dout = torch.randn((b, hq, s, hd), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(18))
        lse = torch.empty((b, hq, s), device="cuda")
        out = _launch(q, k, v, window, meta, lse=lse)
        per = cs.device_ms(torch, lambda: flash_attention_bwd(
            q, k, v, out, dout, lse, window=window, num_meta=meta))
        rows[key] = {"ms": sum(per.values()),
                     "kernels_ms": {k_[:60]: v_ for k_, v_ in per.items()}}
    for tag, bb, hq, hkv, hd in (("qwen2_hd128", b, 12, 2, 128),
                                 ("dbrx_hd128", cs.MOE_TRAIN_B, 48, 8, 128),
                                 ("gemma_hd256", 1, cs.WIDE_HQ, cs.WIDE_HKV,
                                  cs.WIDE_HD)):
        rows.update(causal_backward_rows(torch, cs, _launch,
                                         flash_attention_bwd, tag, bb, hq,
                                         hkv, hd))
    rows.update(mla_backward_rows(torch, cs, _launch, flash_attention_bwd_vd))
    for h, p, n, chunk in ((50, 64, 16, 128), (24, 64, 128, 256)):
        args, _ = cs.ssd_inputs(torch, b, s, h, p, n, 19, False)
        y, _, ws = ssd_launch(*args, chunk, None)
        dy = torch.randn_like(y)
        per = cs.device_ms(torch, lambda: ssd_scan_bwd(*args, ws, dy, None,
                                                       chunk=chunk))
        rows[f"ssd_bwd_h{h}_n{n}_chunk{chunk}"] = {
            "ms": sum(per.values()),
            "kernels_ms": {k_[:60]: v_ for k_, v_ in per.items()}}
    del q, k, v, dout, lse, out, args, y, ws, dy
    if kernels_only:
        return rows
    rows["hymba_prefill"] = hymba_prefill_ms(torch, cs)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train.run_lm_training(
        cs.LM_ARCH, reduced=False, batch=b, seq_len=cs.TRAIN_SEQ, steps=4,
        train_cfg=TrainConfig(lr=3e-3, remat=False), verbose=False)
    torch.cuda.synchronize()
    later = out["step_seconds"][1:]
    s_step = sum(later) / len(later)
    rows["hymba_train_step"] = {
        "seconds_per_step": s_step, "step_seconds": out["step_seconds"],
        "tokens_per_second": b * cs.TRAIN_SEQ / s_step,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": out["losses"], "seconds": time.perf_counter() - t0}
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--set", choices=("forward", "backward", "ptxas"),
                    default="forward",
                    help="forward (default): the forward kernels, prefill "
                         "and fedp2p; backward: the backward kernels and a "
                         "train step; ptxas: the flash kernels' registers "
                         "and spills")
    ap.add_argument("--kernels-only", action="store_true",
                    help="leave out the prefills, fedp2p and the train step")
    args = ap.parse_args()
    if args.set == "ptxas":
        sys.path.insert(0, str(Path(args.src).resolve()))
        from repro_torch.kernels import backend
        return emit(args, ptxas_usage(backend))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import backend
    from repro_torch.kernels.fed_mix_sparse import fed_mix_matching
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    backend.use_full_f32()
    if args.set == "backward":
        rows = backward_rows(torch, cs, args.kernels_only)
        return emit(args, rows)
    backend.build(("flash_attention", "ssd_scan", "fed_mix_matching",
                   "fed_mix_segment"))
    rows = {}

    def record(key, fn):
        per = cs.device_ms(torch, fn)
        rows[key] = {"ms": sum(per.values()),
                     "kernels_ms": {k[:60]: v for k, v in per.items()}}

    q, k, v = cs.attention_inputs(torch, cs.LM_B, cs.LM_HQ, cs.LM_HKV,
                                  cs.LM_S, cs.LM_HD, torch.float32, seed=7)
    for window in (cs.LM_WINDOW, 0):
        record(f"flash_window{window}",
               lambda: flash_attention(q, k, v, window=window,
                                       num_meta=cs.LM_META))
    qw, kw_, vw = cs.attention_inputs(torch, cs.LM_B, cs.WIDE_HQ,
                                      cs.WIDE_HKV, cs.LM_S, cs.WIDE_HD,
                                      torch.float32, seed=9)
    try:
        record("flash_gemma_hd256", lambda: flash_attention(qw, kw_, vw))
    except ValueError as exc:        # a tree whose wrapper caps head_dim
        rows["flash_gemma_hd256"] = {"ms": None, "error": str(exc)}
    # gemma-2b's training forward, B 1
    q1, k1, v1 = qw[:1], kw_[:1], vw[:1]
    if rows["flash_gemma_hd256"]["ms"] is not None:
        record("flash_gemma_hd256_b1", lambda: flash_attention(q1, k1, v1))
    del qw, kw_, vw, q1, k1, v1
    import torch.nn.functional as F
    # the dense models' GQA at 128 beside SDPA (nemotron's 48/8 is dbrx's)
    mask = cs.flash_mask(torch, cs.DENSE_PROMPT, 0, 0)
    for model, hq in (("nemotron", 48), ("yi", 56), ("chameleon", 64)):
        qd, kd, vd = cs.attention_inputs(torch, cs.LM_B, hq, 8,
                                         cs.DENSE_PROMPT, 128, torch.float32,
                                         seed=9)
        record(f"flash_{model}_hd128", lambda: flash_attention(qd, kd, vd))
        record(f"sdpa_{model}_hd128", lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True))
        del qd, kd, vd
    qm, km, vm = cs.attention_inputs(torch, cs.LM_B, cs.MLA_H, cs.MLA_H,
                                     cs.LM_S, cs.MLA_HD, torch.float32,
                                     seed=11, vd=cs.MLA_VD)
    try:
        record("flash_mla_192_128", lambda: flash_attention(qm, km, vm))
    except ValueError as exc:        # a tree whose wrapper needs vd = hd
        rows["flash_mla_192_128"] = {"ms": None, "error": str(exc)}
    record("sdpa_mla_192_128", lambda: F.scaled_dot_product_attention(
        qm, km, vm, is_causal=True))
    del qm, km, vm
    args_ssd, init = cs.ssd_inputs(torch, cs.LM_B, cs.LM_S, 50, 64, 16, 8,
                                   True)
    record("ssd_scan_hymba",
           lambda: ssd_scan(*args_ssd, chunk=128, initial_state=init))
    for stages in (2, 1):
        m = cs.matching_inputs(torch, cs.MAIN_D, cs.MAIN_P, stages,
                               torch.float32, seed=3)
        record(f"fed_mix_matching_S{stages}", lambda: fed_mix_matching(*m))
    del args_ssd, init, m
    if args.kernels_only:
        return emit(args, rows)
    rows["hymba_prefill"] = hymba_prefill_ms(torch, cs)
    torch.cuda.empty_cache()
    rows["deepseek_prefill"] = deepseek_prefill_ms(torch, cs)
    torch.cuda.empty_cache()
    rows["fedp2p_seconds_per_round"] = fedp2p_seconds_per_round(torch)
    return emit(args, rows)


def emit(args, rows) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    line = json.dumps({"label": args.label or args.src, "set": args.set,
                       "nvidia_smi": smi, "times": rows})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
