#!/usr/bin/env python3
"""Where the time of the flash kernels built on wgmma goes, by ablation.

    python3 scripts/torch_flash_variants.py --kernel KERNEL [KERNEL ...]
        [--parent DIR] [--out FILE]

Builds, beside the tree's own source, variants of it that each drop or
change one part of the kernel (every kernel's variants, all ``nvcc`` runs
started together, into ``build/flash_variants/<kernel>/``), prints
ptxas' registers, spills and warnings (a serialized wgmma) for each
variant's ablated kernels, and times each variant, f32 and bf16, beside
the library call on the same inputs (``chip_smoke.py``'s inputs and
``device_ms``), one JSON line per kernel and dtype. Needs the card and
``nvcc``.

``--kernel fwd``: ``flash_fwd_kernel_wgmma`` (``csrc/flash_attention.cu``)
at DeepSeek-V2's MLA prefill (B 4, 128 heads, q/k 192, v 128, S 2048,
causal), beside ``scaled_dot_product_attention(is_causal=True)``.

``--kernel bwd_vd``: ``flash_attention_bwd_vd``'s dK/dV and dQ passes
(``csrc/flash_attention_bwd_vd.cu``) at DeepSeek-V2's training shape (B 1,
128 heads, q/k 192, v 128, S 2048, causal), per pass by launch name,
beside the backward of ``scaled_dot_product_attention(is_causal=True)``.

``--kernel bwd256``: ``flash_attention_bwd_256`` (dK/dV and dQ passes by
launch name) at gemma-2b's training shape (B 1, MQA 8/1 of 256, S 2048,
causal), beside SDPA's backward (boolean mask, ``enable_gqa``).
``--kernel fwd256``: ``flash_fwd_kernel_wgmma256`` at gemma-2b's prefill
(B 4, same heads and S), beside SDPA. With ``--parent DIR`` (a tree of the
design before them, e.g. the parent commit unpacked under
``build/parent``) each also times that design and its suspects:
``old_sdp_once`` (S and dP once per row group of warps: half the k8 steps
each), ``old_rows16`` (16-row tiles, two blocks an SM), ``old_nospill``
(the dK/dV products two n8 tiles at a time; bit for bit the parent's,
``old_nospill_bitwise_equal_parent``) and ``old_one_slice`` (the wide
forward with one block per query tile and head: the scores once, P·V for
one 128-column slice).

``--kernel bwd128``: the backward at vd = hd = 128 with GQA at DBRX's
training shape (B 1, 48/8 of 128, S 2048, causal) by pass, beside SDPA's
backward; ``--kernel fwd128``: the forward at nemotron-4-15b's prefill
(B 4, 48/8 of 128, S 2048, causal), beside SDPA. With ``--parent DIR`` (the
tree before their redesign) each also times that design (``mma.sync``,
4 warps) and its suspects: ``old_unroll1`` (the backward's tile copies not
unrolled, K2's cure for hoisted addresses), ``old_ng4`` (its dK/dV and dQ
products four n8 tiles at a time: fewer live partials, bit for bit the
parent's, ``old_ng4_bitwise_equal_parent``), ``old_qreg`` (the forward's Q
fragments split once into registers, as at hd <= 64; bit for bit,
``old_qreg_bitwise_equal_parent``) and ``old_kv1`` (one K/V buffer instead
of two: 101 KB of shared memory, two blocks an SM; the next tile's copies
land over the one being read, so its output is wrong by design).
``--only-parent`` times the parent and its suspects alone.

The variants:

* ``noprod``: the producer loads and stores nothing (it still fills and
  frees the ring's barriers; at 256 the rings' bulk copies are left out):
  the consumers' own time;
* ``nomma``: the consumers issue no tensor-core product: the producer's
  time, with the consumers' elementwise work;
* ``noload``: the producer stores made-up values instead of loading (at
  256: every bulk copy reads the image's first stage, an L2 hit): the
  time without the global loads;
* ``rawhi`` (bwd_vd): the producer stores each f32 as it is for its TF32
  hi part (lo still x minus x truncated to 19 bits): the result equals
  the tree's bit for bit exactly when the tensor cores read an f32
  operand as its truncation to TF32 (``rawhi_bitwise_equal_tree``), the
  condition on which a copy engine (TMA, cp.async) could land the hi part
  unconverted;
* ``dsreread`` (bwd_vd): the dK warpgroup reads dSᵀ's A fragments from
  the swap two k8 steps at a time for each Qᵀ stage instead of a 32-query
  half at a time for three stages: fewer live registers, more waits; its
  result equals the tree's bit for bit (``dsreread_bitwise_equal_tree``).

``noprod``, ``nomma`` and ``noload`` also skip the full-split pass, which
a garbage result would take; their outputs are wrong by design and only
their times mean something.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

# a patch: (file, old, new, count), old exact text or a regex after "re:"
NO_MMA = [("wgmma.cuh", rf"re:(void {f}\(.*?\) \{{\n)", r"\1  return;\n", 1)
          for f in ("mma_ss", "mma_rs64", "mma_rs")]


def no_redo(fname, count):
    return (fname, r"re:if \(n < 0\) break;\n\s*[nm]0 = \(uint32_t\)n;",
            "break;", count)


FWD = "flash_attention.cu"
FWD_NO_LOAD = [
    (FWD, "    for (int i = 0; i < 8; ++i) x[i] = ld_raw<T>(base + (row0 + 8 * "
     "i + (p >> 4)) * stride + col);",
     "    for (int i = 0; i < 8; ++i) x[i] = make_uint4(i, 0u, 0u, 0u);", 1),
    (FWD, "    for (int c = 0; c < 8; ++c) x[c] = ld_raw<T>(r + 8 * c);",
     "    for (int c = 0; c < 8; ++c) x[c] = make_uint4(c, 0u, 0u, 0u);", 1),
]
FWD_NO_STORE = [
    (FWD, "  const int off0 = ((p & 15) >> 3) * kAtom;",
     "  return;\n  const int off0 = ((p & 15) >> 3) * kAtom;", 1),
    (FWD, "  const int kp = 16 * (w & 1) + (l & 15);\n  const int pos",
     "  return;\n  const int kp = 16 * (w & 1) + (l & 15);\n  const int pos", 1),
]

BWD = "flash_attention_bwd_vd.cu"
# the producer's stages and the products over an atom (shared header)
BWD_H = "wgmma.cuh"
BWD_NO_LOAD = [
    (BWD_H, "      x[i] = ld_raw<T>(base + (long long)(row0 + (p >> 3) + 16 * i) "
     "* stride + col);", "      x[i] = make_uint4(i, 0u, 0u, 0u);", 1),
    (BWD_H, "    for (int m = 0; m < 4; ++m) x[m] = ld_raw<T>(r + 4 * m);",
     "    for (int m = 0; m < 4; ++m) x[m] = make_uint4(m, 0u, 0u, 0u);", 1),
]
BWD_NO_STORE = [(BWD_H, rf"re:(void {f}\(.*?\) \{{\n)", r"\1  return;\n", 1)
                for f in ("put_rows", "put_cols")]
RAW_HI = [
    ("wgmma.cuh",
     "    hi = __float_as_uint(x) & kTrunc;\n"
     "    lo = __float_as_uint(x - __uint_as_float(hi));",
     "    lo = __float_as_uint(x - __uint_as_float(__float_as_uint(x) & "
     "kTrunc));\n    hi = __float_as_uint(x);", 1),
]
DS_REREAD = [
    (BWD_H, "template <bool kBf16, int N>\n__device__ __forceinline__ void "
     "rs_atom(", "template <bool kBf16, int N, int KS = 4>\n"
     "__device__ __forceinline__ void rs_atom(", 1),
    (BWD_H, "uint64_t b_lo) {\n#pragma unroll\n  for (int kk = 0; kk < 4; ++kk) "
     "{\n    const int j = 4 * (j0 + kk);\n    const uint64_t o = 2 * kk;",
     "uint64_t b_lo, int b0 = 0) {\n#pragma unroll\n"
     "  for (int kk = 0; kk < KS; ++kk) {\n    const int j = 4 * (j0 + kk);\n"
     "    const uint64_t o = 2 * (b0 + kk);", 1),
    (BWD, """        uint32_t fh[16], fl[16];
        float half[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) half[r] = swap[(16 * hh + r) * 128 + tid];
        split_frags(half, fh, fl, slow);
#pragma unroll
        for (int c = 0; c < NKC; ++c) {
          const uint32_t n = nb + S::PH + S::pos_k(hh * NKC + c);
          const uint32_t st = take(n);
          zero(part);
          mma_fence();
          rs_atom<kBf16>(part, fh, fl, 0, desc(st), desc(st + kAtom));
          mma_commit();
          mma_wait<0>();
          warp_arrive(empty(n));
          keep(part);
          keep(fh);
          keep(fl);
""", """#pragma unroll
        for (int c = 0; c < NKC; ++c) {
          const uint32_t n = nb + S::PH + S::pos_k(hh * NKC + c);
          const uint32_t st = take(n);
          zero(part);
#pragma unroll
          for (int kp = 0; kp < 2; ++kp) {
            float ds[8];
            uint32_t fh[8], fl[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) ds[r] = swap[(16 * hh + 8 * kp + r) * 128 + tid];
            split_frags(ds, fh, fl, slow);
            mma_fence();
            rs_atom<kBf16, 8, 2>(part, fh, fl, 0, desc(st), desc(st + kAtom), 2 * kp);
            mma_commit();
            mma_wait<0>();
            keep(fh);
            keep(fl);
          }
          warp_arrive(empty(n));
          keep(part);
""", 1),
]

# The design that ran hd = vd = 256 before flash_attention_bwd_256.cu and
# flash_fwd_kernel_wgmma256 (``--parent``: a tree whose csrc holds it): one
# variant a suspect, each timed alone. Their outputs are wrong by design
# (all but nospill).
OLD_BWD = "flash_attention_bwd.cu"
OLD_BWD_NO_REDO = [
    (OLD_BWD, "  if (dkdv_block<T, HD, false>(q, k, v, dout, a)) "
     "dkdv_block_full<T, HD>(q, k, v, dout, a);",
     "  dkdv_block<T, HD, false>(q, k, v, dout, a);", 1),
    (OLD_BWD, "  if (dq_block<T, HD, false>(q, k, v, dout, dq, a)) "
     "dq_block_full<T, HD>(q, k, v, dout, dq, a);",
     "  dq_block<T, HD, false>(q, k, v, dout, dq, a);", 1),
]
OLD_BWD_VARIANTS = {
    # S and dP once per row group: each warp takes half of the k8 steps
    # (the two warps of a row group computed all 256 each)
    "old_sdp_once": OLD_BWD_NO_REDO + [
        (OLD_BWD, "  for (int ks = 0; ks < HD / 8; ++ks) {",
         "  for (int ks = 0; ks < (HD > 128 ? HD / 16 : HD / 8); ++ks) {",
         1)],
    # 16-row tiles: 100 KB of shared memory, two blocks an SM; every warp
    # owns 64 output columns and computes S and dP over all 256
    "old_rows16": [(OLD_BWD, "static constexpr int kT = HD > 128 ? 32 : 64;",
                    "static constexpr int kT = HD > 128 ? 16 : 64;", 1)],
    # the dK/dV products two n8 tiles at a time (four before): fewer live
    # partials, the same sums in the same order (bit for bit)
    "old_nospill": [(OLD_BWD, "DC / 8 < 8 ? DC / 8 : HD > 128 ? 4 : 8;",
                     "DC / 8 < 8 ? DC / 8 : HD > 128 ? 2 : 8;", 1)],
}
# the wide forward: one block per query tile and head instead of one per
# 128-column slice of O: the scores once, P·V for one slice
OLD_FWD_VARIANTS = {
    "old_one_slice": [
        (FWD, "  kernel<<<dim3(n_qt, hq * n_sl, batch), kThreads, bytes, "
         "stream>>>(", "  kernel<<<dim3(n_qt, hq, batch), kThreads, bytes, "
         "stream>>>(", 1)],
}

# The designs that ran vd = hd = 128 before their redesign (``--parent``)
OLD_FWD_NO_REDO = [
    (FWD, "    flash_block_full<T, HD, kLse>(q, k, v, o, lse, sq, sk, sv, so, group, "
     "n_q, n_k, hd, scale,", "    if (false) flash_block_full<T, HD, kLse>(q, k, "
     "v, o, lse, sq, sk, sv, so, group, n_q, n_k, hd, scale,", 1)]
OLD128_BWD_VARIANTS = {
    "old_unroll1": [(OLD_BWD, "#pragma unroll\n  for (int i = 0; i < KT * CPR / "
                     "kThreads; ++i) {", "#pragma unroll 1\n  for (int i = 0; "
                     "i < KT * CPR / kThreads; ++i) {", 1)],
    "old_ng4": [(OLD_BWD, "DC / 8 < 8 ? DC / 8 : 8;", "DC / 8 < 8 ? DC / 8 : 4;",
                 1)],
}
OLD128_FWD_VARIANTS = {
    "old_qreg": [(FWD, "constexpr bool kQReg = HD <= 64;",
                  "constexpr bool kQReg = HD <= 128;", 1)],
    "old_kv1": OLD_FWD_NO_REDO + [
        (FWD, "(kBQ + 4 * kBK);  // Q, K x 2, V x 2", "(kBQ + 2 * kBK);", 1),
        (FWD, "T* Vs = Ks + 2 * kBK * PT;              // [2][kBK][PT]",
         "T* Vs = Ks + kBK * PT;", 1),
        (FWD, "copy_tile<T, HD>(Ks + (buf ^ 1) * kBK * PT, kb,",
         "copy_tile<T, HD>(Ks, kb,", 1),
        (FWD, "copy_tile<T, HD>(Vs + (buf ^ 1) * kBK * PT, vb,",
         "copy_tile<T, HD>(Vs, vb,", 1),
        (FWD, "const T* Kt = Ks + buf * kBK * PT;", "const T* Kt = Ks;", 1),
        (FWD, "const T* Vt = Vs + buf * kBK * PT;", "const T* Vt = Vs;", 1)],
}

# The redesign at hd = vd = 256: its producer lands no stage (it arrives on
# the full barriers alone: the consumers' own time), or lands every stage
# from one image stage (an L2 hit each: the time without the images'
# traffic); "nomma" as above
BWD256 = "flash_attention_bwd_256.cu"
# the producer's one copy call, in the rings both redesigns share
NO_LAND = [
    ("wgmma.cuh", "    bar_arrive_tx(full(m), b != nullptr ? 2 * part : part);\n"
     "    bulk_copy(slot(m), a, part, full(m));\n"
     "    if (b != nullptr) bulk_copy(slot(m) + part, b, part, full(m));",
     "    bar_arrive(full(m));", 1)]
BWD256_NO_LOAD = [
    (BWD256, "  return im.p[which] + ((((long long)b * heads + h) * tiles + tile) "
     "* (HD / 32) + s) * kStage;", "  return im.p[which];", 1)]
FWD256_NO_LOAD = [
    (FWD, "  return images + (vt ? per : 0) + ((((long long)b * hkv + hk) * n_kt "
     "+ kt) * kNA + s) * kStage;", "  return images + (vt ? per : 0);", 1)]

# the wgmma designs at vd = hd (128 and 256 share their source)
BWD_WG_VARIANTS = {"noprod": [no_redo(BWD256, 2)] + NO_LAND,
                   "nomma": [no_redo(BWD256, 2)] + NO_MMA,
                   "noload": [no_redo(BWD256, 2)] + BWD256_NO_LOAD}
FWD_WG_VARIANTS = {"noprod": [no_redo(FWD, 2)] + NO_LAND,
                   "nomma": [no_redo(FWD, 2)] + NO_MMA,
                   "noload": [no_redo(FWD, 2)] + FWD256_NO_LOAD}

KERNELS = {
    "fwd": {"source": FWD, "lib": "flash_attention",
            "label": r"wgmmaI(\w+?)Li(\d)E",
            "variants": {"noprod": [no_redo(FWD, 2)] + FWD_NO_LOAD
                         + FWD_NO_STORE,
                         "nomma": [no_redo(FWD, 2)] + NO_MMA,
                         "noload": [no_redo(FWD, 2)] + FWD_NO_LOAD}},
    "bwd_vd": {"source": BWD, "lib": "flash_attention_bwd_vd",
               "label": r"(dkdv|dq)_wgmma_kernelI(\w+?)Li(\d+)ELi(\d+)E",
               "variants": {"noprod": [no_redo(BWD, 3)] + BWD_NO_LOAD
                            + BWD_NO_STORE,
                            "nomma": [no_redo(BWD, 3)] + NO_MMA,
                            "noload": [no_redo(BWD, 3)] + BWD_NO_LOAD,
                            "rawhi": RAW_HI,
                            "dsreread": DS_REREAD}},
    "bwd256": {"source": OLD_BWD, "lib": "flash_attention_bwd",
               "new_source": BWD256, "new_lib": "flash_attention_bwd_256",
               "label": r"flash_bwd_(dkdv|dq)_kernelI(\w+?)Li256E"
                        r"|flash_bwd_256_(dkdv|dq|image)_kernelI(\w+?)E",
               "parent_variants": OLD_BWD_VARIANTS,
               "variants": BWD_WG_VARIANTS},
    "fwd256": {"source": FWD, "lib": "flash_attention",
               "label": r"flash_fwd_kernel_wideI(\w+?)Lb(\d)E"
                        r"|flash_fwd_kernel_(wgmma256|image256)I(\w+?)E",
               "parent_variants": OLD_FWD_VARIANTS,
               "variants": FWD_WG_VARIANTS},
    # the same source at head width 128, and the mma.sync kernels it replaced
    "bwd128": {"source": OLD_BWD, "lib": "flash_attention_bwd",
               "new_source": BWD256, "new_lib": "flash_attention_bwd_256",
               "label": r"flash_bwd_(dkdv|dq)_kernelI(\w+?)Li128E"
                        r"|flash_bwd_128_(dkdv|dq|image)_kernelI(\w+?)E",
               "parent_variants": OLD128_BWD_VARIANTS,
               "variants": BWD_WG_VARIANTS},
    "fwd128": {"source": FWD, "lib": "flash_attention",
               "label": r"flash_fwd_kernelI(\w+?)Li128ELb(\d)E"
                        r"|flash_fwd_kernel_(wgmma128|image128)I(\w+?)E",
               "parent_variants": OLD128_FWD_VARIANTS,
               "variants": FWD_WG_VARIANTS},
}


def patched(texts: dict, patches) -> dict:
    """The sources with each patch applied, where it matches ``count``
    times."""
    out = dict(texts)
    for fname, old, new, count in patches:
        text = out[fname]
        if old.startswith("re:"):
            text, n = re.subn(old[3:], new, text, flags=re.S)
        else:
            n = text.count(old)
            text = text.replace(old, new)
        if n != count:
            raise RuntimeError(f"{fname}: expected {count} of {old[:60]!r}, "
                               f"found {n}")
        out[fname] = text
    return out


def ptxas_report(out: str, tag: str, label: str) -> None:
    """The ablated kernels' registers and spills by instantiation (the
    functions whose mangled name matches ``label``), and ptxas'
    warnings."""
    name = None
    for line in out.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"([\w$.]+)", line)
        if m:
            name = m.group(1)
        kind = re.search(label, name) if name else None
        if kind and ("Used" in line or "spill" in line):
            print(tag, kind.groups(), "|", line.strip()[:120])
        if "warning" in line.lower():
            print(tag, "warning:", line.strip()[:200])


def sources(root: Path) -> dict:
    """The kernel sources and shared headers of the tree at ``root``."""
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    return {f.name: f.read_text() for f in csrc.iterdir()
            if f.suffix in (".cu", ".cuh")}


def variants(kernel: str, parent: Path, only_parent=False) -> dict:
    """{variant: (its sources, the file nvcc builds)}: the tree's source
    and its ablations (not with ``only_parent``); with
    ``parent_variants``, the parent's source (``parent``) and its own
    ablations."""
    spec = KERNELS[kernel]
    tree = sources(ROOT)
    out = {}
    if spec.get("parent_variants") and parent is not None:
        old = sources(parent)
        for name, patches in {"parent": [],
                              **spec["parent_variants"]}.items():
            out[name] = (patched(old, patches), spec["source"])
    if not only_parent:
        src = spec.get("new_source", spec["source"])
        for name, patches in {"tree": [], **spec["variants"]}.items():
            out[name] = (patched(tree, patches), src)
    return out


def start_build(backend, kernel: str, parent: Path, only_parent=False):
    """Start every variant's nvcc, each into ``build/flash_variants/
    <kernel>/<variant>/lib.so``; -> (the directory, the processes)."""
    work = ROOT / "build" / "flash_variants" / kernel
    procs = {}
    for name, (texts, source) in variants(kernel, parent,
                                          only_parent).items():
        d = work / name
        d.mkdir(parents=True, exist_ok=True)
        if (d / "lib.so").exists() and all(
                (d / f).exists() and (d / f).read_text() == t
                for f, t in texts.items()):
            print(f"{kernel}/{name}: built before, same sources", flush=True)
            continue
        (d / "lib.so").unlink(missing_ok=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [backend.nvcc(), *backend.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(d / "lib.so"), str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return work, procs


def finish_build(kernel: str, procs: dict, t0: float) -> set:
    """Wait for the variants' nvcc and print ptxas' report of each; -> the
    variants that failed to build (their nvcc output printed; the others
    are timed)."""
    failed = set()
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc {kernel}/{name} FAILED:\n{out[-3000:]}", flush=True)
            failed.add(name)
            continue
        print(f"{kernel}/{name}: built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        ptxas_report(out, f"{kernel}/{name}", KERNELS[kernel]["label"])
    return failed


def time_fwd_vd(torch, cs, use, row, dt):
    """The forward at the MLA prefill, each variant and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = cs.attention_inputs(torch, cs.LM_B, cs.MLA_H, cs.MLA_H,
                                  cs.LM_S, cs.MLA_HD, dt, seed=11,
                                  vd=cs.MLA_VD)
    for name in use:
        use[name]()
        per = cs.device_ms(torch, lambda: flash_attention(q, k, v))
        row[f"{name}_ms"] = sum(t for key, t in per.items() if "wgmma" in key)
    row["sdpa_ms"] = sum(cs.device_ms(
        torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)).values())


def time_bwd_vd(torch, cs, use, row, dt):
    """K2 at DeepSeek-V2's training shape, each variant by pass, the
    variants that compute the same function held to the tree's bits, and
    SDPA's backward."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        _launch, flash_attention_bwd_vd,
    )
    b, h, s = cs.MOE_TRAIN_B, cs.MLA_H, cs.MOE_TRAIN_SEQ
    q, k, v = cs.attention_inputs(torch, b, h, h, s, cs.MLA_HD, dt, seed=11,
                                  vd=cs.MLA_VD)
    dout = torch.randn((b, h, s, cs.MLA_VD), device="cuda",
                       generator=torch.Generator(
                           device="cuda").manual_seed(12)).to(dt)
    lse = torch.empty((b, h, s), device="cuda")
    out = _launch(q, k, v, 0, 0, lse=lse)
    grads = {}
    for name in use:
        use[name]()
        per = cs.device_ms(torch, lambda: flash_attention_bwd_vd(
            q, k, v, out, dout, lse))
        row[f"{name}_ms"] = sum(per.values())
        row[f"{name}_passes_ms"] = {
            p: sum(t for key, t in per.items() if f"{p}_wgmma" in key)
            for p in ("dkdv", "dq")}
        if name in ("tree", "rawhi", "dsreread"):
            grads[name] = flash_attention_bwd_vd(q, k, v, out, dout, lse)
    for name in ("rawhi", "dsreread"):
        pairs = list(zip(grads["tree"], grads[name]))
        row[f"{name}_bitwise_equal_tree"] = all(
            torch.equal(x, y) for x, y in pairs)
        row[f"{name}_max_abs_diff"] = max(
            float((x.float() - y.float()).abs().max()) for x, y in pairs)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*leaves, is_causal=True)
    row["sdpa_bwd_ms"] = sum(cs.device_ms(
        torch, lambda: torch.autograd.grad(o_lib, leaves, dout,
                                           retain_graph=True)).values())


# (B, Hq, Hkv, hd) a kernel is timed at, 2048 positions, causal: gemma-2b's
# training backward and prefill at 256; DBRX's training backward and
# nemotron-4-15b's prefill at 128
SHAPES = {"bwd256": (1, 8, 1, 256), "fwd256": (4, 8, 1, 256),
          "bwd128": (1, 48, 8, 128), "fwd128": (4, 48, 8, 128)}
# variants that compute the parent's function in its order: held to its bits
BITWISE = ("old_nospill", "old_ng4", "old_qreg")


def bwd_inputs(torch, cs, dt, b, hq, hkv, hd):
    """A training shape (2048 positions, causal): q, k, v, the forward's
    output and the rows' log-sum-exp (the plain version's, so that no
    forward kernel of any variant is needed), and dO."""
    from repro_torch.kernels import ref
    s = 2048
    q, k, v = cs.attention_inputs(torch, b, hq, hkv, s, hd, dt, seed=17)
    dout = torch.randn((b, hq, s, hd), device="cuda",
                       generator=torch.Generator(
                           device="cuda").manual_seed(18)).to(dt)
    kk = k.repeat_interleave(hq // hkv, dim=1).float()
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * hd ** -0.5
    mask = cs.flash_mask(torch, s, 0, 0)
    lse = torch.logsumexp(scores.masked_fill(~mask, -1e30), dim=-1)
    del kk, scores
    out = ref.flash_attention_ref(q, k, v)
    return q, k, v, out, dout, lse


def old_bwd(torch, lib, q, k, v, out, dout, lse, rows):
    """The parent's ``flash_attention_bwd_launch`` from ``lib``, with
    workspaces for tiles of ``rows`` (32 in the parent, 16 in
    ``old_rows16``)."""
    b, hq, sq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    f32, dev = torch.float32, q.device
    delta = torch.empty((b, hq, sq), dtype=f32, device=dev)
    dkp = torch.empty((b, hq, tk, 256), dtype=f32, device=dev)
    dvp = torch.empty_like(dkp)
    qflags = torch.empty((b, hq, -(-sq // rows), 8), dtype=torch.int32,
                         device=dev)
    dflags = torch.empty_like(qflags)
    kflags = torch.empty((b, hkv, -(-tk // rows), 8), dtype=torch.int32,
                         device=dev)
    strides = (ctypes.c_longlong * 24)(
        *[s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]])
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), dkp.data_ptr(), dvp.data_ptr(),
            qflags.data_ptr(), dflags.data_ptr(), kflags.data_ptr(), strides,
            b, hq, hq // hkv, sq, tk, hd, hd ** -0.5, 0, 0,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_bwd_launch: cudaError {rc}")
    return dq, dk, dv


def old_fwd(torch, lib, q, k, v):
    """The parent's ``flash_attention_launch`` from ``lib`` (no lse; the
    entry point with the images' and the log-sum-exp's pointers)."""
    from repro_torch.kernels.flash_attention import _empty_out
    b, hq, sq, hd = q.shape
    hkv, tk, vd = k.shape[1], k.shape[2], v.shape[3]
    out = _empty_out(q, vd)
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (q, k, v, out) for s in t.stride()[:3]])
    vflags = torch.empty((b, hkv, -(-tk // 64), 4 * -(-vd // 128)),
                         dtype=torch.int32, device=q.device)
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            vflags.data_ptr(), None, None, b, hq, hq // hkv, sq, tk, hd, vd,
            hd ** -0.5, 0, 0, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_launch: cudaError {rc}")
    return out


def time_bwd(torch, cs, libs, row, dt, kernel):
    """The backward at ``SHAPES[kernel]``: the parent's design and its
    suspects by pass (``BITWISE`` held to the parent's bits), the tree's
    design and its ablations, and SDPA's backward."""
    import torch.nn.functional as F

    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    q, k, v, out, dout, lse = bwd_inputs(torch, cs, dt, *SHAPES[kernel])
    grads = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        if name == "parent" or name.startswith("old_"):
            rows = (16 if name == "old_rows16"
                    else 32 if kernel == "bwd256" else 64)

            def call():
                return old_bwd(torch, lib, q, k, v, out, dout, lse, rows)
        else:
            backend._libs[KERNELS[kernel]["new_lib"]] = lib

            def call():
                return flash_attention_bwd(q, k, v, out, dout, lse)
        per = cs.device_ms(torch, call)
        row[f"{name}_ms"] = sum(per.values())
        row[f"{name}_passes_ms"] = {
            key: round(t, 4) for key, t in per.items()
            if "dkdv" in key or "_dq" in key}
        if name in ("parent", "tree") + BITWISE:
            grads[name] = call()
    for name in BITWISE:
        if name in grads:
            row[f"{name}_bitwise_equal_parent"] = all(
                torch.equal(x, y) for x, y in zip(grads["parent"],
                                                  grads[name]))
    mask = cs.flash_mask(torch, q.shape[2], 0, 0)
    lib_in = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*lib_in, attn_mask=mask,
                                           enable_gqa=True)
    row["sdpa_bwd_ms"] = sum(cs.device_ms(
        torch, lambda: torch.autograd.grad(o_lib, lib_in, dout,
                                           retain_graph=True)).values())


def time_fwd(torch, cs, libs, row, dt, kernel):
    """The forward at ``SHAPES[kernel]`` (a prefill: gemma-2b's at 256,
    nemotron-4-15b's at 128): the parent's kernel and its suspects
    (``BITWISE`` held to the parent's bits), the tree's design and its
    ablations, and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import flash_attention
    b, hq, hkv, hd = SHAPES[kernel]
    q, k, v = cs.attention_inputs(torch, b, hq, hkv, 2048, hd, dt, seed=9)
    outs = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        if name == "parent" or name.startswith("old_"):
            def call():
                return old_fwd(torch, lib, q, k, v)
        else:
            backend._libs["flash_attention"] = lib

            def call():
                return flash_attention(q, k, v)
        per = cs.device_ms(torch, call)
        row[f"{name}_ms"] = sum(t for key, t in per.items()
                                if "vflags" not in key and "nanfix" not in key)
        if name in ("parent",) + BITWISE:
            outs[name] = call()
    for name in BITWISE:
        if name in outs:
            row[f"{name}_bitwise_equal_parent"] = torch.equal(
                outs["parent"], outs[name])
    mask = cs.flash_mask(torch, q.shape[2], 0, 0)
    row["sdpa_ms"] = sum(cs.device_ms(
        torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)).values())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), nargs="+",
                    required=True, help="one or more; every variant of all "
                    "of them builds at once, then each is timed in turn")
    ap.add_argument("--parent", default="",
                    help="a tree holding the parent design's sources (bwd256 "
                         "and fwd256, bwd128 and fwd128: the design before "
                         "the redesign at that head_dim, and its suspects); "
                         "without it only the tree's variants")
    ap.add_argument("--only-parent", action="store_true",
                    help="with --parent: the parent and its suspects alone")
    ap.add_argument("--build-only", action="store_true",
                    help="build the variants and print ptxas' report, time "
                         "nothing (a later run reuses the builds)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available() and not args.build_only:
        print("needs a CUDA card", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from repro_torch.kernels import backend
    parent = Path(args.parent) if args.parent else None
    t0 = time.perf_counter()
    started = {kernel: start_build(backend, kernel, parent,
                                   args.only_parent)
               for kernel in args.kernel}
    # fwd and bwd_vd use the tree's libraries beside their variants
    if set(args.kernel) - set(SHAPES):
        backend.build(("flash_attention", "flash_attention_bwd"))
    failed = {kernel: finish_build(kernel, procs, t0)
              for kernel, (_, procs) in started.items()}
    if args.build_only:
        return 0
    backend.use_full_f32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for kernel, (work, _) in started.items():
        spec = KERNELS[kernel]
        names = [name for name in variants(kernel, parent, args.only_parent)
                 if name not in failed[kernel]]
        libs = {name: work / name / "lib.so" for name in names}

        def loader(name):
            def use():
                backend._libs[spec["lib"]] = ctypes.CDLL(str(libs[name]))
            return use

        for dt in (torch.float32, torch.bfloat16):
            row = {"kernel": kernel, "dtype": str(dt)[6:], "nvidia_smi": smi}
            if kernel in SHAPES:
                (time_bwd if kernel.startswith("bwd") else time_fwd)(
                    torch, cs, libs, row, dt, kernel)
            else:
                (time_fwd_vd if kernel == "fwd" else time_bwd_vd)(
                    torch, cs, {name: loader(name) for name in names}, row,
                    dt)
            for lib in ("flash_attention", "flash_attention_bwd",
                        "flash_attention_bwd_vd", "flash_attention_bwd_256"):
                backend._libs.pop(lib, None)
            emit_row(row, args.out)
            torch.cuda.empty_cache()
    return 0


def emit_row(row, out) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    sys.exit(main())
