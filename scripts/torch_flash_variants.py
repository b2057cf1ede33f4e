#!/usr/bin/env python3
"""Where the time of the flash kernels built on wgmma goes, by ablation.

    python3 scripts/torch_flash_variants.py --kernel fwd|bwd_vd [--out FILE]

Builds, beside the tree's own source, variants of it that each drop or
change one part of the kernel (all ``nvcc`` runs started together, into
``build/flash_variants/<kernel>/``), prints ptxas' registers, spills and
warnings (a serialized wgmma) for each variant's wgmma instantiations,
and times each variant, f32 and bf16, beside the library call on the same
inputs (``chip_smoke.py``'s inputs and ``device_ms``), one JSON line per
dtype. Needs the card and ``nvcc``.

``--kernel fwd``: ``flash_fwd_kernel_wgmma`` (``csrc/flash_attention.cu``)
at DeepSeek-V2's MLA prefill (B 4, 128 heads, q/k 192, v 128, S 2048,
causal), beside ``scaled_dot_product_attention(is_causal=True)``.

``--kernel bwd_vd``: ``flash_attention_bwd_vd``'s dK/dV and dQ passes
(``csrc/flash_attention_bwd_vd.cu``) at DeepSeek-V2's training shape (B 1,
128 heads, q/k 192, v 128, S 2048, causal), per pass by launch name,
beside the backward of ``scaled_dot_product_attention(is_causal=True)``.

The variants:

* ``noprod``: the producer loads and stores nothing (it still fills and
  frees the ring's barriers): the consumers' own time;
* ``nomma``: the consumers issue no tensor-core product: the producer's
  time, with the consumers' elementwise work;
* ``noload``: the producer stores made-up values instead of loading: the
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
    return (fname, r"re:if \(n < 0\) break;\n\s*n0 = \(uint32_t\)n;",
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
BWD_NO_LOAD = [
    (BWD, "      x[i] = ld_raw<T>(base + (long long)(row0 + (p >> 3) + 16 * i) "
     "* stride + col);", "      x[i] = make_uint4(i, 0u, 0u, 0u);", 1),
    (BWD, "    for (int m = 0; m < 4; ++m) x[m] = ld_raw<T>(r + 4 * m);",
     "    for (int m = 0; m < 4; ++m) x[m] = make_uint4(m, 0u, 0u, 0u);", 1),
]
BWD_NO_STORE = [(BWD, rf"re:(void {f}\(.*?\) \{{\n)", r"\1  return;\n", 1)
                for f in ("put_rows", "put_cols")]
RAW_HI = [
    ("wgmma.cuh",
     "    hi = __float_as_uint(x) & kTrunc;\n"
     "    lo = __float_as_uint(x - __uint_as_float(hi));",
     "    lo = __float_as_uint(x - __uint_as_float(__float_as_uint(x) & "
     "kTrunc));\n    hi = __float_as_uint(x);", 1),
]
DS_REREAD = [
    (BWD, "template <bool kBf16, int N>\n__device__ __forceinline__ void "
     "rs_atom(", "template <bool kBf16, int N, int KS = 4>\n"
     "__device__ __forceinline__ void rs_atom(", 1),
    (BWD, "uint64_t b_lo) {\n#pragma unroll\n  for (int kk = 0; kk < 4; ++kk) "
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

KERNELS = {
    "fwd": {"source": FWD, "lib": "flash_attention",
            "label": r"wgmmaI(\w+?)Li(\d)E",
            "variants": {"noprod": [no_redo(FWD, 1)] + FWD_NO_LOAD
                         + FWD_NO_STORE,
                         "nomma": [no_redo(FWD, 1)] + NO_MMA,
                         "noload": [no_redo(FWD, 1)] + FWD_NO_LOAD}},
    "bwd_vd": {"source": BWD, "lib": "flash_attention_bwd_vd",
               "label": r"(dkdv|dq)_wgmma_kernelI(\w+?)Li(\d+)ELi(\d+)E",
               "variants": {"noprod": [no_redo(BWD, 3)] + BWD_NO_LOAD
                            + BWD_NO_STORE,
                            "nomma": [no_redo(BWD, 3)] + NO_MMA,
                            "noload": [no_redo(BWD, 3)] + BWD_NO_LOAD,
                            "rawhi": RAW_HI,
                            "dsreread": DS_REREAD}},
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
    """The wgmma kernels' registers and spills by instantiation, and
    ptxas' warnings."""
    name = None
    for line in out.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"([\w$.]+)", line)
        if m:
            name = m.group(1)
        if name and "wgmma" in name and ("Used" in line or "spill" in line):
            kind = re.search(label, name)
            print(tag, kind.groups() if kind else name[:60], "|",
                  line.strip()[:120])
        if "warning" in line.lower():
            print(tag, "warning:", line.strip()[:200])


def build(backend, kernel: str, meanwhile=None) -> Path:
    """Every variant's library, each under ``build/flash_variants/<kernel>/
    <variant>/lib.so``; ``meanwhile`` runs while nvcc does."""
    spec = KERNELS[kernel]
    texts = {spec["source"]: (backend.CSRC / spec["source"]).read_text()}
    for header in backend.CSRC.glob("*.cuh"):
        texts[header.name] = header.read_text()
    work = ROOT / "build" / "flash_variants" / kernel
    procs = {}
    for name, patches in {"tree": [], **spec["variants"]}.items():
        d = work / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in patched(texts, patches).items():
            (d / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [backend.nvcc(), *backend.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(d / "lib.so"), str(d / spec["source"])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if meanwhile:
        meanwhile()
    t0 = time.perf_counter()
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{out[-3000:]}")
        print(f"{name}: built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        ptxas_report(out, name, spec["label"])
    return work


def time_fwd(torch, cs, use, row, dt):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from repro_torch.kernels import backend
    spec = KERNELS[args.kernel]
    # the backward needs the forward's lse
    work = build(backend, args.kernel, meanwhile=(
        (lambda: backend.build(("flash_attention",)))
        if args.kernel == "bwd_vd" else None))
    backend.use_full_f32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()

    def loader(name):
        def use():
            backend._libs[spec["lib"]] = ctypes.CDLL(
                str(work / name / "lib.so"))
        return use

    use = {name: loader(name) for name in ("tree", *spec["variants"])}
    timer = time_fwd if args.kernel == "fwd" else time_bwd_vd
    for dt in (torch.float32, torch.bfloat16):
        row = {"kernel": args.kernel, "dtype": str(dt)[6:], "nvidia_smi": smi}
        timer(torch, cs, use, row, dt)
        backend._libs.pop(spec["lib"])
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
