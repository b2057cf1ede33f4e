#!/usr/bin/env python3
"""Where the time of flash_attention's wgmma kernel goes, by ablation.

    python3 scripts/torch_flash_variants.py [--out FILE]

Builds, beside the tree's own ``csrc/flash_attention.cu``, variants of it
that each drop one part of ``flash_fwd_kernel_wgmma`` (all ``nvcc`` runs
started together, into ``build/flash_variants/``), and times each at
DeepSeek-V2's MLA prefill (B 4, 128 heads, q/k 192, v 128, S 2048,
causal), f32 and bf16, beside ``scaled_dot_product_attention`` on the same
inputs (``chip_smoke.py``'s inputs and ``device_ms``). The variants'
outputs are wrong by design; only their times mean something:

* ``noprod``: the producer loads and stores nothing (it still fills and
  frees the ring's barriers): the consumer's own time;
* ``nomma``: the consumer issues no tensor-core product: the producer's
  time, with the softmax;
* ``noload``: the producer stores made-up values instead of loading: the
  time without the global loads.

Each also skips the full-split pass, which a garbage result would take.
It prints ptxas' registers, spills and warnings (a serialized wgmma) for
every instantiation of the kernel, then one JSON line per dtype. Needs
the card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

NO_REDO = ("    if (n < 0) break;\n    n0 = (uint32_t)n;", "    break;")
NO_LOAD = [
    ("    for (int i = 0; i < 8; ++i) x[i] = ld_raw<T>(base + (row0 + 8 * i + "
     "(p >> 4)) * stride + col);",
     "    for (int i = 0; i < 8; ++i) x[i] = make_uint4(i, 0u, 0u, 0u);"),
    ("    for (int c = 0; c < 8; ++c) x[c] = ld_raw<T>(r + 8 * c);",
     "    for (int c = 0; c < 8; ++c) x[c] = make_uint4(c, 0u, 0u, 0u);"),
]
NO_STORE = [
    ("  const int off0 = ((p & 15) >> 3) * kAtom;",
     "  return;\n  const int off0 = ((p & 15) >> 3) * kAtom;"),
    ("  const int kp = 16 * (w & 1) + (l & 15);\n  const int pos",
     "  return;\n  const int kp = 16 * (w & 1) + (l & 15);\n  const int pos"),
]
NO_MMA = [
    ("__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, "
     "uint64_t b) {\n",
     "__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, "
     "uint64_t b) {\n  return;\n"),
    ("                                       uint32_t a3, uint64_t b) {\n",
     "                                       uint32_t a3, uint64_t b) {\n"
     "  return;\n"),
]
VARIANTS = {"noprod": [NO_REDO] + NO_LOAD + NO_STORE,
            "nomma": [NO_REDO] + NO_MMA,
            "noload": [NO_REDO] + NO_LOAD}


def ptxas_report(out: str, tag: str) -> None:
    """The wgmma kernel's registers and spills by instantiation, and
    ptxas' performance warnings."""
    name = None
    for line in out.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"([\w$.]+)", line)
        if m:
            name = m.group(1)
        if name and "wgmma" in name and ("Used" in line or "spill" in line):
            kind = re.search(r"wgmmaI(\w+?)Li(\d)E", name)
            print(tag, kind.groups() if kind else name[:60], "|",
                  line.strip()[:120])
        if "C75" in line:
            print(tag, "warning:", line.strip()[:200])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import flash_attention
    src = (backend.CSRC / "flash_attention.cu").read_text()
    work = ROOT / "build" / "flash_variants"
    work.mkdir(parents=True, exist_ok=True)
    for header in backend.CSRC.glob("*.cuh"):
        shutil.copy(header, work)
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the source no longer "
                                   f"has {old[:60]!r}")
            text = text.replace(old, new)
        (work / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [backend.nvcc(), *backend.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(work / f"lib{name}.so"), str(work / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs["tree"] = subprocess.Popen(
        [backend.nvcc(), *backend.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(work / "libtree.so"), str(backend.CSRC / "flash_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{out[-3000:]}")
        print(f"{name}: built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        ptxas_report(out, name)
    backend.use_full_f32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = cs.attention_inputs(torch, cs.LM_B, cs.MLA_H, cs.MLA_H,
                                      cs.LM_S, cs.MLA_HD, dt, seed=11,
                                      vd=cs.MLA_VD)
        row = {"dtype": str(dt)[6:], "nvidia_smi": smi}
        for name in ("tree", *VARIANTS):
            backend._libs["flash_attention"] = ctypes.CDLL(
                str(work / f"lib{name}.so"))
            per = cs.device_ms(torch, lambda: flash_attention(q, k, v))
            row[f"{name}_ms"] = sum(t for key, t in per.items()
                                    if "wgmma" in key)
        backend._libs.pop("flash_attention")
        row["sdpa_ms"] = sum(cs.device_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)).values())
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
