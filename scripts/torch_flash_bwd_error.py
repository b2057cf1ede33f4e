#!/usr/bin/env python3
"""Where ``flash_attention_bwd``'s error against float64 comes from, and
how far it stays from ``chip_smoke.py``'s tolerance.

    python3 scripts/torch_flash_bwd_error.py [--seeds N] [--variants] [--out FILE]

On one card, at Hymba-1.5B's training window layer (B 2, 25/5 heads of 64,
2048 positions, window 1024, 128 meta tokens) and qwen2-1.5b's (B 2, 12/2
heads of 128, causal), f32, for each input family below, it prints the
largest |error| of dq, dk and dv against the float64 gradient (the plain
version under autograd in float64), the plain f32 autograd's, and the
largest ratio of |kernel - plain f32| to ``chip_smoke.py``'s bound (2e-5 +
2e-5·|plain|; the gate holds while it is below 1). The families separate
the causes:

* ``randn``: ``chip_smoke.py``'s inputs (q, k, v at 0.5·N(0, 1), dO
  N(0, 1)), seeds 0 .. N-1;
* ``qk_exact``: q and k rounded to multiples of 1/16, so that every
  product q·k and every partial sum over head_dim is exact in TF32 and
  f32: S = Q·Kᵀ carries no error in any pass, and P only expf's and the
  log-sum-exp's rounding;
* ``do_exact``: dO rounded to multiples of 1/16 (exact in TF32: its split
  has no lo part, so dV = Pᵀ·dO drops no lo·lo term);
* ``both``: the two together.

Two emulations in PyTorch on the card take the kernel's products out:
for ``randn``, the fast split of S's operands alone (hi = the TF32
rounding of x, lo = x - hi truncated to TF32 as the tensor cores read it;
the three products summed in float64): the largest relative error of P =
exp(S·scale - lse) over the visible pairs and the error it gives dV =
Pᵀ·dO, summed in float64. For ``qk_exact`` (S exact), P in f32 as the
kernel forms it, expf(S·scale - lse), with the forward kernel's lse
(``p_fwd_lse``), with the exact lse rounded to f32 (``p_exact_lse``), and
as the plain softmax forms it, exp(S·scale - max) / sum (``p_softmax``),
each giving dV = Pᵀ·dO summed in float64: dv's error from P's rounding
alone; and ``p_split``: the first P and dO split as the kernel splits
them, the three products summed in float64: dv's error from the split of
the dV product's operands, without the tensor cores' accumulation.

``--variants`` also builds three variants of ``csrc/flash_attention_bwd.cu``
under ``build/flash_bwd_variants/`` (``.gitignore``d) and measures each
in a process of its own, with its time (device ms of every launch of one
call, and its dK/dV pass's):

* ``mb_k8``: dV, dK and dQ summed per k8 step (a zeroed accumulator per
  step, then a rounded add) instead of per 64-row tile;
* ``s_k8``: S = Q·Kᵀ and dP = dO·Vᵀ summed per k8 step instead of in one
  accumulator over head_dim;
* ``s_k8_mb_k8``: both.

Prints one JSON line per tree (the shipped one first), and appends them
to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANT_DIR = ROOT / "build" / "flash_bwd_variants"
CASES = {"hymba_window": (25, 5, 64, 1024, 128),
         "qwen2_hd128": (12, 2, 128, 0, 0)}

# the S and dP products (Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, S = Q·Kᵀ, dP = dO·Vᵀ)
# with a zeroed accumulator per k8 step, rounded into acc at the add
PRODUCT_ABT_K8 = r"""
template <bool kFull, bool kExact, typename T, int HD>
__device__ __forceinline__ void product_abt(float (&acc)[8][4], const T* a, int r0,
                                            const T* bm, int g, int t) {
  constexpr int PT = pitch<T, HD>();
#pragma unroll
  for (int ks = 0; ks < HD / 8; ++ks) {
    uint32_t ah[4], al[4];
    load_a<kFull, T, PT>(a, r0, ks, g, t, ah, al);
    uint32_t bh[8][2], bl[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = (j * 8 + g) * PT + ks * 8 + t;
      frag<kFull>(bm, idx, bh[j][0], bl[j][0]);
      frag<kFull>(bm, idx + 4, bh[j][1], bl[j][1]);
    }
    float part[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[j][c] = 0.f;
    tf32x3::mma_split<8, kExact, kExact>(part, ah, al, bh, bl);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] += part[j][c];
  }
}
"""

# dV, dK and dQ with a zeroed accumulator per k8 step, rounded into acc at
# the add
PRODUCT_MB_K8 = r"""
template <bool kFull, bool kExactB, typename T, int HD>
__device__ __forceinline__ void product_mb(float (&acc)[HD / 8][4], const float (&m)[8][4],
                                           const T* bm, int g, int t) {
  constexpr int PT = pitch<T, HD>();
  constexpr int NG = HD / 8 < 8 ? HD / 8 : 8;
#pragma unroll
  for (int n0 = 0; n0 < HD / 8; n0 += NG) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ah[4], al[4];
      tf32x3::split_as<kFull>(m[kk][0], ah[0], al[0]);
      tf32x3::split_as<kFull>(m[kk][2], ah[1], al[1]);
      tf32x3::split_as<kFull>(m[kk][1], ah[2], al[2]);
      tf32x3::split_as<kFull>(m[kk][3], ah[3], al[3]);
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        const int idx = (kk * 8 + 2 * t) * PT + (n0 + n) * 8 + g;
        frag<kFull>(bm, idx, bh[n][0], bl[n][0]);
        frag<kFull>(bm, idx + PT, bh[n][1], bl[n][1]);
      }
      float part[NG][4];
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[n][c] = 0.f;
      tf32x3::mma_split<NG, false, kExactB>(part, ah, al, bh, bl);
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n0 + n][c] += part[n][c];
    }
  }
}
"""

VARIANTS = {"mb_k8": ("product_mb",), "s_k8": ("product_abt",),
            "s_k8_mb_k8": ("product_abt", "product_mb")}


def replace_function(src: str, name: str, body: str) -> str:
    """``src`` with the template function ``name`` (from its template line
    to its closing brace at column 0) replaced by ``body``."""
    pat = re.compile(r"\ntemplate <[^\n]*>\n__device__ __forceinline__ void "
                     + name + r"\(.*?\n}\n", re.S)
    if len(pat.findall(src)) != 1:
        raise RuntimeError(f"{name} not found once in flash_attention_bwd.cu")
    return pat.sub(lambda _: body, src)


def make_variant(name: str, forward_lib: Path) -> Path:
    """A copy of ``src/repro_torch`` whose flash_attention_bwd.cu is the
    variant's, with this tree's built forward library (the same source,
    so the same name) in its build directory; returns its ``src``
    directory."""
    tree = VARIANT_DIR / name / "src"
    shutil.rmtree(tree, ignore_errors=True)  # its build/ stays: libraries
    # are named by the digest of their source
    shutil.copytree(ROOT / "src" / "repro_torch", tree / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = tree / "repro_torch" / "kernels" / "csrc" / "flash_attention_bwd.cu"
    text = cu.read_text()
    for fn in VARIANTS[name]:
        text = replace_function(text, fn, PRODUCT_ABT_K8 if fn == "product_abt"
                                else PRODUCT_MB_K8)
    cu.write_text(text)
    build = VARIANT_DIR / name / "build" / "repro_torch"
    build.mkdir(parents=True, exist_ok=True)
    shutil.copy2(forward_lib, build / forward_lib.name)
    return tree


def inputs(torch, cs, case, family, seed):
    hq, hkv, hd, window, meta = CASES[case]
    q, k, v = cs.attention_inputs(torch, cs.TRAIN_B, hq, hkv, cs.LM_S, hd,
                                  torch.float32, seed=seed)
    dout = torch.randn((cs.TRAIN_B, hq, cs.LM_S, hd), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(
                           seed + 1000))
    if family in ("qk_exact", "both"):
        q, k = [(t * 16).round() / 16 for t in (q, k)]
    if family in ("do_exact", "both"):
        dout = (dout * 16).round() / 16
    return q, k, v, dout, window, meta


def fast_split(torch, x):
    """tf32x3::split_fast of f32 ``x`` as the tensor cores read it: (hi,
    lo) in float64, hi the TF32 rounding, lo = x - hi truncated to TF32."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -8192).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -8192).view(torch.float32)
    return hi.double(), lo.double()


def split_emulation(torch, q, k, dout, window, meta, cs):
    """(max relative error of P over the visible pairs, max |error| of
    Pᵀ·dO) from the fast split of S's operands alone, against float64."""
    f64 = torch.float64

    def parts(x):
        return fast_split(torch, x)

    b, hq, s, hd = q.shape
    group = hq // k.shape[1]
    mask = cs.flash_mask(torch, s, window, meta)
    scale = hd ** -0.5
    p_err, dv_err = 0.0, 0.0
    for bi in range(b):
        for kh in range(k.shape[1]):
            kk = k[bi, kh]
            kh_, kl = parts(kk)
            dv64 = torch.zeros((s, hd), dtype=f64, device="cuda")
            dv_sp = torch.zeros_like(dv64)
            for h in range(kh * group, (kh + 1) * group):
                qq = q[bi, h]
                qh, ql = parts(qq)
                s64 = (qq.double() @ kk.double().T) * scale
                s_sp = (ql @ kh_.T + qh @ kl.T + qh @ kh_.T) * scale
                s64 = s64.masked_fill(~mask, -float("inf"))
                lse = torch.logsumexp(s64, dim=-1, keepdim=True)
                p64 = torch.exp(s64 - lse)
                p_sp = torch.exp(s_sp - lse).masked_fill(~mask, 0.0)
                rel = ((p_sp - p64).abs() / p64)[mask]
                p_err = max(p_err, float(rel.max()))
                d = dout[bi, h].double()
                dv64 += p64.T @ d
                dv_sp += p_sp.T @ d
            dv_err = max(dv_err, float((dv_sp - dv64).abs().max()))
    return p_err, dv_err


def p_rounding(torch, q, k, dout, lse, window, meta, cs):
    """dv's largest |error| against float64 from P formed in f32 alone (S
    exact): {"p_fwd_lse", "p_exact_lse", "p_softmax"} (see the module
    docstring)."""
    f64 = torch.float64
    b, hq, s, hd = q.shape
    group = hq // k.shape[1]
    mask = cs.flash_mask(torch, s, window, meta)
    scale = hd ** -0.5
    errs = dict.fromkeys(("p_fwd_lse", "p_exact_lse", "p_softmax",
                          "p_split"), 0.0)
    for bi in range(b):
        for kh in range(k.shape[1]):
            kk = k[bi, kh].double()
            dv = {name: torch.zeros((s, hd), dtype=f64, device="cuda")
                  for name in ("f64", *errs)}
            for h in range(kh * group, (kh + 1) * group):
                s64 = ((q[bi, h].double() @ kk.T) * scale).masked_fill(
                    ~mask, -float("inf"))
                lse64 = torch.logsumexp(s64, dim=-1, keepdim=True)
                m64 = s64.max(dim=-1, keepdim=True).values
                s32 = s64.float()
                d = dout[bi, h].double()
                dv["f64"] += torch.exp(s64 - lse64).T @ d
                p_hi, p_lo = fast_split(torch, torch.exp(
                    s32 - lse[bi, h][:, None]).masked_fill(~mask, 0.0))
                d_hi, d_lo = fast_split(torch, dout[bi, h])
                dv["p_split"] += (p_lo.T @ d_hi + p_hi.T @ d_lo
                                  + p_hi.T @ d_hi)
                for name, p32 in (  # P in f32, dO exact
                        ("p_fwd_lse", torch.exp(s32 - lse[bi, h][:, None])),
                        ("p_exact_lse", torch.exp(s32 - lse64.float())),
                        ("p_softmax", torch.exp(s32 - m64.float())
                         / torch.exp(s64 - m64).sum(-1, keepdim=True)
                         .float())):
                    dv[name] += p32.masked_fill(~mask, 0.0).double().T @ d
            for name in errs:
                errs[name] = max(errs[name], float(
                    (dv[name] - dv["f64"]).abs().max()))
    return errs


def measure(torch, cs, seeds, emulate):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import _launch, flash_attention_bwd
    atol, rtol = cs.FLASH_TOL["float32"]
    runs = [("hymba_window", "randn", s) for s in range(seeds)]
    runs += [("hymba_window", f, 0) for f in ("qk_exact", "do_exact", "both")]
    runs += [("qwen2_hd128", "randn", s) for s in range(min(seeds, 2))]
    rows, times = [], {}
    for case, family, seed in runs:
        q, k, v, dout, window, meta = inputs(torch, cs, case, family, seed)
        hq = q.shape[1]
        lse = torch.empty((cs.TRAIN_B, hq, cs.LM_S), device="cuda")
        out = _launch(q, k, v, window, meta, lse=lse)
        got = flash_attention_bwd(q, k, v, out, dout, lse, window=window,
                                  num_meta=meta)
        torch.cuda.synchronize()
        want = cs.flash_grads(torch, ref.flash_attention_ref, q, k, v, dout,
                              window, meta)[1:]
        w64 = cs.flash_grads(torch, ref.flash_attention_ref,
                             *[t.double() for t in (q, k, v, dout)], window,
                             meta)[1:]
        row = {"case": case, "family": family, "seed": seed}
        for name, g, w, r in zip(("dq", "dk", "dv"), got, want, w64):
            row[name] = {
                "f64_err_kernel": float((g.double() - r).abs().max()),
                "f64_err_plain": float((w.double() - r).abs().max()),
                "gate_ratio": float(((g - w).abs()
                                     / (atol + rtol * w.abs())).max()),
                "scale": float(r.abs().max())}
        if emulate and family == "randn" and case == "hymba_window":
            p_err, dv_err = split_emulation(torch, q, k, dout, window, meta,
                                            cs)
            row["split_only"] = {"p_max_rel_err": p_err,
                                 "dv_f64_err": dv_err}
        if emulate and family == "qk_exact":
            row["p_rounding_dv_f64_err"] = p_rounding(
                torch, q, k, dout, lse, window, meta, cs)
        rows.append(row)
        if seed == 0 and family == "randn":
            per = cs.device_ms(torch, lambda: flash_attention_bwd(
                q, k, v, out, dout, lse, window=window, num_meta=meta))
            times[case] = {"ms": sum(per.values()),
                           "dkdv_ms": cs.named_ms(per, "flash_bwd_dkdv")}
        del q, k, v, dout, lse, out, got, want, w64
        torch.cuda.empty_cache()
    return {"runs": rows, "times": times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="shipped")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import backend
    backend.build(("flash_attention", "flash_attention_bwd"))
    children = []
    if args.variants:
        for name in VARIANTS:
            tree = make_variant(name, backend.library_path("flash_attention"))
            children.append((name, tree, subprocess.Popen(
                [sys.executable, __file__, "--src", str(tree),
                 "--build-only"])))
    for name, _, proc in children:
        if proc.wait() != 0:
            raise RuntimeError(f"variant {name}: build failed")
    if args.build_only:
        return 0
    backend.use_full_f32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lines = [json.dumps({"label": args.label, "nvidia_smi": smi,
                         **measure(torch, cs, args.seeds,
                                   emulate=args.label == "shipped")})]
    print(lines[0], flush=True)
    for name, tree, _ in children:
        proc = subprocess.run(
            [sys.executable, __file__, "--src", str(tree), "--label", name,
             "--seeds", str(min(args.seeds, 2))],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}:\n{proc.stderr[-4000:]}")
        lines.append(proc.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
