#!/usr/bin/env python3
"""``chip_smoke.py``'s model_axis phase alone, on the card:

    python3 scripts/torch_model_axis.py

builds the kernels (one nvcc per source or part, all at once; prints the
seconds), holds flash_attention at the phase's local shapes
(``chip_smoke.model_axis_flash_cases``, f32) and ssd_scan at Hymba's local
batch against their plain versions, then runs ``phase_model_axis``
(MODEL_AXIS_RUNS on MODEL_AXIS_RANKS gloo ranks sharing card 0) and
prints its JSON line and its seconds. Needs a CUDA device and the
repository around it.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_model_axis: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import backend, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    backend.use_full_f32()
    t0 = time.perf_counter()
    backend.build()
    print(f"build {time.perf_counter() - t0:.1f} s; {cs.nvidia_smi()}",
          flush=True)
    ok = True
    for i, (b, hq, hkv, s, hd, w, meta, vd) in enumerate(
            cs.model_axis_flash_cases()):
        q, k, v = cs.attention_inputs(torch, b, hq, hkv, s, hd,
                                      torch.float32, 900 + i, vd)
        err, _, _, good = cs.compare(
            torch, flash_attention(q, k, v, window=w, num_meta=meta),
            ref.flash_attention_ref(q, k, v, window=w, num_meta=meta),
            cs.FLASH_TOL["float32"])
        ok &= good
        print("flash_attention", (b, hq, hkv, s, hd, w, meta), err, good,
              flush=True)
    args, init = cs.ssd_inputs(torch, cs.LM_B // 2, cs.LM_S, 50, 64, 16, 77,
                               True)
    y, _ = ssd_scan(*args, chunk=128, initial_state=init)
    y_ref, _ = ref.ssd_chunked(*args, 128, initial_state=init)
    scale = float(y_ref.abs().max())
    err, _, _, good = cs.compare(torch, y, y_ref,
                                 (cs.SSD_ATOL_SCALE * scale, cs.SSD_RTOL))
    ok &= good
    print("ssd_scan", err, good, flush=True)
    state = {"launches": {name: 0 for name, _, _ in cs.KERNELS}}
    t0 = time.perf_counter()
    cs.phase_model_axis(torch, state)
    print(json.dumps({"model_axis_seconds": time.perf_counter() - t0,
                      "kernels_ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
