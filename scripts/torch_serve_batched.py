"""Batched serving on the PyTorch port: prefill + decode with the KV and
SSM caches across three architecture families (GQA dense, SSM, hybrid
with meta tokens), each at its reduced config.

    PYTHONPATH=src python scripts/torch_serve_batched.py [--device cpu]
        [--batch 4] [--prompt 24] [--new-tokens 12]

Runs on the card unless ``--device cpu``.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.serve import generate

ARCHS = ("qwen2-1.5b", "mamba2-130m", "hymba-1.5b")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=12)
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.batch, args.prompt)).astype(np.int32)
        out = generate(arch, prompts, max_new_tokens=args.new_tokens,
                       temperature=0.0, verbose=True, device=args.device)
        print(f"{arch}: generated {out['tokens'].shape} "
              f"(decode {out['decode_s_per_token']*1e3:.0f} ms/token)\n")


if __name__ == "__main__":
    main()
