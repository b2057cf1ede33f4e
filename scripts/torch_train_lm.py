"""Train an LM on the PyTorch port for a few hundred steps with the full
substrate stack (the synthetic token stream, AdamW with warmup cosine,
checkpoints). Reduced config by default; ``--full --steps 300`` trains the
real mamba2-130m (130M params) on the card.

    PYTHONPATH=src python scripts/torch_train_lm.py --arch mamba2-130m
        --steps 200 [--device cpu]
"""
import argparse

from repro_torch.launch.train import run_lm_training


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="unreduced config (mamba2-130m = 130M params)")
    ap.add_argument("--ckpt-dir", default="build/torch_lm_ckpt")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    out = run_lm_training(args.arch, steps=args.steps, batch=args.batch,
                          seq_len=args.seq_len, reduced=not args.full,
                          ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"\nloss: {out['first_loss']:.4f} -> {out['final_loss']:.4f} "
          f"over {out['steps']} steps")
    if not out["final_loss"] < out["first_loss"]:
        raise SystemExit("training did not reduce the loss")


if __name__ == "__main__":
    main()
