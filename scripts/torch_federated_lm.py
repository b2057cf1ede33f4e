"""FedP2P over LM clients on the PyTorch port (``protocols.engine
.MeshEngine``): cluster-local sync with a global sync every second round,
a FedAvg baseline, and FedP2P with a quarter of the clients straggling.

    PYTHONPATH=src python scripts/torch_federated_lm.py [--device cpu]
        [--rounds 20]

Runs on the card unless ``--device cpu``; qwen2-1.5b at the JAX package's
cut (two layers, width 128), 4 clients in 2 clusters, 4 local steps of B 4
x 64 tokens a round.
"""
import argparse

from repro_torch.launch.train import run_federated_training


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--local-steps", type=int, default=4)
    args = ap.parse_args()
    common = dict(rounds=args.rounds, num_clients=4, num_clusters=2,
                  local_steps=args.local_steps, batch=4, seq_len=64,
                  lr=5e-3, seed=0, device=args.device)
    print("== FedP2P (sync_period=2: global sync every 2nd round) ==")
    p2p = run_federated_training("qwen2-1.5b", algorithm="fedp2p",
                                 sync_period=2, **common)
    print("== FedAvg baseline ==")
    avg = run_federated_training("qwen2-1.5b", algorithm="fedavg", **common)
    print("== FedP2P with 25% stragglers ==")
    strag = run_federated_training("qwen2-1.5b", algorithm="fedp2p",
                                   straggler_rate=0.25, **common)
    print(f"\nfinal losses: fedp2p={p2p['final_loss']:.4f} "
          f"fedavg={avg['final_loss']:.4f} "
          f"fedp2p@25%stragglers={strag['final_loss']:.4f}")


if __name__ == "__main__":
    main()
