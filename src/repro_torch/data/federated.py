"""Federated dataset container + offline stand-ins for the paper's
benchmark datasets — the port's numpy-only copy of ``repro.data.federated``
(same generators, same draws: a seed gives identical arrays in both).

Stand-ins preserve the PARTITION STATISTICS the paper relies on:
  pseudo-MNIST   : 10-class 784-d "digit" templates + noise; power-law client
                   sizes; 2 classes per client (paper's MNIST partition).
  pseudo-FEMNIST : 62-class 28x28 image templates; 5 classes per client,
                   lowercase-letter subsample regime (paper §4.1).
  char-LM        : Shakespeare-like character stream from an order-2 Markov
                   chain over 80 symbols; each client is a "role" with its
                   own transition temperature (next-char task, 80 classes).

``FederatedDataset`` pads per-client data to a uniform [N, n_max, ...] block
with masks so the simulator can batch over clients.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class FederatedDataset:
    """Dense padded federated data. x: [N, n_max, ...]; y: [N, n_max];
    mask: [N, n_max] (1 = real sample); counts: [N]."""
    x: np.ndarray
    y: np.ndarray
    mask: np.ndarray
    counts: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    test_mask: np.ndarray
    num_classes: int

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]


def pack_clients(xs: List[np.ndarray], ys: List[np.ndarray], num_classes: int,
                 test_frac: float = 0.2, seed: int = 0, max_per_client: int = 0
                 ) -> FederatedDataset:
    """Split each client 80/20 train/test (paper §4.2) and pad."""
    rng = np.random.default_rng(seed)
    tr_x, tr_y, te_x, te_y = [], [], [], []
    for x, y in zip(xs, ys):
        n = len(y)
        if max_per_client and n > max_per_client:
            idx = rng.permutation(n)[:max_per_client]
            x, y, n = x[idx], y[idx], max_per_client
        perm = rng.permutation(n)
        n_te = max(1, int(n * test_frac))
        te, tr = perm[:n_te], perm[n_te:]
        tr_x.append(x[tr])
        tr_y.append(y[tr])
        te_x.append(x[te])
        te_y.append(y[te])

    def pad(blocks_x, blocks_y):
        n_max = max(len(b) for b in blocks_y)
        shape = (len(blocks_x), n_max) + blocks_x[0].shape[1:]
        X = np.zeros(shape, blocks_x[0].dtype)
        Y = np.zeros((len(blocks_y), n_max), np.int32)
        M = np.zeros((len(blocks_y), n_max), np.float32)
        for i, (bx, by) in enumerate(zip(blocks_x, blocks_y)):
            X[i, :len(by)] = bx
            Y[i, :len(by)] = by
            M[i, :len(by)] = 1.0
        return X, Y, M

    X, Y, M = pad(tr_x, tr_y)
    TX, TY, TM = pad(te_x, te_y)
    return FederatedDataset(x=X, y=Y, mask=M, counts=M.sum(-1).astype(np.int32),
                            test_x=TX, test_y=TY, test_mask=TM,
                            num_classes=num_classes)


def _power_law_counts(rng, num_clients: int, total: int, alpha: float = 1.5,
                      min_n: int = 12) -> np.ndarray:
    w = rng.pareto(alpha, num_clients) + 1.0
    n = np.maximum((w / w.sum() * total).astype(int), min_n)
    return n


# ---------------------------------------------------------------------------
# pseudo-MNIST / pseudo-FEMNIST (template + noise image classes)
# ---------------------------------------------------------------------------

def _make_templates(rng, num_classes: int, dim: int) -> np.ndarray:
    """Smooth-ish class templates: low-frequency random fields."""
    side = int(np.sqrt(dim))
    t = rng.normal(0, 1, (num_classes, side // 4 + 1, side // 4 + 1))
    up = np.kron(t, np.ones((4, 4)))[:, :side, :side]
    return up.reshape(num_classes, side * side).astype(np.float32)


def pseudo_mnist_federated(num_clients: int = 1000, classes_per_client: int = 2,
                           total: int = 0, noise: float = 2.0,
                           label_noise: float = 0.08,
                           seed: int = 0) -> FederatedDataset:
    """MNIST partition per the paper: power-law sizes across 1000 devices,
    2 of 10 classes each. 784-d inputs for the logreg model. ``label_noise``
    caps the achievable accuracy around the paper's ~0.9 regime (a logreg on
    clean high-dim template data would otherwise saturate at 1.0)."""
    rng = np.random.default_rng(seed)
    total = total or 60 * num_clients
    dim, ncls = 784, 10
    templates = _make_templates(rng, ncls, dim) * 0.35
    counts = _power_law_counts(rng, num_clients, total)
    xs, ys = [], []
    for i in range(num_clients):
        cls = rng.choice(ncls, classes_per_client, replace=False)
        y = rng.choice(cls, counts[i])
        x = templates[y] + rng.normal(0, noise, (counts[i], dim)).astype(np.float32)
        flip = rng.random(counts[i]) < label_noise
        y = np.where(flip, rng.choice(cls, counts[i]), y)
        xs.append(x.astype(np.float32))
        ys.append(y.astype(np.int32))
    return pack_clients(xs, ys, ncls, seed=seed, max_per_client=256)


def pseudo_femnist_federated(num_clients: int = 200, classes_per_client: int = 5,
                             per_client: int = 120, noise: float = 0.7,
                             seed: int = 0, num_classes: int = 10
                             ) -> FederatedDataset:
    """FEMNIST regime: 200 devices, 5-of-10 lowercase-letter subsample
    (paper subsamples 'a'..'j'); 28x28x1 images for the CNN."""
    rng = np.random.default_rng(seed)
    dim = 28 * 28
    templates = _make_templates(rng, num_classes, dim)
    xs, ys = [], []
    for i in range(num_clients):
        cls = rng.choice(num_classes, classes_per_client, replace=False)
        n = rng.integers(per_client // 2, per_client + 1)
        y = rng.choice(cls, n)
        x = templates[y] + rng.normal(0, noise, (n, dim)).astype(np.float32)
        xs.append(x.reshape(n, 28, 28, 1).astype(np.float32))
        ys.append(y.astype(np.int32))
    return pack_clients(xs, ys, num_classes, seed=seed)


# ---------------------------------------------------------------------------
# char-LM (Shakespeare stand-in)
# ---------------------------------------------------------------------------

def char_lm_federated(num_clients: int = 100, seq_len: int = 80,
                      per_client: int = 80, vocab: int = 80,
                      seed: int = 0) -> FederatedDataset:
    """Each client ('character in the play') has its own mixing coefficient
    over two shared order-1 transition matrices -> heterogeneous styles.
    Sample = seq_len chars; label = next char (80-way)."""
    rng = np.random.default_rng(seed)
    base = rng.dirichlet(np.full(vocab, 0.3), size=(2, vocab))  # [2,V,V]
    xs, ys = [], []
    for i in range(num_clients):
        lam = rng.beta(0.4, 0.4)
        T = lam * base[0] + (1 - lam) * base[1]
        n = rng.integers(per_client // 2, per_client + 1)
        stream_len = n + seq_len + 1
        s = np.empty(stream_len, np.int32)
        s[0] = rng.integers(vocab)
        for t in range(1, stream_len):
            s[t] = rng.choice(vocab, p=T[s[t - 1]])
        x = np.stack([s[j:j + seq_len] for j in range(n)])
        y = s[seq_len:seq_len + n]
        xs.append(x.astype(np.int32))
        ys.append(y.astype(np.int32))
    return pack_clients(xs, ys, vocab, seed=seed)
