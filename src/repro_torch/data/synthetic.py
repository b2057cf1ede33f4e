"""SynCov and SynLabel synthetic federated datasets — generated exactly per
paper §4.1 (feature dim 60, 10 classes, N=100 clients, lognormal quantity
skew). The port's numpy-only copy of ``repro.data.synthetic``.

SynCov:   P_i(X) varies (client-specific Gaussian), P(Y|X) shared
          (softmax with global W, b). Covariate shift + quantity skew.
SynLabel: P_i(Y) varies (Dirichlet multinomial per client), P(X|Y) shared
          (class-conditional Gaussians). Label shift + quantity skew.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

FEATURE_DIM = 60
NUM_CLASSES = 10


def _quantity_skew(rng, num_clients: int, mean: float = 4.0,
                   sigma: float = 0.6, min_n: int = 20, max_n: int = 400):
    n = np.exp(rng.normal(mean, sigma, num_clients)).astype(int)
    return np.clip(n, min_n, max_n)


def syncov(num_clients: int = 100, seed: int = 0
           ) -> Tuple[list, list]:
    """Returns (xs, ys): lists of per-client arrays [n_i, 60], [n_i]."""
    rng = np.random.default_rng(seed)
    W = rng.normal(0, 1, (FEATURE_DIM, NUM_CLASSES))
    b = rng.normal(0, 1, NUM_CLASSES)
    counts = _quantity_skew(rng, num_clients)
    xs, ys = [], []
    for i in range(num_clients):
        mu = rng.normal(0, 1)
        sigma = np.abs(rng.normal(0, 1)) + 0.5
        x = rng.normal(mu, sigma, (counts[i], FEATURE_DIM))
        logits = x @ W + b
        y = np.argmax(logits, axis=-1)
        xs.append(x.astype(np.float32))
        ys.append(y.astype(np.int32))
    return xs, ys


def synlabel(num_clients: int = 100, seed: int = 0, beta: float = 0.5
             ) -> Tuple[list, list]:
    """Label-shift: per-client Dirichlet class priors; shared class-conditional
    Gaussians P(X|Y) (logical sampling [11])."""
    rng = np.random.default_rng(seed)
    mu_y = rng.normal(0, 1, (NUM_CLASSES, FEATURE_DIM))
    sigma_y = np.abs(rng.normal(0, 1, (NUM_CLASSES,))) + 0.5
    counts = _quantity_skew(rng, num_clients)
    xs, ys = [], []
    for i in range(num_clients):
        prior = rng.dirichlet(np.full(NUM_CLASSES, beta))
        y = rng.choice(NUM_CLASSES, size=counts[i], p=prior)
        x = mu_y[y] + rng.normal(0, 1, (counts[i], FEATURE_DIM)) * sigma_y[y, None]
        xs.append(x.astype(np.float32))
        ys.append(y.astype(np.int32))
    return xs, ys
