"""Synthetic token streams for LM training (the port's copy of
``repro.data.lm``, numpy only): the same tokens as the JAX package's for
the same seed.

Deterministic Zipf-ish token sampling with local n-gram structure so the
loss actually decreases during the e2e example runs."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def token_stream_batches(vocab_size: int, batch: int, seq_len: int,
                         seed: int = 0, structure: float = 0.7
                         ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {"tokens": [B,S], "labels": [B,S]} forever. ``structure`` is
    the probability of a deterministic successor (learnable signal)."""
    rng = np.random.default_rng(seed)
    base = min(vocab_size, 4096)
    successor = rng.integers(0, base, size=base)
    zipf_p = 1.0 / np.arange(1, base + 1) ** 1.1
    zipf_p /= zipf_p.sum()
    while True:
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.choice(base, size=batch, p=zipf_p)
        det = rng.random((batch, seq_len)) < structure
        rnd = rng.choice(base, size=(batch, seq_len), p=zipf_p)
        for t in range(seq_len):
            nxt = successor[toks[:, t]]
            toks[:, t + 1] = np.where(det[:, t], nxt, rnd[:, t])
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
