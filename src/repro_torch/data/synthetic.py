"""Synthetic data generators (paper §5: dense/sparse regression inputs;
LM token streams for the model zoo).

Port of `repro.data.synthetic`: numpy only, so a seed gives the
reference's arrays bit for bit."""
from __future__ import annotations

import numpy as np


def gen_regression(rows: int, cols: int, *, sparsity: float = 1.0,
                   noise: float = 0.01, seed: int = 7
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (X, y, beta_true). sparsity = nnz/#cells like the paper."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, cols))
    if sparsity < 1.0:
        mask = rng.random((rows, cols)) < sparsity
        x = np.where(mask, x, 0.0)
    beta = rng.normal(size=(cols, 1))
    y = x @ beta + noise * rng.normal(size=(rows, 1))
    return x, y, beta


def gen_tokens(n_tokens: int, vocab: int, *, seed: int = 0,
               n_codebooks: int = 0) -> np.ndarray:
    """Markov-ish synthetic token stream (not uniform — so training can
    actually reduce loss)."""
    rng = np.random.default_rng(seed)
    # zipf-like unigram + short-range repetition
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    shape = (n_tokens, n_codebooks) if n_codebooks else (n_tokens,)
    base = rng.choice(vocab, size=shape, p=probs)
    rep = rng.random(shape[:1]) < 0.3          # 30% repeat prev token
    out = base.copy()
    out[1:][rep[1:]] = out[:-1][rep[1:]]
    return out.astype(np.int32)
