"""Modality frontend STUBS (per assignment: "the modality frontend is a
STUB — input_specs() provides precomputed frame/patch embeddings").

  * vision (llama-3.2-vision): precomputed patch embeddings
    (B, n_image_tokens, d_model) — stands in for the ViT encoder.
  * audio (musicgen): EnCodec token ids (B, S, n_codebooks) with the
    delay interleaving pattern applied.

Port of `repro.data.frontends`: numpy only, the reference's arrays bit
for bit.
"""
from __future__ import annotations

import numpy as np


def vision_embeddings(batch: int, n_tokens: int, d_model: int,
                      seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.02,
                      size=(batch, n_tokens, d_model)).astype(np.float32)


def encodec_tokens(batch: int, seq_len: int, vocab: int, n_books: int = 4,
                   seed: int = 0) -> np.ndarray:
    """Synthetic EnCodec codebook ids with MusicGen's delay pattern:
    book k at time t holds the frame from t-k (first k steps = pad 0)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=(batch, seq_len, n_books))
    out = np.zeros_like(base)
    for k in range(n_books):
        out[:, k:, k] = base[:, : seq_len - k, k]
    return out.astype(np.int32)
