"""Synthetic datasets — a numpy copy of ``repro.data.synthetic`` (the port
imports nothing of the JAX package), same seeds, same arrays.

* ``synthetic_image_classification`` — class-conditional Gaussian images with
  learnable structure (each class has a distinct low-rank template), so a
  small CNN/MLP genuinely improves with training, non-trivially.
* ``synthetic_lm_tokens`` — Zipf-distributed token streams with a Markov
  bigram skeleton (the LM serving path's prompts).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_image_classification(
        num_examples: int, image_shape: Tuple[int, int, int] = (32, 32, 3),
        num_classes: int = 10, noise: float = 0.35, rank: int = 6,
        seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Class-templated images: x = template[y] + noise, unit-normalised."""
    rng = np.random.default_rng(seed)
    h, w, c = image_shape
    d = h * w * c
    u = rng.normal(0, 1, (num_classes, rank, d)).astype(np.float32)
    coeff = rng.normal(0, 1, (num_classes, rank)).astype(np.float32)
    templates = np.einsum("kr,krd->kd", coeff, u) / np.sqrt(rank)
    templates /= np.linalg.norm(templates, axis=1, keepdims=True)
    y = rng.integers(0, num_classes, num_examples).astype(np.int32)
    x = templates[y] + noise * rng.normal(0, 1, (num_examples, d)).astype(
        np.float32)
    return x.reshape((num_examples, h, w, c)).astype(np.float32), y



def synthetic_lm_tokens(num_sequences: int, seq_len: int, vocab_size: int,
                        seed: int = 0) -> np.ndarray:
    """Zipf unigram mixture with a deterministic bigram successor skeleton."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
    successor = rng.permutation(vocab_size)
    toks = np.empty((num_sequences, seq_len), np.int32)
    toks[:, 0] = rng.choice(vocab_size, num_sequences, p=unigram)
    for t in range(1, seq_len):
        use_bigram = rng.random(num_sequences) < 0.5
        draw = rng.choice(vocab_size, num_sequences, p=unigram)
        toks[:, t] = np.where(use_bigram, successor[toks[:, t - 1]], draw)
    return toks
