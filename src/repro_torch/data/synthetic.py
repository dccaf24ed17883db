"""Seeded synthetic inputs, in numpy: the same arrays as the JAX package's
`data/synthetic.py` for the same seed (the code is a copy, so the bits are
equal).

  sentiment:  sequences of 100-d "word vectors" from a fixed random
              vocabulary; label = sign of the accumulated sentiment score,
              with negation words flipping the polarity of the next two
              words, so the task needs sequential state (Fig. 9b's task).
  mnist-like: class-conditional 28x28 stroke patterns, the input of the
              impulse-mnist conv program.
  LM tokens:  Zipfian unigrams with repeated n-gram motifs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

GLOVE_DIM = 100
VOCAB = 2000
NEG_WORDS = 40        # first NEG_WORDS ids after the neutral block are negators


@dataclass
class SentimentDataset:
    vectors: np.ndarray       # (VOCAB, 100) word embeddings ("GloVe")
    polarity: np.ndarray      # (VOCAB,) per-word sentiment score
    is_negator: np.ndarray    # (VOCAB,) bool


def make_sentiment_vocab(seed: int = 0) -> SentimentDataset:
    rng = np.random.default_rng(seed)
    vectors = rng.standard_normal((VOCAB, GLOVE_DIM)).astype(np.float32) * 0.3
    polarity = np.zeros(VOCAB, np.float32)
    n_pol = VOCAB // 2
    polarity[:n_pol // 2] = rng.uniform(0.5, 1.5, n_pol // 2)       # positive
    polarity[n_pol // 2:n_pol] = -rng.uniform(0.5, 1.5, n_pol // 2)  # negative
    # give polar words a shared direction component so it's linearly decodable
    direction = rng.standard_normal(GLOVE_DIM).astype(np.float32)
    direction /= np.linalg.norm(direction)
    vectors += polarity[:, None] * direction[None, :] * 0.8
    is_negator = np.zeros(VOCAB, bool)
    is_negator[n_pol:n_pol + NEG_WORDS] = True
    neg_dir = rng.standard_normal(GLOVE_DIM).astype(np.float32)
    vectors[is_negator] += neg_dir / np.linalg.norm(neg_dir) * 1.2
    return SentimentDataset(vectors, polarity, is_negator)


def sentiment_batch(ds: SentimentDataset, batch: int, n_words: int,
                    seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Returns (x (B, n_words, 100), labels (B,) in {0,1})."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (batch, n_words))
    pol = ds.polarity[ids].copy()
    neg = ds.is_negator[ids]
    # a negator flips the polarity of the next 2 words (sequential semantics)
    for off in (1, 2):
        flip = np.zeros_like(neg)
        flip[:, off:] = neg[:, :-off]
        pol = np.where(flip, -pol, pol)
    score = pol.sum(axis=1) + rng.normal(0, 0.25, batch)
    labels = (score > 0).astype(np.float32)
    x = ds.vectors[ids]
    return x.astype(np.float32), labels


def mnist_like_batch(batch: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Class-conditional 28x28 patterns (10 classes). (B, 28, 28, 1), (B,)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, batch)
    base = np.zeros((10, 28, 28), np.float32)
    proto_rng = np.random.default_rng(1234)
    for c in range(10):
        for _ in range(4):                       # 4 strokes per class
            x0, y0 = proto_rng.integers(4, 24, 2)
            dx, dy = proto_rng.integers(-3, 4, 2)
            for t in range(8):
                xx = np.clip(x0 + t * dx // 3, 0, 27)
                yy = np.clip(y0 + t * dy // 3, 0, 27)
                base[c, xx, yy] = 1.0
    imgs = base[labels]
    shift = rng.integers(-2, 3, (batch, 2))
    out = np.zeros_like(imgs)
    for i in range(batch):
        out[i] = np.roll(imgs[i], shift[i], axis=(0, 1))
    out += rng.normal(0, 0.15, out.shape).astype(np.float32)
    return out[..., None].astype(np.float32), labels.astype(np.int32)


def lm_token_batch(batch: int, seq: int, vocab: int, seed: int,
                   motif_len: int = 16) -> np.ndarray:
    """Zipfian tokens with injected repeated motifs; (B, seq+1) so that
    (inputs, targets) = (x[:, :-1], x[:, 1:])."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    p = 1.0 / ranks
    p /= p.sum()
    x = rng.choice(vocab, size=(batch, seq + 1), p=p)
    n_motifs = (seq + 1) // (4 * motif_len)
    motif = rng.integers(0, vocab, (8, motif_len))
    for b in range(batch):
        for _ in range(n_motifs):
            m = motif[rng.integers(0, 8)]
            pos = rng.integers(0, seq + 1 - motif_len)
            x[b, pos:pos + motif_len] = m
    return x.astype(np.int32)
