"""Real-IMDB loader hook (the JAX package's, in numpy): when the aclImdb
dump and the GloVe vectors are on disk (``REPRO_IMDB_DIR``, default
``/data/aclImdb``; ``REPRO_GLOVE_PATH``, default
``/data/glove.6B.100d.txt``), reviews become (B, n_words, 100) batches of
word vectors; otherwise callers use `data.synthetic`'s structure-matched
task."""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

IMDB_DIR = os.environ.get("REPRO_IMDB_DIR", "/data/aclImdb")
GLOVE_PATH = os.environ.get("REPRO_GLOVE_PATH", "/data/glove.6B.100d.txt")


def available() -> bool:
    """Whether both the review tree and the GloVe file exist."""
    return Path(IMDB_DIR).exists() and Path(GLOVE_PATH).exists()


def load_glove() -> dict[str, np.ndarray]:
    """word -> its f32 vector, one line of ``GLOVE_PATH`` each."""
    vecs = {}
    with open(GLOVE_PATH, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            vecs[parts[0]] = np.asarray(parts[1:], np.float32)
    return vecs


def load_reviews(split: str = "train", limit: int | None = None) -> list:
    """[(text, label)]: the ``split``'s positive reviews (label 1.0), then
    its negative ones (0.0), each in file-name order; ``limit`` keeps
    ``limit // 2`` of each."""
    out = []
    for label, sub in ((1.0, "pos"), (0.0, "neg")):
        d = Path(IMDB_DIR) / split / sub
        for i, p in enumerate(sorted(d.glob("*.txt"))):
            if limit and i >= limit // 2:
                break
            out.append((p.read_text(encoding="utf-8", errors="ignore"), label))
    return out


def vectorize(reviews, glove, n_words: int = 64) -> tuple:
    """(x (N, n_words, 100) f32, y (N,) f32): each review's first
    ``n_words`` tokens found in ``glove`` (split on whitespace, stripped of
    ``.,!?<>/"'()`` and lower-cased), zero-padded; reviews with none are
    dropped."""
    xs, ys = [], []
    for text, label in reviews:
        toks = [t.strip(".,!?<>/\"'()").lower() for t in text.split()]
        vs = [glove[t] for t in toks if t in glove][:n_words]
        if not vs:
            continue
        arr = np.zeros((n_words, 100), np.float32)
        arr[:len(vs)] = np.stack(vs)
        xs.append(arr)
        ys.append(label)
    return np.stack(xs), np.asarray(ys, np.float32)
