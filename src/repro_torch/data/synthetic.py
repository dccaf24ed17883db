"""Seeded synthetic inputs, in numpy (the same arrays as the JAX package's
`data/synthetic.py` for the same seed).

  mnist_like_batch: class-conditional 28x28 stroke patterns, the input of
                    the impulse-mnist conv program.
"""
from __future__ import annotations

import numpy as np


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
