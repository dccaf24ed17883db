"""Real-MNIST loader hook (the JAX package's, in numpy): the gzip idx files
under ``REPRO_MNIST_DIR`` (default ``/data/mnist``); callers use
`data.synthetic.mnist_like_batch` when they are absent."""
from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

MNIST_DIR = os.environ.get("REPRO_MNIST_DIR", "/data/mnist")


def available() -> bool:
    """Whether the training images are on disk."""
    return (Path(MNIST_DIR) / "train-images-idx3-ubyte.gz").exists()


def _read_idx(path: Path) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def load(split: str = "train") -> tuple:
    """(images (N, 28, 28, 1) f32 in [0, 1], labels (N,) int32) of
    ``split`` ("train", or anything else for the t10k files)."""
    pre = "train" if split == "train" else "t10k"
    imgs = _read_idx(Path(MNIST_DIR) / f"{pre}-images-idx3-ubyte.gz")
    labels = _read_idx(Path(MNIST_DIR) / f"{pre}-labels-idx1-ubyte.gz")
    x = imgs.astype(np.float32)[..., None] / 255.0
    return x, labels.astype(np.int32)
