"""2-layer LSTM baseline (the paper's comparison network, Fig. 9b).

hidden=128, 2 layers + scalar head = 248,961 params (paper: 247.8K) against
the SNN's 29.3K, the 8.5x parameter ratio the paper reports. Written as
tensor ops in the JAX package's gate order (i, f, g, o, forget bias +1);
`torch.nn.LSTM` orders its gates otherwise and runs a library kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.snn import bce_with_logits
from repro_torch.tree import tree_leaves


def init_lstm(seed: int, in_dim: int = 100, hidden: int = 128,
              layers: int = 2, device=None) -> dict:
    """Float parameters from numpy seed ``seed``: per layer ``wx`` (d, 4h)
    and ``wh`` (h, 4h) normal over sqrt(fan-in), ``b`` (4h,) zeros, then
    the (h, 1) ``head`` and ``head_b``. ``device`` defaults to the CUDA
    device (raises without one)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def normal(shape, fan_in):
        w = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(w / np.float32(np.sqrt(fan_in))).to(device)

    out = {"layers": []}
    d = in_dim
    for _ in range(layers):
        out["layers"].append({
            "wx": normal((d, 4 * hidden), d),
            "wh": normal((hidden, 4 * hidden), hidden),
            "b": torch.zeros(4 * hidden, device=device),
        })
        d = hidden
    out["head"] = normal((hidden, 1), hidden)
    out["head_b"] = torch.zeros(1, device=device)
    return out


def param_count(params: dict) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def lstm_apply(params: dict, x) -> torch.Tensor:
    """x: (B, T, in_dim) -> logits (B,), on the parameters' device."""
    head = params["head"]
    x = torch.as_tensor(x, dtype=torch.float32, device=head.device)
    hs = [torch.zeros((x.shape[0], p["wh"].shape[0]), device=head.device)
          for p in params["layers"]]
    cs = [torch.zeros_like(h) for h in hs]
    for t in range(x.shape[1]):
        inp = x[:, t]
        for li, p in enumerate(params["layers"]):
            z = inp @ p["wx"] + hs[li] @ p["wh"] + p["b"]
            i, f, g, o = torch.chunk(z, 4, dim=-1)
            cs[li] = (torch.sigmoid(f + 1.0) * cs[li]
                      + torch.sigmoid(i) * torch.tanh(g))
            hs[li] = torch.sigmoid(o) * torch.tanh(cs[li])
            inp = hs[li]
    return (hs[-1] @ head + params["head_b"])[:, 0]


def lstm_loss(params: dict, x, labels) -> tuple:
    """(mean BCE of the logits, accuracy)."""
    z = lstm_apply(params, x)
    labels = torch.as_tensor(labels, dtype=torch.float32, device=z.device)
    acc = torch.mean(((z > 0) == (labels > 0.5)).to(torch.float32))
    return bce_with_logits(z, labels), acc
