"""The int8 gradient wire format, without a collective.

`fake_compress` quantizes each gradient leaf to int8 with one f32 scale and
dequantizes it, the per-step quantization noise of an int8-wire gradient
reduction (``ParallelConfig.grad_compress``). The reduction itself with its
error-feedback residual (the JAX package's `compressed_psum_mean`) needs
several GPUs and is not part of the port yet.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_map


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: (q int8, f32 scale)."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def fake_compress(grads: Any) -> Any:
    """Quantize-dequantize each leaf of ``grads`` through the int8 wire
    format, in the leaf's dtype."""
    def leaf(g):
        q, scale = _quantize_int8(g.to(torch.float32))
        return _dequantize(q, scale).to(g.dtype)
    return tree_map(leaf, grads)
