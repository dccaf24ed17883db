"""Layer helpers of the language models: weight init and RMS norm (the two
of `repro.models.layers` that the RWKV family uses).

Numerics as in the JAX package: params and activations bf16 by default;
norms accumulate in float32.
"""
from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, shape: tuple, in_axis: int = 0,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Normal(0, 1 / fan_in) weights drawn in float32 from ``gen`` on the
    generator's device, then cast to ``dtype``; ``fan_in`` is
    ``shape[in_axis]``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x / math.sqrt(shape[in_axis])).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w
