"""Fixed-point quantization matching the IMPULSE macro's number formats.

The macro stores:
  * weights  W_MEM : 6-bit signed two's complement -> integer range [-32, 31]
    (the symmetric range [-31, 31] is used so that -w is representable)
  * membrane V_MEM : 11-bit signed two's complement -> integer range
    [-1024, 1023]

W and V share one fixed-point grid: V accumulates raw W integers, so a single
per-layer scale converts between float and macro domains. Thresholds and
leaks are quantized on the same grid.

`fake_quant_w` is the QAT weight path of the float domain: quantize then
dequantize in the forward, the straight-through estimator in the backward.
Rounding is half to even (`torch.round`, like `jnp.round`), and the wrap
clamp is a *floored*
modulo (`torch.remainder`, never `torch.fmod`, which truncates toward zero).
`clamp_v_np`/`spike_compare_np` are the numpy twins the host event executor
(`kernels/fused_snn_net/events.py`) runs on.
"""
from __future__ import annotations

import numpy as np
import torch

W_BITS = 6
V_BITS = 11
W_MAX = 2 ** (W_BITS - 1) - 1          # 31
W_MIN = -W_MAX                          # symmetric range
V_MAX = 2 ** (V_BITS - 1) - 1          # 1023
V_MIN = -(2 ** (V_BITS - 1))           # -1024
V_SPAN = 2 ** V_BITS                   # wraparound span of the 11-bit word

CLAMP_MODES = ("saturate", "wrap")


def w_scale(w: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric f32 scale so that max|w| maps to W_MAX."""
    return torch.clamp(w.abs().max(), min=1e-8) / W_MAX


def quantize_w(w: torch.Tensor, scale: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """float weights -> (int8 weights in [-31, 31], f32 scale)."""
    scale = w_scale(w) if scale is None else scale
    wq = torch.clamp(torch.round(w / scale), W_MIN, W_MAX).to(torch.int8)
    return wq, scale


def dequantize_w(wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int weights -> f32 weights on the grid: ``wq * scale``."""
    return wq.to(torch.float32) * scale


class _FakeQuantW(torch.autograd.Function):
    """Quantize-dequantize forward, straight-through backward."""

    @staticmethod
    def forward(ctx, w):
        wq, scale = quantize_w(w)
        return dequantize_w(wq, scale)

    @staticmethod
    def backward(ctx, g):
        return g                        # STE: the gradient passes unchanged


def fake_quant_w(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded onto its 6-bit grid and back (f32), differentiable with
    the straight-through estimator (QAT)."""
    return _FakeQuantW.apply(w)


def clamp_v(v: torch.Tensor, mode: str = "saturate") -> torch.Tensor:
    """Constrain membrane potential to the 11-bit signed range.

    ``saturate`` clips (the deployment-safe mode); ``wrap`` reproduces raw
    two's-complement rollover of the 12-column ripple adder."""
    if mode == "saturate":
        return torch.clamp(v, V_MIN, V_MAX)
    if mode == "wrap":
        return torch.remainder(v - V_MIN, V_SPAN) + V_MIN
    raise ValueError(f"unknown clamp mode {mode!r}")


def spike_compare(v: torch.Tensor, threshold, mode: str = "saturate"
                  ) -> torch.Tensor:
    """SpikeCheck per clamp mode: in ``wrap`` mode the comparator evaluates
    sign(v - th) through the same 11-bit adder, so the comparison itself
    wraps; ``saturate`` is a true comparison."""
    if mode == "wrap":
        return clamp_v(v - threshold, "wrap") >= 0
    return v >= threshold


def clamp_v_np(v: np.ndarray, mode: str = "saturate") -> np.ndarray:
    """Numpy twin of `clamp_v` for host-side executors (numpy's ``%`` is
    already the floored modulo)."""
    if mode == "saturate":
        return np.clip(v, V_MIN, V_MAX)
    if mode == "wrap":
        return ((v - V_MIN) % V_SPAN) + V_MIN
    raise ValueError(f"unknown clamp mode {mode!r}")


def spike_compare_np(v: np.ndarray, threshold, mode: str = "saturate"
                     ) -> np.ndarray:
    """Numpy twin of `spike_compare`."""
    if mode == "wrap":
        return clamp_v_np(v - threshold, "wrap") >= 0
    return v >= threshold


def quantize_const(x: float, scale: torch.Tensor, lo: int = V_MIN,
                   hi: int = V_MAX) -> torch.Tensor:
    """Quantize a scalar (threshold / leak / reset) onto the shared grid:
    ``round(x / scale)`` clipped to [lo, hi], as an int32 tensor."""
    return torch.clamp(torch.round(torch.as_tensor(x, dtype=torch.float32)
                                   / scale), lo, hi).to(torch.int32)


def quantize_neuron_const(x: float, scale: torch.Tensor,
                          clamp_mode: str = "saturate") -> int:
    """Quantize a neuron constant (threshold / leak) into the 11-bit V word
    its const row stores: round ``x / scale`` in f32, then fold it with the
    program's clamp mode (``wrap`` rolls over instead of clipping)."""
    q = torch.round(torch.tensor(x, dtype=torch.float32) / scale)
    return int(clamp_v(q.to(torch.int32), clamp_mode))
