"""Neuron models (IF / LIF / RMP) in the float domain, with the
surrogate-gradient spike of training.

  IF  : v += i;                 s = v >= th;  v = where(s, v_reset, v)
  LIF : v += i; v -= leak;      s = v >= th;  v = where(s, v_reset, v)
  RMP : v += i;                 s = v >= th;  v = v - th * s        (soft reset)

The macro's leak is subtractive (the default); the multiplicative leak
``v * (1 - leak)`` is the DIET-SNN training convention. The off-macro spike
encoder and the float (QAT) domain run these in f32 with the op order of
`repro.core.neuron.neuron_step`, so the same f32 inputs give the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEURON_TYPES = ("if", "lif", "rmp")
LEAK_MODES = ("subtractive", "multiplicative")


class _Spike(torch.autograd.Function):
    """Heaviside forward, triangular surrogate backward."""

    @staticmethod
    def forward(ctx, v, threshold, width):
        ctx.save_for_backward(v, threshold if torch.is_tensor(threshold)
                              else None)
        ctx.threshold, ctx.width = threshold, width
        return (v >= threshold).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        v, th_tensor = ctx.saved_tensors
        th = ctx.threshold if th_tensor is None else th_tensor
        x = (v - th) / ctx.width
        gv = g * torch.clamp(1.0 - x.abs(), min=0.0) / ctx.width
        if th_tensor is None or not ctx.needs_input_grad[1]:
            return gv, None, None
        gth = -gv
        extra = gth.dim() - th_tensor.dim()     # leading broadcast axes
        if extra > 0:
            gth = gth.sum(dim=tuple(range(extra)))
        for ax, n in enumerate(th_tensor.shape):  # broadcast size-1 axes
            if n == 1 and gth.shape[ax] != 1:
                gth = gth.sum(dim=ax, keepdim=True)
        return gv, gth.reshape(th_tensor.shape).to(th_tensor.dtype), None


def spike(v: torch.Tensor, threshold, width: float = 1.0) -> torch.Tensor:
    """Heaviside spike ``(v >= threshold)`` in v's dtype, with a triangular
    surrogate gradient of half-width ``width`` (area 1): dv = g * max(0,
    1 - |x|) / width for x = (v - threshold) / width, and the threshold's
    gradient is -dv summed down to the threshold's own shape."""
    return _Spike.apply(v, threshold, width)


class NeuronState(NamedTuple):
    v: torch.Tensor       # membrane potential


def init_state(shape, dtype=torch.float32, device=None) -> NeuronState:
    """All-zero membrane potential of ``shape``."""
    return NeuronState(v=torch.zeros(shape, dtype=dtype, device=device))


def neuron_step(state: NeuronState, current: torch.Tensor, *, neuron: str,
                threshold, leak=0.0, v_reset: float = 0.0,
                leak_mode: str = "subtractive",
                surrogate_width: float = 1.0
                ) -> tuple[NeuronState, torch.Tensor]:
    """One timestep of membrane dynamics driven by ``current``. Returns (new
    state, spikes), spikes in v's dtype (1.0 where fired), differentiable
    through `spike`'s surrogate."""
    if neuron not in NEURON_TYPES:
        raise ValueError(f"unknown neuron {neuron!r}")
    v = state.v + current
    if neuron == "lif":
        if leak_mode == "subtractive":
            v = v - leak
        elif leak_mode == "multiplicative":
            v = v * (1.0 - leak)
        else:
            raise ValueError(f"unknown leak_mode {leak_mode!r}")
    s = spike(v, threshold, surrogate_width)
    if neuron == "rmp":
        v = v - threshold * s                                # soft reset
    else:                                                    # if / lif
        v = torch.where(s > 0, torch.full_like(v, v_reset), v)
    return NeuronState(v=v), s


def accumulate_only_step(state: NeuronState, current: torch.Tensor
                         ) -> NeuronState:
    """Output-layer variant: integrate, never fire (the sentiment readout:
    the sign of the final V is the prediction, Fig. 10)."""
    return NeuronState(v=state.v + current)
