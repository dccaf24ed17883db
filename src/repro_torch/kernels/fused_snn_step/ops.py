"""Public wrapper of the fused SNN layer kernel, one spiking FC layer over
all timesteps (the per-layer dispatch path).

`fused_snn_layer` runs a (T, B, N_in) spike raster through one layer: on
CUDA tensors it launches the CUDA kernel (`kernel.py`), on CPU tensors it
runs the plain version `ref.fused_snn_layer_ref`. It never falls back from
one to the other: a CUDA input that the kernel refuses raises. The kernel
masks ragged B, N_in and N_out itself, so unlike the TPU wrapper nothing is
padded to 128 lanes and sliced off.
"""
from __future__ import annotations

import torch

from repro_torch.core.neuron import NEURON_TYPES
from repro_torch.core.quant import CLAMP_MODES
from repro_torch.kernels.fused_snn_step.kernel import fused_snn_step_cuda
from repro_torch.kernels.fused_snn_step.ref import fused_snn_layer_ref

INT32 = (-2 ** 31, 2 ** 31 - 1)


def _check_args(spikes, wq, threshold, leak, reset, neuron, clamp_mode,
                block_b, block_n) -> None:
    if spikes.dim() != 3:
        raise ValueError(f"spikes must be a (T, B, N_in) raster, got shape "
                         f"{tuple(spikes.shape)}")
    if wq.dim() != 2 or wq.shape[0] != spikes.shape[2]:
        raise ValueError(f"wq must be (N_in, N_out) with N_in = "
                         f"{spikes.shape[2]}, got shape {tuple(wq.shape)}")
    if wq.device != spikes.device:
        raise ValueError(f"wq is on {wq.device}, the spikes on "
                         f"{spikes.device}")
    if neuron not in NEURON_TYPES:
        raise ValueError(f"unknown neuron {neuron!r}; have {NEURON_TYPES}")
    if clamp_mode not in CLAMP_MODES:
        raise ValueError(f"unknown clamp mode {clamp_mode!r}; have "
                         f"{CLAMP_MODES}")
    for name, x in (("threshold", threshold), ("leak", leak),
                    ("reset", reset)):
        if not INT32[0] <= x <= INT32[1]:
            raise ValueError(f"{name}={x} is not an int32")
    if block_b < 1 or block_n < 1:
        raise ValueError(f"block_b and block_n must be >= 1, got "
                         f"{block_b}, {block_n}")


def fused_snn_layer(spikes: torch.Tensor, wq: torch.Tensor, *,
                    threshold: int, leak: int = 0, reset: int = 0,
                    neuron: str = "rmp", clamp_mode: str = "saturate",
                    block_b: int = 8, block_n: int = 128
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run a (T, B, N_in) {0, 1} spike raster (int8 or bool) through one
    spiking FC layer with int8 (N_in, N_out) weights ``wq`` and integer
    ``threshold``, ``leak`` (LIF) and ``reset`` (IF/LIF) on the layer's
    grid. ``block_b`` lanes by ``block_n`` output columns are one CTA of
    the kernel.

    Returns (out_spikes (T, B, N_out) int8, v_final (B, N_out) int32).
    CUDA tensors launch the CUDA kernel; CPU tensors run the plain version.
    Raises `ValueError` on misaligned shapes or an invalid option."""
    threshold, leak, reset = int(threshold), int(leak), int(reset)
    _check_args(spikes, wq, threshold, leak, reset, neuron, clamp_mode,
                block_b, block_n)
    kw = dict(threshold=threshold, leak=leak, reset=reset, neuron=neuron,
              clamp_mode=clamp_mode)
    if spikes.device.type == "cpu":
        return fused_snn_layer_ref(spikes.to(torch.int8), wq, **kw)
    return fused_snn_step_cuda(spikes.to(torch.int8).contiguous(),
                               wq.to(torch.int8).contiguous(),
                               block_b=block_b, block_n=block_n, **kw)
