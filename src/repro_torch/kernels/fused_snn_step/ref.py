"""Plain PyTorch version of the fused SNN layer kernel.

Semantics (integer domain, `isa.layer_timestep_int` looped over T):
  for t in range(T):
      v      = clamp11(v + spikes[t] @ W)
      if lif: v = clamp11(v - leak)
      fired  = SpikeCheck(v, threshold)
      if rmp: v = clamp11(where(fired, v - threshold, v))
      else:   v = where(fired, reset, v)
      out[t] = fired
"""
from __future__ import annotations

import torch

from repro_torch.core.isa import layer_timestep_int


def fused_snn_layer_ref(spikes: torch.Tensor, wq: torch.Tensor, *,
                        neuron: str, threshold: int, leak: int = 0,
                        reset: int = 0, clamp_mode: str = "saturate"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """spikes (T, B, N_in) int8 or bool {0, 1}; wq (N_in, N_out) int8; on
    any device (the product goes through `isa.int_matmul`, exact on CUDA
    too). Returns (out_spikes (T, B, N_out) int8, v_final (B, N_out)
    int32)."""
    T, B, _ = spikes.shape
    v = torch.zeros((B, wq.shape[1]), dtype=torch.int32, device=spikes.device)
    out = torch.empty((T, B, wq.shape[1]), dtype=torch.int8,
                      device=spikes.device)
    for t in range(T):
        v, fired = layer_timestep_int(
            v, wq, spikes[t].to(torch.int32), neuron=neuron,
            threshold=threshold, leak=leak, reset=reset,
            clamp_mode=clamp_mode)
        out[t] = fired
    return out, v
