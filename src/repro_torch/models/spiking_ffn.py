"""SpikingFFN: IMPULSE's spiking layer as a transformer FFN
(`repro.models.spiking_ffn`).

The FFN's hidden layer runs ``cfg.spiking.timesteps`` steps of IF/LIF/RMP
dynamics (rate coding) with 6-bit fake-quantized weights; the normalized
spike count is the activation. The temporal loop is the pipeline's float
executor on a single-population program, built for the call's own
``(T, d_ff)`` state shape. Gradients flow through the surrogate spike, to
the output and to the mean spike rate, which `lm.loss_fn` adds to the
loss as aux.
"""
from __future__ import annotations

import torch

from repro_torch.core import pipeline
from repro_torch.core.quant import fake_quant_w
from repro_torch.models.layers import dense_init


def init_spiking_ffn(gen, d_model: int, d_ff: int,
                     dtype=torch.bfloat16) -> dict:
    return {"up": dense_init(gen, (d_model, d_ff), dtype=dtype),
            "down": dense_init(gen, (d_ff, d_model), dtype=dtype)}


def spiking_ffn(x: torch.Tensor, p: dict, cfg) -> tuple:
    """x: (B, T, d). Returns (out, mean spike rate): the hidden population
    integrates the same current for ``timesteps`` steps on the float
    backend, on ``x``'s device."""
    sp = cfg.spiking
    w_up = fake_quant_w(p["up"].float()).to(x.dtype)
    current = (x @ w_up).float()
    program = pipeline.rate_coded_program(sp, tuple(current.shape[1:]),
                                          device=current.device)
    res = pipeline.run_network(program, current, "float", collect_sums=True,
                               static_input=True)
    h = (res.aux["spike_sums"][0] / sp.timesteps).to(x.dtype)
    w_down = fake_quant_w(p["down"].float()).to(x.dtype)
    return h @ w_down, res.aux["spike_rates"].mean()
