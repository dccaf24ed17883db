"""Parameter init for the paper's two SNNs.

IMDB: GloVe-100d word -> encoder (100 spiking neurons) -> FC 100x128 ->
FC 128x128 (both spiking, on-macro) -> FC 128x1 accumulate-only readout;
each word is presented ``timesteps`` steps and membrane potentials persist
across words. 29,312 weights (paper: 29.3K). Its weights come from a numpy
`Generator`, so they are reproducible from a seed on any device.

MNIST (LeNet5-mod): the conv spike encoder, two on-macro 3x3 convs and the
FC stack; `init_lenet_snn` draws its weights from a `torch.Generator` on
the device. Neither is the JAX package's random bits; `params_from_arrays`
carries the JAX package's parameters across as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.impulse_snn import SNNModelConfig


def init_fc_snn(seed: int, cfg: SNNModelConfig, device=None) -> dict:
    """Float parameters of the FC stack of ``cfg`` from numpy seed ``seed``:
    per-layer He-style normal weights (n_in, n_out) f32, plus the
    pre-softplus threshold and leak of the encoder and every spiking layer
    (index 0 = encoder). ``device`` defaults to the CPU: these are host
    parameters that `pipeline.compile_network` places."""
    rng = np.random.default_rng(seed)
    sizes = cfg.layer_sizes
    layers = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        w = rng.standard_normal((n_in, n_out)).astype(np.float32)
        w *= np.float32(2.0 / np.sqrt(n_in))
        layers.append({"w": torch.from_numpy(w).to(device)})
    n_spiking = len(sizes) - 2                    # last layer is accumulate-only
    return {
        "layers": layers,
        "threshold": torch.full((n_spiking + 1,), cfg.spiking.threshold,
                                dtype=torch.float32, device=device),
        "leak": torch.full((n_spiking + 1,), cfg.spiking.leak,
                           dtype=torch.float32, device=device),
    }


def init_lenet_snn(seed: int, cfg: SNNModelConfig, device=None) -> dict:
    """Float parameters of the conv program ``cfg`` (``conv_spec``,
    ``in_shape`` and the FC ``layer_sizes``) drawn from a `torch.Generator`
    seeded with ``seed`` on ``device`` (default: the CUDA device; raises
    without one): He-style normal HWIO conv kernels (k, k, c_in, c_out) and
    FC weights (n_in, n_out), and the pre-softplus threshold and leak of
    every neuron layer (the conv encoder first). The numbers differ between
    devices for the same seed."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=device)
                * float(2.0 / np.sqrt(fan_in)))

    convs, c_in = [], cfg.in_shape[-1]
    for c_out, k, _ in cfg.conv_spec:
        convs.append({"w": normal((k, k, c_in, c_out), k * k * c_in)})
        c_in = c_out
    sizes = cfg.layer_sizes
    layers = [{"w": normal((n_in, n_out), n_in)}
              for n_in, n_out in zip(sizes[:-1], sizes[1:])]
    n_spiking = len(cfg.conv_spec) + len(sizes) - 2
    return {"convs": convs, "layers": layers,
            "threshold": torch.full((n_spiking,), cfg.spiking.threshold,
                                    dtype=torch.float32, device=device),
            "leak": torch.full((n_spiking,), cfg.spiking.leak,
                               dtype=torch.float32, device=device)}


def params_from_arrays(params: dict, device=None) -> dict:
    """SNN parameters with numpy array leaves (the JAX package's, taken
    through ``np.asarray``) as the same nesting of f32 tensors on
    ``device`` (default: the CUDA device; raises without one)."""
    device = resolve_device(device)

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [leaf(v) for v in x]
        return torch.tensor(np.asarray(x, np.float32), device=device)
    return leaf(params)


def param_count(params: dict) -> int:
    """Number of FC and conv weights in ``params``."""
    return sum(ly["w"].numel()
               for ly in params["layers"] + params.get("convs", []))
