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

Training follows DIET-SNN: surrogate-gradient BPTT with trainable
per-layer threshold and leak and QAT to the macro's 6-bit weights, through
the float domain of `core.pipeline` (`sentiment_loss`, `lenet_loss`). The
deployed network is the same parameters compiled to the int domain
(`sentiment_apply_int`, `lenet_apply_int`) on any integer backend.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.impulse_snn import SNNModelConfig
from repro_torch.core import pipeline


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


# ---------------------------------------------------------------------------
# IMDB sentiment: the float (QAT) program and the deployed integer program
# ---------------------------------------------------------------------------

def _on(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or array) as an f32 tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def sentiment_apply(params: dict, x_words, cfg: SNNModelConfig,
                    quantize: bool = True, return_trace: bool = False,
                    device=None) -> tuple:
    """Float (QAT) inference of the sentiment net, differentiable.
    ``x_words``: (B, n_words, d_in). Returns (logits (B,) = the final
    output V, the float backend's aux: per-step spike rates and the V
    trace). ``device`` defaults to the CUDA device (raises without one)."""
    program = pipeline.compile_network(cfg, params, domain="float",
                                       quantize=quantize, device=device)
    xs = pipeline.present_words(_on(x_words, program.device), cfg.timesteps)
    res = pipeline.run_network(program, xs, "float",
                               return_trace=return_trace)
    return res.logits[:, 0], res.aux


def bce_with_logits(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of logits ``z`` against 0/1 ``labels``,
    in the stable form max(z, 0) - z * y + log1p(exp(-|z|))."""
    return torch.mean(torch.clamp(z, min=0) - z * labels
                      + torch.log1p(torch.exp(-z.abs())))


def sentiment_loss(params: dict, x_words, labels, cfg: SNNModelConfig,
                   quantize: bool = True, device=None) -> tuple:
    """(BCE loss, aux) of the sentiment net on a batch. The output V grows
    with n_words * T, so the logit is normalized to ``logits / (T *
    n_words) * 8`` first. aux: ``accuracy`` and `sentiment_apply`'s aux."""
    logits, aux = sentiment_apply(params, x_words, cfg, quantize,
                                  device=device)
    labels = _on(labels, logits.device)
    z = logits / (cfg.timesteps * x_words.shape[1]) * 8.0
    acc = torch.mean(((logits > 0) == (labels > 0.5)).to(torch.float32))
    return bce_with_logits(z, labels), {"accuracy": acc, **aux}


def sentiment_apply_int(params: dict, x_words, cfg: SNNModelConfig,
                        backend: str = "int_ref", device=None,
                        **backend_kw) -> tuple:
    """Integer-domain inference (the deployed macro program) on any integer
    backend (``int_ref``, ``cuda``, ``cuda_sparse``, ``ref_events``,
    ``cuda_events``, ``bitmacro``; ``backend_kw``: its options). Returns
    (f32 logits (B,), the per-layer input rasters, the instruction counts
    of `pipeline.count_network_instructions`)."""
    program = pipeline.compile_network(cfg, params, domain="int",
                                       device=device)
    xs = pipeline.present_words(_on(x_words, program.device), cfg.timesteps)
    res = pipeline.run_network(program, xs, backend, **backend_kw)
    counts = (pipeline.count_network_instructions(program, res.rasters)
              if res.rasters is not None else None)
    return res.logits[:, 0], res.rasters, counts


# ---------------------------------------------------------------------------
# MNIST LeNet5-mod
# ---------------------------------------------------------------------------

def lenet_apply(params: dict, images, cfg: SNNModelConfig,
                quantize: bool = True, device=None) -> torch.Tensor:
    """Float (QAT) class logits (B, n_classes) = output V of ``images``
    (B, H, W, C), presented every timestep (direct encoding; the first
    conv is the unquantized spike encoder). Differentiable."""
    program = pipeline.compile_network(cfg, params, domain="float",
                                       quantize=quantize, device=device)
    return pipeline.run_network(program, _on(images, program.device),
                                "float", static_input=True).v_out


def lenet_apply_int(params: dict, images, cfg: SNNModelConfig,
                    backend: str = "int_ref", device=None,
                    clamp_mode: str = "saturate", **backend_kw) -> tuple:
    """The deployed conv program on any integer backend (``bitmacro`` needs
    ``clamp_mode="wrap"``). Returns (logits (B, n_classes), rasters,
    instruction counts)."""
    program = pipeline.compile_network(cfg, params, domain="int",
                                       clamp_mode=clamp_mode, device=device)
    xs = pipeline.present_static(_on(images, program.device), cfg.timesteps)
    res = pipeline.run_network(program, xs, backend, **backend_kw)
    counts = (pipeline.count_network_instructions(program, res.rasters)
              if res.rasters is not None else None)
    return res.logits, res.rasters, counts


def lenet_loss(params: dict, images, labels, cfg: SNNModelConfig,
               quantize: bool = True, device=None) -> tuple:
    """(cross-entropy loss, {"accuracy"}) of LeNet5-mod on a batch."""
    logits = lenet_apply(params, images, cfg, quantize, device=device)
    labels = torch.as_tensor(labels, dtype=torch.int64, device=logits.device)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(logp.gather(1, labels[:, None]))
    acc = torch.mean((logits.argmax(-1) == labels).to(torch.float32))
    return loss, {"accuracy": acc}
