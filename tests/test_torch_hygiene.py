"""Structural guarantees of the port (src/repro_torch/ and chip_smoke.py):
it imports nothing of JAX or the JAX package, its entry points refuse to
fall back to the CPU when no device is given, and the CUDA wrapper never
catches a failed launch.
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs.base import (ShapeConfig, get_config,  # noqa: E402
                                      reduced_config)
from repro_torch.configs.impulse_snn import IMDB, MNIST  # noqa: E402
from repro_torch.core import pipeline, snn  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import io_spec, lm  # noqa: E402
from repro_torch.serve import SNNServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
WRAPPERS = [ROOT / "src" / "repro_torch" / "kernels" / kernel / name
            for kernel in ("fused_snn_net", "wkv6", "fused_snn_step")
            for name in ("ops.py", "kernel.py")]


def imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_the_jax_package(path):
    top = {name.split(".")[0] for name in imported_modules(path)}
    assert not top & {"jax", "jaxlib", "repro"}, (path, top)


def wrapper_id(path: Path) -> str:
    """The fused-network files keep their bare names as ids."""
    kernel = path.parent.name
    return path.name if kernel == "fused_snn_net" else f"{kernel}/{path.name}"


@pytest.mark.parametrize("path", WRAPPERS, ids=wrapper_id)
def test_cuda_wrapper_has_no_try(path):
    """A CUDA tensor launches the kernel or raises; nothing catches the
    failure and falls back to the plain version."""
    tree = ast.parse(path.read_text(), str(path))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_entry_points_without_a_device_raise_on_a_host_without_cuda(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = snn.init_fc_snn(0, IMDB)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.compile_network(IMDB, params, domain="int")
    program = pipeline.compile_network(IMDB, params, domain="int",
                                       device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SNNServeEngine(program, backend="cuda")
    layers = [{"kind": ly.kind, "n_in": ly.n_in, "n_out": ly.n_out,
               "w": None if ly.w is None else ly.w.numpy(),
               "threshold": (np.float32(ly.threshold) if ly.kind == "encoder"
                             else ly.threshold),
               "leak": (np.float32(ly.leak) if ly.kind == "encoder"
                        else ly.leak),
               "scale": ly.scale} for ly in program.layers]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.program_from_arrays(layers, neuron="rmp", timesteps=10)
    assert pipeline.program_from_arrays(
        layers, neuron="rmp", timesteps=10, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        snn.init_lenet_snn(0, MNIST)
    conv_params = snn.init_lenet_snn(0, MNIST, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.compile_network(MNIST, conv_params, domain="int")
    assert pipeline.compile_network(MNIST, conv_params, domain="int",
                                    device="cpu").device.type == "cpu"
    cfg = reduced_config(get_config("rwkv6-7b"))
    whisper = reduced_config(get_config("whisper-large-v3"))
    spec = io_spec.prefill_batch_spec(whisper, ShapeConfig("s", 16, 1,
                                                           "prefill"))
    for make in (lambda: lm.init_params(0, cfg),
                 lambda: lm.init_cache(cfg, 1, 8),
                 lambda: launch_serve.main(["--requests", "1"]),
                 lambda: lm.init_params(0, whisper),
                 lambda: lm.init_cache(whisper, 1, 8, enc_len=16),
                 lambda: io_spec.materialize(spec, 0),
                 lambda: launch_serve.main(["--requests", "1", "--arch",
                                            "llava-next-mistral-7b"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert lm.init_cache(cfg, 1, 8, device="cpu")["len"].device.type == "cpu"
    assert io_spec.materialize(spec, 0, device="cpu")[
        "frames"].device.type == "cpu"


def test_init_fc_snn_is_seeded():
    a, b = snn.init_fc_snn(3, IMDB), snn.init_fc_snn(3, IMDB)
    assert all(torch.equal(x["w"], y["w"])
               for x, y in zip(a["layers"], b["layers"]))
    assert snn.param_count(a) == 29_312


def test_training_entry_points_without_a_device_raise_on_a_host_without_cuda(
        monkeypatch):
    """The float program, the training launcher, the LSTM baseline and the
    SNN losses default to the CUDA device and refuse to fall back."""
    from repro_torch.core import pipeline as pipe
    from repro_torch.launch import train_snn
    from repro_torch.models import lstm_baseline
    from repro_torch.configs.impulse_snn import SpikingConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = snn.init_fc_snn(0, IMDB)
    x = np.zeros((1, 2, 100), np.float32)
    for make in (lambda: pipe.compile_network(IMDB, params),
                 lambda: pipe.rate_coded_program(SpikingConfig(), (4,)),
                 lambda: snn.sentiment_loss(params, x, np.zeros(1), IMDB),
                 lambda: lstm_baseline.init_lstm(0),
                 lambda: train_snn.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    prog = pipe.compile_network(IMDB, params, device="cpu")
    assert prog.domain == "float" and prog.device.type == "cpu"
