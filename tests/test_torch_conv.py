"""Conv programs in the port (repro_torch.core.mapping, the conv branch of
repro_torch.core.pipeline, `snn.init_lenet_snn`, the impulse-mnist config)
against the JAX package.

A JAX conv program compiled with ``compile_network(..., domain="int",
validate=False)`` is carried across with `program_from_arrays`, so both
sides compute with identical constants; the same seeded numpy images drive
both. Every comparison is exact (tolerance 0): on-macro values are
integers, and the off-macro f32 conv encoder sums its terms in XLA:CPU's
order with one fused multiply-add per term (`pipeline.conv2d_f32`), so its
spike maps and V agree bit for bit. Shapes are cut for time where the full
configuration is slow: batch <= 4 and T <= 4 (the JAX int_ref backend runs
the MNIST program at about a second per call here).
"""
import dataclasses
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import SpikingConfig as JaxSpiking  # noqa: E402
from repro.configs.impulse_snn import MNIST as JAX_MNIST  # noqa: E402
from repro.configs.impulse_snn import SNNModelConfig as JaxCfg  # noqa: E402
from repro.core import isa as jisa  # noqa: E402
from repro.core import mapping as jmap  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import snn as jsnn  # noqa: E402
from repro.data.synthetic import mnist_like_batch as jax_mnist  # noqa: E402
from repro_torch.configs.impulse_snn import (MNIST, SNNModelConfig,  # noqa: E402
                                             SpikingConfig)
from repro_torch.core import isa, mapping, pipeline, snn  # noqa: E402
from repro_torch.data.synthetic import mnist_like_batch  # noqa: E402
from test_torch_pipeline import carry_across  # noqa: E402

NEURONS = ("if", "lif", "rmp")
CLAMPS = ("saturate", "wrap")


def lenet_bench(spiking_cls, cfg_cls, neuron="rmp"):
    """`benchmarks/fig9_efficiency.py`'s LeNet-shaped conv workload."""
    return cfg_cls(
        arch_id="lenet-bench", conv_spec=((8, 3, 1), (12, 3, 2)),
        in_shape=(12, 12, 1), layer_sizes=(6 * 6 * 12, 64, 10),
        spiking=spiking_cls(neuron=neuron, timesteps=4, threshold=1.0,
                            leak=0.0625, w_bits=6, v_bits=11),
        timesteps=4, task="multiclass")


def jax_cfg(name, neuron="rmp"):
    if name == "mnist":
        return dataclasses.replace(
            JAX_MNIST, spiking=dataclasses.replace(JAX_MNIST.spiking,
                                                   neuron=neuron))
    return lenet_bench(JaxSpiking, JaxCfg, neuron)


def port_cfg(name):
    return MNIST if name == "mnist" else lenet_bench(SpikingConfig,
                                                     SNNModelConfig)


_PROGRAMS = {}


def programs(name, neuron="rmp", clamp="saturate", seed=0):
    """(JAX program, port program carried across), built once per test
    process."""
    key = (name, neuron, clamp, seed)
    if key not in _PROGRAMS:
        params = jsnn.init_lenet_snn(jax.random.PRNGKey(seed),
                                     jax_cfg(name, neuron))
        jprog = jpipe.compile_network(jax_cfg(name, neuron), params,
                                      domain="int", clamp_mode=clamp,
                                      validate=False)
        _PROGRAMS[key] = (jprog, carry_across(jprog))
    return _PROGRAMS[key]


def images(name, B, seed):
    if name == "mnist":
        return mnist_like_batch(B, seed)[0]
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, 12, 12, 1)).astype(np.float32) * 2


def assert_equal(got, want):
    np.testing.assert_array_equal(got.numpy() if torch.is_tensor(got)
                                  else np.asarray(got), np.asarray(want))


def test_compile_network_default_domain_matches_jax():
    """The same call returns the same kind of program: both default to the
    float (QAT) domain, and the port's float conv program is
    differentiable."""
    def default(fn):
        return inspect.signature(fn).parameters["domain"].default
    assert default(pipeline.compile_network) == default(
        jpipe.compile_network) == "float"
    params = snn.init_lenet_snn(0, MNIST, "cpu")
    params["convs"][1]["w"].requires_grad_(True)
    prog = pipeline.compile_network(MNIST, params, device="cpu")
    assert prog.domain == "float" and prog.quantize
    v_out = pipeline.run_network(prog, torch.from_numpy(images("mnist", 1, 0)),
                                 "float", static_input=True).v_out
    (g,) = torch.autograd.grad(v_out.sum(), [params["convs"][1]["w"]])
    assert g.shape == (3, 3, 14, 14) and torch.isfinite(g).all()


def test_same_pads_and_conv_out_hw_match_jax():
    for size in range(1, 13):
        for k in range(1, 6):
            for s in (1, 2, 3):
                assert mapping.same_pads(size, k, s) == jmap.same_pads(size, k,
                                                                      s)
                assert mapping.conv_out_hw((size, size + 3), k, s) == \
                    jmap.conv_out_hw((size, size + 3), k, s)


@pytest.mark.parametrize("shape,k,stride", [
    ((2, 7, 9, 3), 3, 1), ((2, 7, 9, 3), 3, 2), ((1, 5, 5, 1), 2, 2),
    ((3, 28, 28, 14), 3, 2), ((2, 6, 11, 2), 4, 1)])
def test_im2col_matches_jax(shape, k, stride):
    rng = np.random.default_rng(sum(shape) + k)
    x = (rng.random(shape) < 0.4).astype(np.int8)
    assert_equal(mapping.im2col(torch.from_numpy(x), k, stride),
                 jmap.im2col(jnp.asarray(x), k, stride))
    xf = rng.standard_normal(shape).astype(np.float32)
    assert_equal(mapping.im2col(torch.from_numpy(xf), k, stride),
                 jmap.im2col(jnp.asarray(xf), k, stride))
    r = (rng.random((3, *shape)) < 0.3).astype(np.int8)
    assert_equal(mapping.im2col_raster(torch.from_numpy(r), k, stride),
                 jmap.im2col_raster(jnp.asarray(r), k, stride))


@pytest.mark.parametrize("stride", [1, 2])
def test_im2col_times_packed_weights_is_the_conv(stride):
    """``im2col @ pack_conv_weights`` equals the SAME conv of integer maps
    exactly (the JAX conv2d of integer-valued f32 is exact here)."""
    rng = np.random.default_rng(stride)
    x = (rng.random((2, 9, 7, 3)) < 0.35).astype(np.int8)
    w = rng.integers(-31, 32, (3, 3, 3, 5)).astype(np.int8)
    want = np.asarray(jpipe.conv2d(jnp.asarray(x, jnp.float32),
                                   jnp.asarray(w, jnp.float32), stride))
    patches = mapping.im2col(torch.from_numpy(x), 3, stride)
    got = isa.int_matmul(patches.reshape(-1, 27),
                         mapping.pack_conv_weights(torch.from_numpy(w)))
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(),
                                  want.astype(np.int32))


@pytest.mark.parametrize("clamp", CLAMPS)
@pytest.mark.parametrize("neuron", NEURONS)
def test_conv_layer_timestep_int_matches_jax(neuron, clamp):
    """Several timesteps of persistent V, weights large enough that V
    leaves the 11-bit range (the wrap regime)."""
    rng = np.random.default_rng(3)
    w = rng.integers(-31, 32, (3, 3, 2, 5)).astype(np.int8) * 4
    kw = dict(neuron=neuron, threshold=200, leak=3, reset=0,
              clamp_mode=clamp)
    v = torch.zeros((2, 4, 4, 5), dtype=torch.int32)
    jv = jnp.zeros((2, 4, 4, 5), jnp.int32)
    for t in range(4):
        x = (rng.random((2, 7, 7, 2)) < 0.5).astype(np.int8)
        v, s = isa.conv_layer_timestep_int(v, torch.from_numpy(w),
                                           torch.from_numpy(x), stride=2, **kw)
        jv, js = jisa.conv_layer_timestep_int(
            jv, jnp.asarray(w), jnp.asarray(x), stride=2,
            **{**kw, "threshold": jnp.int32(200), "leak": jnp.int32(3),
               "reset": jnp.int32(0)})
        assert_equal(v, jv)
        assert_equal(s, js)


@pytest.mark.parametrize("c_in,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_conv2d_f32_matches_jax_bit_for_bit(c_in, stride):
    """The encoder conv against XLA:CPU's, compared as bit patterns."""
    rng = np.random.default_rng(c_in * 10 + stride)
    x = rng.standard_normal((2, 11, 9, c_in)).astype(np.float32)
    w = rng.standard_normal((3, 3, c_in, 6)).astype(np.float32)
    got = pipeline.conv2d_f32(torch.from_numpy(x), torch.from_numpy(w), stride)
    want = np.asarray(jpipe.conv2d(jnp.asarray(x), jnp.asarray(w), stride))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("batch", [1, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_conv_encoder_matches_jax_bit_for_bit(seed, batch):
    """The MNIST conv encoder's spike maps and f32 V equal JAX's `encode`
    exactly (V compared as bit patterns), over seeds and batch sizes."""
    jprog, prog = programs("mnist", seed=seed)
    x = images("mnist", batch, seed)
    spikes, v = pipeline.encode(prog, pipeline.present_static(
        torch.from_numpy(x), 3))
    j_spikes, j_v = jpipe.encode(jprog, jpipe.present_static(
        jnp.asarray(x), 3))
    assert spikes.shape == (3, batch, 28, 28, 14)
    assert_equal(spikes, j_spikes)
    np.testing.assert_array_equal(v.numpy().view(np.int32),
                                  np.asarray(j_v).view(np.int32))
    assert float(spikes.float().mean()) > 0.01


@pytest.mark.parametrize("clamp", CLAMPS)
@pytest.mark.parametrize("seed", [0, 1])
def test_compile_network_mnist_matches_jax(seed, clamp):
    """Same float params, compiled by both: kinds, geometry, int8 HWIO
    kernels and weights, int thresholds and leaks, and scales are equal;
    the encoder conv keeps its f32 kernel. The encoder's f32 threshold and
    leak may differ by one ulp (softplus's exp/log1p can round differently
    in torch and XLA); the carried programs the other tests use avoid even
    that."""
    jparams = jsnn.init_lenet_snn(jax.random.PRNGKey(seed), JAX_MNIST)
    params = snn.params_from_arrays(jax.tree_util.tree_map(np.asarray, jparams),
                                    device="cpu")
    jprog = jpipe.compile_network(JAX_MNIST, jparams, domain="int",
                                  clamp_mode=clamp, validate=False)
    prog = pipeline.compile_network(MNIST, params, domain="int",
                                    clamp_mode=clamp, device="cpu")
    assert [(ly.kind, ly.n_in, ly.n_out, ly.stride, ly.state_shape)
            for ly in prog.layers] == [
        (ly.kind, ly.n_in, ly.n_out, ly.stride, tuple(ly.state_shape))
        for ly in jprog.layers]
    assert [ly.n_in for ly in prog.macro_stack] == [126, 126, 686, 120, 84]
    assert len(prog.neuron_layers) == 5
    for got, want in zip(prog.layers[1:], jprog.layers[1:]):
        assert_equal(got.w, want.w)
        assert got.w.dtype == torch.int8
        assert got.scale == want.scale
        if want.threshold is not None:
            assert (got.threshold, got.leak) == (int(want.threshold),
                                                 int(want.leak))
    enc, jenc = prog.layers[0], jprog.layers[0]
    assert enc.scale is None and enc.w.dtype == torch.float32
    assert_equal(enc.w, jenc.w)
    for name in ("threshold", "leak"):
        got = np.float32(getattr(enc, name))
        want = np.float32(getattr(jenc, name))
        assert abs(int(got.view(np.int32)) - int(want.view(np.int32))) <= 1


def check_against_jax(got, want, backend):
    assert len(got.rasters) == len(want.rasters)
    for g, w in zip(got.rasters, want.rasters):
        assert_equal(g, w)
    for g, w in zip(got.v_final, want.v_final):
        assert_equal(g, w)
    assert_equal(got.v_out, want.v_out)
    assert_equal(got.logits, want.logits)
    if backend == "ref_events":
        for name in ("row_event_frames", "row_skip_counts",
                     "skipped_row_fraction"):
            assert got.aux[name] == want.aux[name], name
        for g, w in zip(got.aux["row_events"], want.aux["row_events"]):
            assert_equal(g, w)
    if backend == "int_ref_sparse":
        assert_equal(got.aux["skip_counts"], want.aux["skip_counts"])
        assert got.aux["skipped_tile_fraction"] == \
            want.aux["skipped_tile_fraction"]
        assert len(got.aux["conv_skip_counts"]) == len(
            want.aux["conv_skip_counts"])
        for g, w in zip(got.aux["conv_skip_counts"],
                        want.aux["conv_skip_counts"]):
            assert_equal(g, w)


@pytest.mark.parametrize("backend", ["int_ref", "int_ref_sparse",
                                     "ref_events"])
@pytest.mark.parametrize("name,neuron,clamp", [
    ("mnist", "rmp", "saturate"), ("mnist", "lif", "wrap"),
    ("lenet", "if", "wrap"), ("lenet", "rmp", "saturate")])
def test_run_network_matches_jax(name, neuron, clamp, backend):
    """V, every raster (spike maps for the convs), logits, and the gate
    (int_ref with use_sparse) or row-event counters."""
    jprog, prog = programs(name, neuron, clamp)
    x = images(name, 3, seed=5)
    kw = {"use_sparse": True} if backend == "int_ref_sparse" else {}
    be = backend.replace("_sparse", "")
    want = jpipe.run_network(jprog, jpipe.present_static(jnp.asarray(x), 4),
                             be, **kw)
    got = pipeline.run_network(prog, pipeline.present_static(
        torch.from_numpy(x), 4), be, **kw)
    check_against_jax(got, want, backend)
    assert float(got.rasters[1].float().mean()) > 0.0


@pytest.mark.parametrize("backend,kw", [
    ("cuda", {}), ("cuda_sparse", {"gate_granularity": 8}),
    ("cuda_events", {"event_crossover": 0.15})])
def test_kernel_backends_on_the_cpu_equal_int_ref(backend, kw):
    """The cuda* backends run their plain versions on CPU tensors: same
    values as int_ref, the event ledger equal to ref_events', one skip
    entry per conv layer."""
    _, prog = programs("mnist", "lif", "wrap")
    xs = pipeline.present_static(torch.from_numpy(images("mnist", 3, 6)), 3)
    ref = pipeline.run_network(prog, xs, "int_ref")
    got = pipeline.run_network(prog, xs, backend, **kw)
    for g, w in zip(got.rasters + got.v_final, ref.rasters + ref.v_final):
        assert torch.equal(g, w)
    if backend == "cuda_sparse":
        assert len(got.aux["conv_skip_counts"]) == 2
        assert all(len(s) == 1 for s in got.aux["conv_skip_counts"])
    if backend == "cuda_events":
        events = pipeline.run_network(prog, xs, "ref_events")
        for g, w in zip(got.aux["row_events"], events.aux["row_events"]):
            np.testing.assert_array_equal(g, w)
        assert got.aux["row_event_frames"] == events.aux["row_event_frames"]
        assert len(got.aux["event_dense_fallbacks"]) == 5


def test_run_stack_from_raster_refuses_conv_programs():
    _, prog = programs("lenet")
    with pytest.raises(ValueError, match="run_network"):
        pipeline.run_stack_from_raster(prog, torch.zeros((1, 2, 432),
                                                         dtype=torch.int8))


@pytest.mark.parametrize("bad", ["no readout", "conv after fc", "kernel"])
def test_program_from_arrays_checks_conv_layers(bad):
    from test_torch_pipeline import jax_program_arrays
    layers = jax_program_arrays(programs("lenet")[0])
    if bad == "no readout":
        layers = layers[:-1]
    elif bad == "conv after fc":
        layers = [layers[0], layers[2], layers[1], layers[3]]
    else:
        layers[1] = dict(layers[1], w=layers[1]["w"][:2])
    with pytest.raises(ValueError):
        pipeline.program_from_arrays(layers, neuron="rmp", timesteps=4,
                                     device="cpu")


def test_init_lenet_snn_is_seeded_and_compiles():
    a = snn.init_lenet_snn(3, MNIST, device="cpu")
    b = snn.init_lenet_snn(3, MNIST, device="cpu")
    ja = jsnn.init_lenet_snn(jax.random.PRNGKey(3), JAX_MNIST)
    for x, y, z in zip(a["convs"] + a["layers"], b["convs"] + b["layers"],
                       ja["convs"] + ja["layers"]):
        assert torch.equal(x["w"], y["w"]) and x["w"].dtype == torch.float32
        assert tuple(x["w"].shape) == tuple(z["w"].shape)
    for name in ("threshold", "leak"):
        assert_equal(a[name], ja[name])
    assert snn.param_count(a) == sum(int(np.prod(ly["w"].shape))
                                     for ly in ja["convs"] + ja["layers"])
    prog = pipeline.compile_network(MNIST, a, domain="int", device="cpu")
    res = pipeline.run_network(prog, pipeline.present_static(
        torch.from_numpy(mnist_like_batch(2, 0)[0]), 2), "int_ref")
    assert res.v_out.shape == (2, 10) and res.v_out.dtype == torch.int32


@pytest.mark.parametrize("batch,seed", [(1, 0), (5, 3)])
def test_mnist_like_batch_matches_jax(batch, seed):
    for got, want in zip(mnist_like_batch(batch, seed),
                         jax_mnist(batch, seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
