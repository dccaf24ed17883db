"""Conv programs streamed and served by the port (`pipeline.stream_step`,
`pipeline.stream_megastep`, `serve.SNNServeEngine`) against the JAX
package's stream functions and engines.

A JAX conv program compiled with ``compile_network(..., domain="int",
validate=False)`` is carried across with `program_from_arrays` (with the
port's config, which gives the engine its input shape), and the same seeded
numpy images drive both. Every comparison is exact (tolerance 0): every V
leaf (the f32 encoder map bit for bit, the conv maps and the fc stack),
every raster, the readout trajectory, the counters and the per-request
reports. V is carried across block edges in every case (at least two
blocks a stream), so a conv V map flattened in another frame order than
`mapping.im2col_raster`'s would show. The oracles are JAX `int_ref`
(optionally gated) and `ref_events`: its Pallas backends cannot emit
rasters on this JAX.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import SpikingConfig as JaxSpiking  # noqa: E402
from repro.configs.impulse_snn import MNIST as JAX_MNIST  # noqa: E402
from repro.configs.impulse_snn import SNNModelConfig as JaxCfg  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import snn as jsnn  # noqa: E402
from repro.serve import SNNRequest as JaxRequest  # noqa: E402
from repro.serve import SNNServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs.impulse_snn import (MNIST, SNNModelConfig,  # noqa: E402
                                             SpikingConfig)
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.data.synthetic import mnist_like_batch  # noqa: E402
from repro_torch.launch.serve_snn import image_requests  # noqa: E402
from repro_torch.serve import SNNServeEngine  # noqa: E402
from test_torch_pipeline import jax_program_arrays  # noqa: E402


def lenet_s(spiking_cls, cfg_cls, neuron="rmp"):
    """JAX `tests/test_stream.py`'s small conv stack."""
    return cfg_cls(
        arch_id="lenet-s", conv_spec=((4, 3, 1), (6, 3, 2)),
        in_shape=(8, 8, 1), layer_sizes=(4 * 4 * 6, 10, 3),
        spiking=spiking_cls(neuron=neuron, timesteps=2, threshold=1.0,
                            leak=0.0625, w_bits=6, v_bits=11),
        timesteps=2, task="multiclass")


def configs(name, neuron="rmp"):
    """(JAX config, port config)."""
    if name == "mnist":
        return (dataclasses.replace(JAX_MNIST, spiking=dataclasses.replace(
                    JAX_MNIST.spiking, neuron=neuron)),
                dataclasses.replace(MNIST, spiking=dataclasses.replace(
                    MNIST.spiking, neuron=neuron)))
    return (lenet_s(JaxSpiking, JaxCfg, neuron),
            lenet_s(SpikingConfig, SNNModelConfig, neuron))


_PROGRAMS = {}


def programs(name, neuron="rmp", clamp="wrap"):
    """(JAX program, the port's copy on the CPU with its config), built
    once per test process."""
    key = (name, neuron, clamp)
    if key not in _PROGRAMS:
        jcfg, cfg = configs(name, neuron)
        jprog = jpipe.compile_network(
            jcfg, jsnn.init_lenet_snn(jax.random.PRNGKey(0), jcfg),
            domain="int", clamp_mode=clamp, validate=False)
        prog = pipeline.program_from_arrays(
            jax_program_arrays(jprog), neuron=jprog.neuron,
            timesteps=jprog.timesteps, clamp_mode=clamp, device="cpu",
            cfg=cfg)
        _PROGRAMS[key] = (jprog, prog)
    return _PROGRAMS[key]


def images(name, batch, seed):
    if name == "mnist":
        return mnist_like_batch(batch, seed)[0]
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, 8, 8, 1)).astype(np.float32) * 2


def blocks(T, K):
    """Block lengths of a T-frame stream at K frames a block."""
    return [min(K, T - t) for t in range(0, T, K)]


def stream(mod, program, xs, backend, K, to, **kw):
    """Stream ``xs`` (T, B, ...) through ``mod``'s stream functions in
    blocks of K (K = 1: the `stream_step` chain), carrying the state.
    Returns (final V leaves, rasters over the stream, per-block outputs)
    as numpy, ``to`` making each module's arrays."""
    state = mod.init_stream_state(program, xs.shape[1], backend)
    outs, t = [], 0
    for k in blocks(xs.shape[0], K):
        if K == 1:
            state, out = mod.stream_step(program, state, to(xs[t]), backend,
                                         **kw)
        else:
            state, out = mod.stream_megastep(program, state,
                                             to(xs[t:t + k]), backend, **kw)
        outs.append(out)
        t += k
    axis = [np.asarray(r)[None] if K == 1 else np.asarray(r)
            for r in outs[0].rasters]
    rasters = [np.concatenate([np.asarray(o.rasters[i])[None] if K == 1
                               else np.asarray(o.rasters[i]) for o in outs])
               for i in range(len(axis))]
    return [np.asarray(v) for v in state.vs], rasters, outs


def assert_counters_equal(got, want):
    """`events.EventStats`, gate-count arrays or per-granularity lists,
    from the two packages, equal."""
    if want is None:
        assert got is None
    elif isinstance(want, (list, tuple)) and not hasattr(want, "row_events"):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_counters_equal(g, w)
    elif hasattr(want, "row_events"):
        assert got.frames == want.frames
        assert tuple(got.dense_fallbacks) == tuple(want.dense_fallbacks)
        for g, w in zip(got.row_events, want.row_events):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def to_jax(x):
    return jnp.asarray(x)


def to_torch(x):
    return torch.from_numpy(np.array(x))


CASES = [("lenet", "int_ref", {}), ("lenet", "ref_events", {}),
         ("lenet", "int_ref", {"use_sparse": True})]


@pytest.mark.parametrize("K", [1, 3, 10])
@pytest.mark.parametrize("name,backend,kw", CASES + [
    ("mnist", "int_ref", {}), ("mnist", "ref_events", {})])
def test_conv_stream_matches_jax(name, backend, kw, K):
    """Every V leaf, raster, readout trajectory and counter of a streamed
    conv program equals the JAX stream functions'. lenet-s streams 12
    frames (wrap, RMP), impulse-mnist (batch 2) 4 frames tick by tick, 6
    at K = 3 and 20 at K = 10: at least two blocks, so V crosses a block
    edge."""
    jprog, prog = programs(name)
    T = {1: 4, 3: 6, 10: 20}[K] if name == "mnist" else 12
    xs = np.broadcast_to(images(name, 2, 3)[None], (T, 2, *prog.in_shape))
    jv, jr, jouts = stream(jpipe, jprog, xs, backend, K, to_jax, **kw)
    pv, pr, pouts = stream(pipeline, prog, xs, backend, K, to_torch, **kw)
    assert [v.shape for v in pv] == [v.shape for v in jv]
    for got, want in zip(pv + pr, jv + jr):
        np.testing.assert_array_equal(got, want)
    for po, jo in zip(pouts, jouts):
        np.testing.assert_array_equal(po.v_out.numpy(), np.asarray(jo.v_out))
        if K > 1:
            np.testing.assert_array_equal(po.v_out_traj.numpy(),
                                          np.asarray(jo.v_out_traj))
            np.testing.assert_array_equal(po.logits_traj.numpy(),
                                          np.asarray(jo.logits_traj))
        assert_counters_equal(po.skips, jo.skips)
        assert_counters_equal(po.conv_skips, jo.conv_skips)


def test_conv_state_leaves():
    """init_stream_state gives the conv encoder V as (B, H, W, C) f32 and
    each on-macro conv V as (B, H_out, W_out, C) int32, as JAX's."""
    jprog, prog = programs("mnist")
    state = pipeline.init_stream_state(prog, 3)
    jstate = jpipe.init_stream_state(jprog, 3, "int_ref")
    assert [tuple(v.shape) for v in state.vs] == [
        (3, 28, 28, 14), (3, 14, 14, 14), (3, 7, 7, 14), (3, 120), (3, 84),
        (3, 10)]
    assert [tuple(v.shape) for v in state.vs] == [v.shape for v in jstate.vs]
    assert [v.dtype for v in state.vs] == [torch.float32] + [torch.int32] * 5


@pytest.mark.parametrize("K", [1, 3])
def test_every_port_backend_streams_conv_alike(K):
    """On CPU tensors the streaming backends (the float rendering of the
    int program among them) give the same V, rasters
    and readout; the event backends the same ledger, and the gated ones
    one counter per conv."""
    _, prog = programs("lenet", "lif")
    xs = np.broadcast_to(images("lenet", 5, 4)[None], (7, 5, 8, 8, 1))
    ref_v, ref_r, _ = stream(pipeline, prog, xs, "int_ref", K, to_torch)
    events = None
    for backend in pipeline.STREAM_BACKENDS:
        kw = {"block_b": 2} if backend.startswith("cuda") else {}
        v, r, outs = stream(pipeline, prog, xs, backend, K, to_torch, **kw)
        for got, want in zip(v + r, ref_v + ref_r):
            np.testing.assert_array_equal(got, want)
        if backend.endswith("events"):
            rows = [[np.asarray(x) for st in (o.conv_skips + [o.skips])
                     for x in st.row_events] for o in outs]
            if events is None:
                events = rows
            for a, b in zip(rows, events):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
        if backend == "cuda_sparse":
            assert all(len(o.conv_skips) == len(prog.int_conv_stack) == 1
                       for o in outs)


def test_conv_stream_frame_order_is_im2col_order():
    """A conv V map carried from a previous block with distinct values at
    every (example, position, channel) enters the next call as its
    (B*P, C) frames in im2col order: a transposed (H, W) reshape would
    change the outputs."""
    _, prog = programs("lenet")
    xs = torch.from_numpy(np.broadcast_to(images("lenet", 2, 5)[None],
                                          (2, 2, 8, 8, 1)).copy())
    state = pipeline.init_stream_state(prog, 2)
    vs = list(state.vs)
    vs[1] = torch.arange(vs[1].numel(), dtype=torch.int32).reshape(
        vs[1].shape) % 40 - 20
    state = pipeline.StreamState(vs=tuple(vs))
    _, out = pipeline.stream_megastep(prog, state, xs, "int_ref")
    jprog = programs("lenet")[0]
    jstate = jpipe.StreamState(vs=tuple(jnp.asarray(v.numpy()) for v in vs))
    _, jout = jpipe.stream_megastep(jprog, jstate, jnp.asarray(xs.numpy()),
                                    "int_ref")
    for got, want in zip(out.rasters, jout.rasters):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the engine on conv requests -------------------------------------------

def drain(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return sorted(engine.run_until_drained(), key=lambda r: r.rid)


def jax_requests(reqs):
    return [JaxRequest(rid=r.rid, frames=r.frames, arrival_tick=r.arrival_tick,
                       stop_threshold=r.stop_threshold, max_ticks=r.max_ticks)
            for r in reqs]


def serve_both(name, backend, pages, K, n_req=5, slots=2, T=7, stagger=3,
               stop_threshold=None, seed=11):
    jprog, prog = programs(name)
    reqs = image_requests(images(name, n_req, seed), T, stagger,
                          stop_threshold)
    want_eng = JaxEngine(jprog, batch_slots=slots, backend=backend,
                         pages=pages, megastep=K)
    want = drain(want_eng, jax_requests(reqs))
    eng = SNNServeEngine(prog, batch_slots=slots, backend=backend,
                         pages=pages, megastep=K, device="cpu")
    got = drain(eng, image_requests(images(name, n_req, seed), T, stagger,
                                    stop_threshold))
    return got, want, eng, want_eng


def assert_same_requests(got, want):
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.v_out, w.v_out)
        np.testing.assert_array_equal(g.logits, w.logits)
        assert (g.ticks, g.finish_clock) == (w.ticks, w.finish_clock)
        assert g.report.events == w.report.events
        assert g.report.layer_frames == w.report.layer_frames
        for a, b in zip(g.report.row_events, w.report.row_events):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["int_ref", "ref_events"])
@pytest.mark.parametrize("pages,K", [(1, 1), (1, 4), (2, 5), (2, 4)])
def test_conv_engine_matches_jax(backend, pages, K):
    """Staggered conv requests of 7 frames on 2 slots a page: every
    request, the finish clocks, the per-request reports, and on
    ref_events the device ledger equal the JAX engine's."""
    got, want, eng, jeng = serve_both("lenet", backend, pages, K)
    assert_same_requests(got, want)
    assert eng.max_safe_ticks == jeng.max_safe_ticks
    if backend == "ref_events":
        a, b = eng.device_event_stats(), jeng.device_event_stats()
        assert a.frames == b.frames
        for x, y in zip(a.row_events, b.row_events):
            np.testing.assert_array_equal(x, y)
        assert (eng.device_skipped_row_fraction()
                == jeng.device_skipped_row_fraction())


@pytest.mark.parametrize("K", [1, 5])
def test_conv_engine_stop_threshold_matches_jax(K):
    got, want, _, _ = serve_both("lenet", "int_ref", 1, K, n_req=4,
                                 stop_threshold=0.05)
    assert_same_requests(got, want)
    assert any(r.ticks < 7 for r in got)


def test_mnist_engine_matches_jax_and_isolated_runs():
    """impulse-mnist requests (10 frames, staggered by 3) on 2 slots x 2
    pages at K = 5: equal to the JAX int_ref engine, to an isolated
    `run_network` of each image, and each report to `sparsity_report` of
    that run on events and layer_frames; the ref_events ledger equals the
    pooled per-request tally (every request is whole blocks: no ghost
    ticks)."""
    got, want, _, _ = serve_both("mnist", "int_ref", 2, 5, n_req=4, T=10)
    assert_same_requests(got, want)
    _, prog = programs("mnist")
    imgs = images("mnist", 4, 11)
    for r in got:
        xs = pipeline.present_static(torch.from_numpy(imgs[r.rid:r.rid + 1]),
                                     10)
        iso = pipeline.run_network(prog, xs, "int_ref")
        np.testing.assert_array_equal(r.v_out, iso.v_out[0].numpy())
        rep = pipeline.sparsity_report(prog, iso.rasters)
        assert (r.report.events, r.report.layer_frames) == (
            rep.events, rep.layer_frames)
    eng = SNNServeEngine(prog, batch_slots=2, pages=2, megastep=5,
                         backend="ref_events", device="cpu")
    served = drain(eng, image_requests(imgs, 10, 3))
    tally = sum(np.concatenate(r.report.row_events) for r in served)
    np.testing.assert_array_equal(
        np.concatenate(eng.device_event_stats().row_events), tally)
