"""The port's pipeline (repro_torch.core.pipeline) against the JAX package's
``int_ref`` path on the full-width IMDB program (100-128-128-1).

A JAX program compiled with ``compile_network(..., validate=False)`` is
carried across with `program_from_arrays`, so both sides compute with
identical constants; the same seeded numpy currents drive both. Every
comparison is exact: on-macro values are integers, and the f32 encoder
does the same f32 ops in the same order (``v - th * s`` with s in {0, 1}
rounds once), so its V and spikes agree bit for bit too.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.impulse_snn import IMDB as JAX_IMDB  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import snn as jsnn  # noqa: E402
from repro_torch.configs.impulse_snn import IMDB  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402

VARIANTS = [("rmp", "saturate"), ("lif", "wrap"), ("if", "saturate")]


def jax_program_arrays(prog) -> list:
    """A JAX `SNNProgram`'s layers as the plain dicts `program_from_arrays`
    takes."""
    def arr(x):
        return None if x is None else np.asarray(x)
    return [{"kind": ly.kind, "n_in": ly.n_in, "n_out": ly.n_out,
             "w": arr(ly.w), "threshold": arr(ly.threshold),
             "leak": arr(ly.leak), "scale": ly.scale, "stride": ly.stride,
             "state_shape": ly.state_shape} for ly in prog.layers]


def carry_across(prog, device="cpu"):
    """The port's copy of JAX program ``prog`` on ``device``."""
    return pipeline.program_from_arrays(
        jax_program_arrays(prog), neuron=prog.neuron,
        timesteps=prog.timesteps, clamp_mode=prog.clamp_mode, device=device)


def jax_imdb_program(neuron="rmp", clamp_mode="saturate", seed=0):
    cfg = dataclasses.replace(
        JAX_IMDB, spiking=dataclasses.replace(JAX_IMDB.spiking, neuron=neuron))
    params = jsnn.init_fc_snn(jax.random.PRNGKey(seed), cfg)
    return jpipe.compile_network(cfg, params, domain="int",
                                 clamp_mode=clamp_mode, validate=False)


_PROGRAMS = {}


def programs(variant):
    """(JAX program, port program) for a (neuron, clamp) variant, built
    once per test process."""
    if variant not in _PROGRAMS:
        jprog = jax_imdb_program(*variant)
        _PROGRAMS[variant] = (jprog, carry_across(jprog))
    return _PROGRAMS[variant]


def currents(T, B, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((T, B, 100)) * 1.6).astype(np.float32)


def assert_equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["int_ref", "cuda"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_run_network_matches_jax_int_ref(backend, variant):
    jprog, prog = programs(variant)
    xs = currents(20, 5, seed=1)
    want = jpipe.run_network(jprog, jnp.asarray(xs), "int_ref")
    got = pipeline.run_network(prog, torch.from_numpy(xs), backend)
    assert len(got.rasters) == len(want.rasters) == 3
    for g, w in zip(got.rasters, want.rasters):
        assert_equal(g, w)
    assert got.v_final[0].dtype == torch.float32
    for g, w in zip(got.v_final, want.v_final):
        assert_equal(g, w)
    assert_equal(got.v_out, want.v_out)
    assert_equal(got.logits, want.logits)
    assert float(np.asarray(got.rasters[0], np.float64).mean()) > 0.05


@pytest.mark.parametrize("backend", ["int_ref", "cuda"])
def test_stream_step_chain_equals_batch_run(backend):
    _, prog = programs(VARIANTS[1])
    xs = torch.from_numpy(currents(12, 4, seed=2))
    batch = pipeline.run_network(prog, xs, backend)
    state = pipeline.init_stream_state(prog, 4, backend)
    ticks = []
    for t in range(xs.shape[0]):
        state, out = pipeline.stream_step(prog, state, xs[t], backend)
        ticks.append(out)
    for i, r in enumerate(batch.rasters):
        assert torch.equal(torch.stack([o.rasters[i] for o in ticks]), r)
    for g, w in zip(state.vs, batch.v_final):
        assert torch.equal(g, w)
    assert torch.equal(ticks[-1].logits, batch.logits)
    assert state.t == 12


@pytest.mark.parametrize("backend", ["int_ref", "cuda"])
@pytest.mark.parametrize("variant", VARIANTS[:2])
def test_stream_megastep_matches_jax(backend, variant):
    """Two K=10 blocks, the second from carried state with an active mask
    (lanes consume 10, 3, 0, 7 and 10 frames)."""
    jprog, prog = programs(variant)
    B, K = 5, 10
    xs = currents(2 * K, B, seed=3)
    active = np.array([10, 3, 0, 7, 10], np.int32)
    jstate = jpipe.init_stream_state(jprog, B, "int_ref")
    state = pipeline.init_stream_state(prog, B, backend)
    jstate, _ = jpipe.stream_megastep(jprog, jstate, jnp.asarray(xs[:K]),
                                      "int_ref")
    state, _ = pipeline.stream_megastep(prog, state, torch.from_numpy(xs[:K]),
                                        backend)
    jstate, want = jpipe.stream_megastep(jprog, jstate, jnp.asarray(xs[K:]),
                                         "int_ref", active=active)
    state, got = pipeline.stream_megastep(prog, state,
                                          torch.from_numpy(xs[K:]), backend,
                                          active=active)
    for g, w in zip(state.vs, jstate.vs):
        assert_equal(g, w)
    for name in ("v_out", "logits", "v_out_traj", "logits_traj",
                 "frames_consumed"):
        assert_equal(getattr(got, name), getattr(want, name))
    for g, w in zip(got.rasters, want.rasters):
        assert_equal(g, w)


def _method_drive(prog, xs, backend, chunks, as_array):
    """`tests/test_megastep.py`'s method forms: T ticks of
    ``program.step`` from ``program.init_state``, then the same currents
    through ``program.megastep`` in ``chunks``. Returns the per-tick
    v_out and logits of both and both final states' V."""
    state = prog.init_state(xs.shape[1], backend)
    ticks = []
    for t in range(xs.shape[0]):
        state, out = prog.step(state, as_array(xs[t]), backend)
        ticks.append((out.v_out, out.logits))
    mstate, t, blocks = prog.init_state(xs.shape[1], backend), 0, []
    for k in chunks:
        mstate, out = prog.megastep(mstate, as_array(xs[t:t + k]), backend)
        blocks.append((out.v_out_traj, out.logits_traj))
        t += k
    return ticks, blocks, state.vs, mstate.vs


@pytest.mark.parametrize("backend", ["int_ref", "cuda"])
def test_program_methods_match_jax(backend):
    """``SNNProgram.init_state``/``step``/``megastep`` (JAX's method forms
    of the stream functions) on the port == JAX's methods on its
    ``int_ref`` backend, bit for bit: 12 ticks one at a time and in
    megasteps of 4, 3 and 5; `LayerSpec.tiling` is JAX's for every layer
    and `SNNServeEngine.state` is page 0's state."""
    from repro.serve import SNNServeEngine as JaxEngine
    from repro_torch.serve import SNNServeEngine
    jprog, prog = programs(VARIANTS[0])
    xs = currents(12, 3, seed=5)
    got = _method_drive(prog, xs, backend, (4, 3, 5), torch.from_numpy)
    want = _method_drive(jprog, xs, "int_ref", (4, 3, 5), jnp.asarray)
    for (gv, gl), (wv, wl) in zip(got[0] + got[1], want[0] + want[1]):
        assert_equal(gv, wv)
        assert_equal(gl, wl)
    for g, w in zip(got[2] + got[3], want[2] + want[3]):
        assert_equal(g, w)
    assert len(got[0]) == 12 and len(got[1]) == 3
    for ly, jly in zip(prog.layers, jprog.layers):
        assert dataclasses.astuple(ly.tiling) == dataclasses.astuple(jly.tiling)
    eng = SNNServeEngine(prog, batch_slots=4, backend=backend,
                         device="cpu")
    jeng = JaxEngine(jprog, batch_slots=4, backend="int_ref")
    assert eng.state is eng.states[0]
    for g, w in zip(eng.state.vs, jeng.state.vs):
        assert_equal(g, w)


@pytest.mark.parametrize("clamp_mode", ["saturate", "wrap"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compile_network_matches_jax(clamp_mode, seed):
    """Same float params, compiled by both: int8 weights, int thresholds
    and leaks, and scales are equal. The encoder's f32 threshold and leak
    may differ by one ulp, because softplus's exp/log1p can round
    differently in torch and XLA; carrying a program across with
    `program_from_arrays` (as the other tests do) avoids even that."""
    jparams = jsnn.init_fc_snn(jax.random.PRNGKey(seed), JAX_IMDB)
    params = jax.tree_util.tree_map(np.asarray, jparams)
    jprog = jpipe.compile_network(JAX_IMDB, jparams, domain="int",
                                  clamp_mode=clamp_mode, validate=False)
    prog = pipeline.compile_network(IMDB, params, domain="int",
                                    clamp_mode=clamp_mode, device="cpu")
    assert [ly.kind for ly in prog.layers] == [ly.kind for ly in jprog.layers]
    for got, want in zip(prog.layers[1:], jprog.layers[1:]):
        assert_equal(got.w, want.w)
        assert got.w.dtype == torch.int8
        assert got.scale == want.scale
        if want.threshold is not None:
            assert (got.threshold, got.leak) == (int(want.threshold),
                                                 int(want.leak))
    for name in ("threshold", "leak"):
        got = np.float32(getattr(prog.layers[0], name))
        want = np.float32(getattr(jprog.layers[0], name))
        assert abs(int(got.view(np.int32)) - int(want.view(np.int32))) <= 1


def test_sparsity_report_matches_jax():
    jprog, prog = programs(VARIANTS[0])
    xs = currents(20, 3, seed=4)
    want = jpipe.sparsity_report(
        jprog, jpipe.run_network(jprog, jnp.asarray(xs), "int_ref").rasters)
    got = pipeline.sparsity_report(
        prog, pipeline.run_network(prog, torch.from_numpy(xs), "cuda").rasters)
    for name in ("n_in", "n_out", "neurons", "events", "frames", "timesteps",
                 "batch", "layer_frames", "layer_sparsity",
                 "overall_sparsity", "row_skip_counts",
                 "skipped_row_fraction"):
        assert getattr(got, name) == getattr(want, name), name
    for g, w in zip(got.row_events + got.occupancy_t,
                    want.row_events + want.occupancy_t):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_present_words_matches_jax():
    x = np.random.default_rng(5).random((3, 4, 7)).astype(np.float32)
    assert_equal(pipeline.present_words(torch.from_numpy(x), 10),
                 jpipe.present_words(jnp.asarray(x), 10))


@pytest.mark.parametrize("params,kw", [
    ({"layers": []}, {"domain": "float"}),
    ({"layers": [], "convs": [{"w": np.zeros((3, 3, 1, 14))}]}, {}),
])
def test_unported_paths_raise(params, kw):
    """The float domain is ported: the float program of the IMDB network
    compiles and runs (the first case); parameters whose layers do not
    match the config are refused (the second)."""
    if kw:
        params = jax.tree_util.tree_map(
            np.asarray, jsnn.init_fc_snn(jax.random.PRNGKey(0), JAX_IMDB))
        prog = pipeline.compile_network(IMDB, params, device="cpu", **kw)
        res = pipeline.run_network(prog, torch.ones((10, 2, 100)), "float")
        assert prog.domain == "float" and res.logits.shape == (2, 1)
        assert torch.isfinite(res.logits).all()
        return
    with pytest.raises(ValueError, match="config"):
        pipeline.compile_network(IMDB, params, device="cpu", **kw)


def test_program_from_arrays_rejects_a_non_fc_stack():
    layers = jax_program_arrays(programs(VARIANTS[0])[0])
    with pytest.raises(ValueError, match="layer kinds"):
        pipeline.program_from_arrays(layers[1:], neuron="rmp", timesteps=10,
                                     device="cpu")
