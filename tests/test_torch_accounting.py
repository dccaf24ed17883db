"""The port's instruction accounting (repro_torch.core.isa counters,
repro_torch.core.energy, the SparsityReport / count_network_instructions
pass of repro_torch.core.pipeline) against the JAX package on the same
inputs. Counts are integers and compared exactly; the energy model is plain
Python float arithmetic in the same order on both sides, so its values are
compared exactly too.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import energy as jenergy  # noqa: E402
from repro.core import isa as jisa  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import snn as jsnn  # noqa: E402
from repro_torch.core import energy, isa, pipeline, snn  # noqa: E402
from test_torch_conv import (images, jax_cfg, port_cfg,  # noqa: E402
                             programs as conv_programs)
from test_torch_pipeline import currents  # noqa: E402
from test_torch_pipeline import programs as imdb_programs  # noqa: E402

COUNTS = [isa.InstrCount(), isa.InstrCount(10, 2, 3, 4),
          isa.InstrCount(acc_w2v=896176, acc_v2v=22280, spike_check=20280)]
LAYERS = [(100, 128, "rmp"), (686, 120, "lif"), (126, 14, "if"),
          (128, 1, "none"), (7, 3, "rmp")]


def as_jax(c):
    return jisa.InstrCount(*c)


def test_instr_count_and_macro_constants_match_jax():
    a, b = COUNTS[1], COUNTS[2]
    assert tuple(a + b) == tuple(as_jax(a) + as_jax(b))
    assert (a + b).total == (as_jax(a) + as_jax(b)).total == sum(a) + sum(b)
    assert isa.InstrCount._fields == jisa.InstrCount._fields
    for name in ("MACRO_IN", "MACRO_OUT", "V_ROWS", "V_SLOTS_PER_ROW",
                 "N_CONST_ROWS", "N_NEURON_SETS"):
        assert getattr(isa, name) == getattr(jisa, name), name


@pytest.mark.parametrize("n_in,n_out,neuron", LAYERS)
def test_count_functions_match_jax(n_in, n_out, neuron):
    rng = np.random.default_rng(n_in + n_out)
    raster = (rng.random((6, 5, n_in)) < 0.2).astype(np.int8)
    events, frames = int(raster.sum()), 30
    assert tuple(isa.count_layer_instructions_from_events(
        events, frames, n_in, n_out, neuron)) == tuple(
        jisa.count_layer_instructions_from_events(events, frames, n_in, n_out,
                                                  neuron))
    assert tuple(isa.count_skipped_instructions_from_events(
        events, frames, n_in, n_out)) == tuple(
        jisa.count_skipped_instructions_from_events(events, frames, n_in,
                                                    n_out))
    want = tuple(jisa.count_layer_instructions(raster, n_in, n_out, neuron))
    assert tuple(isa.count_layer_instructions(raster, n_in, n_out,
                                              neuron)) == want
    assert tuple(isa.count_layer_instructions(torch.from_numpy(raster), n_in,
                                              n_out, neuron)) == want
    with pytest.raises(ValueError):
        isa.count_skipped_instructions_from_events(frames * n_in + 1, frames,
                                                   n_in, n_out)


@pytest.mark.parametrize("point", range(3))
def test_energy_model_matches_jax(point):
    pt, jpt = energy.OPERATING_POINTS[point], jenergy.OPERATING_POINTS[point]
    assert (pt.name, pt.vdd, pt.freq_hz, pt.power_w, pt.accw2v_tops_w) == (
        jpt.name, jpt.vdd, jpt.freq_hz, jpt.power_w, jpt.accw2v_tops_w)
    for instr in energy.TOPS_W_D:
        assert energy.instr_energy_j(instr, pt) == jenergy.instr_energy_j(
            instr, jpt)
    for c in COUNTS:
        for fn in ("sequence_energy_j", "sequence_delay_s", "sequence_edp",
                   "measured_edp", "snn_energy_j"):
            assert getattr(energy, fn)(c, pt) == getattr(jenergy, fn)(
                as_jax(c), jpt), fn
        assert energy.energy_per_inference_j(c, 7, pt) == \
            jenergy.energy_per_inference_j(as_jax(c), 7, jpt)
        assert energy.measured_edp_per_neuron_timestep(c, 13, pt) == \
            jenergy.measured_edp_per_neuron_timestep(as_jax(c), 13, jpt)
    assert energy.measured_edp_reduction(COUNTS[1], COUNTS[2], pt) == \
        jenergy.measured_edp_reduction(as_jax(COUNTS[1]), as_jax(COUNTS[2]),
                                       jpt)
    assert energy.tops_per_watt(pt) == jenergy.tops_per_watt(jpt)
    assert energy.gops_per_mm2(pt) == jenergy.gops_per_mm2(jpt)
    for neuron in ("if", "lif", "rmp"):
        assert energy.neuron_update_energy_pj(neuron, pt) == \
            jenergy.neuron_update_energy_pj(neuron, jpt)
        for s in (0.0, 0.5, 0.85, 1.0):
            assert tuple(energy.timestep_counts(s, neuron)) == tuple(
                jenergy.timestep_counts(s, neuron))
            assert energy.edp_per_neuron_per_timestep(s, neuron, pt) == \
                jenergy.edp_per_neuron_per_timestep(s, neuron, jpt)
            assert energy.edp_reduction(s, neuron, pt) == \
                jenergy.edp_reduction(s, neuron, jpt)
    with pytest.raises(ValueError):
        energy.energy_per_inference_j(COUNTS[1], 0)
    with pytest.raises(ValueError):
        energy.measured_edp_reduction(isa.InstrCount(), isa.InstrCount())


def check_report(prog, rasters, jprog, jrasters):
    """Report fields, the raster and report routes of the counter, the
    skipped counts and the block totals, port against JAX."""
    got = pipeline.sparsity_report(prog, rasters)
    want = jpipe.sparsity_report(jprog, jrasters)
    for name in ("n_in", "n_out", "neurons", "events", "frames", "timesteps",
                 "batch", "layer_frames", "layer_sparsity",
                 "overall_sparsity", "row_skip_counts", "skipped_row_fraction",
                 "silent_timestep_fraction", "macro_timesteps"):
        assert getattr(got, name) == getattr(want, name), name
    for g, w in zip(got.row_events + got.occupancy_t,
                    want.row_events + want.occupancy_t):
        np.testing.assert_array_equal(g, np.asarray(w))
    for g in (1, 2, 8):
        for a, b in zip(got.block_event_counts(g),
                        want.block_event_counts(g)):
            np.testing.assert_array_equal(a, np.asarray(b))
    counts = pipeline.count_network_instructions(prog, rasters)
    assert tuple(counts) == tuple(jpipe.count_network_instructions(
        jprog, jrasters))
    assert tuple(got.instruction_counts()) == tuple(counts)
    assert tuple(pipeline.count_network_instructions(prog, report=got)) == \
        tuple(counts)
    assert tuple(got.skipped_instruction_counts()) == tuple(
        want.skipped_instruction_counts())
    return got, counts


def test_imdb_program_accounting_matches_jax():
    jprog, prog = imdb_programs(("rmp", "saturate"))
    xs = currents(20, 3, seed=4)
    jres = jpipe.run_network(jprog, jnp.asarray(xs), "int_ref")
    res = pipeline.run_network(prog, torch.from_numpy(xs), "cuda")
    check_report(prog, res.rasters, jprog, jres.rasters)


@pytest.mark.parametrize("name", ["mnist", "lenet"])
def test_conv_program_accounting_matches_jax(name):
    """Conv layers counted per (timestep, example, output position) frame,
    from their input spike maps lowered to patch rasters; and the
    raster-free report from per-neuron spike sums."""
    jprog, prog = conv_programs(name, "lif", "wrap")
    x = images(name, 2, seed=9)
    jres = jpipe.run_network(jprog, jpipe.present_static(jnp.asarray(x), 3),
                             "int_ref")
    res = pipeline.run_network(prog, pipeline.present_static(
        torch.from_numpy(x), 3), "int_ref")
    rep, _ = check_report(prog, res.rasters, jprog, jres.rasters)
    assert rep.frames_by_layer[0] == 3 * 2 * (196 if name == "mnist" else 36)
    sums = [r.to(torch.float32).sum(dim=0) for r in res.rasters]
    got = pipeline.sparsity_report_from_sums(prog, sums, 3)
    want = jpipe.sparsity_report_from_sums(
        jprog, [np.asarray(jnp.asarray(r, jnp.float32).sum(axis=0))
                for r in jres.rasters], 3)
    for field in ("events", "layer_frames", "frames", "batch"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.events == rep.events
    assert tuple(got.instruction_counts()) == tuple(rep.instruction_counts())


def test_lenet_bench_total_equals_the_committed_baseline():
    """`benchmarks/fig9_efficiency.py`'s conv workload: the JAX package's
    params from PRNGKey(0), compiled by the port, run on the same images.
    Its total is the committed baseline's ``instr=49276`` (and 12.30 nJ per
    inference) under the random bits that baseline was drawn with, JAX's
    pre-0.5 threefry (``jax_threefry_partitionable=False``); the JAX
    package's own count on the same params is held equal too."""
    cfg = jax_cfg("lenet")
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        jparams = jsnn.init_lenet_snn(jax.random.PRNGKey(0), cfg)
        jparams = jax.tree_util.tree_map(np.asarray, jparams)
    finally:
        jax.config.update("jax_threefry_partitionable", before)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 12, 12, 1)).astype(np.float32) * 2
    prog = pipeline.compile_network(
        port_cfg("lenet"), snn.params_from_arrays(jparams, device="cpu"),
        domain="int", device="cpu")
    res = pipeline.run_network(prog, pipeline.present_static(
        torch.from_numpy(x), 4), "int_ref")
    counts = pipeline.count_network_instructions(prog, res.rasters)
    rep = pipeline.sparsity_report(prog, res.rasters)
    jprog = jpipe.compile_network(cfg, jparams, domain="int", validate=False)
    jres = jpipe.run_network(jprog, jpipe.present_static(jnp.asarray(x), 4),
                             "int_ref")
    assert counts.total == jpipe.count_network_instructions(
        jprog, jres.rasters).total == 49276
    assert f"{energy.energy_per_inference_j(counts, 4) * 1e9:.2f}" == "12.30"
    assert f"{rep.overall_sparsity:.3f}" == "0.665"
    assert rep.frames_by_layer[0] == 576
