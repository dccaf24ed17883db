"""The port's serving engine (repro_torch.serve.SNNServeEngine) against the
JAX package's `SNNServeEngine(backend="int_ref")`, on the full-width IMDB
program carried across with `program_from_arrays` and the same
`make_requests` frames. Every per-request output is compared exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import snn as jsnn  # noqa: E402
from repro.configs.impulse_snn import IMDB as JAX_IMDB  # noqa: E402
from repro.launch.serve_snn import make_requests as jax_make_requests  # noqa: E402
from repro.serve import SNNServeEngine as JaxEngine  # noqa: E402
from repro_torch.launch.serve_snn import make_requests  # noqa: E402
from repro_torch.serve import (EngineUndrained, ReportUnavailable,  # noqa: E402
                               SNNRequest, SNNServeEngine)
from test_torch_pipeline import carry_across  # noqa: E402

_PROGRAMS = {}


def programs():
    """(JAX IMDB program from PRNGKey(0), the port's copy on the CPU)."""
    if not _PROGRAMS:
        params = jsnn.init_fc_snn(jax.random.PRNGKey(0), JAX_IMDB)
        jprog = jpipe.compile_network(JAX_IMDB, params, domain="int",
                                      validate=False)
        _PROGRAMS["p"] = (jprog, carry_across(jprog))
    return _PROGRAMS["p"]


def drain(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return sorted(engine.run_until_drained(), key=lambda r: r.rid)


def serve_both(backend, pages, megastep, n_req=6, n_words=3, slots=4,
               stop_threshold=None, poisson_gap=None):
    jprog, prog = programs()
    args = (n_req, n_words, 10, 0.85, 0, stop_threshold, poisson_gap)
    want = drain(JaxEngine(jprog, batch_slots=slots, backend="int_ref",
                           pages=pages, megastep=megastep),
                 jax_make_requests(jprog, *args))
    eng = SNNServeEngine(prog, batch_slots=slots, backend=backend,
                         pages=pages, megastep=megastep, device="cpu")
    got = drain(eng, make_requests(prog, *args))
    return got, want, eng


def assert_same_requests(got, want):
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.v_out, w.v_out)
        np.testing.assert_array_equal(g.logits, w.logits)
        assert g.v_out.dtype == np.int32 and g.logits.dtype == np.float32
        assert (g.ticks, g.finish_clock) == (w.ticks, w.finish_clock)
        assert g.report.events == w.report.events
        for a, b in zip(g.report.row_events, w.report.row_events):
            np.testing.assert_array_equal(a, b)


def test_requests_frames_match_jax():
    jprog, prog = programs()
    for g, w in zip(make_requests(prog, 3, 2, 10, 0.85, 0),
                    jax_make_requests(jprog, 3, 2, 10, 0.85, 0)):
        np.testing.assert_array_equal(g.frames, w.frames)
        assert g.frames.dtype == np.float32


@pytest.mark.parametrize("backend", ["cuda", "int_ref"])
@pytest.mark.parametrize("pages,megastep", [(1, 1), (1, 10), (2, 1), (2, 10)])
def test_engine_matches_jax(backend, pages, megastep):
    got, want, _ = serve_both(backend, pages, megastep)
    assert_same_requests(got, want)


@pytest.mark.parametrize("backend", ["cuda", "int_ref"])
def test_pinned_readout_v(backend):
    """Readout V of the six IMDB requests served by the JAX int_ref engine
    (PRNGKey(0) weights, batch_slots=4, K=10), pinned."""
    got, _, eng = serve_both(backend, pages=1, megastep=10)
    assert [int(r.v_out[0]) for r in got] == [701, 913, 694, 1068, 929, 510]
    assert eng.aggregate_report().skipped_row_fraction == pytest.approx(
        0.8845349563046192, abs=0)


@pytest.mark.parametrize("megastep", [1, 10])
def test_stop_threshold_matches_jax(megastep):
    got, want, _ = serve_both("cuda", pages=1, megastep=megastep,
                              stop_threshold=12.0)
    assert_same_requests(got, want)
    assert any(r.ticks < 30 for r in got)


@pytest.mark.parametrize("megastep", [1, 10])
def test_arrival_ticks_match_jax(megastep):
    got, want, _ = serve_both("cuda", pages=2, megastep=megastep, n_req=7,
                              slots=2, poisson_gap=9.0)
    assert_same_requests(got, want)
    assert [r.arrival_tick for r in got] == [r.arrival_tick for r in want]
    assert len({r.arrival_tick for r in got}) > 1


def test_aggregate_report_matches_jax():
    _, _, eng = serve_both("cuda", pages=2, megastep=10)
    jprog, _ = programs()
    jeng = JaxEngine(jprog, batch_slots=4, backend="int_ref", pages=2,
                     megastep=10)
    drain(jeng, jax_make_requests(jprog, 6, 3, 10, 0.85, 0))
    a, b = eng.aggregate_report(), jeng.aggregate_report()
    assert (a.events, a.frames, a.layer_frames) == (b.events, b.frames,
                                                   b.layer_frames)


def test_engine_contracts():
    _, prog = programs()
    with pytest.raises(ValueError, match="frame shape"):
        SNNServeEngine(prog, device="cpu").submit(
            SNNRequest(rid=0, frames=np.zeros((5, 99), np.float32)))
    eng = SNNServeEngine(prog, device="cpu", track_events=False)
    with pytest.raises(ReportUnavailable):
        eng.aggregate_report()
    eng = SNNServeEngine(prog, batch_slots=1, device="cpu")
    for r in make_requests(prog, 2, 3, 10, 0.85, 0):
        eng.submit(r)
    with pytest.raises(EngineUndrained) as exc:
        eng.run_until_drained(max_ticks=2)
    assert exc.value.pending == 2 and exc.value.finished == []
    with pytest.raises(ValueError, match="lives on"):
        SNNServeEngine(prog, device="meta")


# -- double-buffered upload and the compiled (static-buffer) dispatch -------
# The JAX engine with double_buffer=True is the oracle: the JAX `int_ref`
# engine for `int_ref`, `cuda` and `cuda_sparse` (plain versions on the
# CPU), the JAX `ref_events` engine for `cuda_events` (with its device
# ledger). Seven requests of 30 frames on 2 slots per page, so admissions
# land mid-drain: ragged budgets and one early exit (request 3 stops at
# tick 12, inside a block at K = 4 and K = 10), or Poisson arrivals.
BUDGETS = [30, 17, 30, None, 9, 30, 23]
_JAX_DRAINS = {}


def scenario_requests(make, program, scenario):
    if scenario == "poisson":
        return make(program, 7, 3, 10, 0.85, 0, None, 9.0)
    reqs = make(program, 7, 3, 10, 0.85, 0)
    for r, budget in zip(reqs, BUDGETS):
        r.max_ticks = budget
    reqs[3].stop_threshold = 8.0
    return reqs


def jax_double_buffer_drain(backend, pages, megastep, scenario):
    key = (backend, pages, megastep, scenario)
    if key not in _JAX_DRAINS:
        jprog, _ = programs()
        eng = JaxEngine(jprog, batch_slots=2, backend=backend, pages=pages,
                        megastep=megastep, double_buffer=True, validate=False)
        _JAX_DRAINS[key] = (drain(eng, scenario_requests(
            jax_make_requests, jprog, scenario)), eng)
    return _JAX_DRAINS[key]


@pytest.mark.parametrize("scenario", ["early_exit", "poisson"])
@pytest.mark.parametrize("pages,megastep", [(1, 1), (2, 4), (3, 10)])
@pytest.mark.parametrize("backend",
                         ["int_ref", "cuda", "cuda_sparse", "cuda_events"])
def test_double_buffer_matches_jax(backend, pages, megastep, scenario):
    """The compiled static-buffer dispatch with double-buffered upload
    equals the JAX engine with double_buffer=True request for request:
    logits, V, ticks, finish clock, per-request row events, and on
    cuda_events the device ledger."""
    jax_backend = "ref_events" if backend == "cuda_events" else "int_ref"
    want, jeng = jax_double_buffer_drain(jax_backend, pages, megastep,
                                         scenario)
    _, prog = programs()
    eng = SNNServeEngine(prog, batch_slots=2, backend=backend, pages=pages,
                         megastep=megastep, double_buffer=True, device="cpu")
    assert eng._dispatch is not None
    got = drain(eng, scenario_requests(make_requests, prog, scenario))
    assert_same_requests(got, want)
    assert [r.arrival_tick for r in got] == [r.arrival_tick for r in want]
    assert eng.clock == jeng.clock
    if scenario == "early_exit":
        assert got[3].ticks == 12 and [r.ticks for r in got][:3] == [30, 17,
                                                                     30]
    assert eng._staged_used > 0
    if backend == "cuda_events":
        a, b = eng.device_event_stats(), jeng.device_event_stats()
        assert a.frames == b.frames
        for x, y in zip(a.row_events, b.row_events):
            np.testing.assert_array_equal(x, y)
        assert set(a.dense_fallbacks) == {0}
        assert (eng.device_skipped_row_fraction()
                == jeng.device_skipped_row_fraction())


def launcher_lines(main, argv, capsys):
    main(argv)
    lines = capsys.readouterr().out.splitlines()
    return ([ln for ln in lines if ln.startswith("latency")],
            [ln for ln in lines if ln.startswith("offered sparsity")])


def test_launcher_lines_match_jax(monkeypatch, capsys):
    """`launch/serve_snn.py --quick --poisson-gap 4 --stop-threshold 2
    --double-buffer`: the latency (p50/p99) and sparsity/instr=/EDP lines
    equal the JAX launcher's, both serving the same program (the JAX one,
    carried across)."""
    from repro.launch import serve_snn as jax_launch
    from repro_torch.launch import serve_snn as port_launch
    jprog, prog = programs()
    monkeypatch.setattr(jax_launch.pipeline, "compile_network",
                        lambda *a, **k: jprog)
    monkeypatch.setattr(port_launch.pipeline, "compile_network",
                        lambda *a, **k: prog)
    argv = ["--quick", "--poisson-gap", "4", "--stop-threshold", "2",
            "--double-buffer"]
    want = launcher_lines(jax_launch.main, argv, capsys)
    got = launcher_lines(port_launch.main, argv + ["--device", "cpu"], capsys)
    assert got == want
    assert len(got[0]) == 1 and "instr=" in got[1][0]


def test_launcher_arch_flag_follows_the_jax_launcher(capsys):
    """``--arch impulse-imdb`` (JAX's default) prints what no ``--arch``
    prints, timing aside; an arch that is not registered raises JAX's
    `KeyError`, and ``impulse-mnist``, whose conv front end the launcher's
    FC init cannot build, is refused by `compile_network` (JAX's compile
    drops the convs unchecked): neither serves IMDB instead."""
    from repro.launch import serve_snn as jax_launch
    from repro_torch.launch import serve_snn as port_launch
    argv = ["--quick", "--device", "cpu", "--backend", "int_ref"]

    def lines(extra):
        port_launch.main(argv + extra)
        out = capsys.readouterr().out.splitlines()
        return [out[0].split(" in ")[0]] + out[1:]
    assert lines(["--arch", "impulse-imdb"]) == lines([])
    errors = []
    for main, extra in ((jax_launch.main, []), (port_launch.main, argv)):
        with pytest.raises(KeyError) as ei:
            main(["--arch", "impulse-nope"] + extra)
        errors.append(ei.value.args)
    assert errors[0] == errors[1] == ("impulse-nope",)
    with pytest.raises(ValueError, match="the config has 3 convs"):
        port_launch.main(argv + ["--arch", "impulse-mnist"])
    assert capsys.readouterr().out == ""
