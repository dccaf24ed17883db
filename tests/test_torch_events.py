"""The port's event-driven paths (the host executor `ref_events`, the
event-list kernel's plain version, the `cuda_events` backend and the
serving engine's device ledger) against the JAX package, on seeded numpy
inputs, at exact equality.

The JAX oracles: `events.fused_snn_net_events` (host executor),
`ops.fused_snn_net(use_pallas=True, interpret=True, emit_rasters=False,
use_events=True)` for per-tile row counts and fallbacks, the `ref_events` /
`pallas_events` backends of `run_network` on the full-width IMDB program,
and the JAX `ref_events` serving engine (`validate=False`). The JAX
`pallas_events` engine cannot run here: its megastep needs rasters, which
the Pallas interpret path cannot emit on the installed jax. The
`cuda`-marked cases hold the event-list kernel against its plain version
on the card.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import pipeline  # noqa: E402
from repro_torch.kernels.fused_snn_net import kernel  # noqa: E402
from repro_torch.kernels.fused_snn_net.events import (  # noqa: E402
    fused_snn_net_events)
from repro_torch.kernels.fused_snn_net.ops import (  # noqa: E402
    fused_snn_net, fused_snn_net_device_events, fused_snn_net_ref)
from repro_torch.launch.serve_snn import make_requests  # noqa: E402
from repro_torch.serve import SNNServeEngine  # noqa: E402
from test_torch_gating import (IMDB_WIDTHS, WIDE_WIDTHS,  # noqa: E402
                               assert_same_aux, assert_same_outputs,
                               assert_same_result, exact_currents, host,
                               jax_run, make_case, programs, torch_args)

CROSSOVERS = (0.0, 0.5, 1.0)


@pytest.mark.parametrize("neuron,clamp", [("rmp", "saturate"),
                                          ("lif", "wrap"), ("if", "wrap")])
@pytest.mark.parametrize("v_init", [False, True])
def test_host_executor_matches_jax(neuron, clamp, v_init):
    from repro.kernels.fused_snn_net.events import (
        fused_snn_net_events as jax_events)
    spikes, ws, ths, lks, vi = make_case(IMDB_WIDTHS, T=8, B=5, seed=1,
                                         v_init=v_init)
    kw = dict(thresholds=ths, leaks=lks, neuron=neuron, clamp_mode=clamp,
              v_init=vi)
    got = fused_snn_net_events(spikes, ws, **kw)
    want = jax_events(spikes, ws, **kw)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g, w)
    assert got[2].frames == want[2].frames and got[2].dense_fallbacks == ()
    for g, w in zip(got[2].row_events, want[2].row_events):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    assert got[2].skipped_row_fraction == want[2].skipped_row_fraction


@pytest.mark.parametrize("crossover", CROSSOVERS)
@pytest.mark.parametrize("widths,B,block_b", [
    (IMDB_WIDTHS, 5, 2), (WIDE_WIDTHS, 7, 4)], ids=["imdb-B5", "wide-B7"])
def test_tile_counters_match_pallas(widths, B, block_b, crossover):
    """Per-tile row counts and fallbacks on a ragged batch equal the
    Pallas event kernel's (interpret mode); V and rasters equal the jnp
    reference."""
    case = make_case(widths, T=6, B=B, seed=20)
    s, w, ths, lks, vi = torch_args(case)
    got = fused_snn_net(s, w, thresholds=ths, leaks=lks, block_b=block_b,
                        use_events=True, event_crossover=crossover, v_init=vi,
                        neuron="lif", clamp_mode="saturate")
    want = jax_run(case, neuron="lif", clamp="saturate", use_pallas=True,
                   emit_rasters=False, block_b=block_b, use_events=True,
                   event_crossover=crossover)
    for g, x in zip(got[2]["row_events"], want[2]["row_events"]):
        assert g.shape == (-(-B // block_b), x.shape[1])
        np.testing.assert_array_equal(host(g), np.asarray(x))
    np.testing.assert_array_equal(host(got[2]["dense_fallbacks"]),
                                  np.asarray(want[2]["dense_fallbacks"]))
    fallbacks = int(got[2]["dense_fallbacks"].sum())
    assert (fallbacks == 0) == (crossover == 1.0)
    assert_same_outputs(got, jax_run(case, neuron="lif", clamp="saturate",
                                     use_pallas=False))


@pytest.mark.parametrize("crossover", [0.0, 0.15])
def test_device_events_fold_matches_jax(crossover):
    """`fused_snn_net_device_events` folds the tile counters into the JAX
    wrapper's `EventStats`; its row events equal the host executor's."""
    import jax.numpy as jnp
    from repro.kernels.fused_snn_net import ops as jax_ops
    spikes, ws, ths, lks, _ = make_case(IMDB_WIDTHS, T=10, B=6, seed=30,
                                        v_init=False)
    kw = dict(thresholds=ths, leaks=lks, neuron="rmp", clamp_mode="wrap",
              block_b=4, event_crossover=crossover)
    got = fused_snn_net_device_events(
        torch.from_numpy(spikes), [torch.from_numpy(w) for w in ws], **kw)
    want = jax_ops.fused_snn_net_device_events(
        jnp.asarray(spikes), [jnp.asarray(w) for w in ws], interpret=True,
        emit_rasters=False, **kw)
    _, _, host_stats = fused_snn_net_events(
        spikes, ws, thresholds=ths, leaks=lks, neuron="rmp",
        clamp_mode="wrap")
    assert got[2].frames == want[2].frames == host_stats.frames
    assert got[2].dense_fallbacks == want[2].dense_fallbacks
    for g, w, h in zip(got[2].row_events, want[2].row_events,
                       host_stats.row_events):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, h)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_all_silent_and_all_ones_rasters():
    """Silent input: no event, no fallback, silent rasters; all-ones input
    at crossover 0.5: the full first-layer tile falls back every step, the
    ragged one (2 of 4 lanes: 200 events, not above 0.5 x 4 x 100) never,
    as its capacity stays block_b lanes. V and rasters equal the dense
    plain version."""
    _, ws, ths, lks, _ = make_case(IMDB_WIDTHS, T=4, B=6, seed=3)
    w = [torch.from_numpy(x) for x in ws]
    kw = dict(thresholds=ths, leaks=lks, neuron="rmp", clamp_mode="wrap",
              block_b=4)
    for fill in (0, 1):
        s = torch.full((4, 6, 100), fill, dtype=torch.int8)
        r, v, ev = fused_snn_net(s, w, use_events=True, event_crossover=0.5,
                                 **kw)
        assert ev["row_events"][0].tolist() == [[4 * 4 * fill] * 100,
                                                [4 * 2 * fill] * 100]
        assert ev["dense_fallbacks"][:, 0].tolist() == [4 * fill, 0]
        r0, v0, _ = fused_snn_net(s, w, **kw)
        for a, b in zip(r + v, r0 + v0):
            assert torch.equal(a, b)


def test_ref_events_backend_matches_jax():
    import jax.numpy as jnp
    from repro.core import pipeline as jpipe
    jprog, prog = programs("lif", "wrap")
    xs = exact_currents(prog, 20, 5, seed=40)
    want = jpipe.run_network(jprog, jnp.asarray(xs), "ref_events")
    got = pipeline.run_network(prog, torch.from_numpy(xs), "ref_events")
    assert_same_result(got, want)
    assert_same_aux(got.aux, want.aux)
    assert 0.0 < got.aux["skipped_row_fraction"] < 1.0


@pytest.mark.parametrize("crossover", [0.0, 0.1, 1.0])
def test_cuda_events_backend_matches_pallas_events(crossover):
    """The port's cuda_events backend (its plain version on the CPU) equals
    the JAX pallas_events backend: V, logits and every aux counter, the
    fallbacks included; its rasters equal the JAX ref_events'."""
    import jax.numpy as jnp
    from repro.core import pipeline as jpipe
    jprog, prog = programs()
    xs = exact_currents(prog, 20, 5, seed=50)
    want = jpipe.run_network(jprog, jnp.asarray(xs), "pallas_events",
                             block_b=2, interpret=True, emit_rasters=False,
                             event_crossover=crossover)
    host_run = jpipe.run_network(jprog, jnp.asarray(xs), "ref_events")
    got = pipeline.run_network(prog, torch.from_numpy(xs), "cuda_events",
                               block_b=2, event_crossover=crossover)
    assert_same_result(got, want, rasters_from=host_run)
    assert_same_aux(got.aux, want.aux)
    for g, h in zip(got.aux["row_events"], host_run.aux["row_events"]):
        np.testing.assert_array_equal(g, h)


@pytest.mark.parametrize("backend,kw", [
    ("ref_events", {}), ("cuda_events", {"event_crossover": 0.1})])
def test_megastep_equals_ten_ticks(backend, kw):
    """One K=10 megastep equals 10 stream_step ticks: state, readout
    trajectory, rasters, and the event counters summed over the ticks."""
    _, prog = programs("rmp", "saturate")
    B, K = 5, 10
    xs = torch.from_numpy(exact_currents(prog, K, B, seed=60))
    st_m, out = pipeline.stream_megastep(
        prog, pipeline.init_stream_state(prog, B, backend), xs, backend, **kw)
    st = pipeline.init_stream_state(prog, B, backend)
    ticks = []
    for t in range(K):
        st, o = pipeline.stream_step(prog, st, xs[t], backend, **kw)
        ticks.append(o)
    for a, b in zip(st_m.vs, st.vs):
        assert torch.equal(a, b)
    assert torch.equal(out.v_out_traj, torch.stack([o.v_out for o in ticks]))
    for i, r in enumerate(out.rasters):
        assert torch.equal(r, torch.stack([o.rasters[i] for o in ticks]))
    assert out.skips.frames == sum(o.skips.frames for o in ticks) == K * B
    for i, r in enumerate(out.skips.row_events):
        np.testing.assert_array_equal(
            r, sum(o.skips.row_events[i] for o in ticks))


def drain(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return sorted(engine.run_until_drained(), key=lambda r: r.rid)


@pytest.mark.parametrize("n_req,pages", [(8, 1), (6, 2)],
                         ids=["full", "partial"])
def test_ref_events_engine_matches_jax(n_req, pages):
    """Per request and in the device ledger, at full occupancy (8 requests
    on 2 x 4 lanes) and partial (6 requests on 2 pages of 4 lanes). The
    port's cuda_events engine (plain version on the CPU) keeps the same
    ledger, with its fallback counts beside it."""
    from repro.launch.serve_snn import make_requests as jax_make_requests
    from repro.serve import SNNServeEngine as JaxEngine
    jprog, prog = programs()
    args = (n_req, 3, 10, 0.85, 0)
    jeng = JaxEngine(jprog, batch_slots=4, backend="ref_events", pages=pages,
                     megastep=10, validate=False)
    want = drain(jeng, jax_make_requests(jprog, *args))
    engines = {b: SNNServeEngine(prog, batch_slots=4, backend=b, pages=pages,
                                 megastep=10, device="cpu")
               for b in ("ref_events", "cuda_events")}
    for backend, eng in engines.items():
        got = drain(eng, make_requests(prog, *args))
        assert [r.rid for r in got] == [r.rid for r in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.v_out, w.v_out)
            np.testing.assert_array_equal(g.logits, w.logits)
            assert (g.ticks, g.finish_clock) == (w.ticks, w.finish_clock)
            for a, b in zip(g.report.row_events, w.report.row_events):
                np.testing.assert_array_equal(a, b)
        a, b = eng.device_event_stats(), jeng.device_event_stats()
        assert a.frames == b.frames and eng.device_ticks == jeng.device_ticks
        for x, y in zip(a.row_events, b.row_events):
            np.testing.assert_array_equal(x, y)
        assert eng.device_skipped_row_fraction() == \
            jeng.device_skipped_row_fraction()
        assert a.dense_fallbacks == (() if backend == "ref_events"
                                     else (0, 0, 0))
    # no request finishes mid-block (30 frames, K=10): the ledger equals
    # the summed per-request raster tallies
    rep = engines["cuda_events"].aggregate_report()
    for x, y in zip(engines["cuda_events"].device_event_stats().row_events,
                    rep.row_events):
        np.testing.assert_array_equal(x, y)


def test_device_ledger_before_any_dispatch_raises():
    _, prog = programs()
    eng = SNNServeEngine(prog, backend="ref_events", device="cpu")
    with pytest.raises(ValueError, match="no device ledger"):
        eng.device_event_stats()
    with pytest.raises(ValueError, match="no device ledger"):
        eng.device_skipped_row_fraction()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("crossover", [0.0, 0.15, 0.5, 1.0])
@pytest.mark.parametrize("widths,B,block_b", [
    (IMDB_WIDTHS, 37, 8), (WIDE_WIDTHS, 300, 64)], ids=["imdb", "wide"])
def test_event_kernel_matches_plain_version_on_the_card(
        cuda_device, widths, B, block_b, crossover):
    s, w, ths, lks, vi = torch_args(make_case(widths, T=10, B=B, seed=70),
                                    cuda_device)
    kw = dict(neuron="rmp", clamp_mode="saturate", v_init=vi,
              use_events=True, event_crossover=crossover, block_b=block_b)
    got = fused_snn_net(s, w, thresholds=ths, leaks=lks, **kw)
    want = fused_snn_net_ref(s, w, ths, lks, **kw)
    torch.cuda.synchronize()
    for g, x in zip(got[0] + got[1] + got[2]["row_events"],
                    want[0] + want[1] + want[2]["row_events"]):
        assert torch.equal(g, x)
    assert torch.equal(got[2]["dense_fallbacks"], want[2]["dense_fallbacks"])


LAYOUT_STACKS = [IMDB_WIDTHS, WIDE_WIDTHS, (686, 120, 84, 10), (126, 14)]


def previous_event_bytes(widths, block_b):
    """Shared memory of the previous, step-by-step event-list kernel: the
    dense layout, the row and fallback counters, one list of the widest
    fan-in per lane and the lanes' list lengths."""
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    dense = kernel.smem_layout(widths, block_b)["bytes"]
    return (dense + a16(4 * (sum(widths[:-1]) + len(widths) - 1))
            + a16(2 * block_b * max(widths[:-1])) + a16(4 * block_b))


@pytest.mark.parametrize("block_b", [8, 64])
@pytest.mark.parametrize("widths", LAYOUT_STACKS, ids=str)
def test_event_chunk_regions(widths, block_b):
    """The event-list chunk regions at one timestep and at the chunk the
    budget allows for a K = 10 megastep: the dense layout first, then the
    counters, the (t, lane) lists (16-byte rows of 8-entry loads), their
    lengths, the two chunk buffers (the spike buffers themselves at one
    timestep) and the per-step totals, 16-byte aligned and not
    overlapping; one timestep fits wherever the previous layout did."""
    dense = kernel.smem_layout(widths, block_b)
    fits_before = previous_event_bytes(widths, block_b) <= kernel.SMEM_LIMIT
    chosen = kernel.event_layout(widths, block_b, 10)
    for tc in sorted({1, chosen["tc"]}):
        lay = kernel.smem_layout(widths, block_b, "events", tc=tc)
        assert lay["tc"] == tc
        assert lay["cnt_off"] == dense["bytes"]
        assert max(widths[:-1]) <= lay["list_ld"] < max(widths[:-1]) + 8
        assert lay["list_ld"] % 8 == 0
        assert lay["list_off"] >= lay["cnt_off"] + 4 * lay["n_counters"]
        assert lay["lcount_off"] >= (lay["list_off"]
                                     + 2 * tc * block_b * lay["list_ld"])
        assert lay["chunk_ld"] >= block_b * lay["spk_ld"] * 4
        end = lay["lcount_off"] + 4 * tc * block_b
        if tc == 1:
            assert lay["chunk_off"] == lay["spk_off"]
        else:
            assert lay["chunk_off"][0] >= end
            assert lay["chunk_off"][1] >= (lay["chunk_off"][0]
                                           + tc * lay["chunk_ld"])
            end = lay["chunk_off"][1] + tc * lay["chunk_ld"]
        assert lay["ttot_off"] >= end
        assert lay["bytes"] >= lay["ttot_off"] + 4 * 2 * tc
        for key in ("list_off", "lcount_off", "chunk_ld", "ttot_off"):
            assert lay[key] % 16 == 0
        assert all(off % 16 == 0 for off in lay["chunk_off"])
        if fits_before:
            assert lay["bytes"] <= kernel.SMEM_LIMIT
    assert 1 <= chosen["tc"] <= 10
    if fits_before:
        assert chosen["bytes"] <= kernel.SMEM_LIMIT


def test_event_chunk_holds_the_megastep():
    """The serving shape (IMDB, block_b 8, K = 10) runs in one chunk, and
    the MNIST FC stack, whose weights take about 94 KB, in chunks of 5."""
    assert kernel.event_layout(IMDB_WIDTHS, 8, 10)["tc"] == 10
    assert kernel.event_layout((686, 120, 84, 10), 8, 10)["tc"] == 5
    assert kernel.event_layout(IMDB_WIDTHS, 8, 1)["tc"] == 1


def mixed_case(widths, T, B, seed, v_init=True):
    """A raster whose steps alternate between dense (0.6) and sparse
    (0.05) frames, so that at crossover 0.15 one chunk holds both steps
    that fall back and steps that gather."""
    rng = np.random.default_rng(seed)
    density = np.where(np.arange(T) % 3 == 1, 0.6, 0.05)[:, None, None]
    spikes = (rng.random((T, B, widths[0])) < density).astype(np.int8)
    ws = [rng.integers(-12, 32, (a, b)).astype(np.int8)
          for a, b in zip(widths[:-1], widths[1:])]
    ths = tuple(int(t) for t in rng.integers(20, 300, len(ws) - 1))
    lks = tuple(int(t) for t in rng.integers(0, 20, len(ws) - 1))
    vi = ([rng.integers(-1024, 1024, (B, n)).astype(np.int32)
           for n in widths[1:]] if v_init else None)
    return spikes, ws, ths, lks, vi


def assert_kernel_equals_plain(case, device, **kw):
    s, w, ths, lks, vi = torch_args(case, device)
    got = fused_snn_net(s, w, thresholds=ths, leaks=lks, v_init=vi,
                        use_events=True, **kw)
    want = fused_snn_net_ref(s, w, ths, lks, v_init=vi, use_events=True,
                             **kw)
    torch.cuda.synchronize()
    assert len(got[0]) == len(want[0])
    for g, x in zip(got[0] + got[1] + got[2]["row_events"],
                    want[0] + want[1] + want[2]["row_events"]):
        assert torch.equal(g, x)
    assert torch.equal(got[2]["dense_fallbacks"], want[2]["dense_fallbacks"])
    return want[2]["dense_fallbacks"]


@pytest.mark.cuda
@pytest.mark.parametrize("emit", [True, False])
@pytest.mark.parametrize("v_init", [False, True])
@pytest.mark.parametrize("crossover", [0.0, 0.15, 0.5, 1.0])
def test_event_kernel_mixes_fallback_and_gathered_steps_on_the_card(
        cuda_device, crossover, v_init, emit):
    """One chunk of 10 steps in which, at crossover 0.15, the dense frames
    fall back and the sparse ones gather: V, rasters, row counts and
    fallbacks equal the plain version's."""
    fb = assert_kernel_equals_plain(
        mixed_case(IMDB_WIDTHS, 10, 37, seed=80, v_init=v_init), cuda_device,
        neuron="rmp", clamp_mode="saturate", emit_rasters=emit,
        event_crossover=crossover)
    if crossover == 0.15:
        assert (0 < fb[:, 0]).all() and (fb[:, 0] < 10).all()


@pytest.mark.cuda
@pytest.mark.parametrize("neuron,clamp", [(n, c) for n in ("if", "lif", "rmp")
                                          for c in ("saturate", "wrap")])
@pytest.mark.parametrize("widths,T,B,block_b", [
    (IMDB_WIDTHS, 15, 1, 8), (IMDB_WIDTHS, 16, 3, 8),
    (IMDB_WIDTHS, 17, 37, 8), (IMDB_WIDTHS, 33, 300, 8),
    (IMDB_WIDTHS, 1, 37, 64), (IMDB_WIDTHS, 120, 3, 8),
    ((686, 120, 84, 10), 11, 14, 8), (WIDE_WIDTHS, 10, 300, 64)])
def test_event_kernel_chunk_edges_on_the_card(cuda_device, widths, T, B,
                                              block_b, neuron, clamp):
    """Chunk edges (16 steps a chunk at IMDB widths, 5 for the MNIST FC
    stack), ragged lanes, every neuron and clamp, at crossover 0.15 on the
    mixed raster."""
    assert_kernel_equals_plain(
        mixed_case(widths, T, B, seed=T + B), cuda_device, neuron=neuron,
        clamp_mode=clamp, emit_rasters=True, event_crossover=0.15,
        block_b=block_b)
