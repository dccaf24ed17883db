"""The port's row-block gated path (`use_sparse`, the `cuda_sparse`
backend) against the JAX package, on seeded numpy inputs, at exact
equality (every value and counter is an integer).

The JAX oracles: `ops.fused_snn_net(use_pallas=True, interpret=True,
emit_rasters=False, use_sparse=True)` for per-tile skip counts (the Pallas
interpret path runs here only without rasters), `use_pallas=False` for V,
rasters and the whole-batch skip counts, and the `int_ref(use_sparse)` /
`pallas_sparse` backends of `run_network` on the full-width IMDB program.
On the CPU the port's wrapper runs its plain version; the `cuda`-marked
cases hold the gated kernel against it on the card. JAX is imported inside
the helpers, so those cases also run where JAX is not installed.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import pipeline  # noqa: E402
from repro_torch.kernels.fused_snn_net import kernel  # noqa: E402
from repro_torch.kernels.fused_snn_net.ops import (fused_snn_net,  # noqa: E402
                                                   fused_snn_net_ref)

IMDB_WIDTHS = (100, 128, 128, 1)
WIDE_WIDTHS = (130, 24, 3)         # a fan-in spanning two macro row tiles
GRANULARITIES = (1, 2, 4, 8)


def jax_ops():
    """The JAX wrapper module (imported here, not at the top)."""
    from repro.kernels.fused_snn_net import ops
    return ops


def jnp_list(xs):
    import jax.numpy as jnp
    return None if xs is None else [jnp.asarray(x) for x in xs]


def sparse_raster(T, B, n, seed, density=0.25):
    """Seeded {0, 1} raster with whole silent frames, silent 16-row chunks
    per lane, and iid spikes elsewhere, so gates at every granularity
    see both silent and occupied blocks."""
    rng = np.random.default_rng(seed)
    chunks = np.repeat(rng.random((T, B, -(-n // 16))) < 0.4, 16,
                       axis=2)[:, :, :n]
    frames_on = rng.random((T, 1, 1)) < 0.7
    return ((rng.random((T, B, n)) < density) & chunks
            & frames_on).astype(np.int8)


def make_case(widths, T, B, seed, v_init=True, readout=True):
    """Sparse raster, weights biased positive so deeper layers fire, one
    threshold and leak per spiking layer, optional carried V."""
    rng = np.random.default_rng(seed + 1000)
    spikes = sparse_raster(T, B, widths[0], seed)
    ws = [rng.integers(-12, 32, (a, b)).astype(np.int8)
          for a, b in zip(widths[:-1], widths[1:])]
    n_spiking = len(ws) - 1 if readout else len(ws)
    ths = tuple(int(t) for t in rng.integers(20, 300, n_spiking))
    lks = tuple(int(t) for t in rng.integers(0, 20, n_spiking))
    vi = ([rng.integers(-1024, 1024, (B, n)).astype(np.int32)
           for n in widths[1:]] if v_init else None)
    return spikes, ws, ths, lks, vi


def torch_args(case, device="cpu"):
    spikes, ws, ths, lks, vi = case
    return (torch.from_numpy(spikes).to(device),
            [torch.from_numpy(w).to(device) for w in ws], ths, lks,
            None if vi is None else [torch.from_numpy(v).to(device)
                                     for v in vi])


def jax_run(case, *, neuron, clamp, use_pallas, emit_rasters=True, **kw):
    import jax.numpy as jnp
    spikes, ws, ths, lks, vi = case
    return jax_ops().fused_snn_net(
        jnp.asarray(spikes), jnp_list(ws), thresholds=ths, leaks=lks,
        neuron=neuron, clamp_mode=clamp, use_pallas=use_pallas,
        interpret=use_pallas, emit_rasters=emit_rasters,
        v_init=jnp_list(vi), **kw)


def host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def as_list(skips):
    """Skip counts as a list of host arrays (one per layer at G > 1, the
    single (tiles, n_layers) array at G = 1)."""
    if isinstance(skips, (list, tuple)):
        return [host(s) for s in skips]
    return [host(skips)]


def assert_same_outputs(got, want):
    g_r, g_v, _ = got
    w_r, w_v, _ = want
    assert len(g_r) == len(w_r) and len(g_v) == len(w_v)
    for g, w in zip(g_r + g_v, list(w_r) + list(w_v)):
        np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(w))


@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("widths", [IMDB_WIDTHS, WIDE_WIDTHS],
                         ids=["imdb", "wide"])
def test_skip_layout_matches_jax(widths, granularity):
    from repro.kernels.fused_snn_net.kernel import skip_layout as jax_layout
    n_cols, offsets, total = kernel.skip_layout(widths[:-1], granularity)
    want_cols, want_off, _ = jax_layout(widths[:-1], granularity)
    assert (n_cols, offsets) == (want_cols, want_off)
    assert total == sum(want_cols)


@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("widths,B,block_b", [
    (IMDB_WIDTHS, 5, 2), (WIDE_WIDTHS, 7, 4)], ids=["imdb-B5", "wide-B7"])
def test_tile_skip_counts_match_pallas(widths, B, block_b, granularity):
    """Per-tile skip counts on a ragged batch equal the Pallas kernel's
    (interpret mode); V and rasters equal the jnp reference."""
    case = make_case(widths, T=6, B=B, seed=granularity)
    kw = dict(neuron="rmp", clamp="saturate")
    s, w, ths, lks, vi = torch_args(case)
    got = fused_snn_net(s, w, thresholds=ths, leaks=lks, block_b=block_b,
                        use_sparse=True, gate_granularity=granularity,
                        v_init=vi, neuron="rmp", clamp_mode="saturate")
    want = jax_run(case, use_pallas=True, emit_rasters=False, block_b=block_b,
                   use_sparse=True, gate_granularity=granularity, **kw)
    got_skips, want_skips = as_list(got[2]), as_list(want[2])
    assert len(got_skips) == len(want_skips)
    for g, x in zip(got_skips, want_skips):
        assert g.shape == (-(-B // block_b), x.shape[1])
        np.testing.assert_array_equal(g, x)
    assert sum(int(g.sum()) for g in got_skips) > 0
    assert_same_outputs(got, jax_run(case, use_pallas=False, **kw))


@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("neuron,clamp", [("lif", "wrap"), ("if", "saturate")])
def test_one_tile_counts_match_jax_reference(neuron, clamp, granularity):
    """With block_b >= B the plain version's tile is the whole batch, the
    layout of the JAX jnp reference's gate counts."""
    case = make_case(IMDB_WIDTHS, T=7, B=3, seed=10 + granularity)
    s, w, ths, lks, vi = torch_args(case)
    got = fused_snn_net_ref(s, w, ths, lks, neuron=neuron, clamp_mode=clamp,
                            v_init=vi, use_sparse=True, block_b=3,
                            gate_granularity=granularity)
    want = jax_run(case, neuron=neuron, clamp=clamp, use_pallas=False,
                   use_sparse=True, gate_granularity=granularity)
    for g, x in zip(as_list(got[2]), as_list(want[2])):
        np.testing.assert_array_equal(g, x)
    assert_same_outputs(got, want)


def test_all_silent_and_all_ones_rasters():
    """Silent input: every first-layer gate skips on every tile; all-ones
    input: none does. V and rasters equal the dense plain version."""
    _, ws, ths, lks, _ = make_case(IMDB_WIDTHS, T=4, B=6, seed=3)
    w = [torch.from_numpy(x) for x in ws]
    kw = dict(thresholds=ths, leaks=lks, neuron="rmp", clamp_mode="wrap",
              block_b=4)
    for fill, skipped in ((0, 4), (1, 0)):      # 4 timesteps, 2 tiles
        s = torch.full((4, 6, 100), fill, dtype=torch.int8)
        r, v, skips = fused_snn_net(s, w, use_sparse=True,
                                    gate_granularity=8, **kw)
        assert skips[0].tolist() == [[skipped] * 7] * 2
        r0, v0, none = fused_snn_net(s, w, **kw)
        assert none is None
        for a, b in zip(r + v, r0 + v0):
            assert torch.equal(a, b)


def programs(neuron="rmp", clamp="saturate"):
    """(JAX IMDB program, the port's copy on the CPU)."""
    from test_torch_pipeline import programs as both
    return both((neuron, clamp))


def exact_currents(prog, T, B, seed):
    """Currents that make the f32 encoder emit a sparse raster exactly (the
    threshold on event ticks), as `make_requests` builds them."""
    raster = sparse_raster(T, B, 100, seed, density=0.3)
    return raster.astype(np.float32) * float(prog.layers[0].threshold)


def assert_same_result(got, want, *, rasters_from=None):
    for g, w in zip(got.v_final, want.v_final):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.logits.numpy(), np.asarray(want.logits))
    ref = rasters_from if rasters_from is not None else want
    assert len(got.rasters) == len(ref.rasters)
    for g, w in zip(got.rasters, ref.rasters):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def assert_same_aux(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, (list, tuple)):
            assert len(g) == len(w), key
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=key)
        elif isinstance(w, float):
            assert g == w, key
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=key)


@pytest.mark.parametrize("neuron,clamp", [("rmp", "saturate"),
                                          ("lif", "wrap")])
def test_int_ref_use_sparse_matches_jax(neuron, clamp):
    import jax.numpy as jnp
    from repro.core import pipeline as jpipe
    jprog, prog = programs(neuron, clamp)
    xs = exact_currents(prog, 20, 5, seed=21)
    want = jpipe.run_network(jprog, jnp.asarray(xs), "int_ref",
                             use_sparse=True)
    got = pipeline.run_network(prog, torch.from_numpy(xs), "int_ref",
                               use_sparse=True)
    assert_same_result(got, want)
    assert_same_aux(got.aux, want.aux)
    assert got.aux["skip_counts"].shape == (1, 3)


@pytest.mark.parametrize("granularity", GRANULARITIES)
def test_cuda_sparse_backend_matches_pallas_sparse(granularity):
    """The port's cuda_sparse backend (its plain version on the CPU) equals
    the JAX pallas_sparse backend: V, logits and every aux counter; its
    rasters equal the JAX int_ref's."""
    import jax.numpy as jnp
    from repro.core import pipeline as jpipe
    jprog, prog = programs()
    xs = exact_currents(prog, 20, 5, seed=30 + granularity)
    want = jpipe.run_network(jprog, jnp.asarray(xs), "pallas_sparse",
                             block_b=2, interpret=True, emit_rasters=False,
                             gate_granularity=granularity)
    dense = jpipe.run_network(jprog, jnp.asarray(xs), "int_ref")
    got = pipeline.run_network(prog, torch.from_numpy(xs), "cuda_sparse",
                               block_b=2, gate_granularity=granularity)
    assert_same_result(got, want, rasters_from=dense)
    assert_same_aux(got.aux, want.aux)
    frac = ("skipped_tile_fraction" if granularity == 1
            else "skipped_block_fraction")
    assert 0.0 < got.aux[frac] < 1.0


def test_run_stack_from_raster_matches_jax():
    import jax.numpy as jnp
    from repro.core import pipeline as jpipe
    jprog, prog = programs()
    raster = sparse_raster(12, 4, 100, seed=40)
    want = jpipe.run_stack_from_raster(jprog, jnp.asarray(raster),
                                       use_sparse=True)
    got = pipeline.run_stack_from_raster(prog, torch.from_numpy(raster),
                                         use_sparse=True)
    for g, w in zip(got[0] + got[1], list(want[0]) + list(want[1])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("backend,kw", [
    ("cuda_sparse", {"gate_granularity": 8, "block_b": 2}),
    ("cuda_sparse", {"gate_granularity": 1, "block_b": 4}),
    ("int_ref", {"use_sparse": True})])
def test_megastep_equals_ten_ticks(backend, kw):
    """One K=10 megastep equals 10 stream_step ticks: state, readout
    trajectory, rasters, and the skip counts summed over the ticks."""
    _, prog = programs("lif", "wrap")
    B, K = 5, 10
    xs = torch.from_numpy(exact_currents(prog, K, B, seed=50))
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
    summed = [sum(as_list(o.skips)[j] for o in ticks)
              for j in range(len(as_list(out.skips)))]
    for a, b in zip(as_list(out.skips), summed):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bad", ["granularity_without_sparse",
                                 "sparse_with_events", "crossover",
                                 "granularity_value", "skip_columns"])
def test_gating_error_paths(bad):
    spikes, ws, ths, lks, _ = make_case(IMDB_WIDTHS, T=2, B=2, seed=60,
                                        v_init=False)
    s, w = torch.from_numpy(spikes), [torch.from_numpy(x) for x in ws]
    kw = dict(thresholds=ths, leaks=lks)
    if bad == "granularity_without_sparse":
        kw["gate_granularity"] = 4
        match = "use_sparse"
    elif bad == "sparse_with_events":
        kw.update(use_sparse=True, use_events=True)
        match = "mutually exclusive"
    elif bad == "crossover":
        kw.update(use_events=True, event_crossover=1.5)
        match = r"\[0, 1\]"
    elif bad == "granularity_value":
        kw.update(use_sparse=True, gate_granularity=3)
        match = "granularity"
    else:
        with pytest.raises(ValueError, match="MAX_SKIP_COLS"):
            kernel.skip_layout((128,) * 129, 8)
        return
    with pytest.raises(ValueError, match=match):
        fused_snn_net(s, w, **kw)


@pytest.mark.parametrize("mode,extra,fits", [
    ("gated", 7 + 8 + 8, True), ("events", 0, True),
    ("events", 0, False)])
def test_shared_memory_layout_of_the_new_modes(mode, extra, fits):
    """The counters and event lists sit after the dense layout; the size
    check against a Hopper block's 227 KB covers them."""
    block_b = 8 if fits else 256
    dense = kernel.smem_layout(IMDB_WIDTHS, block_b)
    lay = kernel.smem_layout(IMDB_WIDTHS, block_b, mode, extra)
    assert lay["cnt_off"] == dense["bytes"]
    if mode == "events":
        assert lay["n_counters"] == sum(IMDB_WIDTHS[:-1]) + 3
        assert lay["row_off"] == [0, 100, 228] and lay["fb_off"] == 356
        assert lay["list_ld"] == 128
        assert lay["lcount_off"] >= lay["list_off"] + 2 * block_b * 128
    else:
        assert lay["n_counters"] == extra
    assert (lay["bytes"] <= kernel.SMEM_LIMIT) == fits


MASK_WIDTHS = [IMDB_WIDTHS, WIDE_WIDTHS, (686, 120, 84, 10), (126, 14)]


@pytest.mark.parametrize("widths", MASK_WIDTHS, ids=str)
def test_gate_mask_region_of_the_gated_layout(widths):
    """The gated kernel's per-warp occupancy masks: one 32-bit word per
    128 fan-in rows of the widest layer for each of the block's warps,
    after the skip counters; the dense and event-list layouts carry none
    and keep their size."""
    n_cols = kernel.skip_layout(widths[:-1], 8)[2]
    lay = kernel.smem_layout(widths, 8, "gated", n_cols)
    assert lay["gate_ld"] == -(-max(widths[:-1]) // 128)
    assert lay["gate_off"] >= lay["cnt_off"] + 4 * n_cols
    assert lay["gate_off"] % 16 == 0
    assert lay["list_off"] >= (lay["gate_off"]
                               + 4 * (kernel.THREADS // 32) * lay["gate_ld"])
    assert lay["bytes"] <= kernel.SMEM_LIMIT
    for mode in ("dense", "events"):
        other = kernel.smem_layout(widths, 8, mode)
        assert other["gate_ld"] == 0
        assert other["gate_off"] == other["list_off"]


@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("widths", MASK_WIDTHS, ids=str)
def test_gate_blocks_are_word_runs_inside_one_segment(widths, granularity):
    """What the gated kernel's masks rely on: a gate block of 128/G rows
    is a run of whole 32-bit words of the spike rows and the transposed
    weights that never crosses a 128-row (32-word) segment, and counting
    blocks in words, ceil(ceil(n / 4) / (32 / G)), gives JAX's skip-count
    columns (`skip_layout`)."""
    from repro.kernels.fused_snn_net.kernel import skip_layout as jax_layout
    n_cols = jax_layout(widths[:-1], granularity)[0]
    assert kernel.skip_layout(widths[:-1], granularity)[0] == tuple(n_cols)
    for n_in, cols in zip(widths[:-1], n_cols):
        words = -(-n_in // 4)
        if granularity == 1:
            assert cols == 1
            continue
        bwq = kernel.LANE // granularity // 4
        assert 32 % bwq == 0
        assert -(-words // bwq) == cols
        for g in range(cols):
            lo, hi = g * bwq, min((g + 1) * bwq, words)
            assert lo // 32 == (hi - 1) // 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("widths,B,block_b", [
    (IMDB_WIDTHS, 37, 8), (WIDE_WIDTHS, 300, 64)], ids=["imdb", "wide"])
def test_gated_kernel_matches_plain_version_on_the_card(
        cuda_device, widths, B, block_b, granularity):
    s, w, ths, lks, vi = torch_args(make_case(widths, T=10, B=B, seed=70),
                                    cuda_device)
    kw = dict(neuron="lif", clamp_mode="wrap", v_init=vi, use_sparse=True,
              gate_granularity=granularity, block_b=block_b)
    got = fused_snn_net(s, w, thresholds=ths, leaks=lks, **kw)
    want = fused_snn_net_ref(s, w, ths, lks, **kw)
    torch.cuda.synchronize()
    for g, x in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, x)
    for g, x in zip(as_list(got[2]), as_list(want[2])):
        np.testing.assert_array_equal(g, x)


@pytest.mark.cuda
@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("clamp", ["saturate", "wrap"])
@pytest.mark.parametrize("widths", [IMDB_WIDTHS, (686, 120, 84, 10)],
                         ids=["imdb", "mnist-fc"])
def test_gated_kernel_on_structured_rasters_on_the_card(
        cuda_device, widths, clamp, granularity):
    """Rasters with silent 16-row chunks and silent frames, so whole gate
    blocks are silent at every G, on a ragged tile (B = 13, block_b = 8):
    V, rasters and skip counters equal the plain version's, and the first
    layer's gates both skip and run."""
    s, w, ths, lks, vi = torch_args(make_case(widths, T=10, B=13, seed=90),
                                    cuda_device)
    kw = dict(neuron="rmp", clamp_mode=clamp, v_init=vi, use_sparse=True,
              gate_granularity=granularity, block_b=8)
    got = fused_snn_net(s, w, thresholds=ths, leaks=lks, **kw)
    want = fused_snn_net_ref(s, w, ths, lks, **kw)
    torch.cuda.synchronize()
    for g, x in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, x)
    skips = as_list(got[2])
    for g, x in zip(skips, as_list(want[2])):
        np.testing.assert_array_equal(g, x)
    first = skips[0] if granularity > 1 else skips[0][:, :1]
    assert 0 < first.sum() < 10 * first.size


@pytest.mark.cuda
@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("fill", [0, 1])
def test_gated_kernel_on_silent_and_full_rasters_on_the_card(
        cuda_device, fill, granularity):
    """All-silent input skips every first-layer gate on every tile, all-ones
    input none; both equal the plain version bit for bit."""
    _, ws, ths, lks, vi = make_case(IMDB_WIDTHS, T=6, B=13, seed=4)
    s = torch.full((6, 13, 100), fill, dtype=torch.int8, device=cuda_device)
    w = [torch.from_numpy(x).to(cuda_device) for x in ws]
    v = [torch.from_numpy(x).to(cuda_device) for x in vi]
    kw = dict(neuron="lif", clamp_mode="wrap", v_init=v, use_sparse=True,
              gate_granularity=granularity, block_b=8)
    got = fused_snn_net(s, w, thresholds=ths, leaks=lks, **kw)
    want = fused_snn_net_ref(s, w, ths, lks, **kw)
    torch.cuda.synchronize()
    for g, x in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, x)
    skips = as_list(got[2])
    for g, x in zip(skips, as_list(want[2])):
        np.testing.assert_array_equal(g, x)
    first = skips[0] if granularity > 1 else skips[0][:, :1]
    assert (first == (6 if fill == 0 else 0)).all()
