"""The port's per-layer fused SNN kernel path (repro_torch.kernels.
fused_snn_step) against the JAX package's `fused_snn_layer_ref` and
`fused_snn_layer(use_pallas=False)`, on seeded numpy inputs, at exact
equality (every value is an integer). The JAX Pallas path cannot run here
(`pl.store` is gone from this JAX), so the jnp reference is the oracle.

On the CPU the wrapper runs its plain version; the `cuda`-marked tests hold
the CUDA kernel against it and run only where a GPU is present
(``pytest -m cuda``). JAX is imported inside the JAX-side helpers, so the
card-side run needs no JAX.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.isa import int_matmul  # noqa: E402
from repro_torch.kernels.fused_snn_net.ops import fused_snn_net  # noqa: E402
from repro_torch.kernels.fused_snn_step import kernel  # noqa: E402
from repro_torch.kernels.fused_snn_step.ops import fused_snn_layer  # noqa: E402
from repro_torch.kernels.fused_snn_step.ref import (  # noqa: E402
    fused_snn_layer_ref)

NEURONS = ("if", "lif", "rmp")
CLAMPS = ("saturate", "wrap")


def make_case(T, B, n_in, n_out, seed, density=0.4):
    """Seeded raster and weights biased positive, so V reaches and passes
    the 11-bit limits (the wrap regime)."""
    rng = np.random.default_rng(seed)
    spikes = (rng.random((T, B, n_in)) < density).astype(np.int8)
    wq = rng.integers(-20, 32, (n_in, n_out)).astype(np.int8)
    return spikes, wq


def jax_layer(spikes, wq, via_ops, **kw):
    import jax.numpy as jnp

    from repro.kernels.fused_snn_step.ops import fused_snn_layer as jax_ops
    from repro.kernels.fused_snn_step.ref import fused_snn_layer_ref as jax_ref
    if via_ops:
        out, v = jax_ops(jnp.asarray(spikes), jnp.asarray(wq),
                         use_pallas=False, **kw)
    else:
        out, v = jax_ref(jnp.asarray(spikes), jnp.asarray(wq), **kw)
    return np.asarray(out), np.asarray(v)


def assert_same(got, want):
    (g_out, g_v), (w_out, w_v) = got, want
    assert g_out.dtype == torch.int8 and g_v.dtype == torch.int32
    np.testing.assert_array_equal(g_out.numpy(), w_out)
    np.testing.assert_array_equal(g_v.numpy(), w_v)


@pytest.mark.parametrize("reset", [0, -37])
@pytest.mark.parametrize("clamp", CLAMPS)
@pytest.mark.parametrize("neuron", NEURONS)
def test_ref_and_wrapper_match_jax(neuron, clamp, reset):
    """The neuron x clamp x reset grid at a ragged batch and a fan-in that
    is not a multiple of 128; the leak is negative for LIF."""
    spikes, wq = make_case(T=9, B=5, n_in=100, n_out=24, seed=1)
    kw = dict(neuron=neuron, threshold=300, leak=-7 if neuron == "lif" else 0,
              reset=reset, clamp_mode=clamp)
    want = jax_layer(spikes, wq, via_ops=False, **kw)
    s, w = torch.from_numpy(spikes), torch.from_numpy(wq)
    assert_same(fused_snn_layer_ref(s, w, **kw), want)
    assert_same(fused_snn_layer(s, w, **kw), want)
    assert_same(fused_snn_layer(s, w, **kw), jax_layer(spikes, wq, True, **kw))


@pytest.mark.parametrize("T,B,n_in,n_out", [(1, 3, 128, 128), (1, 1, 7, 1),
                                            (6, 13, 686, 120),
                                            (10, 8, 128, 128)])
def test_shapes_match_jax(T, B, n_in, n_out):
    """T = 1, a single lane, a multi-row-tile fan-in and the Fig. 9
    shape."""
    spikes, wq = make_case(T, B, n_in, n_out, seed=T * 1000 + n_in,
                           density=0.15)
    kw = dict(neuron="rmp", threshold=60, clamp_mode="wrap")
    assert_same(fused_snn_layer(torch.from_numpy(spikes),
                                torch.from_numpy(wq), **kw),
                jax_layer(spikes, wq, True, **kw))


def test_bool_spikes_match_int8():
    spikes, wq = make_case(T=5, B=2, n_in=64, n_out=24, seed=3, density=0.3)
    s, w = torch.from_numpy(spikes), torch.from_numpy(wq)
    kw = dict(threshold=40, neuron="rmp")
    for got, want in zip(fused_snn_layer(s.bool(), w, **kw),
                         fused_snn_layer(s, w, **kw)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("neuron", NEURONS)
@pytest.mark.parametrize("clamp", CLAMPS)
def test_per_layer_dispatch_equals_fused_network(neuron, clamp):
    """The IMDB stack (100-128-128-1, T = 120, B = 8, threshold 60, leak 2)
    layer by layer through `fused_snn_layer`, then the int32 readout,
    equals one `fused_snn_net` call: readout V and every raster."""
    rng = np.random.default_rng(0)
    spikes = torch.from_numpy((rng.random((120, 8, 100)) < 0.1)
                              .astype(np.int8))
    ws = [torch.from_numpy(rng.integers(-31, 32, shp).astype(np.int8))
          for shp in ((100, 128), (128, 128), (128, 1))]
    cur, rasters = spikes, []
    for w in ws[:-1]:
        cur, _ = fused_snn_layer(cur, w, threshold=60, leak=2, neuron=neuron,
                                 clamp_mode=clamp)
        rasters.append(cur)
    v_layer = int_matmul(cur.reshape(-1, 128), ws[-1]).reshape(
        120, 8, 1).sum(dim=0, dtype=torch.int32)
    r_fused, v_fused, _ = fused_snn_net(spikes, ws, thresholds=(60, 60),
                                        leaks=(2, 2), neuron=neuron,
                                        clamp_mode=clamp)
    assert torch.equal(v_layer, v_fused[-1])
    for a, b in zip(rasters, r_fused):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["misaligned", "rank", "neuron", "clamp",
                                 "threshold", "block_b"])
def test_wrapper_rejects_bad_arguments(bad):
    spikes, wq = make_case(T=2, B=2, n_in=16, n_out=8, seed=4)
    s, w = torch.from_numpy(spikes), torch.from_numpy(wq)
    kw = dict(threshold=10)
    if bad == "misaligned":
        w = w[:15]
    elif bad == "rank":
        s = s[0]
    elif bad == "neuron":
        kw["neuron"] = "izhikevich"
    elif bad == "clamp":
        kw["clamp_mode"] = "fold"
    elif bad == "threshold":
        kw["threshold"] = 2 ** 31
    else:
        kw["block_b"] = 0
    with pytest.raises(ValueError):
        fused_snn_layer(s, w, **kw)


def test_cuda_binding_refuses_cpu_tensors():
    """The kernel's binding never runs anything on the CPU."""
    spikes, wq = make_case(T=2, B=2, n_in=16, n_out=8, seed=5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.fused_snn_step_cuda(
            torch.from_numpy(spikes), torch.from_numpy(wq), threshold=10,
            leak=0, reset=0, neuron="rmp", clamp_mode="saturate")


@pytest.mark.parametrize("n_in,tile_n,block_b,fits", [
    (100, 128, 8, True), (686, 128, 64, True), (686, 16, 300, True),
    (4096, 128, 8, False)])
def test_shared_memory_layout(n_in, tile_n, block_b, fits):
    """Weights at their logical fan-in, odd word strides, and the one size
    check against a Hopper block's 227 KB."""
    lay = kernel.smem_layout(n_in, tile_n, block_b)
    assert lay["wt_ld"] % 2 == 1 and lay["wt_ld"] * 4 >= n_in
    assert lay["spk_off"] % 16 == 0 and lay["spk_off"] >= tile_n * n_in
    assert (lay["bytes"] <= kernel.SMEM_LIMIT) == fits


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("reset", [0, 5])
@pytest.mark.parametrize("clamp", CLAMPS)
@pytest.mark.parametrize("neuron", NEURONS)
def test_kernel_matches_plain_version_on_the_card(cuda_device, neuron, clamp,
                                                  reset):
    spikes, wq = make_case(T=10, B=37, n_in=130, n_out=140, seed=6)
    s = torch.from_numpy(spikes).to(cuda_device)
    w = torch.from_numpy(wq).to(cuda_device)
    kw = dict(threshold=300, leak=-3 if neuron == "lif" else 0, reset=reset,
              neuron=neuron, clamp_mode=clamp)
    got = fused_snn_layer(s, w, **kw)
    want = fused_snn_layer_ref(s, w, **kw)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@pytest.mark.cuda
@pytest.mark.parametrize("block_b,block_n", [(64, 128), (1, 7), (300, 16)])
def test_kernel_tiles_on_the_card(cuda_device, block_b, block_n):
    spikes, wq = make_case(T=4, B=301, n_in=686, n_out=120, seed=7,
                           density=0.2)
    s = torch.from_numpy(spikes).to(cuda_device)
    w = torch.from_numpy(wq).to(cuda_device)
    kw = dict(threshold=200, neuron="lif", leak=4, clamp_mode="wrap")
    got = fused_snn_layer(s, w, block_b=block_b, block_n=block_n, **kw)
    want = fused_snn_layer_ref(s, w, **kw)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert torch.equal(g, x)


# (T, B, N_in, N_out) of chip_smoke.py's phase 7, the IMDB layers and the
# kernel's chunk edges (16 steps a chunk)
PLAN_SHAPES = [(10, 8, 128, 128), (120, 8, 100, 128), (120, 8, 128, 128),
               (1, 1, 100, 1), (10, 37, 686, 14), (10, 300, 686, 128),
               (1, 300, 128, 14), (120, 37, 100, 1), (15, 3, 686, 14),
               (16, 1, 100, 1), (17, 37, 100, 14), (33, 300, 686, 1),
               (4, 301, 686, 120), (2, 2, 100_000, 3)]


def pr17_accepts(n_in, n_out, block_b, block_n):
    """Whether the previous kernel (one CTA per block_b x block_n tile, at
    most 8,192 elements, its W tile and spike rows in shared memory at odd
    word strides) took these arguments."""
    tile_n = min(block_n, n_out)
    ld = -(-n_in // 4) | 1
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    return (block_b * tile_n <= 8192
            and a16(tile_n * ld * 4) + a16(block_b * ld * 4) <= 232_448
            and -(-n_out // tile_n) <= 65_535)


@pytest.mark.parametrize("T,B,n_in,n_out", PLAN_SHAPES)
def test_launch_plan_regions(T, B, n_in, n_out):
    """The plan fits the budget with at least one timestep a chunk; its
    regions (W^T tile, the staged steps, the output tile) follow each other
    without overlap at 16-byte boundaries; the grid covers every lane and
    column; the CTA is at most 8 lanes by 32 columns, a warp per 8."""
    plan = kernel.launch_plan(T, B, n_in, n_out)
    assert plan is not None
    assert 1 <= plan["tc"] <= min(T, kernel.TC_MAX)
    assert plan["nbuf"] in (1, 2) and (plan["nbuf"] == 1 or plan["tc"] < T)
    assert plan["smem_bytes"] == plan["bytes"] <= kernel.SMEM_LIMIT
    lanes, cols = plan["lanes"], plan["cols"]
    assert 1 <= lanes <= min(B, kernel.MAX_LANES)
    assert 1 <= cols <= min(n_out, kernel.MAX_COLS)
    assert plan["threads"] == 32 * -(-cols // 8)
    assert plan["grid_b"] * lanes >= B > (plan["grid_b"] - 1) * lanes
    assert plan["grid_n"] * cols >= n_out > (plan["grid_n"] - 1) * cols
    assert plan["wt_ld"] % 2 == 1 and plan["wt_ld"] * 4 >= n_in
    for key in ("spk_off", "seg_ld", "row_ld", "out_off", "out_ld", "bytes"):
        assert plan[key] % 16 == 0
    assert plan["spk_off"] >= cols * plan["wt_ld"] * 4
    assert plan["row_ld"] % 32 == 16 and plan["row_ld"] >= n_in + 31
    assert plan["seg_ld"] == lanes * plan["row_ld"]
    assert plan["out_off"] >= (plan["spk_off"] + kernel.SEG_SLACK
                               + plan["nbuf"] * plan["tc"] * plan["seg_ld"])
    assert plan["out_ld"] >= cols
    assert plan["bytes"] >= plan["out_off"] + plan["tc"] * lanes * cols


def test_launch_plan_spreads_the_imdb_layer():
    """IMDB layer 1 (T = 120, B = 8, 100 -> 128) runs on several CTAs, 16
    steps a chunk, double-buffered."""
    plan = kernel.launch_plan(120, 8, 100, 128)
    assert plan["grid_b"] * plan["grid_n"] >= 4
    assert (plan["tc"], plan["nbuf"], plan["lanes"]) == (16, 2, 8)


@pytest.mark.parametrize("n_in", [1, 7, 100, 686, 4096, 20_000, 60_000])
def test_every_shape_the_previous_kernel_took_is_planned(n_in):
    """No (N_in, N_out, block_b, block_n) that the previous kernel accepted
    is refused: the plan falls back to one lane and one column, one
    timestep, single-buffered."""
    for n_out in (1, 14, 128, 8192):
        for block_b in (1, 8, 64, 300):
            for block_n in (1, 16, 128):
                if pr17_accepts(n_in, n_out, block_b, block_n):
                    for T in (1, 120):
                        assert kernel.launch_plan(T, 300, n_in,
                                                  n_out) is not None


# (T, B, N_in, N_out): the chunk edges around 16 steps (15, 16, 17, 33),
# T = 1 and 120, ragged lanes (1, 3, 37, 300), fan-ins that are not a
# multiple of 32 (100, 686) and ragged columns (1, 14)
EDGE_SHAPES = [(15, 1, 100, 14), (16, 3, 686, 1), (17, 37, 100, 1),
               (33, 300, 686, 14), (1, 37, 686, 14), (120, 3, 100, 14),
               (120, 300, 100, 1), (33, 8, 100, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("neuron,clamp", [(n, c) for n in NEURONS
                                          for c in CLAMPS])
@pytest.mark.parametrize("T,B,n_in,n_out", EDGE_SHAPES)
def test_kernel_chunk_edges_on_the_card(cuda_device, T, B, n_in, n_out,
                                        neuron, clamp):
    """Chunk edges, ragged lanes, fan-ins and columns, every neuron and
    clamp with a nonzero IF/LIF reset, against the plain version."""
    spikes, wq = make_case(T, B, n_in, n_out, seed=T * 7 + B + n_in,
                           density=0.3)
    s = torch.from_numpy(spikes).to(cuda_device)
    w = torch.from_numpy(wq).to(cuda_device)
    kw = dict(threshold=250, leak=-5 if neuron == "lif" else 0, reset=-40,
              neuron=neuron, clamp_mode=clamp)
    got = fused_snn_layer(s, w, **kw)
    want = fused_snn_layer_ref(s, w, **kw)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@pytest.mark.cuda
def test_kernel_takes_unaligned_spikes_on_the_card(cuda_device):
    """A raster that starts at an odd byte of its storage (a slice) is
    staged exactly: the runs keep their offset modulo 16."""
    spikes, wq = make_case(T=21, B=5, n_in=100, n_out=20, seed=8)
    base = torch.zeros(spikes.size + 3, dtype=torch.int8)
    base[3:] = torch.from_numpy(spikes).reshape(-1)
    s = base.to(cuda_device)[3:].view(spikes.shape)
    w = torch.from_numpy(wq).to(cuda_device)
    kw = dict(threshold=150, neuron="rmp", clamp_mode="saturate")
    got = fused_snn_layer(s, w, **kw)
    want = fused_snn_layer_ref(s, w, **kw)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert torch.equal(g, x)
