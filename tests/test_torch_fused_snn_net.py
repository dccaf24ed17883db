"""The port's fused-network wrapper (repro_torch.kernels.fused_snn_net)
against the JAX package's `fused_snn_net(use_pallas=False)`, on seeded
numpy inputs, at exact equality (every value is an integer).

On the CPU the wrapper runs its plain version;
`test_kernel_matches_plain_version_on_the_card` and the dense kernel's
chunk-edge and stack tests hold the CUDA kernel against it and run only
where a GPU is present (``pytest -m cuda``). The dense kernel's launch plan
(`kernel.dense_plan`) is checked here, and against its C mirror
(``csrc/dense_plan.h``, built for the host with g++).
"""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.fused_snn_net import kernel  # noqa: E402
from repro_torch.kernels.fused_snn_net.ops import (fused_snn_net,  # noqa: E402
                                                   fused_snn_net_ref)

IMDB_WIDTHS = (100, 128, 128, 1)


def make_case(widths, T, B, readout, seed, v_init):
    """Seeded raster, weights biased positive (so V reaches and passes the
    11-bit limits), per-layer constants and optional carried V."""
    rng = np.random.default_rng(seed)
    spikes = (rng.random((T, B, widths[0])) < 0.4).astype(np.int8)
    ws = [rng.integers(-20, 32, (a, b)).astype(np.int8)
          for a, b in zip(widths[:-1], widths[1:])]
    n_spiking = len(ws) - 1 if readout else len(ws)
    ths = tuple(int(t) for t in rng.integers(20, 1000, n_spiking))
    lks = tuple(int(t) for t in rng.integers(0, 120, n_spiking))
    vi = ([rng.integers(-1024, 1024, (B, n)).astype(np.int32)
           for n in widths[1:]] if v_init else None)
    return spikes, ws, ths, lks, vi


def run_both(case, neuron, clamp, readout, emit_rasters):
    # JAX is imported here, not at the top, so that the card-only test
    # below also runs where JAX is not installed
    import jax.numpy as jnp

    from repro.kernels.fused_snn_net.ops import fused_snn_net as jax_net
    spikes, ws, ths, lks, vi = case
    kw = dict(thresholds=ths, leaks=lks, neuron=neuron, clamp_mode=clamp,
              emit_rasters=emit_rasters, readout=readout)
    got = fused_snn_net(torch.from_numpy(spikes),
                        [torch.from_numpy(w) for w in ws],
                        v_init=None if vi is None else
                        [torch.from_numpy(v) for v in vi], **kw)
    want = jax_net(jnp.asarray(spikes), [jnp.asarray(w) for w in ws],
                   use_pallas=False,
                   v_init=None if vi is None else [jnp.asarray(v) for v in vi],
                   **kw)
    return got, want


def assert_same(got, want):
    (g_r, g_v, g_s), (w_r, w_v, w_s) = got, want
    assert g_s is None and w_s is None
    assert len(g_r) == len(w_r) and len(g_v) == len(w_v)
    for g, w in zip(g_r, w_r):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(g_v, w_v):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("neuron", ["if", "lif", "rmp"])
@pytest.mark.parametrize("clamp", ["saturate", "wrap"])
def test_imdb_stack_matches_jax(neuron, clamp):
    case = make_case(IMDB_WIDTHS, T=8, B=6, readout=True, seed=1,
                     v_init=True)
    assert_same(*run_both(case, neuron, clamp, True, True))


@pytest.mark.parametrize("v_init", [False, True])
@pytest.mark.parametrize("emit_rasters", [False, True])
def test_v_init_and_rasters_match_jax(v_init, emit_rasters):
    case = make_case(IMDB_WIDTHS, T=5, B=4, readout=True, seed=2,
                     v_init=v_init)
    assert_same(*run_both(case, "rmp", "saturate", True, emit_rasters))


@pytest.mark.parametrize("clamp", ["saturate", "wrap"])
def test_all_spiking_stack_matches_jax(clamp):
    """readout=False: every layer spikes (the shape conv patch rasters
    take, e.g. 126 -> 14)."""
    case = make_case((126, 14), T=6, B=7, readout=False, seed=3,
                     v_init=True)
    assert_same(*run_both(case, "lif", clamp, False, True))


@pytest.mark.parametrize("B", [1, 3, 13])
def test_ragged_batch_matches_jax(B):
    case = make_case(IMDB_WIDTHS, T=4, B=B, readout=True, seed=4,
                     v_init=False)
    assert_same(*run_both(case, "rmp", "wrap", True, True))


def test_chunked_calls_equal_one_call():
    """Threading the final V back in as v_init composes bit for bit."""
    spikes, ws, ths, lks, _ = make_case(IMDB_WIDTHS, T=9, B=5, readout=True,
                                        seed=5, v_init=False)
    s, w = torch.from_numpy(spikes), [torch.from_numpy(x) for x in ws]
    kw = dict(thresholds=ths, leaks=lks, neuron="lif", clamp_mode="wrap")
    r_full, v_full, _ = fused_snn_net(s, w, **kw)
    r_a, v_a, _ = fused_snn_net(s[:4], w, **kw)
    r_b, v_b, _ = fused_snn_net(s[4:], w, v_init=v_a, **kw)
    for full, a, b in zip(r_full, r_a, r_b):
        assert torch.equal(full, torch.cat([a, b]))
    for full, b in zip(v_full, v_b):
        assert torch.equal(full, b)


@pytest.mark.parametrize("bad", ["misaligned", "empty", "thresholds",
                                 "v_init", "neuron"])
def test_wrapper_rejects_bad_arguments(bad):
    spikes, ws, ths, lks, _ = make_case(IMDB_WIDTHS, T=2, B=2, readout=True,
                                        seed=6, v_init=False)
    s, w = torch.from_numpy(spikes), [torch.from_numpy(x) for x in ws]
    kw = dict(thresholds=ths, leaks=lks)
    if bad == "misaligned":
        w = [w[1], w[0], w[2]]
    elif bad == "empty":
        w = []
    elif bad == "thresholds":
        kw["thresholds"] = ths[:1]
    elif bad == "v_init":
        kw["v_init"] = [torch.zeros((2, 128), dtype=torch.int32)]
    else:
        kw["neuron"] = "izhikevich"
    with pytest.raises(ValueError):
        fused_snn_net(s, w, **kw)


def test_cuda_binding_refuses_cpu_tensors():
    """The kernel's binding never runs anything on the CPU."""
    spikes, ws, ths, lks, _ = make_case(IMDB_WIDTHS, T=2, B=2, readout=True,
                                        seed=7, v_init=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.fused_snn_net_cuda(
            torch.from_numpy(spikes), [torch.from_numpy(w) for w in ws], ths,
            lks, neuron="rmp", clamp_mode="saturate", readout=True,
            emit_rasters=True)


@pytest.mark.parametrize("widths,block_b,fits", [
    (IMDB_WIDTHS, 8, True), (IMDB_WIDTHS, 64, True),
    (IMDB_WIDTHS, 256, False)])
def test_shared_memory_layout(widths, block_b, fits):
    """Weights at logical widths, odd word strides, and the one size check
    against a Hopper block's 227 KB."""
    lay = kernel.smem_layout(widths, block_b)
    assert all(ld % 2 == 1 for ld in lay["wt_ld"] + [lay["spk_ld"]])
    assert lay["wt_ld"][0] * 4 >= widths[0]
    assert (lay["bytes"] <= kernel.SMEM_LIMIT) == fits


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("neuron", ["if", "lif", "rmp"])
@pytest.mark.parametrize("clamp", ["saturate", "wrap"])
def test_kernel_matches_plain_version_on_the_card(cuda_device, neuron, clamp):
    spikes, ws, ths, lks, vi = make_case(IMDB_WIDTHS, T=10, B=37,
                                         readout=True, seed=8, v_init=True)
    s = torch.from_numpy(spikes).to(cuda_device)
    w = [torch.from_numpy(x).to(cuda_device) for x in ws]
    v = [torch.from_numpy(x).to(cuda_device) for x in vi]
    kw = dict(neuron=neuron, clamp_mode=clamp, v_init=v)
    got_r, got_v, _ = fused_snn_net(s, w, thresholds=ths, leaks=lks, **kw)
    want_r, want_v, _ = fused_snn_net_ref(s, w, ths, lks, **kw)
    torch.cuda.synchronize()
    for g, x in zip(got_r + got_v, want_r + want_v):
        assert torch.equal(g, x)


# The dense kernel's own plan (`kernel.dense_plan`, mirrored by
# `csrc/dense_plan.h`): the stacks the dense mode runs.
MNIST_FC = (686, 120, 84, 10)
WIDE_WIDTHS = (130, 24, 3)
CONV = (126, 14)
PLAN_STACKS = [IMDB_WIDTHS, MNIST_FC, WIDE_WIDTHS, CONV]
DEEP_STACKS = ([(100,) + (32,) * n for n in range(1, 17)]
               + [(100,) + (128,) * (n - 1) + (1,) for n in range(1, 17)])
PLAN_CALLS = [(10, 1), (10, 32), (10, 4096), (120, 8), (1, 300),
              (17, 12_544)]


def dense_regions(widths, plan):
    """(name, start, end) of every region of a dense layout."""
    lanes, tc = plan["lanes"], plan["tc"]
    n_layers = len(widths) - 1
    out = [(f"wt{i}", off, off + -(-n_out * 4 * plan["wt_ld"][i] // 16) * 16)
           for i, (off, n_out) in enumerate(zip(plan["wt_off"], widths[1:]))]
    out.append(("in", plan["in_off"],
                plan["in_off"] + tc * lanes * plan["in_ld"]))
    for k in range(2 if n_layers > 1 else 1):
        out.append((f"out{k}", plan["out_off"][k],
                    plan["out_off"][k] + tc * lanes * plan["out_ld"][k]))
    if plan["counts_ld"]:
        out.append(("counts", plan["counts_off"],
                    plan["counts_off"] + lanes * plan["counts_ld"]))
    out += [(f"v{i}", off, off + 4 * lanes * n_out)
            for i, (off, n_out) in enumerate(zip(plan["v_off"], widths[1:]))]
    return out


@pytest.mark.parametrize("T,B", PLAN_CALLS)
@pytest.mark.parametrize("widths", PLAN_STACKS + [
    (100,) + (32,) * 16, (100,) + (128,) * 9 + (1,),
    (100,) + (128,) * 11 + (1,)], ids=str)
def test_dense_plan_regions(widths, T, B):
    """The regions do not overlap, fit a Hopper block, start on 16 bytes
    and leave 16 bytes after every spike or counts region (32 after a
    weight region) for the k-steps' reads past their rows; rows are
    16 mod 32 bytes (weight rows an odd word count in a compact plan);
    lanes are whole MMA row tiles; the grid covers B."""
    plan = kernel.dense_plan(widths, T, B)
    assert plan is not None
    regions = sorted(dense_regions(widths, plan), key=lambda r: r[1])
    assert regions[0][1] == 0 and regions[-1][2] <= plan["bytes"] - 16
    for (_, _, end), (_, start, _) in zip(regions, regions[1:]):
        assert end <= start
    assert plan["bytes"] <= kernel.SMEM_LIMIT
    for name, start, end in regions:
        assert start % 16 == 0, name
        if name.startswith(("out", "counts")):  # the k-steps' over-read
            assert plan["bytes"] - end >= 16, name
        if name.startswith("wt"):
            assert plan["bytes"] - end >= 32, name
    assert plan["lanes"] % 8 == 0 or plan["lanes"] in (1, 2, 4)
    assert plan["grid"] == -(-B // plan["lanes"])
    assert plan["grid"] <= max(kernel.DENSE_SMS, -(-B // 8))
    assert 1 <= plan["tc"] <= min(kernel.DENSE_TC_MAX, max(T, 1))
    assert plan["in_ld"] % 32 == 16 and plan["in_ld"] >= widths[0] + 31
    for k in (0, 1):                  # chunk k holds the outputs of layer k,
        ld = plan["out_ld"][k]        # k + 2, ... in 16-column units
        assert ld % 32 == 16
        assert ld >= -(-max(widths[k + 1::2], default=1) // 16) * 16
    if plan["counts"] and len(widths) > 2:
        assert plan["counts_ld"] % 32 == 16
        assert plan["counts_ld"] >= -(-widths[-2] // 16) * 16
    else:
        assert plan["counts_ld"] == 0
    for n_in, ld in zip(widths[:-1], plan["wt_ld"]):
        assert 4 * ld >= n_in
        assert ld % 2 == 1 if plan["compact"] else (4 * ld) % 32 == 16


@pytest.mark.parametrize("block_b", [8, 64])
@pytest.mark.parametrize("widths", PLAN_STACKS + DEEP_STACKS, ids=str)
def test_dense_plan_takes_every_stack_the_dense_mode_took(widths, block_b):
    """Every stack whose block_b-lane layout the previous dense kernel
    accepted is planned, at every call shape; the plan no longer depends
    on block_b."""
    if kernel.smem_layout(widths, block_b)["bytes"] > kernel.SMEM_LIMIT:
        return
    for T, B in PLAN_CALLS:
        assert kernel.dense_plan(widths, T, B) is not None, (T, B)


@pytest.mark.parametrize("block_b", [8, 64])
def test_dense_plan_takes_random_stacks_the_dense_mode_took(block_b):
    """A seeded sweep of 1- to 16-layer stacks of widths 1 to 2,000: every
    one whose block_b-lane layout the previous dense kernel accepted is
    planned."""
    rng = np.random.default_rng(19)
    choices = (1, 3, 10, 14, 24, 84, 100, 120, 126, 128, 130, 256, 512, 686,
               1000, 2000)
    taken = 0
    for _ in range(1500):
        widths = tuple(int(x) for x in rng.choice(
            choices, size=int(rng.integers(2, 18))))
        if kernel.smem_layout(widths, block_b)["bytes"] <= kernel.SMEM_LIMIT:
            taken += 1
            assert kernel.dense_plan(widths, 10, 32) is not None, widths
    assert taken > 150


def test_dense_plan_of_the_repository_stacks():
    """The K = 10 megastep is one chunk at IMDB widths at every batch; the
    MNIST FC and conv stacks run their 10 steps in one chunk too; lanes
    spread over at most DENSE_SMS CTAs; 120 steps run in chunks of 16."""
    for B in (1, 8, 32, 256, 300, 4096):
        plan = kernel.dense_plan(IMDB_WIDTHS, 10, B)
        assert plan["tc"] == 10
        assert plan["grid"] <= kernel.DENSE_SMS
    assert kernel.dense_plan(IMDB_WIDTHS, 10, 32)["lanes"] == 8
    assert kernel.dense_plan(IMDB_WIDTHS, 10, 4096)["lanes"] == 32
    assert kernel.dense_plan(IMDB_WIDTHS, 120, 8)["tc"] == 16
    assert kernel.dense_plan(MNIST_FC, 10, 64)["tc"] == 10
    conv = kernel.dense_plan(CONV, 10, 64 * 196)
    assert conv["tc"] == 10 and conv["grid"] <= kernel.DENSE_SMS
    assert not kernel.dense_plan(MNIST_FC, 10, 64)["compact"]
    assert kernel.dense_plan((100,) + (128,) * 11 + (1,), 10, 8)["compact"]
    assert kernel.dense_plan((120_000, 2), 2, 9) is None


# a stack on each rung of the plan's ladder at T = 10, B = 8: (widths,
# compact weight rows, readout counts, lanes)
PLAN_TIERS = [(IMDB_WIDTHS, False, True, 8),
              ((100, 1000, 14, 1000, 10), True, True, 8),
              ((14, 686, 14, 3000, 1), True, False, 8),
              ((14, 4000, 1), True, False, 4),
              ((14, 1500, 14, 4000, 1), True, False, 2),
              ((14, 4000, 14, 2000, 1), True, False, 1)]


@pytest.mark.parametrize("widths,compact,counts,lanes", PLAN_TIERS, ids=str)
def test_dense_plan_ladder(widths, compact, counts, lanes):
    """Where the widest tile does not fit, the plan takes compact weight
    rows, then drops the readout's counts, then takes 4, 2 or 1 lanes; a
    rung is taken only when the ones above it do not fit."""
    plan = kernel.dense_plan(widths, 10, 8)
    assert (plan["compact"], plan["counts"], plan["lanes"]) == (
        compact, counts, lanes)
    assert plan["bytes"] <= kernel.SMEM_LIMIT
    if lanes < 8:
        assert kernel.dense_layout(widths, 8, 1, True, False)["bytes"] > \
            kernel.SMEM_LIMIT
    elif not counts:
        assert kernel.dense_layout(widths, 8, 1, True, True)["bytes"] > \
            kernel.SMEM_LIMIT
    elif compact:
        assert kernel.dense_layout(widths, 8, 1)["bytes"] > kernel.SMEM_LIMIT


@pytest.fixture(scope="module")
def plan_library(tmp_path_factory):
    """`csrc/dense_plan.h` alone built for the host with g++."""
    import shutil
    import subprocess
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the plan's C mirror for the host")
    header = (Path(kernel.__file__).parent / "csrc" / "dense_plan.h")
    lib = tmp_path_factory.mktemp("dense_plan") / "libdense_plan.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++",
                    str(header), "-o", str(lib)], check=True)
    import ctypes
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("probe", range(len(kernel.DENSE_PLAN_PROBES)))
def test_dense_plan_c_mirror_agrees_on_its_probes(plan_library, probe):
    """The check the binding makes when the library loads, here on the
    header built for the host: every probe planned alike."""
    widths, T, B = kernel.DENSE_PLAN_PROBES[probe]
    got = kernel.c_dense_plan(plan_library, widths, T, B)
    plan = kernel.dense_plan(widths, T, B)
    assert got == {k: plan[k] for k in got}
    kernel.check_dense_plan(plan_library)


@pytest.mark.parametrize("widths", PLAN_STACKS + DEEP_STACKS[::3], ids=str)
def test_dense_plan_c_mirror_agrees_off_its_probes(plan_library, widths):
    for T, B in PLAN_CALLS + [(0, 5), (33, 37)]:
        got = kernel.c_dense_plan(plan_library, widths, T, B)
        plan = kernel.dense_plan(widths, T, B)
        assert (got is None) == (plan is None), (T, B)
        if plan is not None:
            assert got == {k: plan[k] for k in got}, (T, B)
    assert kernel.c_dense_plan(plan_library, (120_000, 2), 2, 9) is None


def card_case(device, widths, T, B, readout, v_init, seed, density=0.4):
    spikes, ws, ths, lks, vi = make_case(widths, T, B, readout, seed, v_init)
    if density != 0.4:
        rng = np.random.default_rng(seed + 1)
        spikes = (rng.random(spikes.shape) < density).astype(np.int8)
    return (torch.from_numpy(spikes).to(device),
            [torch.from_numpy(x).to(device) for x in ws], ths, lks,
            None if vi is None else [torch.from_numpy(x).to(device)
                                     for x in vi])


def assert_kernel_is_plain(s, w, ths, lks, **kw):
    got_r, got_v, _ = fused_snn_net(s, w, thresholds=ths, leaks=lks, **kw)
    want_r, want_v, _ = fused_snn_net_ref(s, w, ths, lks, **kw)
    torch.cuda.synchronize()
    assert len(got_r) == len(want_r) and len(got_v) == len(want_v)
    for g, x in zip(got_r + got_v, want_r + want_v):
        assert g.dtype == x.dtype and torch.equal(g, x)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [0, 1, 15, 16, 17, 33, 120])
@pytest.mark.parametrize("neuron", ["if", "lif", "rmp"])
@pytest.mark.parametrize("clamp", ["saturate", "wrap"])
def test_dense_kernel_at_chunk_edges_on_the_card(cuda_device, T, neuron,
                                                 clamp):
    """Chunk edges of the dense plan (16 steps a chunk): no step (V out is
    V in), one step, a step short of, at and past a chunk, and 120 steps,
    on a ragged batch."""
    s, w, ths, lks, vi = card_case(cuda_device, IMDB_WIDTHS, T, 37, True,
                                   T % 2 == 1, seed=20 + T)
    assert_kernel_is_plain(s, w, ths, lks, neuron=neuron, clamp_mode=clamp,
                           v_init=vi, emit_rasters=T != 16)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(10, 8), (17, 37)])
@pytest.mark.parametrize("widths,compact,counts,lanes", PLAN_TIERS, ids=str)
def test_dense_kernel_on_each_plan_rung_on_the_card(cuda_device, widths,
                                                    compact, counts, lanes,
                                                    T, B):
    """Compact weight rows (bank-conflicted B loads), a readout that sums
    its input's spike rows, and tiles of fewer than 8 lanes (MMA rows past
    them read the last lane and store nothing), each with a ragged tile."""
    s, w, ths, lks, vi = card_case(cuda_device, widths, T, B, True, True,
                                   seed=T + len(widths), density=0.15)
    assert_kernel_is_plain(s, w, ths, lks, neuron="lif", clamp_mode="wrap",
                           v_init=vi)


@pytest.mark.cuda
@pytest.mark.parametrize("B,block_b", [(1, 1), (37, 8), (300, 32),
                                       (4096, 64)])
@pytest.mark.parametrize("widths,readout", [
    (IMDB_WIDTHS, True), (MNIST_FC, True), (WIDE_WIDTHS, True),
    (CONV, False)], ids=str)
def test_dense_kernel_on_every_stack_on_the_card(cuda_device, widths,
                                                 readout, B, block_b):
    """Fan-ins of 100 to 686 and fan-outs of 1 to 128 (missing columns in
    the last 8-column tile), ragged lane tiles, block_b that does not tile
    the dense mode, with and without v_init and rasters."""
    s, w, ths, lks, vi = card_case(cuda_device, widths, 10, B, readout,
                                   B % 2 == 1, seed=B + len(widths),
                                   density=0.15)
    assert_kernel_is_plain(s, w, ths, lks, neuron="rmp", clamp_mode="wrap",
                           readout=readout, v_init=vi, block_b=block_b,
                           emit_rasters=block_b != 32)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [6272, 1568])
@pytest.mark.parametrize("mode_kw", [
    {}, {"use_sparse": True, "gate_granularity": 8},
    {"use_events": True, "event_crossover": 1.0},
    {"use_events": True, "event_crossover": 0.5}], ids=str)
@pytest.mark.parametrize("clamp", ["saturate", "wrap"])
def test_conv_v_init_in_each_mode_on_the_card(cuda_device, mode_kw, clamp, B):
    """An impulse-mnist conv call as a served megastep gives it: the
    (K = 5, 32 * P, 126) patch raster at conv 1's and conv 2's lanes
    (P = 196 and 49) with carried V and rasters on, in each mode, equal to
    the plain version: rasters, V and every counter (the plan's multi-CTA
    spread and the ragged last tile of 8 lanes)."""
    s, w, ths, lks, vi = card_case(cuda_device, CONV, 5, B, False, True,
                                   seed=B, density=0.1)
    kw = dict(neuron="rmp", clamp_mode=clamp, readout=False, v_init=vi,
              block_b=8, **mode_kw)
    got = fused_snn_net(s, w, thresholds=ths, leaks=lks, **kw)
    want = fused_snn_net_ref(s, w, ths, lks, **kw)
    torch.cuda.synchronize()
    for g, x in zip(got[0] + got[1], want[0] + want[1]):
        assert g.dtype == x.dtype and torch.equal(g, x)
    if mode_kw.get("use_sparse"):
        for g, x in zip(got[2], want[2]):
            assert torch.equal(g, x)
    if mode_kw.get("use_events"):
        for g, x in zip(got[2]["row_events"], want[2]["row_events"]):
            assert torch.equal(g, x)
        assert torch.equal(got[2]["dense_fallbacks"],
                           want[2]["dense_fallbacks"])
