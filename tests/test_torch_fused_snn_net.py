"""The port's fused-network wrapper (repro_torch.kernels.fused_snn_net)
against the JAX package's `fused_snn_net(use_pallas=False)`, on seeded
numpy inputs, at exact equality (every value is an integer).

On the CPU the wrapper runs its plain version;
`test_kernel_matches_plain_version_on_the_card` holds the CUDA kernel
against it and runs only where a GPU is present (``pytest -m cuda``).
"""
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
