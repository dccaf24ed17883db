"""The port's static analysis (repro_torch.analysis) against the JAX
package's, and its kernel contracts against the CUDA wrapper's refusals.

`check_program` must give the JAX `RangeReport` field for field on the
IMDB and MNIST programs and on seeded FC stacks, in both clamp modes, and
raise `RangeError` on the cases JAX's `tests/test_analysis.py` rejects.
`check_kernel_contracts` must accept exactly the calls the wrapper's own
refusal function (`kernel.launch_plan`) accepts, naming the same rule,
over seeded 1- to 18-layer stacks in each CUDA mode; on the card
(``pytest -m cuda``) the wrapper launches every accepted stack and raises
on every refused one. The engine's admission cap equals JAX's. JAX is
imported inside the tests, so the card test also runs where JAX is not
installed.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.analysis import (V_DOMAIN, ContractError, Interval,  # noqa: E402
                                  RangeError, check_kernel_contracts,
                                  check_program, clamp_interval,
                                  validate_program, wrap_is_exact)
from repro_torch.configs.impulse_snn import IMDB, MNIST  # noqa: E402
from repro_torch.core import pipeline, snn  # noqa: E402
from repro_torch.core.pipeline import LayerSpec, SNNProgram  # noqa: E402
from repro_torch.core.quant import V_MAX, V_MIN, V_SPAN  # noqa: E402
from repro_torch.kernels.fused_snn_net import kernel  # noqa: E402
from repro_torch.serve import SNNRequest, SNNServeEngine  # noqa: E402

MODES = {"cuda": "dense", "cuda_sparse": "gated", "cuda_events": "events"}


def jax_program(cfg_name, neuron="rmp", clamp="saturate", sizes=None,
                seed=0):
    """(JAX program compiled with validate=False, the port's copy on the
    CPU): the IMDB or MNIST configuration, or an FC stack of ``sizes``."""
    import jax

    from repro.configs.base import SpikingConfig
    from repro.configs.impulse_snn import IMDB as JI
    from repro.configs.impulse_snn import MNIST as JM
    from repro.configs.impulse_snn import SNNModelConfig
    from repro.core import pipeline as jpipe
    from repro.core import snn as jsnn
    from test_torch_pipeline import jax_program_arrays
    if sizes is not None:
        cfg = SNNModelConfig(
            arch_id="ana-test", layer_sizes=sizes,
            spiking=SpikingConfig(neuron=neuron, timesteps=3, threshold=1.0,
                                  leak=0.0625, w_bits=6, v_bits=11),
            timesteps=3)
    else:
        cfg = JM if cfg_name == "mnist" else JI
        cfg = dataclasses.replace(cfg, spiking=dataclasses.replace(
            cfg.spiking, neuron=neuron))
    init = jsnn.init_lenet_snn if cfg.conv_spec else jsnn.init_fc_snn
    jprog = jpipe.compile_network(cfg, init(jax.random.PRNGKey(seed), cfg),
                                  domain="int", clamp_mode=clamp,
                                  validate=False)
    port_cfg = {"impulse-mnist": MNIST, "impulse-imdb": IMDB}.get(cfg.arch_id)
    prog = pipeline.program_from_arrays(
        jax_program_arrays(jprog), neuron=jprog.neuron,
        timesteps=jprog.timesteps, clamp_mode=clamp, device="cpu",
        cfg=port_cfg)
    return jprog, prog


def iv(x):
    return (x.lo, x.hi)


def assert_same_report(got, want):
    """Two RangeReports of the two packages, field for field."""
    assert (got.domain, got.clamp_mode, got.neuron, got.frames) == (
        want.domain, want.clamp_mode, want.neuron, want.frames)
    assert got.max_safe_frames == want.max_safe_frames
    assert len(got.layers) == len(want.layers)
    for g, w in zip(got.layers, want.layers):
        assert (g.index, g.name, g.kind, g.n_in, g.n_out, g.row_tiles,
                g.wrap_exact, g.max_safe_frames) == (
            w.index, w.name, w.kind, w.n_in, w.n_out, w.row_tiles,
            w.wrap_exact, w.max_safe_frames)
        for f in ("increment", "v_pre_clamp", "v_post"):
            assert iv(getattr(g, f)) == iv(getattr(w, f)), (g.name, f)


# --- intervals ----------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(-3000, -2900), (2040, 2060), (0, 5),
                                   (1020, 1030), (-5000, 5000),
                                   (V_MAX - 1, V_MAX + 1)])
def test_intervals_match_jax(lo, hi):
    from repro.analysis import intervals as jiv
    a, b = Interval(lo, hi), jiv.Interval(lo, hi)
    for mode in ("saturate", "wrap"):
        assert iv(clamp_interval(a, mode)) == iv(jiv.clamp_interval(b, mode))
    assert wrap_is_exact(a) == jiv.wrap_is_exact(b)
    assert iv(a + Interval(-7, 3)) == iv(b + jiv.Interval(-7, 3))
    assert iv(a.scale(-3)) == iv(b.scale(-3))
    for v in range(lo, hi + 1, max(1, (hi - lo) // 50)):
        assert clamp_interval(a, "wrap").contains_value(
            ((v - V_MIN) % V_SPAN) + V_MIN)


# --- ranges ---------------------------------------------------------------------

@pytest.mark.parametrize("clamp", ["saturate", "wrap"])
@pytest.mark.parametrize("name,neuron", [("imdb", "rmp"), ("imdb", "lif"),
                                         ("mnist", "rmp"), ("mnist", "if")])
def test_check_program_matches_jax(name, neuron, clamp):
    from repro.analysis import check_program as jax_check
    jprog, prog = jax_program(name, neuron, clamp)
    for frames in (None, 1, 10, 1000):
        assert_same_report(check_program(prog, frames=frames),
                           jax_check(jprog, frames=frames))


@pytest.mark.parametrize("seed", range(6))
def test_check_program_matches_jax_on_seeded_stacks(seed):
    from repro.analysis import check_program as jax_check
    rng = np.random.default_rng(seed)
    sizes = tuple(int(x) for x in rng.integers(2, 300, rng.integers(3, 6)))
    neuron = ("if", "lif", "rmp")[seed % 3]
    for clamp in ("saturate", "wrap"):
        jprog, prog = jax_program(None, neuron, clamp, sizes, seed)
        assert_same_report(check_program(prog), jax_check(jprog))


def test_mnist_max_safe_frames():
    _, prog = jax_program("mnist")
    assert check_program(prog, frames=1).max_safe_frames == 6_669_203


def synthetic(layers, mode="saturate", neuron="if"):
    return SNNProgram(cfg=None, neuron=neuron, timesteps=2,
                      layers=tuple(layers), clamp_mode=mode)


def test_readout_overflow_horizon_rejected():
    """Past max_safe_frames the readout can overflow int32: a RangeError
    naming the readout, and the bound is sharp."""
    _, prog = jax_program(None, "rmp", "saturate", (17, 12, 5, 2))
    safe = check_program(prog).max_safe_frames
    assert safe is not None and safe > 0
    check_program(prog, frames=safe)
    with pytest.raises(RangeError) as ei:
        check_program(prog, frames=safe + 1)
    assert ei.value.where.startswith("readout")


def test_saturate_overflow_fanin_rejected_wrap_composes():
    layers = [LayerSpec(kind="fc", n_in=10 ** 8, n_out=4, threshold=100,
                        leak=0),
              LayerSpec(kind="readout", n_in=4, n_out=2)]
    with pytest.raises(RangeError) as ei:
        check_program(synthetic(layers, "saturate"))
    assert "fc[0]" in str(ei.value) and "saturate" in str(ei.value)
    report = check_program(synthetic(layers, "wrap"))
    assert not report.layers[0].wrap_exact
    assert V_DOMAIN.contains(report.layers[0].v_post)


def test_oversized_constant_and_weight_rejected():
    layers = [LayerSpec(kind="fc", n_in=8, n_out=4, threshold=V_MAX + 1,
                        leak=0),
              LayerSpec(kind="readout", n_in=4, n_out=2)]
    with pytest.raises(RangeError, match="quantize_neuron_const"):
        check_program(synthetic(layers))
    w = torch.full((8, 4), 40, dtype=torch.int8)
    layers = [LayerSpec(kind="fc", n_in=8, n_out=4, w=w, threshold=10,
                        leak=0), layers[1]]
    with pytest.raises(RangeError, match="6-bit grid"):
        check_program(synthetic(layers))


# --- contracts -------------------------------------------------------------------

def fc_program(widths, neuron="rmp", clamp="saturate"):
    """A weightless FC program of logical ``widths`` (its geometry alone):
    the encoder, len(widths) - 2 spiking layers and the readout."""
    layers = [LayerSpec(kind="encoder", n_in=widths[0], n_out=widths[0],
                        state_shape=(widths[0],))]
    for j, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        last = j == len(widths) - 2
        layers.append(LayerSpec(kind="readout" if last else "fc", n_in=a,
                                n_out=b, threshold=None if last else 10,
                                leak=None if last else 1,
                                state_shape=(b,)))
    return synthetic(layers, clamp, neuron)


def seeded_stacks(n, seed):
    """``n`` seeded (widths, T, B, block_b, G) dispatches: 1 to 18 layers
    of widths that straddle the shared-memory limit (and, rarely, the
    event list's 16-bit index), T and B of serving and conv calls."""
    rng = np.random.default_rng(seed)
    choices = np.array((1, 3, 10, 14, 84, 100, 126, 128, 130, 686, 1000,
                        2000, 4000, 12_000))
    out = []
    for _ in range(n):
        L = int(rng.integers(1, 19))
        top = rng.choice((130, 700, 2000, 12_000))
        widths = tuple(int(x) for x in rng.choice(choices[choices <= top],
                                                  L + 1))
        if rng.random() < 0.02:
            widths = (70_000,) + widths[1:]
        T = int(rng.choice((1, 5, 10, 17)))
        B = int(rng.choice((1, 32, 300, 6272)))
        block_b = int(rng.choice((1, 8, 64, 256, 1024, 1025)))
        G = int(rng.choice((1, 2, 8)))
        out.append((widths, T, B, block_b, G))
    return out


def refusal(fn):
    """The contract named by ``fn()``'s refusal, or None when it passes."""
    try:
        fn()
    except (kernel.KernelRefused, ContractError) as e:
        return e.contract
    return None


@pytest.mark.parametrize("backend", list(MODES))
def test_contracts_agree_with_the_launch_rule(backend):
    """1,100 seeded stacks per mode: the contract pass accepts exactly the
    fc calls `kernel.launch_plan` (what the wrapper runs before every
    launch) accepts, names the same rule, and names the call."""
    seen = set()
    for widths, T, B, block_b, G in seeded_stacks(1100, 20 + len(backend)):
        G = G if backend == "cuda_sparse" else 1
        want = refusal(lambda: kernel.launch_plan(
            widths, T, B, mode=MODES[backend], block_b=block_b,
            gate_granularity=G))
        prog = fc_program(widths)
        got = refusal(lambda: check_kernel_contracts(
            prog, backend, frames=T, batch=B, block_b=block_b,
            gate_granularity=G))
        assert got == want, (widths, T, B, block_b, G)
        seen.add(want)
        if want is None:
            report = check_kernel_contracts(prog, backend, frames=T, batch=B,
                                            block_b=block_b,
                                            gate_granularity=G)
            plan = kernel.launch_plan(widths, T, B, mode=MODES[backend],
                                      block_b=block_b, gate_granularity=G)
            assert report.smem_bytes == plan["layout"]["bytes"]
            assert report.calls[0].name == "fc"
    named = {"max_layers", "block_b", "smem_budget", None}
    named |= {"event_index"} if backend == "cuda_events" else set()
    assert named <= seen, seen


def test_contract_errors_name_the_contract_and_the_call():
    _, prog = jax_program("mnist")
    with pytest.raises(ContractError) as ei:
        check_kernel_contracts(prog, "cuda_events", frames=10, batch=32,
                               block_b=1024)
    assert ei.value.contract == "smem_budget" and ei.value.where == "conv[0]"
    with pytest.raises(ContractError, match="block_b") as ei:
        check_kernel_contracts(prog, "cuda", block_b=0)
    assert ei.value.where == "conv[0]"
    deep = fc_program((100,) + (32,) * 17 + (1,))
    with pytest.raises(ContractError, match="max_layers") as ei:
        check_kernel_contracts(deep, "cuda")
    assert ei.value.where == "fc"
    for bad, match in (({"gate_granularity": 3}, "gate_granularity"),
                       ({"event_crossover": 1.5}, "event_crossover"),
                       ({"use_sparse": True}, "gate_granularity")):
        with pytest.raises(ContractError, match=match):
            check_kernel_contracts(prog, "cuda_events", **bad)
    with pytest.raises(ContractError, match="gate_granularity"):
        check_kernel_contracts(prog, "cuda", gate_granularity=2)
    with pytest.raises(ContractError, match="megastep"):
        check_kernel_contracts(prog, "cuda", frames=0, streaming=True)
    with pytest.raises(ContractError, match="wrap"):
        check_kernel_contracts(prog, "bitmacro")
    with pytest.raises(ContractError, match="backend"):
        check_kernel_contracts(prog, "pallas")
    with pytest.raises(ContractError, match="no streaming entry"):
        check_kernel_contracts(jax_program("mnist", clamp="wrap")[1],
                               "bitmacro", streaming=True)
    skips = fc_program((128,) * 129 + (4,))
    with pytest.raises(ContractError) as ei:
        check_kernel_contracts(skips, "cuda_sparse", gate_granularity=8)
    assert ei.value.contract in ("max_layers", "skip_layout")


def test_mnist_contracts_of_the_served_dispatch():
    """The served impulse-mnist dispatch (K = 5, 32 slots): conv calls at
    6,272 and 1,568 lanes, the fc stack at 32, every mode within the
    shared-memory limit; the host backends carry no calls."""
    _, prog = jax_program("mnist")
    for backend, kw in (("cuda", {}), ("cuda_sparse", {"gate_granularity": 8}),
                        ("cuda_events", {})):
        report = check_kernel_contracts(prog, backend, frames=5, batch=32,
                                        streaming=True, **kw)
        assert [(c.name, c.lanes) for c in report.calls] == [
            ("conv[0]", 6272), ("conv[1]", 1568), ("fc", 32)]
        assert 0 < report.smem_bytes <= kernel.SMEM_LIMIT
        assert {c.contract for c in report.checks} >= {
            "megastep", "chain_alignment", "smem_budget"}
    for backend in ("int_ref", "ref_events"):
        report = check_kernel_contracts(prog, backend, frames=5,
                                        streaming=True)
        assert report.calls == ()
        assert {c.contract for c in report.checks} == {"megastep",
                                                        "chain_alignment"}


# --- the engine's admission ----------------------------------------------------

@pytest.mark.parametrize("name", ["imdb", "mnist"])
def test_engine_max_safe_ticks_matches_jax(name):
    from repro.serve import SNNServeEngine as JaxEngine
    jprog, prog = jax_program(name)
    eng = SNNServeEngine(prog, backend="cuda", megastep=5, device="cpu")
    assert eng.max_safe_ticks == JaxEngine(
        jprog, backend="int_ref", megastep=5).max_safe_ticks
    assert eng.max_safe_ticks == check_program(prog, frames=1).max_safe_frames


def test_engine_caps_admission_at_the_k_rounded_budget():
    _, prog = jax_program(None, "rmp", "saturate", (17, 12, 5, 2))
    eng = SNNServeEngine(prog, backend="int_ref", batch_slots=2, megastep=4,
                         device="cpu")
    frames = np.zeros((3, 17), np.float32)
    eng.submit(SNNRequest(rid="ok", frames=frames))
    eng.max_safe_ticks = 4
    eng.submit(SNNRequest(rid="four", frames=frames))   # 3 ticks -> 4
    eng.max_safe_ticks = 3                               # 3 ticks -> 4 > 3
    with pytest.raises(RangeError, match="proven safe"):
        eng.submit(SNNRequest(rid="too-long", frames=frames))
    assert eng.queue.qsize() == 2
    assert SNNServeEngine(prog, validate=False,
                          device="cpu").max_safe_ticks is None


def test_engine_rejects_a_contract_violation_at_build():
    _, prog = jax_program(None, "if", "saturate", (17, 12, 2))
    with pytest.raises(ContractError, match="event_crossover"):
        SNNServeEngine(prog, backend="cuda_events", device="cpu",
                       step_kw={"event_crossover": 7.0})
    with pytest.raises(ContractError, match="block_b"):
        SNNServeEngine(prog, backend="cuda", device="cpu",
                       step_kw={"block_b": 2048})
    eng = SNNServeEngine(prog, backend="cuda", device="cpu", validate=False,
                         step_kw={"block_b": 2048})
    assert eng.max_safe_ticks is None


# --- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", list(MODES))
def test_contracts_agree_with_the_wrapper_on_the_card(cuda_device, backend):
    """40 seeded stacks per mode whose widths straddle the shared-memory
    limit: the wrapper launches each stack the contract pass accepts and
    raises `KernelRefused` naming the same rule for each it refuses."""
    from repro_torch.kernels.fused_snn_net.ops import fused_snn_net
    rng = np.random.default_rng(7)
    refused = launched = 0
    for widths, T, B, block_b, G in seeded_stacks(40, len(backend)):
        if sum(a * b for a, b in zip(widths[:-1], widths[1:])) > 1e8:
            widths = widths[:2]    # keep the weights of one case small
        G = G if backend == "cuda_sparse" else 1
        B = min(B, 300)
        prog = fc_program(widths)
        want = refusal(lambda: check_kernel_contracts(
            prog, backend, frames=T, batch=B, block_b=block_b,
            gate_granularity=G))
        spikes = torch.from_numpy((rng.random((T, B, widths[0])) < 0.2)
                                  .astype(np.int8)).to(cuda_device)
        ws = [torch.ones((a, b), dtype=torch.int8, device=cuda_device)
              for a, b in zip(widths[:-1], widths[1:])]
        n = len(ws) - 1
        got = refusal(lambda: fused_snn_net(
            spikes, ws, thresholds=(5,) * n, leaks=(0,) * n,
            block_b=block_b, use_sparse=backend == "cuda_sparse",
            gate_granularity=G, use_events=backend == "cuda_events"))
        torch.cuda.synchronize()
        assert got == want, (widths, T, B, block_b, G)
        refused += want is not None
        launched += want is None
    assert refused and launched


# --- compile_network(validate=) ----------------------------------------------

def test_compile_network_signature_is_jax_s_plus_device():
    """The port's `compile_network` takes JAX's keywords with JAX's
    defaults (``validate=True`` among them), plus its own ``device``."""
    import inspect

    from repro.core import pipeline as jpipe
    want = inspect.signature(jpipe.compile_network).parameters
    got = inspect.signature(pipeline.compile_network).parameters
    assert [n for n in got if n != "device"] == list(want)
    for name, p in want.items():
        assert (got[name].kind, got[name].default) == (p.kind, p.default)


def port_cfg(sizes, timesteps=3):
    return dataclasses.replace(
        IMDB, arch_id="ana-test", layer_sizes=tuple(sizes),
        timesteps=timesteps,
        spiking=dataclasses.replace(IMDB.spiking, timesteps=timesteps))


@pytest.mark.parametrize("domain", ["int", "float"])
@pytest.mark.parametrize("clamp", ["saturate", "wrap"])
def test_validate_false_compiles_the_same_program(domain, clamp):
    """With ``validate`` off or on, an accepted program is the same
    program: the same layers, weights, constants and scales."""
    for cfg, init in ((IMDB, snn.init_fc_snn), (MNIST, snn.init_lenet_snn)):
        params = init(3, cfg, device="cpu")
        progs = [pipeline.compile_network(cfg, params, domain=domain,
                                          clamp_mode=clamp, validate=v,
                                          device="cpu")
                 for v in (True, False)]
        a, b = progs
        assert (a.domain, a.clamp_mode, a.timesteps) == (
            b.domain, b.clamp_mode, b.timesteps)
        assert len(a.layers) == len(b.layers)
        for x, y in zip(a.layers, b.layers):
            for f in ("kind", "n_in", "n_out", "scale", "stride",
                      "state_shape", "quantize"):
                assert getattr(x, f) == getattr(y, f), f
            for f in ("w", "threshold", "leak"):
                u, v = getattr(x, f), getattr(y, f)
                if torch.is_tensor(u):
                    assert torch.equal(u, v), f
                else:
                    assert u == v, f


def jax_refusal(fn):
    """The pass ("range") or contract named by a JAX analysis refusal of
    ``fn()``, or None."""
    from repro.analysis import ContractError as JaxContractError
    from repro.analysis import RangeError as JaxRangeError
    try:
        fn()
    except JaxRangeError:
        return "range"
    except JaxContractError as e:
        return str(e)[len(e.where) + 2:].split(":")[0]
    return None


# FC stacks (logical widths) with the verdicts of JAX's dense Pallas
# contract and the port's dense cuda contract at T = 3, B = 1.
COMPILE_CASES = [
    ((100, 128, 128, 1), None, None),                  # the IMDB widths
    ((37, 250, 12, 90, 5), None, None),
    ((100,) + (64,) * 17 + (2,), None, "max_layers"),  # 18 layers
    ((1000, 1000, 2), None, "smem_budget"),
    ((4000, 4000, 2), "vmem_budget", "smem_budget"),
]


@pytest.mark.parametrize("sizes,jax_says,port_says", COMPILE_CASES)
def test_compile_refusals_match_jax_passes(sizes, jax_says, port_says):
    """JAX compiles the stack with ``validate=False`` and its range and
    contract passes are called directly (its ``validate=True`` raises
    `TraceError` on this JAX); the port compiles the same float params
    with the default ``validate=True``. Every JAX refusal is a port
    refusal, and the port's only extra ones are the cuda contract's
    ``smem_budget`` and ``max_layers`` (shared memory and 16 layers a
    launch, against 75 % of a TPU core's VMEM)."""
    import jax

    from repro.analysis import check_kernel_contracts as jax_contracts
    from repro.analysis import check_program as jax_check
    from repro.configs.base import SpikingConfig
    from repro.configs.impulse_snn import SNNModelConfig
    from repro.core import pipeline as jpipe
    from repro.core import snn as jsnn
    jcfg = SNNModelConfig(
        arch_id="ana-test", layer_sizes=sizes,
        spiking=SpikingConfig(neuron="rmp", timesteps=3, threshold=1.0,
                              leak=0.0625, w_bits=6, v_bits=11),
        timesteps=3)
    jparams = jsnn.init_fc_snn(jax.random.PRNGKey(len(sizes)), jcfg)
    jprog = jpipe.compile_network(jcfg, jparams, domain="int",
                                  validate=False)
    want = jax_refusal(lambda: jax_check(jprog)) or jax_refusal(
        lambda: jax_contracts(jprog, "pallas"))
    assert want == jax_says
    params = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = port_cfg(sizes)
    got = refusal(lambda: pipeline.compile_network(
        cfg, params, domain="int", device="cpu"))
    assert got == port_says
    if want is not None:
        assert got is not None
    else:
        assert got in (None, "smem_budget", "max_layers")
    prog = pipeline.compile_network(cfg, params, domain="int",
                                    validate=False, device="cpu")
    if got is None:
        ranges, contracts, traces = validate_program(prog)
        assert list(contracts) == ["cuda"]
        # the trace pass reports every int backend: traced, host or skipped
        assert set(traces) == {"int_ref", "cuda", "cuda_sparse",
                               "cuda_events", "ref_events", "bitmacro"}
        assert traces["cuda"].cost.macs == 3 * sum(
            a * b for a, b in zip(sizes[:-1], sizes[1:])) * 8
        assert_same_report(ranges, jax_check(jprog))


@pytest.mark.parametrize("clamp", ["saturate", "wrap"])
def test_validate_program_range_refusals_match_jax(clamp):
    """The range pass of `validate_program` refuses past the readout's
    safe horizon exactly where JAX's `check_program` does, naming the
    readout."""
    from repro.analysis import check_program as jax_check
    jprog, prog = jax_program(None, "rmp", clamp, (17, 12, 5, 2))
    safe = jax_check(jprog).max_safe_frames
    for frames in (safe, safe + 1):
        want = jax_refusal(lambda: jax_check(jprog, frames=frames))
        try:
            validate_program(prog, frames=frames)
            got = None
        except RangeError as e:
            got = "range"
            assert e.where.startswith("readout")
        assert got == want
    assert want == "range"
    ranges, contracts, traces = validate_program(pipeline.compile_network(
        IMDB, snn.init_fc_snn(0, IMDB, device="cpu"), domain="float",
        device="cpu"))
    assert list(contracts) == ["float"] and ranges.layers == ()
    assert traces == {}
