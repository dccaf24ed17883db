"""The port's trace pass (`repro_torch.analysis.trace_check`, `trace_cost`
and `validate_program`) on the CPU.

  * rejection: five deliberately broken torch functions (a float32
    round-trip, a duplicated clamp, an out-of-bounds slice, a clamp inside
    a ``torch.cond`` branch, a float64 product whose partial sums can pass
    2**53) are each refused by a `TraceError` naming the property and the
    aten node;
  * acceptance: every int backend's real dispatch, neuron x clamp mode, on
    the CPU and on a fake ``cuda`` device (where each ``cuda*`` launch is
    one named kernel node held to its plain twin), traces clean on every
    surface, launches nothing and reaches no kernel library;
  * the cost model: ``int_ref``'s MACs and bytes equal JAX's
    `build_cost_report` on programs carried across with
    `program_from_arrays`, and `check_cost_closure` equals JAX's;
  * `validate_program` has JAX's signature and rows.

JAX is imported inside the tests that compare with it. JAX's own trace
verdicts cannot serve as the oracle on this JAX (its ``check_trace``
refuses every program), so the port is held to their contract and to the
cost model, which still runs there.
"""
import inspect

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch import kernels
from repro_torch.analysis import (TRACE_BACKENDS, TraceError,
                                  TraceExpectation, check_cost_closure,
                                  check_graph, check_trace, validate_program)
from repro_torch.analysis.trace_check import trace
from repro_torch.configs.base import SpikingConfig
from repro_torch.configs.impulse_snn import IMDB, MNIST, SNNModelConfig
from repro_torch.core import pipeline, quant, snn

I8, I32, I64 = torch.int8, torch.int32, torch.int64


def _cfg(layer_sizes, neuron="rmp", timesteps=3, **kw):
    return SNNModelConfig(
        arch_id="trace-test", layer_sizes=layer_sizes,
        spiking=SpikingConfig(neuron=neuron, timesteps=timesteps,
                              threshold=1.0, leak=0.0625, w_bits=6,
                              v_bits=11),
        timesteps=timesteps, **kw)


def _program(layer_sizes, neuron="rmp", clamp_mode="saturate", seed=0,
             timesteps=3):
    cfg = _cfg(layer_sizes, neuron, timesteps)
    return pipeline.compile_network(
        cfg, snn.init_fc_snn(seed, cfg, device="cpu"), domain="int",
        clamp_mode=clamp_mode, validate=False, device="cpu")


def _refused(fn, specs, match, device="cpu", **expect):
    graph = trace(fn, specs, device)
    with pytest.raises(TraceError, match=match):
        check_graph(graph, TraceExpectation(where="bad", neuron="if",
                                            **expect))


# ---------------------------------------------------------------------------
# rejection: injected defects, each refused by name
# ---------------------------------------------------------------------------

_X, _W = ((4, 16), I32), ((16, 8), I32)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_float32_roundtrip_rejected(device):
    """An f32 product inside an int dispatch loses bit-identity past 2**24:
    the dtype pass names the float product."""
    def bad(x, w):
        acc = x.to(torch.float32) @ w.to(torch.float32)
        return quant.clamp_v(acc.to(torch.int32), "saturate")
    _refused(bad, (_X, _W), r"dtype: float torch.float32 .*aten.mm.default"
             r".*node 'mm'", device)


def test_duplicated_clamp_rejected():
    """Two stacked V-word clamps change wrap semantics and hide range bugs:
    the clamp pass counts heads against the ISA contract."""
    def bad(x, w):
        return quant.clamp_v(quant.clamp_v(x @ w, "saturate"), "saturate")
    _refused(bad, (_X, _W), r"clamp: 2 V-word clamp head\(s\).*exactly 1"
             r".*aten.clamp.default")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_out_of_bounds_slice_rejected(device):
    """A slice past its input is a silent wrong read (torch clips it): the
    bounds pass names the slice."""
    def bad(v):
        return quant.clamp_v(v[120:136], "saturate")
    _refused(bad, (((128,), I32),), r"bounds: 'aten.slice.Tensor' \(node "
             r"'slice.*'\).*\[120, 136\) of a dim-0 extent 128", device)


def test_clamp_inside_cond_rejected():
    """A clamp under predication breaks clamp-after-accumulate: the clamp
    pass names the clamp inside the ``torch.cond`` branch."""
    def bad(x, p):
        return torch.cond(p.sum() > 0,
                          lambda v: quant.clamp_v(v, "saturate"),
                          lambda v: v + 1, (x,))
    _refused(bad, (((4,), I32), ((3,), I32)),
             r"clamp: V-word clamp 'aten.clamp.default' \(node 'clamp'\) "
             r"inside a predicated subgraph at /cond.true_graph_0")


def test_float64_product_past_2_53_rejected():
    """The float64 product of `isa.int_matmul` is exact only while its
    partial sums stay below 2**53: int64 operands cannot be proven so."""
    def bad(x, w):
        acc = (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int64)
        return quant.clamp_v(acc, "saturate")
    _refused(bad, (((4, 16), I64), ((16, 8), I64)),
             r"dtype: float64 product 'aten.mm.default' \(node 'mm'\).*not "
             r"below 2\*\*53")
    # int8 operands bound every partial sum by 16 x 128 x 128
    graph = trace(bad, (((4, 16), I8), ((16, 8), I8)), "cpu")
    checks, _ = check_graph(graph, TraceExpectation(where="ok", neuron="if"))
    row = next(c for c in checks if c.prop == "float64_exact")
    assert "|partial sum| <= 262144 < 2**53" in row.detail


def test_unclamped_spike_check_and_rng_rejected():
    def no_clamp(x, w):
        v = x @ w
        return quant.clamp_v(v, "saturate"), v >= 3
    _refused(no_clamp, (_X, _W), r"clamp: SpikeCheck 'aten.ge.Scalar'.*"
             r"reads the product 'aten.mm.default'")

    def draws(x):
        return quant.clamp_v(x + torch.randint(0, 3, x.shape), "saturate")
    _refused(draws, (_X,), r"determinism: RNG op 'aten.randint")


def test_unknown_backend_float_domain_and_mesh_rejected():
    """An unknown backend and a float program are refused by name; a mesh
    is not (since the mesh path): ``mesh=`` adds the mesh surface, each
    model rank's row-partial tick."""
    program = _program((9, 7, 2), "if")
    with pytest.raises(TraceError, match="no int-domain trace"):
        check_trace(program, "no_such_backend")
    rep = check_trace(program, "cuda", mesh={"data": 2, "model": 2})
    assert [s.call for s in rep.surfaces if s.surface == "mesh"] == \
        ["fc_stack/model0", "fc_stack/model1"]
    _, contracts, traces = validate_program(program, mesh={"model": 2})
    assert any(c.contract == "mesh_split" for c in contracts["cuda"].checks)
    assert all(any(s.surface == "mesh" for s in traces[b].surfaces)
               for b in TRACE_BACKENDS)
    float_prog = pipeline.compile_network(
        _cfg((9, 7, 2)), snn.init_fc_snn(0, _cfg((9, 7, 2)), device="cpu"),
        validate=False, device="cpu")
    with pytest.raises(TraceError, match="int-domain dispatches only"):
        check_trace(float_prog, "int_ref")


# ---------------------------------------------------------------------------
# acceptance: real dispatches trace clean on every surface
# ---------------------------------------------------------------------------

@given(st.sampled_from([("if", "saturate"), ("lif", "wrap"),
                        ("rmp", "saturate"), ("rmp", "wrap")]),
       st.sampled_from(TRACE_BACKENDS), st.sampled_from(["cpu", "cuda"]))
@settings(max_examples=12, deadline=None)
def test_clean_dispatches_verify_on_every_surface(neuron_mode, backend,
                                                  device):
    """Property: every int backend's real dispatch verifies on all three
    surfaces for every neuron x clamp mode, on the CPU and on a fake CUDA
    device (one kernel node a surface for the ``cuda*`` backends), with a
    positive MAC count, and the trace launches nothing."""
    neuron, clamp_mode = neuron_mode
    program = _program((9, 7, 5, 2), neuron, clamp_mode)
    before = dict(kernels.LAUNCH_COUNTS)
    report = check_trace(program, backend, block_b=4, device=device)
    assert kernels.LAUNCH_COUNTS == before
    assert {s.surface for s in report.surfaces} == \
        {"batch", "step", "megastep"}
    per_step = {"if": 1, "lif": 2, "rmp": 2}[neuron] + (clamp_mode == "wrap")
    steps = {"batch": 3, "step": 1, "megastep": 2}
    for s in report.surfaces:
        assert s.clamps == steps[s.surface] * 2 * per_step
        kernel = device == "cuda" and backend != "int_ref"
        assert len(s.launches) == (1 if kernel else 0)
    assert report.cost is not None and report.cost.macs > 0
    props = {c.prop for c in report.checks}
    assert {"dtype", "float64_exact", "clamp_count", "clamp_dominance",
            "bounds", "cost_geometry"} <= props
    if device == "cuda" and backend != "int_ref":
        assert {"kernel_twin", "kernel_launch"} <= props


@pytest.mark.parametrize("backend", TRACE_BACKENDS)
def test_conv_program_traces_with_im2col_on_fake_cuda(backend):
    """The conv calls' streaming surfaces trace the im2col lowering ahead
    of the call (static slices checked), and the kernel nodes hold the
    patch raster's lanes."""
    program = _conv_program()
    report = check_trace(program, backend, device="cuda")
    calls = {s.call for s in report.surfaces}
    assert calls == {"conv[0]", "fc_stack"}
    mega = next(s for s in report.surfaces
                if (s.surface, s.call) == ("megastep", "conv[0]"))
    batch = next(s for s in report.surfaces
                 if (s.surface, s.call) == ("batch", "conv[0]"))
    assert mega.bounds_checked > batch.bounds_checked
    if backend != "int_ref":
        launch = [c for c in report.checks if c.prop == "kernel_launch"
                  and c.where == f"{backend}:megastep:conv[0]"]
        assert launch and "B=200" in launch[0].detail   # 2 lanes x 5 x 5


def test_fake_cuda_trace_reaches_no_kernel_library(monkeypatch):
    """Tracing the ``cuda*`` dispatch for a CUDA device builds, loads and
    launches nothing: the kernel node's fake implementation answers."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_snn_net import kernel

    def refuse(*a, **k):
        raise AssertionError("the trace reached the kernel library")
    monkeypatch.setattr(kernel, "_lib", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    program = _program((9, 7, 5, 2))
    before = dict(kernels.LAUNCH_COUNTS)
    for backend in ("cuda", "cuda_sparse", "cuda_events"):
        rep = check_trace(program, backend, device="cuda", use_cache=False)
        assert all(s.launches for s in rep.surfaces)
    assert kernels.LAUNCH_COUNTS == before


def test_kernel_operator_refusal_names_the_contract():
    """A geometry the kernel refuses is refused at trace time, by the same
    `launch_plan` rule the wrapper and the contract pass apply."""
    program = _program((3000, 100, 2), timesteps=2)
    with pytest.raises(TraceError, match="launch: .*smem_budget"):
        check_trace(program, "cuda", device="cuda", use_cache=False)


def test_trace_is_memoized_by_geometry():
    program = _program((9, 7, 5, 2), seed=3)
    first = check_trace(program, "int_ref")
    assert check_trace(program, "int_ref") is first
    assert check_trace(program, "int_ref", use_cache=False) is not first


# ---------------------------------------------------------------------------
# the cost model against JAX's
# ---------------------------------------------------------------------------

def _carry(jprog):
    """The port's copy of JAX program ``jprog`` on the CPU."""
    layers = [{"kind": ly.kind, "n_in": ly.n_in, "n_out": ly.n_out,
               "w": None if ly.w is None else np.asarray(ly.w),
               "threshold": (None if ly.threshold is None
                             else np.asarray(ly.threshold)),
               "leak": None if ly.leak is None else np.asarray(ly.leak),
               "scale": ly.scale, "stride": ly.stride,
               "state_shape": ly.state_shape} for ly in jprog.layers]
    return pipeline.program_from_arrays(
        layers, neuron=jprog.neuron, timesteps=jprog.timesteps,
        clamp_mode=jprog.clamp_mode, device="cpu")


def _jax_program(name, seed=0):
    import jax
    from repro.configs.base import SpikingConfig as JSpiking
    from repro.configs.impulse_snn import IMDB as JIMDB, MNIST as JMNIST
    from repro.configs.impulse_snn import SNNModelConfig as JCfg
    from repro.core import pipeline as jpipe, snn as jsnn
    key = jax.random.PRNGKey(seed)
    if name == "imdb":
        cfg, params = JIMDB, jsnn.init_fc_snn(key, JIMDB)
    elif name == "mnist":
        cfg, params = JMNIST, jsnn.init_lenet_snn(key, JMNIST)
    elif name == "lenet-s":        # tests/test_mesh_snn.py's conv program
        cfg = JCfg(arch_id="lenet-s", conv_spec=((4, 3, 1), (6, 3, 2)),
                   in_shape=(8, 8, 1), layer_sizes=(4 * 4 * 6, 10, 3),
                   spiking=JSpiking(neuron="rmp", timesteps=2, threshold=1.0,
                                    leak=0.0625, w_bits=6, v_bits=11),
                   timesteps=2, task="multiclass")
        params = jsnn.init_lenet_snn(key, cfg)
    elif name == "lenet":          # tests/test_trace_check.py's conv program
        cfg = JCfg(arch_id="trace-lenet", conv_spec=((4, 3, 1), (6, 3, 2)),
                   in_shape=(10, 10, 1), layer_sizes=(5 * 5 * 6, 16, 4),
                   spiking=JSpiking(neuron="if", timesteps=2, threshold=1.0,
                                    leak=0.0625, w_bits=6, v_bits=11),
                   timesteps=2, task="multiclass")
        params = jsnn.init_lenet_snn(key, cfg)
    else:                          # a seeded FC stack "fc:w0-w1-...:neuron"
        _, sizes, neuron = name.split(":")
        cfg = JCfg(arch_id="trace-fc",
                   layer_sizes=tuple(int(w) for w in sizes.split("-")),
                   spiking=JSpiking(neuron=neuron, timesteps=3,
                                    threshold=1.0, leak=0.0625, w_bits=6,
                                    v_bits=11), timesteps=3)
        params = jsnn.init_fc_snn(key, cfg)
    return jpipe.compile_network(cfg, params, domain="int", validate=False)


def _conv_program():
    cfg = SNNModelConfig(
        arch_id="trace-lenet", conv_spec=((4, 3, 1), (6, 3, 2)),
        in_shape=(10, 10, 1), layer_sizes=(5 * 5 * 6, 16, 4),
        spiking=SpikingConfig(neuron="if", timesteps=2, threshold=1.0,
                              leak=0.0625, w_bits=6, v_bits=11),
        timesteps=2, task="multiclass")
    return pipeline.compile_network(
        cfg, snn.init_lenet_snn(0, cfg, device="cpu"), domain="int",
        validate=False, device="cpu")


@pytest.mark.parametrize("name", ["imdb", "mnist", "lenet",
                                  "fc:17-12-5-2:rmp", "fc:9-7-5-2:lif",
                                  "fc:130-24-3:if"])
def test_int_ref_cost_equals_jax(name):
    """``int_ref`` charges the dispatch's operands and results once and its
    dense products, as JAX does: equal MACs and bytes per call."""
    from repro.analysis import trace_check as jtc
    from repro.analysis import trace_cost as jcost
    jprog = _jax_program(name)
    traced = jtc._trace_surfaces(
        jprog, "int_ref", ("batch",), batch=8, block_b=8, megastep_k=2,
        mesh_axes=(), gate_granularity=1, event_crossover=1.0)
    want = jcost.build_cost_report(
        jprog, "int_ref", {call: j for _s, call, j, _e in traced},
        batch=8, block_b=8)
    got = check_trace(_carry(jprog), "int_ref").cost
    assert [(c.call, c.macs, c.hbm_bytes) for c in got.calls] == \
        [(c.call, c.macs, c.hbm_bytes) for c in want.calls]
    assert got.instr == want.instr
    if name == "imdb":
        assert (got.macs, got.hbm_bytes) == (2_344_960, 66_016)
    if name == "mnist":
        assert (got.macs, got.hbm_bytes) == (7_741_440, 198_112)


@pytest.mark.parametrize("name,batch", [("imdb", 8), ("mnist", 8),
                                        ("fc:17-12-5-2:rmp", 4),
                                        ("lenet", 2)])
def test_cost_closure_equals_jax(name, batch):
    from repro.analysis import check_cost_closure as jax_closure
    jprog = _jax_program(name)
    got = check_cost_closure(_carry(jprog), batch=batch)
    assert tuple(got) == tuple(jax_closure(jprog, batch=batch))
    if (name, batch) == ("imdb", 8):
        assert tuple(got) == (421_760, 3_520, 3_520, 0)
    if (name, batch) == ("mnist", 8):
        assert tuple(got) == (10_568_320, 89_120, 81_120, 0)


def test_kernel_node_cost_is_its_operands_and_results():
    """A kernel node charges each operand and result once: the dense
    mode's IMDB call at K = 10, B = 32 with v_init and rasters moves
    209,024 bytes for 9,379,840 MACs."""
    from repro_torch.analysis.trace_cost import dispatch_cost
    cost = dispatch_cost((100, 128, 128, 1), 10, 32, v_init=True,
                         device="cuda")
    assert (cost.hbm_bytes, cost.macs) == (209_024, 9_379_840)
    assert cost.launches == ("fused_snn_net",)
    gated = dispatch_cost((100, 128, 128, 1), 10, 32, v_init=True,
                          backend="cuda_sparse", gate_granularity=8,
                          device="cuda")
    assert gated.hbm_bytes == 209_024 + 4 * 4 * (7 + 8 + 8)


# ---------------------------------------------------------------------------
# validate_program
# ---------------------------------------------------------------------------

def test_validate_program_signature_equals_jax():
    from repro.analysis import validate_program as jax_validate
    assert inspect.signature(validate_program) == \
        inspect.signature(jax_validate)


def test_validate_program_rows_and_skips():
    """Every int backend gets a report: the traced ones their surfaces, the
    host executors a named skip row, and a backend whose contract refuses
    the program a ``contract_skip`` row rather than a failed compile."""
    program = _program((9, 7, 5, 2))
    _, contracts, traces = validate_program(program)
    assert set(contracts) == {"cuda"}
    assert set(traces) == set(TRACE_BACKENDS) | {"ref_events", "bitmacro"}
    assert traces["ref_events"].checks[0].prop == "host_backend"
    assert traces["bitmacro"].checks[0].prop == "contract_skip"  # saturate
    assert all(len(traces[b].surfaces) == 3 for b in TRACE_BACKENDS)
    wide = _program((3000, 100, 2), timesteps=2)
    _, _, traces = validate_program(wide, backends=("int_ref",))
    assert len(traces["int_ref"].surfaces) == 3
    for b in ("cuda", "cuda_sparse", "cuda_events"):
        row = traces[b].checks[0]
        assert (row.prop, traces[b].surfaces) == ("contract_skip", ())
        assert "smem_budget" in row.detail


def test_compile_network_runs_the_trace_pass(monkeypatch):
    """``compile_network(validate=True)`` runs all three passes on an int
    program; a float program is not traced."""
    from repro_torch import analysis
    seen = []
    real = analysis.validate_program

    def spy(program, **kw):
        out = real(program, **kw)
        seen.append(out[2])
        return out
    monkeypatch.setattr(analysis, "validate_program", spy)
    pipeline.compile_network(IMDB, snn.init_fc_snn(0, IMDB, device="cpu"),
                             domain="int", device="cpu")
    pipeline.compile_network(MNIST, snn.init_lenet_snn(0, MNIST,
                                                       device="cpu"),
                             device="cpu")
    assert set(seen[0]) == set(TRACE_BACKENDS) | {"ref_events", "bitmacro"}
    assert seen[0]["cuda"].cost.macs == 2_344_960
    assert seen[1] == {}


def test_check_invariants_gate():
    from repro_torch.launch.check_invariants import main
    assert main(["--lint-only"]) == 0
    assert main(["--analyze-only"]) == 0


# ---------------------------------------------------------------------------
# the mesh surface
# ---------------------------------------------------------------------------

MESH = {"data": 2, "model": 2}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", ["imdb", "lenet-s"])
def test_mesh_surface_reduces_each_layer_once_per_rank(name, device):
    """On a (2, 2) mesh every int backend's trace gains one graph per
    model rank and fused call, each with one reduction node per layer, no
    kernel node, the call's clamp heads, and the reduction-dominance row;
    nothing launches."""
    program = _carry(_jax_program(name))
    before = dict(kernels.LAUNCH_COUNTS)
    for backend in TRACE_BACKENDS:
        rep = check_trace(program, backend, mesh=MESH, device=device)
        calls = {s.call for s in rep.surfaces if s.surface != "mesh"}
        mesh = [s for s in rep.surfaces if s.surface == "mesh"]
        assert sorted(s.call for s in mesh) == sorted(
            f"{c}/model{r}" for c in calls for r in range(2))
        for s in mesh:
            n_layers = (3 if name == "imdb" else 2) \
                if s.call.startswith("fc_stack") else 1
            assert s.reductions == n_layers and s.launches == ()
            assert s.clamps == 2 * (n_layers - s.call.startswith(
                "fc_stack"))           # rmp: 2 heads a spiking layer
        rows = [c for c in rep.checks if c.prop == "clamp_dominance"
                and ":mesh:" in c.where]
        assert rows and all("cross-rank reduction(s) of unclamped "
                            "partials" in c.detail for c in rows)
    assert kernels.LAUNCH_COUNTS == before


def _tick_specs(n=2):
    return (((4, 16), I8), [((16 // n, 8), I8), ((8 // n, 3), I8)],
            [((4, 8), I32), ((4, 3), I32)])


def test_mesh_tick_with_clamp_before_the_reduction_rejected(monkeypatch):
    """A row-partial tick whose partial V is clamped before the cross-rank
    all-reduce is refused by name: the reduction must sum unclamped
    partials. A SpikeCheck that reads the reduction with no clamp between
    is refused too."""
    from repro_torch.kernels.fused_snn_net import ops
    real = ops.accv2v_all_reduce
    monkeypatch.setattr(ops, "accv2v_all_reduce", lambda p, g: real(
        quant.clamp_v(p, "saturate"), g))

    def tick(frame, ws_l, vs):
        return ops.mesh_rowpartial_tick(
            vs, (), frame, ws_l, widths=(16, 8, 3), n_spiking=1,
            thresholds=(3,), leaks=(1,), neuron="if", clamp_mode="saturate",
            use_events=False, model_rank=1, group="model")
    graph = trace(tick, _tick_specs(), "cpu")
    with pytest.raises(TraceError, match=r"clamp: V-word clamp "
                       r"'aten.clamp.default' .* upstream of the cross-rank "
                       r"reduction 'repro_torch.accv2v_all_reduce"):
        check_graph(graph, TraceExpectation(where="bad", neuron="if",
                                            extra_clamps=2))
    monkeypatch.setattr(ops, "accv2v_all_reduce", real)
    checks, st = check_graph(trace(tick, _tick_specs(), "cpu"),
                             TraceExpectation(where="ok", neuron="if"))
    assert st["reductions"] == 2

    def reads_sum(x, w, v):
        total = real(ops.int_matmul(x, w), "model")
        return quant.clamp_v(v + total, "saturate"), (v + total) >= 3
    with pytest.raises(TraceError, match=r"SpikeCheck .* reads the "
                       r"cross-rank reduction"):
        check_graph(trace(reads_sum, (((4, 16), I8), ((16, 8), I8),
                                      ((4, 8), I32)), "cpu"),
                    TraceExpectation(where="bad", neuron="if"))


def _split_rows(checks, rename=None) -> dict:
    """{call: the mesh_split row's split} and the mesh_axes row."""
    out = {}
    for c in checks:
        if c.contract == "mesh_axes":
            out["mesh"] = c.detail
        elif c.contract == "mesh_split":
            call = (rename or {}).get(c.where, c.where)
            out[call] = c.detail.split("-row shard tiles")[0]
    return out


@pytest.mark.parametrize("shape", [(4, 1), (1, 4), (2, 2)])
@pytest.mark.parametrize("name", ["imdb", "lenet-s"])
def test_validate_program_mesh_rows_equal_jax(name, shape):
    """`validate_program(mesh=)` returns the ``mesh_axes`` row and a
    ``mesh_split`` row per call whose padded fan-in rows and per-rank row
    tiles are JAX's `check_kernel_contracts(mesh=)`'s on the same
    program; the trace pass runs clear with the mesh surface."""
    from repro.analysis import check_kernel_contracts as jax_contracts
    jprog = _jax_program(name)
    mesh = {"data": shape[0], "model": shape[1]}
    _, contracts, traces = validate_program(_carry(jprog), mesh=mesh)
    want = _split_rows(jax_contracts(jprog, "pallas", mesh=mesh).checks)
    got = _split_rows(contracts["cuda"].checks, {"fc": "fc_stack"})
    assert got == want and len(got) == 1 + (2 if name == "lenet-s" else 1)
    assert all(traces[b].surfaces for b in TRACE_BACKENDS)
    assert all(any(s.surface == "mesh" for s in traces[b].surfaces)
               == (shape[1] > 1) for b in TRACE_BACKENDS)


def test_check_invariants_mesh_runs_clear():
    from repro_torch.launch.check_invariants import main
    assert main(["--analyze-only", "--mesh"]) == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "cuda_sparse", "cuda_events"])
def test_card_trace_launches_nothing_and_the_kernel_node_runs(cuda_device,
                                                              backend):
    """On the card the trace of a program on the card shows its kernel
    nodes and launches nothing; the eager dispatch through the same
    operator launches once and equals the plain twin bit for bit."""
    from repro_torch.kernels.fused_snn_net.ops import (fused_snn_net,
                                                       fused_snn_net_ref)
    cfg = _cfg((9, 7, 5, 2))
    program = pipeline.compile_network(
        cfg, snn.init_fc_snn(0, cfg, device=cuda_device), domain="int",
        validate=False, device=cuda_device)
    before = dict(kernels.LAUNCH_COUNTS)
    rep = check_trace(program, backend, use_cache=False)
    assert kernels.LAUNCH_COUNTS == before
    assert all(len(s.launches) == 1 for s in rep.surfaces)
    rng = np.random.default_rng(0)
    spikes = torch.from_numpy(
        (rng.random((3, 8, 9)) > 0.5).astype(np.int8)).to(cuda_device)
    ws = [spec.w for spec in program.fc_stack]
    ths = tuple(int(s.threshold) for s in program.fc_stack[:-1])
    lks = tuple(int(s.leak) for s in program.fc_stack[:-1])
    flags = dict(use_sparse=backend == "cuda_sparse",
                 use_events=backend == "cuda_events")
    got = fused_snn_net(spikes, ws, thresholds=ths, leaks=lks, **flags)
    want = fused_snn_net_ref(spikes, ws, ths, lks, neuron="rmp",
                             clamp_mode="saturate", **flags)
    name = rep.surfaces[0].launches[0]
    assert kernels.LAUNCH_COUNTS[name] == before[name] + 1
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
