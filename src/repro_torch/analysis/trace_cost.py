"""Static cost model over the traced dispatch graphs, the port of
`repro.analysis.trace_cost`.

Walks the same aten graphs `trace_check` verifies and counts, per fused
call, the multiply-accumulates and the device-memory bytes the dispatch
moves, then ties that tally back to the ISA contract:

* **geometry validation**: a torch trace unrolls the timestep loop, so
  every layer of a call must show exactly T product sites (a kernel node
  counts as T sites of each of its layers), each contracting the declared
  widths (K = the layer's fan-in, N = its fan-out) over the batch
  (M = the call's lanes). A product that contracts anything else means the
  dispatch silently changed shape: a `TraceError`, not a cost.
* **cost closure**: `dense_instr` folds the trace-validated geometry (T,
  batch, logical widths, neuron kind) through
  `isa.count_layer_instructions_from_events` with dense (every-input-
  spiking) events; `check_cost_closure` proves it equal to
  `pipeline.count_network_instructions` on explicit all-ones rasters.

Conventions of the bytes model: a kernel node moves each operand and
result once (input raster, weights, ``v_init``, rasters, V and its
counters), and its MACs are the dense T x B x sum(N_i x N_{i+1}). A call
with no kernel node (``int_ref``, or any backend on the CPU) charges its
dispatch's operands and results once, as JAX's ``int_ref`` does, so the
``int_ref`` report equals JAX's. MACs are dense products: a ``torch.cond``
counts its costlier branch, and a product inside a ``while_loop`` (a
dynamic trip count) is refused. `dispatch_cost` gives one fused call's
cost from the same walk, for bounds that need its bytes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.analysis.trace_check import (TraceCheck, TraceError, _aten,
                                              _kernel_name, _program_calls,
                                              _Region, _sub_regions,
                                              _tensors, _val)
from repro_torch.core import isa


@dataclass(frozen=True)
class DotSite:
    """One product: its contracted geometry and how many timesteps it
    stands for (1 for an unrolled product, T for a kernel node's layer)."""
    m: int
    k: int
    n: int
    trip: int

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n * self.trip


@dataclass(frozen=True)
class CallCost:
    """Cost of one fused call's batch dispatch."""
    call: str
    macs: int
    hbm_bytes: int
    dots: tuple                    # tuple[DotSite, ...]
    launches: tuple                # kernel names of the call's launches


@dataclass(frozen=True)
class TraceCostReport:
    """Per-dispatch MAC/byte tallies plus the dense ISA instruction counts
    derived from the trace-validated geometry. ``instr`` must close exactly
    against `pipeline.count_network_instructions` on all-ones rasters
    (`check_cost_closure`)."""
    backend: str
    batch: int
    timesteps: int
    calls: tuple                   # tuple[CallCost, ...]
    instr: isa.InstrCount

    @property
    def macs(self) -> int:
        return sum(c.macs for c in self.calls)

    @property
    def hbm_bytes(self) -> int:
        return sum(c.hbm_bytes for c in self.calls)


def _nbytes(val) -> int:
    return sum(int(t.numel()) * t.element_size() for t in _tensors(val))


def _walk_cost(region, dots: list, bytes_acc: list, launches: list,
               where: str) -> None:
    for node in region.gm.graph.nodes:
        if node.op != "call_function":
            continue
        name = _aten(node)
        kernel = _kernel_name(node)
        if kernel is not None:
            spikes, ws = node.args[0], node.args[1]
            T, B, _ = (int(s) for s in _val(spikes).shape)
            for w in ws:
                k, n = (int(s) for s in _val(w).shape)
                dots.append(DotSite(m=B, k=k, n=n, trip=T))
            operands = [_val(a) for a in (spikes, *ws, *node.args[2])]
            bytes_acc.append(_nbytes(operands) + _nbytes(_val(node)))
            launches.append(kernel)
        elif name in ("mm", "matmul", "addmm"):
            a, b = (_val(x) for x in node.args[-2:])
            dots.append(DotSite(m=int(np.prod(a.shape[:-1])),
                                k=int(a.shape[-1]), n=int(b.shape[-1]),
                                trip=1))
        elif name in ("bmm", "baddbmm"):
            a, b = (_val(x) for x in node.args[-2:])
            dots.append(DotSite(m=int(a.shape[0] * a.shape[1]),
                                k=int(a.shape[2]), n=int(b.shape[2]), trip=1))
        subs = _sub_regions(node, region)
        if not subs:
            continue
        if str(node.target).endswith("while_loop"):
            for sub in subs:
                before = len(dots)
                _walk_cost(sub, dots, bytes_acc, launches, where)
                if len(dots) != before:
                    raise TraceError(
                        "cost: product inside a 'while_loop' at "
                        f"{sub.path or '/'}: a dynamic trip count cannot be "
                        "statically accounted", where=where)
        else:                      # cond: the costliest branch (dense bound)
            branches = []
            for sub in subs:
                bd: list = []
                _walk_cost(sub, bd, bytes_acc, launches, where)
                branches.append(bd)
            branches.sort(key=lambda bd: sum(d.macs for d in bd))
            dots.extend(branches[-1])


def _validate_geometry(program, call: str, widths: tuple, cost: CallCost,
                       *, batch: int, where: str) -> None:
    """Exactly T product sites of each layer's (fan-in, fan-out) over the
    batch, and no other product."""
    T = int(program.timesteps)
    layers = list(zip(widths[:-1], widths[1:]))
    for k, n in set(layers):
        want = T * layers.count((k, n))
        got = sum(d.trip for d in cost.dots if (d.k, d.n) == (k, n))
        if got != want:
            raise TraceError(
                f"cost: {got} product site(s) contracting K={k} N={n} in the "
                f"traced '{call}' dispatch, want {want} (T={T} x "
                f"{layers.count((k, n))} layer(s)); traced "
                f"{[(d.m, d.k, d.n, d.trip) for d in cost.dots]} — the "
                "dispatch changed shape", where=where)
    stray = [d for d in cost.dots if (d.k, d.n) not in layers]
    if stray:
        raise TraceError(
            f"cost: product(s) {[(d.m, d.k, d.n) for d in stray]} in "
            f"'{call}' contract no declared layer of widths {widths}",
            where=where)
    if any(d.m != batch for d in cost.dots):
        raise TraceError(
            f"cost: product rows {sorted({d.m for d in cost.dots})} in "
            f"'{call}', want the {batch}-lane batch", where=where)


def call_cost(graph, call: str, where: str) -> CallCost:
    """The `CallCost` of one traced dispatch graph."""
    dots: list = []
    bytes_acc: list = []
    launches: list = []
    _walk_cost(_Region(graph, ""), dots, bytes_acc, launches, where)
    if not launches:               # no kernel node: charge the dispatch
        nodes = list(graph.graph.nodes)
        bytes_acc = [sum(_nbytes(_val(n)) for n in nodes
                         if n.op == "placeholder")
                     + _nbytes([_val(a) for a in torch.utils._pytree
                                .tree_leaves(nodes[-1].args)
                                if isinstance(a, torch.fx.Node)])]
    return CallCost(call=call, macs=sum(d.macs for d in dots),
                    hbm_bytes=int(sum(bytes_acc)), dots=tuple(dots),
                    launches=tuple(launches))


def dispatch_cost(widths: tuple, T: int, B: int, *, readout: bool = True,
                  v_init: bool = False, emit_rasters: bool = True,
                  backend: str = "cuda", block_b: int = 8,
                  gate_granularity: int = 1, device="cuda") -> CallCost:
    """The cost of one fused call of logical ``widths`` over T frames and
    B lanes on ``backend``, from the graph of its dispatch traced on fake
    tensors of ``device`` (nothing runs): on a CUDA device a ``cuda*``
    backend's call is its kernel node, whose bytes are its operands and
    results (with ``v_init`` and rasters as asked) and whose MACs are the
    dense T x B x sum(N_i x N_{i+1}). The event-list crossover moves no
    byte, so the call takes the default."""
    from repro_torch.analysis.trace_check import trace
    from repro_torch.kernels.fused_snn_net.ops import (fused_snn_net,
                                                       fused_snn_net_ref)
    n_spiking = len(widths) - 2 if readout else len(widths) - 1
    ths, lks = (1,) * n_spiking, (0,) * n_spiking
    kw = dict(neuron="rmp", clamp_mode="saturate", readout=readout,
              emit_rasters=emit_rasters)
    if backend == "int_ref":
        def run(s, ws, vi):
            return fused_snn_net_ref(s, ws, ths, lks, v_init=vi or None,
                                     block_b=B, **kw)
    else:
        flags = dict(use_sparse=backend == "cuda_sparse",
                     gate_granularity=gate_granularity,
                     use_events=backend == "cuda_events")

        def run(s, ws, vi):
            return fused_snn_net(s, ws, thresholds=ths, leaks=lks,
                                 v_init=vi or None, block_b=block_b,
                                 **flags, **kw)
    i8, i32 = torch.int8, torch.int32
    specs = (((T, B, widths[0]), i8),
             [((a, b), i8) for a, b in zip(widths[:-1], widths[1:])],
             [((B, n), i32) for n in widths[1:]] if v_init else [])
    graph = trace(run, specs, device)
    return call_cost(graph, backend, f"{backend}:dispatch_cost")


def _conv_input_maps(program) -> list:
    """(H, W, C) input spike-map shape of every on-macro conv: the state
    shape of the layer before it (the encoder conv's for the first)."""
    shapes = []
    for spec in program.int_conv_stack:
        j = next(j for j, ly in enumerate(program.layers) if ly is spec)
        shapes.append(tuple(int(s) for s in program.layers[j - 1].state_shape))
    return shapes


def _dense_conv_counts(in_map: tuple, kernel: int, stride: int) -> tuple:
    """(positions, events per frame pair): for a SAME-padded conv over an
    all-ones (H, W, C) map, the output position count and the total
    non-padding patch cells per (example, timestep); border patches see
    the zero padding, so the dense event count is less than positions x
    k*k*C. Pure numpy re-derivation of the im2col geometry."""
    from repro_torch.core.mapping import same_pads
    h, w, c = in_map
    h_out, lo_h, hi_h = same_pads(h, kernel, stride)
    w_out, lo_w, hi_w = same_pads(w, kernel, stride)
    p = np.pad(np.ones((h, w), np.int64), ((lo_h, hi_h), (lo_w, hi_w)))
    cells = 0
    for di in range(kernel):
        for dj in range(kernel):
            cells += int(p[di:di + (h_out - 1) * stride + 1:stride,
                           dj:dj + (w_out - 1) * stride + 1:stride].sum())
    return h_out * w_out, cells * c


def dense_instr(program, batch: int) -> isa.InstrCount:
    """ISA instruction counts for the dense (every-input-spiking) workload
    of ``program`` at ``batch`` lanes, folded from the trace-validated
    geometry: per macro-stack layer, frames = T x batch x output positions
    and events from the SAME-padded patch geometry (conv) or frames x
    fan-in (fc), through the `count_layer_instructions_from_events` the
    raster accounting uses."""
    T = int(program.timesteps)
    counts = isa.InstrCount()
    conv_maps = iter(_conv_input_maps(program))
    for spec in program.macro_stack:
        if spec.kind == "conv":
            in_map = next(conv_maps)
            pos, ev_frame = _dense_conv_counts(
                in_map, int(spec.w.shape[0]), int(spec.stride))
            want_pos = int(np.prod(spec.state_shape[:-1], dtype=np.int64))
            if pos != want_pos:
                raise TraceError(
                    f"cost: conv geometry drift — SAME-padded im2col of "
                    f"{in_map} gives {pos} output positions, the program "
                    f"state shape {spec.state_shape} declares {want_pos}",
                    where="cost_closure")
            frames = T * batch * pos
            events = T * batch * ev_frame
        else:
            frames = T * batch
            events = frames * int(spec.n_in)
        neuron = "none" if spec.kind == "readout" else program.neuron
        counts += isa.count_layer_instructions_from_events(
            events, frames, int(spec.n_in), int(spec.n_out), neuron)
    return counts


def dense_rasters(program, batch: int) -> list:
    """All-ones input rasters of every macro-stack layer of ``program`` at
    ``batch`` lanes: the explicit dense workload
    `pipeline.count_network_instructions` counts (conv layers take their
    full input spike map, which the counter lowers through the im2col the
    macro executes)."""
    T = int(program.timesteps)
    conv_maps = iter(_conv_input_maps(program))
    out = []
    for spec in program.macro_stack:
        if spec.kind == "conv":
            out.append(np.ones((T, batch, *next(conv_maps)), np.int8))
        else:
            out.append(np.ones((T, batch, int(spec.n_in)), np.int8))
    return out


def check_cost_closure(program, batch: int = 8) -> isa.InstrCount:
    """Prove the trace-geometry dense counts of ``program`` at ``batch``
    lanes equal the raster-accounting dense counts exactly; returns the
    agreed `InstrCount` or raises `TraceError` naming both."""
    from repro_torch.core.pipeline import count_network_instructions
    got = dense_instr(program, batch)
    want = count_network_instructions(program,
                                      rasters=dense_rasters(program, batch))
    if got != want:
        raise TraceError(
            f"cost: dense instruction closure failed — trace-geometry "
            f"counts {got} != raster-accounting counts {want}; the "
            "dispatch and the ISA accounting describe different workloads",
            where="cost_closure")
    return got


def build_cost_report(program, backend: str, batch_graphs: dict, *,
                      batch: int, block_b: int,
                      checks: list = None) -> TraceCostReport:
    """Cost-walk every fused call's traced batch graph of ``program`` on
    ``backend`` (``batch_graphs``: call name -> graph at ``batch`` lanes;
    ``block_b`` is the kernels' tile), validate its geometry, and fold the
    dense ISA counts. Appends `TraceCheck` rows to ``checks`` when
    given."""
    calls = []
    for name, _layer_names, widths, _n_spiking in _program_calls(program):
        graph = batch_graphs.get(name)
        if graph is None:
            continue
        where = f"{backend}:cost:{name}"
        cost = call_cost(graph, name, where)
        _validate_geometry(program, name, widths, cost, batch=batch,
                           where=where)
        if checks is not None:
            checks.append(TraceCheck(
                "cost_geometry", where,
                f"{len(cost.dots)} product site(s) match the declared "
                f"widths (block_b {block_b}); macs={cost.macs} "
                f"hbm_bytes={cost.hbm_bytes}"))
        calls.append(cost)
    return TraceCostReport(backend=backend, batch=batch,
                           timesteps=int(program.timesteps),
                           calls=tuple(calls),
                           instr=dense_instr(program, batch))
