"""Static verification of compiled SNN programs, before they run.

Four passes, composable and individually importable:

  * `check_program`: interval abstract interpretation of the word-level
    ISA; proves weights on the 6-bit grid, constants in the 11-bit V word
    and that no unclamped int32 accumulator can overflow (a per-layer
    `RangeReport` with the readout's ``max_safe_frames``, or a
    `RangeError` naming the layer).
  * `check_kernel_contracts`: the CUDA kernels' contracts of one dispatch
    (layers, lanes, event indices, gate columns, shared memory), decided
    by the same `kernels.fused_snn_net.kernel.launch_plan` the kernel
    wrapper calls (a `ContractReport`, or a `ContractError` naming the
    contract and the call).
  * `check_trace`: aten-graph verification of the dispatch the port runs:
    every int backend's batch, step and megastep dispatch (and, on a mesh
    of model extent above 1, each model rank's row-partial tick) is traced
    on fake tensors (`make_fx`, nothing runs) and checked for dtype
    discipline (with the float64 exactness rule of `isa.int_matmul`),
    determinism, clamp count and dominance, index bounds, and each kernel
    launch as one named node held to its plain twin, plus a static
    MAC/byte cost model that closes against the ISA instruction counts (a
    `TraceReport`, or a `TraceError` naming the property, the aten op and
    its node, and the backend/surface).
  * `lint_paths`: AST repo lint (ANA001 bare asserts, ANA002 ad-hoc
    clamps, ANA003 unseeded randomness, ANA004 undocumented API, ANA005
    float casts in int-domain modules); pure stdlib.

`validate_program` runs the first three; `pipeline.compile_network(...,
validate=True)` (the default) calls it on every program it compiles, and
`serve.SNNServeEngine(validate=True)` runs the range and contract passes
when it is built. `python -m repro_torch.launch.check_invariants` runs all
four.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.analysis.intervals import (INT32, V_DOMAIN, AnalysisError,
                                            Interval, clamp_interval,
                                            wrap_is_exact)
from repro_torch.analysis.kernel_contracts import (CUDA_BACKENDS,
                                                   ContractCheck,
                                                   ContractError,
                                                   ContractReport,
                                                   KernelCall,
                                                   check_kernel_contracts)
from repro_torch.analysis.lint import (RULES, LintViolation, lint_file,
                                       lint_paths, lint_source)
from repro_torch.analysis.program_check import (LayerRange, RangeError,
                                                RangeReport, check_program)
from repro_torch.analysis.trace_check import (HOST_BACKENDS, SURFACES,
                                              TRACE_BACKENDS, TraceCheck,
                                              TraceError, TraceExpectation,
                                              TraceReport, check_graph,
                                              check_trace)
from repro_torch.analysis.trace_cost import (CallCost, TraceCostReport,
                                             check_cost_closure, dense_instr)

__all__ = [
    "AnalysisError", "CUDA_BACKENDS", "CallCost", "ContractCheck",
    "ContractError", "ContractReport", "HOST_BACKENDS", "INT32", "Interval",
    "KernelCall", "LayerRange", "LintViolation", "RULES", "RangeError",
    "RangeReport", "SURFACES", "TRACE_BACKENDS", "TraceCheck",
    "TraceCostReport", "TraceError", "TraceExpectation", "TraceReport",
    "V_DOMAIN", "check_cost_closure", "check_graph",
    "check_kernel_contracts", "check_program", "check_trace",
    "clamp_interval", "dense_instr", "lint_file", "lint_paths",
    "lint_source", "validate_program", "wrap_is_exact",
]


def validate_program(program, *, frames: Optional[int] = None,
                     backends: Optional[tuple] = None,
                     trace: Optional[bool] = None,
                     trace_backends: Optional[tuple] = None, **contract_kw
                     ) -> tuple:
    """Run the range pass, the kernel-contract pass and the trace pass on
    ``program``; return ``(RangeReport, {backend: ContractReport},
    {backend: TraceReport})`` and raise the first `AnalysisError` found.
    This is what `compile_network(..., validate=True)` executes at compile
    time.

    ``frames`` is each call's T for the range and contract passes.
    ``backends`` defaults to the dense ``cuda`` contract for int-domain
    programs (the dispatch every integer backend shares its geometry with)
    and the trivial ``float`` contract otherwise; pass an explicit tuple
    to verify gated/event dispatches with their own knobs
    (``gate_granularity``, ``event_crossover``, ``block_b``, ... via
    ``contract_kw``).

    ``trace`` defaults on for int-domain programs; ``trace_backends``
    defaults to every int backend: the device-dispatched ones
    (`TRACE_BACKENDS`) get the batch/step/megastep surfaces traced for the
    program's device, the host executors (`HOST_BACKENDS`) a named skip
    row, and a backend whose own contract refuses the program (a stack
    the kernel cannot take) a ``contract_skip`` row instead of failing the
    compile; asking for that backend in ``backends`` raises its
    `ContractError`. Trace results are memoized by geometry, so
    re-validating an unchanged program is free. ``mesh`` (in
    ``contract_kw``: an `launch.mesh.SNNMesh` or an ``{axis: extent}``
    dict) adds the ``mesh_axes``/``mesh_split`` contract rows and the
    trace pass's mesh surface."""
    if backends is None:
        backends = ("cuda",) if program.domain == "int" else ("float",)
    ranges = check_program(program, frames=frames)
    contracts = {b: check_kernel_contracts(program, b, frames=frames,
                                           **contract_kw)
                 for b in backends}
    if trace is None:
        trace = program.domain == "int"
    traces = {}
    if trace:
        if trace_backends is None:
            trace_backends = TRACE_BACKENDS + HOST_BACKENDS
        trace_kw = {k: contract_kw[k] for k in
                    ("gate_granularity", "event_crossover", "block_b",
                     "mesh") if k in contract_kw}
        for b in trace_backends:
            # a backend whose own kernel contract refuses this program
            # (shared memory, layer-count caps, clamp-mode requirements)
            # has no dispatch to trace: record the refusal, don't fail
            try:
                bkw = dict(trace_kw)
                if b in HOST_BACKENDS:
                    bkw.pop("mesh", None)      # their own skip row
                if b != "cuda_sparse":
                    bkw.pop("gate_granularity", None)
                if b != "cuda_events":
                    bkw.pop("event_crossover", None)
                check_kernel_contracts(program, b, frames=frames, **bkw)
            except ContractError as e:
                traces[b] = TraceReport(
                    backend=b, surfaces=(), cost=None,
                    checks=(TraceCheck("contract_skip", b, str(e)),))
                continue
            traces[b] = check_trace(program, b, **trace_kw)
    return ranges, contracts, traces
