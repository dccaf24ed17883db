"""Static pre-dispatch verification of the CUDA fused-network kernels'
contracts.

The kernels (`kernels/fused_snn_net`) refuse some stacks and options at
launch. This pass finds the same refusals from the program and the
dispatch options alone, before anything runs, and names them: it rejects a
bad dispatch with a `ContractError` naming the contract and the call
(``conv[i]`` for the i-th on-macro conv, ``fc`` for the fc stack). The
card's refusals are not re-derived here: each call goes through
`kernel.launch_plan`, the one function the kernel wrapper also calls
before every launch, so the pass accepts exactly the calls the wrapper
launches.

  contract          | what is verified
  ------------------|-----------------------------------------------------
  backend           | a known backend; bitmacro demands wrap arithmetic
                    | and has no streaming entry
  chain_alignment   | layer i's fan-in == layer i-1's fan-out (flattened
                    | across the conv -> fc boundary); a conv's fan-in is
                    | its k*k*c_in patch width
  megastep          | a streaming dispatch advances K >= 1 frames a call
  gate_granularity  | granularity in GATE_GRANULARITIES; sub-tile gating
                    | only on the gated path (cuda_sparse or use_sparse),
                    | which excludes the event-list kernel
  event_crossover   | the event-list kernel's crossover lies in [0, 1]
  block_b           | 1 to 1,024 lanes a CTA (`launch_plan`)
  max_layers        | 1 to MAX_LAYERS = 16 layers a call (`launch_plan`)
  event_index       | event-list fan-in below 2**16: the kernel indexes
                    | rows with uint16 (`launch_plan`)
  skip_layout       | the gated mode's columns fit MAX_SKIP_COLS
                    | (`launch_plan`)
  smem_budget       | the call's shared memory (the dense mode's
                    | `dense_plan`, the gated mode's `smem_layout`, the
                    | event-list mode's `event_layout`) fits SMEM_LIMIT
                    | (`launch_plan`)
  mesh_axes         | (``mesh=``) float and bitmacro have no mesh
                    | execution; the data and model extents are >= 1
  mesh_split        | (``mesh=``, CUDA backends) every call's fan-in rows,
                    | padded to the model extent (`ops.mesh_padded_widths`),
                    | split evenly into per-rank row tiles, and one rank's
                    | residency (the call's shared memory with its weight
                    | tiles cut to 1/n_model: JAX's per-shard formula, held
                    | to SMEM_LIMIT in place of VMEM) fits

Each on-macro conv runs one call on its (K, batch*P, k*k*C) patch raster;
the fc stack is one more call on (K, batch, n_in). ``int_ref``,
``ref_events`` and ``bitmacro`` launch no kernel and carry only the
backend, chain-alignment and megastep contracts. On a mesh each data rank
launches its share of the lanes, ceil(batch / n_data) a rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.analysis.intervals import AnalysisError
from repro_torch.core.pipeline import BACKENDS, STREAM_BACKENDS
from repro_torch.kernels.fused_snn_net.kernel import (GATE_GRANULARITIES,
                                                      SMEM_LIMIT,
                                                      KernelRefused, _align16,
                                                      launch_plan)
from repro_torch.kernels.fused_snn_net.ops import mesh_padded_widths
from repro_torch.launch.mesh import mesh_extents

CUDA_BACKENDS = ("cuda", "cuda_sparse", "cuda_events")


class ContractError(AnalysisError):
    """A kernel contract is violated for this (program, dispatch) pair;
    ``contract`` names it and ``where`` the call."""

    def __init__(self, contract: str, message: str, *, where: str) -> None:
        super().__init__(f"{contract}: {message}", where=where)
        self.contract = contract


@dataclass(frozen=True)
class ContractCheck:
    """One verified contract: name, where it was checked, the numbers."""
    contract: str
    where: str
    detail: str


@dataclass(frozen=True)
class KernelCall:
    """The checked geometry of one kernel launch of the dispatch."""
    name: str                  # "conv[i]" | "fc"
    mode: str                  # dense | gated | events
    widths: tuple              # (n_in, n_out_0, n_out_1, ...)
    frames: int                # T of the call (K when streaming)
    lanes: int                 # B of the call (batch * P for a conv)
    cta_lanes: int             # lanes a CTA takes (`launch_plan`)
    grid: int
    smem_bytes: int


@dataclass(frozen=True)
class ContractReport:
    backend: str
    block_b: int
    frames: int
    calls: tuple               # tuple[KernelCall, ...] (empty off the card)
    checks: tuple              # tuple[ContractCheck, ...] all satisfied

    @property
    def smem_bytes(self) -> int:
        """The largest shared memory of one call (calls run in turn)."""
        return max((c.smem_bytes for c in self.calls), default=0)


def _flat_width(spec) -> int:
    """Flattened output width of a layer (conv output maps flatten into
    the first FC's fan-in)."""
    return int(np.prod(spec.state_shape)) if spec.state_shape else spec.n_out


def _check_chain(program, checks: list) -> None:
    cur: Optional[int] = None
    for idx, spec in enumerate(program.layers):
        name = f"{spec.kind}[{idx}] {spec.n_in}x{spec.n_out}"
        if spec.kind in ("fc", "readout"):
            if cur is not None and spec.n_in != cur:
                raise ContractError(
                    "chain_alignment", f"fan-in {spec.n_in} != {cur} lanes "
                    "emitted by the previous layer", where=name)
        elif spec.kind == "conv" and spec.w is not None:
            kh, kw, c_in = spec.w.shape[:3]
            if spec.n_in != kh * kw * c_in:
                raise ContractError(
                    "chain_alignment", f"im2col fan-in {spec.n_in} != "
                    f"{kh}x{kw}x{c_in} patch width", where=name)
        cur = _flat_width(spec)
    checks.append(ContractCheck("chain_alignment", "program",
                                f"{len(program.layers)} layers aligned"))


def _program_calls(program, batch: int) -> list:
    """(name, widths, lanes) of every kernel call of one dispatch."""
    calls = []
    for i, spec in enumerate(program.int_conv_stack):
        p = int(np.prod(spec.state_shape[:-1]))
        calls.append((f"conv[{i}]", (spec.n_in, spec.n_out), batch * p))
    stack = program.fc_stack
    calls.append(("fc", (stack[0].n_in,) + tuple(s.n_out for s in stack),
                  batch))
    return calls


def _weight_bytes(layout: dict, widths: tuple) -> int:
    """Shared-memory bytes of a call's weight tiles in its ``layout``."""
    return sum(_align16(n_out * ld * 4)
               for n_out, ld in zip(widths[1:], layout["wt_ld"]))


def check_kernel_contracts(program, backend: str, *,
                           frames: Optional[int] = None, batch: int = 1,
                           block_b: int = 8, gate_granularity: int = 1,
                           event_crossover: float = 1.0,
                           use_sparse: bool = False,
                           emit_rasters: bool = True,
                           streaming: bool = False,
                           mesh=None) -> ContractReport:
    """Verify every contract of dispatching ``program`` on ``backend`` with
    these options; raise `ContractError` naming the contract and the call
    otherwise.

    ``frames`` is each call's T (default ``program.timesteps``; a
    streaming engine passes its K). ``batch`` is the fc call's lanes (the
    engine's ``batch_slots``); each conv call runs ``batch`` x P lanes, P
    its output positions. ``use_sparse`` gates a ``cuda`` dispatch as
    `pipeline.stream_megastep` does. ``emit_rasters`` is recorded: the
    kernels write rasters to global memory, so it moves no shared memory.
    Returns the `ContractReport` of the checks and of each call with its
    shared-memory bytes.

    ``mesh`` (an `launch.mesh.SNNMesh` or an ``{axis: extent}`` dict, no
    process group needed) adds the mesh contracts: float and bitmacro
    refuse a mesh, each data rank's calls are checked at its share of the
    lanes, and each call's model-parallel row split keeps its chain
    alignment and fits one rank's shared memory (``mesh_split``)."""
    if frames is None:
        frames = int(program.timesteps)
    checks: list = []
    if streaming:
        if not isinstance(frames, int) or frames < 1:
            raise ContractError(
                "megastep", f"a streaming dispatch advances K >= 1 frames "
                f"per call, got K={frames!r}", where="stream")
        checks.append(ContractCheck(
            "megastep", "stream", f"K={frames} frame(s) per dispatch"))
    if backend not in BACKENDS:
        raise ContractError("backend", f"unknown execution backend "
                            f"{backend!r}; have {sorted(BACKENDS)}",
                            where="backend")
    if streaming and backend not in STREAM_BACKENDS:
        raise ContractError("backend", f"{backend!r} has no streaming entry "
                            "(its state lives in host BitMacro objects)",
                            where="backend")
    if backend != "float" and program.domain != "int":
        raise ContractError(
            "backend", f"backend {backend!r} executes int-domain programs "
            f"only; this program is domain={program.domain!r} "
            "(compile_network(..., domain='int'))", where="backend")
    if backend == "bitmacro" and program.clamp_mode != "wrap":
        raise ContractError(
            "backend", "bitmacro executes silicon wrap arithmetic; compile "
            "the program with clamp_mode='wrap'", where="backend")
    n_data = n_model = 1
    if mesh is not None:
        if backend in ("float", "bitmacro"):
            raise ContractError(
                "mesh_axes", f"backend {backend!r} has no mesh execution "
                "(float reductions are not order-exact; bitmacro state "
                "lives in host BitMacro objects)", where="mesh")
        sizes = mesh_extents(mesh)
        n_data, n_model = sizes.get("data", 1), sizes.get("model", 1)
        if n_data < 1 or n_model < 1:
            raise ContractError(
                "mesh_axes", f"axis extents must be >= 1, got data={n_data} "
                f"model={n_model}", where="mesh")
        checks.append(ContractCheck(
            "mesh_axes", "mesh",
            f"data={n_data} (lanes/banks partition) x model={n_model} "
            f"(row-tiled fan-in partition); axes {sorted(sizes)}"))
        batch = -(-batch // n_data)        # a data rank's lanes
    _check_chain(program, checks)
    if backend not in CUDA_BACKENDS:
        return ContractReport(backend=backend, block_b=block_b, frames=frames,
                              calls=(), checks=tuple(checks))

    events = backend == "cuda_events"
    gated = not events and (backend == "cuda_sparse" or use_sparse)
    if gate_granularity not in GATE_GRANULARITIES:
        raise ContractError(
            "gate_granularity", f"must be one of {GATE_GRANULARITIES}, got "
            f"{gate_granularity}", where=backend)
    if events and use_sparse:
        raise ContractError(
            "gate_granularity", "row-block gating (use_sparse) and the "
            "event-list kernel are exclusive", where=backend)
    if gate_granularity != 1 and not gated:
        raise ContractError(
            "gate_granularity", f"sub-tile gating (granularity "
            f"{gate_granularity}) needs the gated path (cuda_sparse, or "
            f"use_sparse=True), not {backend!r}", where=backend)
    if events:
        if not 0.0 <= event_crossover <= 1.0:
            raise ContractError(
                "event_crossover", f"the dense-fallback crossover must lie "
                f"in [0, 1], got {event_crossover}", where=backend)
        checks.append(ContractCheck("event_crossover", backend,
                                    f"crossover {event_crossover}"))
    mode = "events" if events else "gated" if gated else "dense"
    calls = []
    for name, widths, lanes in _program_calls(program, batch):
        try:
            plan = launch_plan(widths, frames, lanes, mode=mode,
                               block_b=block_b,
                               gate_granularity=gate_granularity,
                               neuron=program.neuron,
                               clamp_mode=program.clamp_mode)
        except KernelRefused as e:
            raise ContractError(e.contract, str(e), where=name) from e
        smem = plan["layout"]["bytes"]
        checks.append(ContractCheck(
            "smem_budget", name, f"{mode} mode, widths {widths}, T={frames}, "
            f"B={lanes}: {smem} bytes <= {SMEM_LIMIT}, {plan['lanes']} "
            f"lanes a CTA, grid {plan['grid']}"))
        if gated:
            checks.append(ContractCheck(
                "skip_layout", name, f"{plan['n_skip_cols']} gate columns "
                f"at granularity {gate_granularity}"))
        if mesh is not None:
            mw = mesh_padded_widths(widths, n_model)
            rows = tuple(w // n_model for w in mw[:-1])
            if any(w % n_model for w in mw):
                raise ContractError(       # unreachable by construction
                    "mesh_split", f"padded widths {mw} do not divide "
                    f"n_model={n_model}", where=name)
            # one rank's residency: its weight tiles shrink to 1/n_model
            # (each rank holds its row tile); spike and V blocks stay full
            # width (the input is replicated, the partial V is full width
            # before the all-reduce)
            w_bytes = _weight_bytes(plan["layout"], widths)
            smem_shard = smem - w_bytes + -(-w_bytes // n_model)
            if smem_shard > SMEM_LIMIT:
                raise ContractError(
                    "mesh_split", f"one model rank holds {smem_shard} bytes "
                    f"(weights/{n_model} + full-width spike/V blocks) > "
                    f"budget {SMEM_LIMIT}", where=name)
            checks.append(ContractCheck(
                "mesh_split", name,
                f"fan-in rows {mw[:-1]} split {n_model}-way into "
                f"{rows}-row shard tiles (chain alignment preserved: "
                f"every shard slices the same padded fan-in; the all-reduce "
                f"reassembles the full width); per-shard residency "
                f"{smem_shard} bytes <= {SMEM_LIMIT}"))
        calls.append(KernelCall(
            name=name, mode=mode, widths=tuple(int(w) for w in widths),
            frames=frames, lanes=lanes, cta_lanes=plan["lanes"],
            grid=plan["grid"], smem_bytes=smem))
    checks.append(ContractCheck(
        "block_b", backend, f"block_b={block_b}; every call of at most "
        f"16 layers (max_layers) and, on the event list, fan-in < 2**16 "
        f"(event_index); rasters {'on' if emit_rasters else 'off'}"))
    return ContractReport(backend=backend, block_b=block_b, frames=frames,
                          calls=tuple(calls), checks=tuple(checks))
