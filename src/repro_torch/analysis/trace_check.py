"""Aten-graph verification of the compiled kernel dispatches, the port of
`repro.analysis.trace_check`.

`program_check` and `kernel_contracts` prove properties re-derived from the
config; this pass verifies the dispatch the port actually runs. Every int
backend's real dispatch of each fused call (``conv[i]`` and ``fc_stack``):
`ops.fused_snn_net` on (spikes, ws) (batch), its ``v_init`` step entry
(step) and the K-frame megastep (megastep: a conv's im2col patch lowering
ahead of the call, the readout trajectory ``v_init + cumsum(raster @
W_ro)`` behind the fc stack's, `pipeline.stream_megastep`), and with a
mesh of model extent above 1 each model rank's row-partial tick (mesh:
`ops.mesh_rowpartial_tick`, the all-reduce one node), is traced to an
aten graph with `torch.fx.experimental.proxy_tensor.make_fx` on fake
tensors of the program's device (or any other: the tests trace a fake
``cuda`` device on a host without one), and statically checked:

  property         | what is verified on the traced graph
  -----------------|----------------------------------------------------
  dtype            | no float value anywhere on the int-domain path, and
                   | every integer product accumulates in int32 or int64;
                   | one exception, its own ``float64_exact`` row: a
                   | float64 ``mm`` whose operands are casts of integer
                   | tensors and whose result goes straight back to an
                   | integer type, accepted when interval analysis proves
                   | every partial sum below 2**53 in magnitude (CUDA has
                   | no integer matmul: `isa.int_matmul`)
  determinism      | no RNG ops; no float ``scatter_add``/``index_add``/
                   | ``index_put(accumulate=True)``
  clamp placement  | exactly T x the contracted number of V-word clamp
                   | heads per dispatch (the trace unrolls the timestep
                   | loop; ``aten.clamp``/``clamp_min``/``maximum`` against
                   | V_MIN, ``remainder`` by V_SPAN), every one in the
                   | program's mode, none inside a ``torch.cond``/
                   | ``while_loop`` subgraph; every SpikeCheck (``ge``)
                   | chain meets a clamp before it reaches a product or
                   | the cross-rank reduction; no clamp lies upstream of
                   | a reduction (``repro_torch.accv2v_all_reduce``): the
                   | AccV2V reduction sums *unclamped* partials
  bounds           | every static ``slice``/``select``/``narrow`` lies
                   | within its input's shape, and every ``index``/
                   | ``gather``/``index_select`` index has an interval
                   | bound inside its extent
  kernel launch    | on a CUDA device each launch of a ``cuda*`` backend
                   | is one named node (``repro_torch.fused_snn_net``,
                   | ``..._gated``, ``..._events``: the kernels' custom
                   | operators); its operands are int8 spikes and weights
                   | and int32 ``v_init``, its geometry is one that
                   | `kernel.launch_plan` takes, and a trace launches
                   | nothing (`kernels.LAUNCH_COUNTS` does not move)
  kernel twin      | a kernel node's body is opaque to the graph, so its
                   | clamp, dominance, bounds and dtype contract is checked
                   | on the graph of its plain twin `ops.fused_snn_net_ref`
                   | with the node's operands and flags (the card holds the
                   | kernel to that twin bit for bit)

Violations raise `TraceError` naming the property, the aten op and its
node, the graph path and the backend/surface/call. The companion
`trace_cost` walks the same batch graphs into a `TraceCostReport` (MACs,
bytes) whose instruction tally closes exactly against
`pipeline.count_network_instructions`.

The mesh surface is traced when ``mesh`` (an `launch.mesh.SNNMesh` or
an ``{axis: extent}`` dict; no process group needed) has a model extent
above 1: one graph per model rank, each with one reduction node per
layer. Unlike the JAX package, ``check_trace`` traces no mesh surface when
``mesh`` is not given (JAX defaults to a 2 x 2 mesh).

Entry points: `check_trace(program, backend)` (per-backend `TraceReport`,
memoized by geometry) and the low-level `check_graph(graph, expect)` that
the negative-path tests drive with deliberately broken functions.
`analysis.validate_program` runs `check_trace` for every int backend.
"""
from __future__ import annotations

import contextlib
import operator
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.analysis.intervals import AnalysisError, Interval
from repro_torch.core.quant import V_MIN, V_SPAN

#: int backends whose dispatch is a torch computation we can trace
TRACE_BACKENDS = ("int_ref", "cuda", "cuda_sparse", "cuda_events")
#: int backends that execute on the host (numpy / BitMacro objects): no
#: graph exists; `check_trace` returns a named skip row for them
HOST_BACKENDS = ("ref_events", "bitmacro")
#: the dispatch surfaces one backend trace covers ("mesh" only with a
#: mesh of model extent above 1)
SURFACES = ("batch", "step", "megastep", "mesh")
#: the cross-rank AccV2V reduction's operator (`ops.accv2v_all_reduce`)
_REDUCE_OP = "accv2v_all_reduce"
#: float64 represents every integer below this magnitude exactly
F64_EXACT = 2 ** 53

#: kernel node target namespace and the mode of each kernel's operator
_KERNEL_NS = "repro_torch"
_KERNEL_MODES = {"fused_snn_net": "dense", "fused_snn_net_gated": "gated",
                 "fused_snn_net_events": "events"}
_RNG_OPS = {"rand", "rand_like", "randn", "randn_like", "randint",
            "randint_like", "randperm", "bernoulli", "multinomial",
            "normal", "uniform", "exponential", "geometric", "cauchy",
            "log_normal", "random", "native_dropout", "poisson",
            "binomial", "rrelu_with_noise", "_standard_gamma",
            "_sample_dirichlet", "_fused_dropout"}
#: ops that accumulate in an order the run picks (float sums reorder)
_ACCUMULATE_OPS = {"scatter_add", "index_add", "scatter_reduce",
                   "index_reduce", "_index_put_impl"}
#: integer products (AccW2V) and the float64 ones of `isa.int_matmul`
_PRODUCT_OPS = {"mm", "bmm", "addmm", "matmul", "dot", "mv", "baddbmm"}
#: ops that view their first argument (a write through one reaches it)
_VIEW_OPS = {"view", "_unsafe_view", "reshape", "select", "slice", "narrow",
             "expand", "unsqueeze", "squeeze", "t", "transpose", "permute",
             "alias", "diagonal", "as_strided", "unfold", "split",
             "view_as", "detach"}
#: value-preserving ops: the interval and the constant pass through
_PASSTHROUGH = _VIEW_OPS | {"clone", "contiguous", "lift_fresh_copy",
                            "repeat", "flatten", "_to_copy", "to",
                            "amax", "amin"}
_MAX_DEPTH = 64
_INT64_END = 2 ** 62            # slice ends at or past this mean "to the end"


class TraceError(AnalysisError):
    """A traced dispatch violates the ISA contract (the finding names the
    property, the aten op and its node, its graph path, and the
    backend/surface/call)."""


@dataclass(frozen=True)
class TraceCheck:
    """One verified trace property: name, where it held, the numbers."""
    prop: str
    where: str
    detail: str


@dataclass(frozen=True)
class TraceExpectation:
    """What the checker demands of one traced dispatch surface, per
    timestep of the dispatch."""
    where: str                     # "backend:surface:call" finding label
    neuron: str = "rmp"
    clamp_mode: str = "saturate"
    n_spiking: int = 1
    mesh_axes: tuple = ()          # the mesh surface's axes (multi-GPU)
    extra_clamps: int = 0          # heads beyond the neuron contract
    reductions: int = 0            # cross-rank reductions a mesh tick makes

    @property
    def expected_clamps(self) -> int:
        per = {"if": 1, "lif": 2, "rmp": 2}[self.neuron]
        if self.clamp_mode == "wrap":
            per += 1               # the SpikeCheck comparison itself wraps
        return self.n_spiking * per + self.extra_clamps


@dataclass(frozen=True)
class SurfaceTrace:
    """Checked facts of one traced (surface, call) dispatch."""
    surface: str
    call: str
    clamps: int
    spike_reads: int
    bounds_checked: int
    eqns: int                      # graph nodes, the kernel twins' included
    launches: tuple = ()           # kernel nodes, by kernel name
    reductions: int = 0            # cross-rank reduction nodes (mesh)


@dataclass(frozen=True)
class TraceReport:
    backend: str
    surfaces: tuple                # tuple[SurfaceTrace, ...]
    checks: tuple                  # tuple[TraceCheck, ...] all satisfied
    cost: Any = None               # trace_cost.TraceCostReport (batch)


# ---------------------------------------------------------------------------
# graph regions: one (sub)graph + parent linkage
# ---------------------------------------------------------------------------

class _Region:
    """One graph nesting level: its module, the binding of its
    placeholders to parent values, and whether it runs predicated (a
    ``torch.cond`` branch or a ``while_loop`` body)."""

    __slots__ = ("gm", "path", "parent", "bindings", "predicated",
                 "mutated")

    def __init__(self, gm, path: str, parent=None, bindings=None,
                 predicated: bool = False):
        self.gm = gm
        self.path = path
        self.parent = parent
        self.bindings = bindings or {}
        self.predicated = predicated
        self.mutated = _mutated_bases(gm.graph)


def _kind(node) -> str:
    """``aten.clamp`` for an ``aten.clamp.default`` node, the kernel
    operator's ``repro_torch.<name>``, ``higher_order.cond``, ``getitem``."""
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        return f"{t.namespace}.{t._opname}"
    if isinstance(t, torch._ops.HigherOrderOperator):
        return f"higher_order.{t.name()}"
    if t is operator.getitem:
        return "getitem"
    return str(t)


def _aten(node) -> Optional[str]:
    """The aten op name of a node without its in-place underscore
    (``add`` for ``aten.add_.Tensor``), or None for other nodes."""
    if node.op != "call_function":
        return None
    k = _kind(node)
    if not k.startswith("aten."):
        return None
    name = k[5:]
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


def _label(node) -> str:
    return f"'{node.target}' (node '{node.name}')"


def _at(region) -> str:
    return region.path or "/"


def _kernel_name(node) -> Optional[str]:
    """The kernel name of a kernel-operator node, else None."""
    t = node.target
    if (node.op == "call_function" and isinstance(t, torch._ops.OpOverload)
            and t.namespace == _KERNEL_NS and t._opname in _KERNEL_MODES):
        return t._opname
    return None


def _is_reduction(node) -> bool:
    """True for a node of the cross-rank reduction operator."""
    t = node.target
    return (node.op == "call_function" and isinstance(t, torch._ops.OpOverload)
            and t.namespace == _KERNEL_NS and t._opname == _REDUCE_OP)


def _arg(node, i: int, name: str, default=None):
    if len(node.args) > i:
        return node.args[i]
    return node.kwargs.get(name, default)


def _val(x):
    return x.meta.get("val") if isinstance(x, torch.fx.Node) else None


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _tensors(val) -> list:
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [t for v in val for t in _tensors(v)]
    return []


def _view_base(node):
    while (isinstance(node, torch.fx.Node) and _aten(node) in _VIEW_OPS
           and node.args):
        node = node.args[0]
    return node


def _mutated_bases(graph) -> set:
    """Nodes whose value an in-place op (``copy_``, ``add_``, ...) writes
    through themselves or a view: their creator's interval does not hold
    after the write."""
    out = set()
    for node in graph.nodes:
        if node.op != "call_function" or not node.args:
            continue
        k = _kind(node)
        if k.startswith("aten.") and k.endswith("_") and \
                not k[5:].startswith("_"):
            out.add(_view_base(node.args[0]))
    return out


def _sub_regions(node, region) -> list:
    """Child regions of one node: the branches of ``torch.cond`` (bound to
    its operands, predicated), the cond and body graphs of ``while_loop``
    (the additional inputs bound, the carried ones not: binding them to
    their first values would be wrong from iteration 2 on; predicated), and
    any other higher-order op's graphs (unbound)."""
    if node.op != "call_function" or not isinstance(
            node.target, torch._ops.HigherOrderOperator):
        return []
    k = _kind(node)

    def sub(arg):
        if isinstance(arg, torch.fx.Node) and arg.op == "get_attr":
            mod = getattr(region.gm, arg.target, None)
            if isinstance(mod, torch.fx.GraphModule):
                return mod, arg.target
        return None, None

    def ph(gm):
        return [n for n in gm.graph.nodes if n.op == "placeholder"]

    out = []
    if k == "higher_order.cond":
        operands = list(node.args[3]) if len(node.args) > 3 else []
        for arg in node.args[1:3]:
            gm, name = sub(arg)
            if gm is not None:
                out.append(_Region(gm, f"{region.path}/cond.{name}", region,
                                   dict(zip(ph(gm), operands)), True))
    elif k == "higher_order.while_loop":
        carried = list(node.args[2]) if len(node.args) > 2 else []
        extra = list(node.args[3]) if len(node.args) > 3 else []
        for arg in node.args[:2]:
            gm, name = sub(arg)
            if gm is not None:
                out.append(_Region(
                    gm, f"{region.path}/while_loop.{name}", region,
                    dict(zip(ph(gm)[len(carried):], extra)), True))
    else:
        for arg in node.args:
            gm, name = sub(arg)
            if gm is not None:
                out.append(_Region(gm, f"{region.path}/{k}.{name}", region,
                                   None, region.predicated))
    return out


def _walk(region):
    """Yield (node, region) for every call at every nesting depth."""
    for node in region.gm.graph.nodes:
        if node.op != "call_function":
            continue
        yield node, region
        for sub in _sub_regions(node, region):
            yield from _walk(sub)


# ---------------------------------------------------------------------------
# constants and intervals
# ---------------------------------------------------------------------------

_CONST_BINOPS = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "maximum": max, "minimum": min,
    "eq": lambda a, b: int(a == b), "ne": lambda a, b: int(a != b),
    "lt": lambda a, b: int(a < b), "le": lambda a, b: int(a <= b),
    "gt": lambda a, b: int(a > b), "ge": lambda a, b: int(a >= b),
}
_FILL_OPS = {"full": 1, "full_like": 1, "new_full": 2, "scalar_tensor": 0}
_ZERO_OPS = {"zeros": 0, "zeros_like": 0, "new_zeros": 0, "ones": 1,
             "ones_like": 1, "new_ones": 1}


def _const(x, region, depth: int = 0):
    """The python scalar ``x`` (a literal or a node) is statically known to
    hold, through bindings, value-preserving ops, fills and elementwise
    arithmetic; None when not statically known."""
    if depth > _MAX_DEPTH:
        return None
    if isinstance(x, bool):
        return int(x)
    if isinstance(x, (int, float)):
        return x
    if not isinstance(x, torch.fx.Node):
        return None
    if x.op == "placeholder":
        if x in region.bindings and region.parent is not None:
            return _const(region.bindings[x], region.parent, depth + 1)
        return None
    if x.op == "get_attr":
        t = getattr(region.gm, x.target, None)
        if isinstance(t, torch.Tensor) and t.numel() == 1 and \
                not _is_fake(t):
            return t.reshape(()).item()
        return None
    name = _aten(x)
    if name is None:
        return None
    if name in _FILL_OPS:
        return _const(_arg(x, _FILL_OPS[name], "fill_value"), region,
                      depth + 1)
    if name in _ZERO_OPS:
        return _ZERO_OPS[name]
    if name in _PASSTHROUGH:
        return _const(x.args[0], region, depth + 1)
    if name == "neg":
        a = _const(x.args[0], region, depth + 1)
        return None if a is None else -a
    if name in _CONST_BINOPS and len(x.args) >= 2:
        a = _const(x.args[0], region, depth + 1)
        b = _const(x.args[1], region, depth + 1)
        if a is None or b is None:
            return None
        if name in ("add", "sub"):
            b = b * x.kwargs.get("alpha", 1)
        return _CONST_BINOPS[name](a, b)
    if name == "where" and len(x.args) == 3:
        c = _const(x.args[0], region, depth + 1)
        if c is not None:
            return _const(x.args[1 if c else 2], region, depth + 1)
    return None


def _dtype_interval(dtype) -> Optional[Interval]:
    if dtype is None:
        return None
    if dtype == torch.bool:
        return Interval(0, 1)
    if dtype.is_floating_point or dtype.is_complex:
        return None
    ii = torch.iinfo(dtype)
    return Interval(int(ii.min), int(ii.max))


def _node_dtype(x):
    v = _val(x)
    return v.dtype if isinstance(v, torch.Tensor) else None


def _cmp_interval(name: str, a, b) -> Interval:
    """Bool interval of a comparison from its operand intervals."""
    if a is not None and b is not None:
        if name in ("lt", "le"):
            strict = name == "lt"
            if a.hi < b.lo or (not strict and a.hi <= b.lo):
                return Interval(1, 1)
            if a.lo > b.hi or (strict and a.lo >= b.hi):
                return Interval(0, 0)
        elif name in ("gt", "ge"):
            strict = name == "gt"
            if a.lo > b.hi or (not strict and a.lo >= b.hi):
                return Interval(1, 1)
            if a.hi < b.lo or (strict and a.hi <= b.lo):
                return Interval(0, 0)
        elif name == "eq" and (a.hi < b.lo or a.lo > b.hi):
            return Interval(0, 0)
        elif name == "ne" and (a.hi < b.lo or a.lo > b.hi):
            return Interval(1, 1)
    return Interval(0, 1)


def _hull(ivs) -> Optional[Interval]:
    ivs = list(ivs)
    if not ivs or any(iv is None for iv in ivs):
        return None
    return Interval(min(iv.lo for iv in ivs), max(iv.hi for iv in ivs))


def _prod(a: Interval, b: Interval) -> Interval:
    p = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi]
    return Interval(min(p), max(p))


def _n_fold(a: Interval, n: int) -> Interval:
    """Interval of a sum of ``n`` terms each in ``a``."""
    return Interval(min(a.lo * n, a.lo), max(a.hi * n, a.hi))


def _ival(x, region, env: dict, depth: int = 0) -> Optional[Interval]:
    """Best-effort interval of a literal's or a node's value (None =
    unknown; a float value is unknown). A node written in place (or
    through a view) takes its dtype's range."""
    if depth > _MAX_DEPTH:
        return None
    if isinstance(x, bool):
        return Interval(int(x), int(x))
    if isinstance(x, int):
        return Interval(x, x)
    if not isinstance(x, torch.fx.Node):
        return None
    key = (id(region), x)
    if key in env:
        return env[key]
    env[key] = None                # cycle guard
    iv = _ival_raw(x, region, env, depth)
    dt = _dtype_interval(_node_dtype(x))
    if iv is not None and dt is not None:
        iv = iv.intersect(dt) or dt
    env[key] = iv
    return iv


def _ival_raw(x, region, env, depth) -> Optional[Interval]:
    dtype = _node_dtype(x)
    dt = _dtype_interval(dtype)
    if x.op == "placeholder":
        if x in region.bindings and region.parent is not None:
            return _ival(region.bindings[x], region.parent, env, depth + 1)
        return dt
    if x.op == "get_attr":
        t = getattr(region.gm, x.target, None)
        if isinstance(t, torch.Tensor) and t.numel() and \
                not t.dtype.is_floating_point and not _is_fake(t):
            return Interval(int(t.min()), int(t.max()))
        return dt
    if x.op != "call_function":
        return dt
    if _view_base(x) in region.mutated:
        return dt
    c = _const(x, region)
    if isinstance(c, int):
        return Interval(c, c)
    name = _aten(x)
    if name is None:
        return dt                  # kernel outputs, getitem: the dtype's

    def op(i):
        return _ival(x.args[i], region, env, depth + 1)

    if name in ("cat", "stack"):
        return _hull(_ival(a, region, env, depth + 1) for a in x.args[0])
    if name in ("_to_copy", "to"):
        a = op(0)                  # a cast that does not fit wraps
        return dt if a is None or (dt is not None and not dt.contains(a)) \
            else a
    if name in _PASSTHROUGH:
        return op(0)
    if name in ("add", "sub"):
        a, b = op(0), op(1)
        if a is None or b is None:
            return None
        alpha = x.kwargs.get("alpha", 1)
        b = _prod(b, Interval(alpha, alpha))
        return a + b if name == "add" else a - b
    if name == "mul":
        a, b = op(0), op(1)
        return None if a is None or b is None else _prod(a, b)
    if name == "neg":
        a = op(0)
        return None if a is None else Interval(-a.hi, -a.lo)
    if name in ("maximum", "minimum"):
        a, b = op(0), op(1)
        if a is None or b is None:
            return None
        f = max if name == "maximum" else min
        return Interval(f(a.lo, b.lo), f(a.hi, b.hi))
    if name in ("clamp", "clamp_min", "clamp_max"):
        lo = (_const(_arg(x, 1, "min"), region) if name != "clamp_max"
              else None)
        hi = (_const(_arg(x, 2 if name == "clamp" else 1, "max"), region)
              if name != "clamp_min" else None)
        a = op(0)
        if a is None:
            return (Interval(lo, hi) if lo is not None and hi is not None
                    else None)

        def clip(v):               # min(max(v, lo), hi)
            v = v if lo is None else max(v, lo)
            return v if hi is None else min(v, hi)
        return Interval(clip(a.lo), clip(a.hi))
    if name == "remainder":
        d = _const(x.args[1], region)
        if isinstance(d, int) and d > 0:
            return Interval(0, d - 1)      # floored: the divisor's sign
        return None
    if name == "where":
        c = op(0)
        if c is not None and c.lo == c.hi:
            return op(1 if c.lo else 2)
        return _hull([op(1), op(2)])
    if name in ("lt", "le", "gt", "ge", "eq", "ne"):
        return _cmp_interval(name, op(0), op(1))
    if name in ("logical_and", "logical_or", "logical_not", "logical_xor",
                "bitwise_and", "bitwise_or", "bitwise_xor",
                "bitwise_not") and dtype == torch.bool:
        return Interval(0, 1)
    if name == "arange":
        args = [_const(a, region) for a in x.args]
        if len(args) == 1:
            start, end, step = 0, args[0], 1
        else:
            start, end = args[0], args[1]
            step = args[2] if len(args) > 2 else x.kwargs.get("step", 1)
        if all(isinstance(v, int) for v in (start, end, step)) and step:
            n = max(-(-(end - start) // step), 1)
            last = start + (n - 1) * step
            return Interval(min(start, last), max(start, last))
        return dt
    if name == "sum":
        a = op(0)
        vin, vout = _val(x.args[0]), _val(x)
        if a is None or vin is None or vout is None:
            return None
        n = max(vin.numel() // max(vout.numel(), 1), 1)
        return _n_fold(a, n)
    if name == "cumsum":
        a = op(0)
        vin = _val(x.args[0])
        if a is None or vin is None:
            return None
        return _n_fold(a, int(vin.shape[int(x.args[1])]) if vin.dim() else 1)
    if name in ("mm", "bmm", "matmul", "mv", "dot"):
        a, b = op(0), op(1)
        va = _val(x.args[0])
        if a is None or b is None or va is None:
            return None
        return _n_fold(_prod(a, b), int(va.shape[-1]))
    if name in ("empty", "empty_like", "new_empty", "empty_strided"):
        return dt
    if name in ("index", "gather", "index_select", "take"):
        return op(0)
    return None


# ---------------------------------------------------------------------------
# clamp heads
# ---------------------------------------------------------------------------

def _clamp_kind(node, region) -> Optional[str]:
    """'saturate' or 'wrap' when this node is a V-word clamp head: a clamp
    whose lower bound is V_MIN (``aten.clamp``, ``clamp_min`` or
    ``maximum`` against V_MIN; the upper arm rides along) or a
    ``remainder`` by V_SPAN."""
    name = _aten(node)
    if name == "clamp" and _const(_arg(node, 1, "min"), region) == V_MIN:
        return "saturate"
    if name == "clamp_min" and _const(node.args[1], region) == V_MIN:
        return "saturate"
    if name == "maximum" and any(_const(a, region) == V_MIN
                                 for a in node.args[:2]):
        return "saturate"
    if name == "remainder" and _const(node.args[1], region) == V_SPAN:
        return "wrap"
    return None


def _collect_clamps(region, out: list, pred: bool) -> None:
    """Every clamp head under ``region`` as (node, region, kind,
    predicated)."""
    for node in region.gm.graph.nodes:
        if node.op != "call_function":
            continue
        kind = _clamp_kind(node, region)
        if kind is not None:
            out.append((node, region, kind, pred))
        for sub in _sub_regions(node, region):
            _collect_clamps(sub, out, pred or sub.predicated)


# ---------------------------------------------------------------------------
# the passes
# ---------------------------------------------------------------------------

def _float_site(mm, region, env) -> tuple:
    """Check one float product node against the float64 exactness rule:
    (sanctioned nodes, |partial sum| bound), or raise `TraceError`."""
    where = f"{_label(mm)} at {_at(region)}"
    vmm = _val(mm)
    if vmm.dtype != torch.float64:
        raise TraceError(f"dtype: float {vmm.dtype} product {where}: only a "
                         "float64 product of integer casts can be exact",
                         where="")
    chain = {mm}
    bounds = []
    for operand in mm.args[:2]:
        cur = operand
        while isinstance(cur, torch.fx.Node) and _aten(cur) in (
                _VIEW_OPS | {"clone", "contiguous"}) and \
                _node_dtype(cur) == torch.float64:
            chain.add(cur)
            cur = cur.args[0]
        if not (isinstance(cur, torch.fx.Node)
                and _aten(cur) in ("_to_copy", "to")
                and _node_dtype(cur) == torch.float64
                and _node_dtype(cur.args[0]) is not None
                and not _node_dtype(cur.args[0]).is_floating_point):
            raise TraceError(
                f"dtype: float64 product {where} takes an operand that is "
                "not a cast of an integer tensor — a float value leaked into "
                "the int domain", where="")
        chain.add(cur)
        iv = _ival(cur.args[0], region, env)
        if iv is None:
            raise TraceError(
                f"dtype: cannot bound the integer operand "
                f"{_label(cur.args[0])} of the float64 product {where}",
                where="")
        bounds.append(max(abs(iv.lo), abs(iv.hi)))
    k = int(_val(mm.args[0]).shape[-1])
    bound = k * bounds[0] * bounds[1]
    if bound >= F64_EXACT:
        raise TraceError(
            f"dtype: float64 product {where}: |partial sum| may reach "
            f"{k} x {bounds[0]} x {bounds[1]} = {bound}, not below 2**53 — "
            "the product is not exact", where="")
    frontier = list(mm.users)
    while frontier:
        u = frontier.pop()
        name = _aten(u)
        if name in (_VIEW_OPS | {"clone", "contiguous"}) and \
                _node_dtype(u) == torch.float64:
            chain.add(u)
            frontier.extend(u.users)
        elif name in ("_to_copy", "to") and _node_dtype(u) is not None and \
                not _node_dtype(u).is_floating_point:
            continue
        else:
            raise TraceError(
                f"dtype: the float64 product {where} flows into "
                f"{_label(u)} — its result must go straight back to an "
                "integer type", where="")
    return chain, bound


def _check_dtypes(root, expect: TraceExpectation, checks: list) -> int:
    n = 0
    env: dict = {}
    sanctioned: set = set()
    bounds = []
    for node, region in _walk(root):
        name = _aten(node)
        if name in _PRODUCT_OPS:
            v = _val(node)
            if isinstance(v, torch.Tensor) and v.dtype.is_floating_point:
                try:
                    chain, bound = _float_site(node, region, env)
                except TraceError as e:
                    raise TraceError(str(e), where=expect.where) from None
                sanctioned |= chain
                bounds.append(bound)
    for node, region in _walk(root):
        n += 1
        name = _aten(node)
        if name in _RNG_OPS:
            raise TraceError(
                f"determinism: RNG op {_label(node)} at {_at(region)} — "
                "int-domain dispatches must be replay-exact",
                where=expect.where)
        vals = _tensors(_val(node))
        floats = [t for t in vals if t.dtype.is_floating_point]
        accumulate = name in _ACCUMULATE_OPS or (
            name == "index_put" and _arg(node, 3, "accumulate", False))
        if accumulate and floats:
            raise TraceError(
                f"determinism: float {_label(node)} at {_at(region)} adds "
                "in an order the run picks", where=expect.where)
        if floats and node not in sanctioned:
            raise TraceError(
                f"dtype: float {floats[0].dtype} value of {_label(node)} at "
                f"{_at(region)} — the int domain admits no float math (a "
                "cast, a float constant, or a float reduction leaked in)",
                where=expect.where)
        if name in _PRODUCT_OPS and vals and not floats and \
                vals[0].dtype not in (torch.int32, torch.int64):
            raise TraceError(
                f"dtype: {_label(node)} at {_at(region)} accumulates in "
                f"{vals[0].dtype} — AccW2V must accumulate in int32 or "
                "int64", where=expect.where)
    checks.append(TraceCheck(
        "dtype", expect.where,
        f"{n} node(s): no float values outside exact float64 products, no "
        "RNG ops, int32/int64 integer accumulators"))
    checks.append(TraceCheck(
        "float64_exact", expect.where,
        f"{len(bounds)} float64 product(s) of integer casts back to an "
        "integer type" + (f", |partial sum| <= {max(bounds)} < 2**53"
                          if bounds else "")))
    return n


def _check_clamps(root, expect: TraceExpectation, checks: list, steps: int,
                  twin_clamps: int) -> int:
    found: list = []
    _collect_clamps(root, found, False)
    for node, region, kind, pred in found:
        if pred:
            raise TraceError(
                f"clamp: V-word clamp {_label(node)} inside a predicated "
                f"subgraph at {_at(region)} — partials must accumulate "
                "unclamped under torch.cond/while_loop and the single clamp "
                "runs after the predication", where=expect.where)
        if kind != expect.clamp_mode:
            raise TraceError(
                f"clamp: {kind} clamp {_label(node)} at {_at(region)} in a "
                f"{expect.clamp_mode}-mode program — one clamp policy per "
                "program", where=expect.where)
    want = steps * expect.expected_clamps
    got = len(found) + twin_clamps
    if got != want:
        raise TraceError(
            f"clamp: {got} V-word clamp head(s) in the trace, the ISA "
            f"contract requires exactly {want} ({steps} step(s) x "
            f"{expect.n_spiking} spiking layer(s) x "
            f"{expect.neuron}/{expect.clamp_mode}"
            + (f" + {expect.extra_clamps} extra" if expect.extra_clamps
               else "") + ") — a duplicated or missing clamp changes "
            "11-bit semantics silently"
            + (f"; first: {_label(found[0][0])}" if found else ""),
            where=expect.where)
    checks.append(TraceCheck(
        "clamp_count", expect.where,
        f"exactly {want} {expect.clamp_mode} clamp head(s) over {steps} "
        f"step(s), none predicated"
        + (f" ({twin_clamps} in kernel twins)" if twin_clamps else "")))
    return got


def _upstream(x, region, limit: int = 4000):
    """BFS the def chain of ``x`` upstream. Yields (node, region) for every
    node reached; clamp heads end their branch, and so do higher-order ops
    and kernel nodes (their bodies are out of the SSA walk)."""
    stack, seen, steps = [(x, region)], set(), 0
    while stack and steps < limit:
        a, r = stack.pop()
        steps += 1
        if not isinstance(a, torch.fx.Node):
            continue
        key = (id(r), a)
        if key in seen:
            continue
        seen.add(key)
        if a.op == "placeholder":
            if a in r.bindings and r.parent is not None:
                stack.append((r.bindings[a], r.parent))
            continue
        if a.op != "call_function" or _clamp_kind(a, r) is not None:
            continue
        yield a, r
        if _kernel_name(a) or isinstance(a.target,
                                         torch._ops.HigherOrderOperator):
            continue
        stack.extend((n, r) for n in a.all_input_nodes)


def _check_dominance(root, expect: TraceExpectation, checks: list) -> tuple:
    """Every SpikeCheck (``ge``) must read a clamped V: its upstream chain
    may not reach a product or a cross-rank reduction without passing a
    clamp head. Symmetrically, no clamp may lie upstream of a reduction
    before its product: the AccV2V reduction sums unclamped int32 partials
    and the one clamp composes after the full sum. Returns (SpikeChecks,
    reductions)."""
    n_ge = n_red = 0
    for node, region in _walk(root):
        if _is_reduction(node):
            n_red += 1
            _check_unclamped_partial(node, region, expect)
            continue
        if _aten(node) != "ge":
            continue
        n_ge += 1
        for d, r in _upstream(node.args[0], region):
            if _aten(d) in _PRODUCT_OPS:
                raise TraceError(
                    f"clamp: SpikeCheck {_label(node)} at {_at(region)} "
                    f"reads the product {_label(d)} with no V-word clamp in "
                    "between", where=expect.where)
            if _is_reduction(d):
                raise TraceError(
                    f"clamp: SpikeCheck {_label(node)} at {_at(region)} "
                    f"reads the cross-rank reduction {_label(d)} with no "
                    "V-word clamp in between — on the mesh path the clamp "
                    "must run AFTER the reduction", where=expect.where)
    checks.append(TraceCheck(
        "clamp_dominance", expect.where,
        f"{n_ge} SpikeCheck read(s) dominated by a clamp"
        + (f"; {n_red} cross-rank reduction(s) of unclamped partials"
           if n_red else "")))
    return n_ge, n_red


def _check_unclamped_partial(node, region, expect: TraceExpectation
                             ) -> None:
    """Walk a reduction's operand upstream to its product: a V-word clamp
    on the way means the partial was clamped before the sum."""
    stack, seen = [(node.args[0], region)], set()
    while stack:
        a, r = stack.pop()
        if not isinstance(a, torch.fx.Node) or (id(r), a) in seen:
            continue
        seen.add((id(r), a))
        if a.op == "placeholder":
            if a in r.bindings and r.parent is not None:
                stack.append((r.bindings[a], r.parent))
            continue
        if a.op != "call_function":
            continue
        if _clamp_kind(a, r) is not None:
            raise TraceError(
                f"clamp: V-word clamp {_label(a)} upstream of the cross-rank "
                f"reduction {_label(node)} at {_at(region)} — row-tile "
                "partials must reduce UNCLAMPED (int32 addition is "
                "associative; clamp_v composes only after the full AccV2V "
                "sum)", where=expect.where)
        if _aten(a) in _PRODUCT_OPS or _is_reduction(a):
            continue               # the partial's source
        stack.extend((n, r) for n in a.all_input_nodes)


def _norm(i: int, size: int) -> int:
    return i + size if i < 0 else i


def _check_bounds(root, expect: TraceExpectation, checks: list) -> int:
    n = 0
    env: dict = {}

    def fail(node, region, what):
        raise TraceError(f"bounds: {_label(node)} at {_at(region)} {what}",
                         where=expect.where)

    for node, region in _walk(root):
        name = _aten(node)
        if name not in ("slice", "select", "narrow", "index", "index_select",
                        "gather", "index_put", "scatter", "scatter_add",
                        "embedding"):
            continue
        base = _val(node.args[0])
        if not isinstance(base, torch.Tensor):
            continue
        shape = tuple(int(s) for s in base.shape)
        if name in ("slice", "select", "narrow"):
            dim = _norm(int(_arg(node, 1, "dim", 0)), len(shape))
            size = shape[dim]
        if name == "select":
            i = int(node.args[2])
            if not -size <= i < size:
                fail(node, region, f"selects index {i} of a dim-{dim} "
                     f"extent {size}")
            n += 1
        elif name == "slice":
            start = _arg(node, 2, "start")
            end = _arg(node, 3, "end")
            start = 0 if start is None else _norm(int(start), size)
            end = size if end is None or int(end) >= _INT64_END \
                else _norm(int(end), size)
            if start < 0 or end < 0 or start > size or end > size:
                fail(node, region, f"slices [{start}, {end}) of a dim-{dim} "
                     f"extent {size}")
            n += 1
        elif name == "narrow":
            start = _norm(int(node.args[2]), size)
            if start < 0 or start + int(node.args[3]) > size:
                fail(node, region, f"narrows [{start}, "
                     f"{start + int(node.args[3])}) of a dim-{dim} extent "
                     f"{size}")
            n += 1
        else:
            if name in ("index", "index_put"):
                targets = [(d, ix) for d, ix in enumerate(node.args[1])
                           if ix is not None and _node_dtype(ix) != torch.bool]
                lo_ok = True
            elif name == "embedding":
                base = _val(node.args[0])
                targets, lo_ok = [(0, node.args[1])], False
            else:
                dim = _norm(int(node.args[1]), len(shape))
                targets, lo_ok = [(dim, node.args[2])], False
            for d, ix in targets:
                iv = _ival(ix, region, env)
                size = shape[d]
                if iv is None:
                    fail(node, region, f"has a dim-{d} index with no "
                         "interval bound — not provably in-bounds")
                lo = -size if lo_ok else 0
                if iv.lo < lo or iv.hi > size - 1:
                    fail(node, region, f"indexes dim {d} in [{iv.lo}, "
                         f"{iv.hi}], outside its extent {size}")
                n += 1
    checks.append(TraceCheck(
        "bounds", expect.where,
        f"{n} static slice/select/narrow and index operand(s) proven "
        "in-bounds"))
    return n


def _check_kernels(root, expect: TraceExpectation, checks: list) -> tuple:
    """Every kernel node: operand and result dtypes, a geometry
    `launch_plan` takes (the same flags), and its plain twin's graph
    checked against the contract. Returns (launches by name, the twins'
    clamp heads, their spike reads, bounds and nodes)."""
    from repro_torch.kernels.fused_snn_net.kernel import (KernelRefused,
                                                          launch_plan)
    launches, clamps, ge, bnd, nodes = [], 0, 0, 0, 0
    for node, region in _walk(root):
        name = _kernel_name(node)
        if name is None:
            continue
        (spikes, ws, v_init, ths, lks, neuron, clamp_mode, readout,
         emit_rasters, block_b, gran, crossover) = node.args
        mode = _KERNEL_MODES[name]
        where = f"{_label(node)} at {_at(region)}"
        for what, arg, want in ([("spikes", spikes, torch.int8)]
                                + [(f"ws[{i}]", w, torch.int8)
                                   for i, w in enumerate(ws)]
                                + [(f"v_init[{i}]", v, torch.int32)
                                   for i, v in enumerate(v_init)]):
            if _node_dtype(arg) != want:
                raise TraceError(
                    f"dtype: kernel {where} takes {what} as "
                    f"{_node_dtype(arg)}, the kernel reads {want}",
                    where=expect.where)
        outs = _tensors(_val(node))
        want_out = {torch.int8, torch.int32}
        if any(t.dtype not in want_out for t in outs):
            raise TraceError(f"dtype: kernel {where} returns a non-integer "
                             "value", where=expect.where)
        if clamp_mode != expect.clamp_mode or neuron != expect.neuron:
            raise TraceError(
                f"clamp: kernel {where} runs {neuron}/{clamp_mode} in a "
                f"{expect.neuron}/{expect.clamp_mode} program",
                where=expect.where)
        T, B, n0 = (int(s) for s in _val(spikes).shape)
        widths = (n0,) + tuple(int(_val(w).shape[1]) for w in ws)
        try:
            plan = launch_plan(widths, T, B, mode=mode, block_b=block_b,
                               gate_granularity=gran, neuron=neuron,
                               clamp_mode=clamp_mode)
        except KernelRefused as e:
            raise TraceError(f"launch: kernel {where} has a geometry the "
                             f"kernel refuses ({e.contract}: {e})",
                             where=expect.where) from None
        if any(int(t.shape[0]) != plan["grid"]
               for t in _tensors(_val(node)[2:])):
            raise TraceError(f"launch: kernel {where} counters do not have "
                             f"the plan's {plan['grid']} tiles",
                             where=expect.where)
        twin = _twin(node)
        n_spiking = len(ws) - 1 if readout else len(ws)
        tcs, st = check_graph(twin, TraceExpectation(
            where=f"{expect.where}:{node.name}", neuron=neuron,
            clamp_mode=clamp_mode, n_spiking=n_spiking), steps=T)
        clamps += st["clamps"]
        ge += st["spike_reads"]
        bnd += st["bounds_checked"]
        nodes += st["eqns"]
        launches.append(name)
        checks.append(TraceCheck(
            "kernel_twin", expect.where,
            f"{name} node '{node.name}' == fused_snn_net_ref with its "
            f"operands and flags: {st['clamps']} clamp head(s) over T={T}, "
            f"{st['spike_reads']} SpikeCheck read(s), {st['eqns']} node(s); "
            + "; ".join(c.prop for c in tcs)))
        checks.append(TraceCheck(
            "kernel_launch", expect.where,
            f"{name} node '{node.name}': int8 spikes and weights, int32 "
            f"v_init; widths {widths}, T={T}, B={B}: {plan['lanes']} lanes "
            f"a CTA, grid {plan['grid']}, "
            f"{plan['layout']['bytes']} bytes of shared memory"))
    return launches, clamps, ge, bnd, nodes


def check_graph(graph, expect: TraceExpectation, *, steps: int = 1
                ) -> tuple:
    """Run every trace pass over one traced dispatch (a `GraphModule` from
    `make_fx`) of ``steps`` timesteps: kernel nodes, dtype and
    determinism, clamp count and placement, clamp dominance (the
    cross-rank reductions' unclamped partials among it), bounds.
    Returns ``(checks, stats)`` where ``stats`` is a `SurfaceTrace`-shaped
    dict; raises `TraceError` (naming the property, the aten op and its
    node, and ``expect.where``) on the first violation. This is the
    low-level entry the negative-path tests drive with deliberately broken
    functions (the counterpart of JAX's ``check_closed_jaxpr``)."""
    root = _Region(graph, "")
    checks: list = []
    launches, twin_clamps, twin_ge, twin_bounds, twin_nodes = \
        _check_kernels(root, expect, checks)
    n_nodes = _check_dtypes(root, expect, checks)
    n_clamps = _check_clamps(root, expect, checks, steps, twin_clamps)
    n_ge, n_red = _check_dominance(root, expect, checks)
    n_bounds = _check_bounds(root, expect, checks)
    return checks, dict(clamps=n_clamps, spike_reads=n_ge + twin_ge,
                        bounds_checked=n_bounds + twin_bounds,
                        eqns=n_nodes + twin_nodes, launches=tuple(launches),
                        reductions=n_red)


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def aten_index(x, idx):
    """``x[idx]`` as the aten ops the indexing records: int, slice, None
    and Ellipsis indices, then any tensor (or list) indices in one
    ``aten.index`` (`Tensor.__getitem__` on a fake CUDA tensor needs a CUDA
    device guard, which a torch without CUDA lacks)."""
    aten = torch.ops.aten
    if not isinstance(idx, tuple):
        idx = (idx,)

    def consumes(i):
        return i is not None and i is not Ellipsis

    dim, tensors = 0, {}
    for k, i in enumerate(idx):
        if i is None:
            x = aten.unsqueeze.default(x, dim)
            dim += 1
        elif i is Ellipsis:        # the dims the later indices leave
            dim = x.dim() - sum(1 for j in idx[k + 1:] if consumes(j))
        elif torch.is_tensor(i) or isinstance(i, list):
            tensors[dim] = torch.as_tensor(i, device=x.device)
            dim += 1
        elif isinstance(i, (int, np.integer)):
            x = aten.select.int(x, dim, int(i))
        elif isinstance(i, slice):
            if i != slice(None):
                x = aten.slice.Tensor(x, dim, i.start, i.stop,
                                      1 if i.step is None else i.step)
            dim += 1
        else:
            raise TypeError(f"the trace cannot index with {type(i).__name__}")
    if tensors:
        x = aten.index.Tensor(x, [tensors.get(d)
                                  for d in range(max(tensors) + 1)])
    return x


def _setitem(x, idx, value) -> None:
    view = aten_index(x, idx)
    if isinstance(value, torch.Tensor):
        torch.ops.aten.copy_.default(view, value)
    else:
        torch.ops.aten.fill_.Scalar(view, value)


def _contiguous(x, memory_format=torch.contiguous_format):
    if x.is_contiguous(memory_format=memory_format):
        return x
    return torch.ops.aten.clone.default(x, memory_format=memory_format)


#: `torch.Tensor` methods whose Python bindings take a device guard, as
#: the aten ops they record
_GUARDED = {"__getitem__": aten_index, "__setitem__": _setitem,
            "copy_": lambda x, src, non_blocking=False:
                torch.ops.aten.copy_.default(x, src, non_blocking),
            "contiguous": _contiguous}


@contextlib.contextmanager
def fake_device_indexing():
    """Indexing, index assignment, ``copy_`` and ``contiguous`` of fake
    tensors of a device this torch was not built for, as the aten ops they
    record: `_GUARDED` stands in for `torch.Tensor`'s methods for the
    duration (they are `TensorBase`'s, so removing ours restores them).
    A torch-function mode would not do: DTensor calls them inside its own
    dispatch, where no such mode is active."""
    for name, fn in _GUARDED.items():
        setattr(torch.Tensor, name, fn)
    try:
        yield
    finally:
        for name in _GUARDED:
            delattr(torch.Tensor, name)


def trace(fn, specs, device) -> torch.fx.GraphModule:
    """The aten graph of ``fn`` on fake tensors of ``device``: ``specs``
    is a pytree of (shape, dtype) leaves, one fake tensor each, passed to
    ``fn`` in that structure. Nothing runs on the device and no kernel
    launches; raises `TraceError` if a kernel launch count moves."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils import _pytree as pytree
    device = torch.device(device)
    mode = FakeTensorMode()

    def is_spec(x):
        return (isinstance(x, tuple) and len(x) == 2
                and isinstance(x[1], torch.dtype))

    with mode:
        args = pytree.tree_map(
            lambda s: torch.empty(s[0], dtype=s[1], device=device), specs,
            is_leaf=is_spec)

    def run(*a):
        if device.type == "cpu":
            return fn(*a)
        with fake_device_indexing():
            return fn(*a)

    before = dict(kernels.LAUNCH_COUNTS)
    graph = make_fx(run, tracing_mode="fake")(*args)
    moved = {k: n - before[k] for k, n in kernels.LAUNCH_COUNTS.items()
             if n != before.get(k)}
    if moved:
        raise TraceError(f"launch: tracing launched kernels {moved} — a "
                         "launch must show up as its node, never run",
                         where="trace")
    return graph


def _twin(node) -> torch.fx.GraphModule:
    """The graph of a kernel node's plain twin, `ops.fused_snn_net_ref`
    with the node's operands (shapes, dtypes, device) and flags."""
    from repro_torch.kernels.fused_snn_net.ops import fused_snn_net_ref
    (spikes, ws, v_init, ths, lks, neuron, clamp_mode, readout,
     emit_rasters, block_b, gran, crossover) = node.args
    mode = _KERNEL_MODES[_kernel_name(node)]

    def spec(x):
        v = _val(x)
        return (tuple(int(s) for s in v.shape), v.dtype)

    def run(s, w, vi):
        return fused_snn_net_ref(
            s, w, tuple(ths), tuple(lks), neuron=neuron,
            clamp_mode=clamp_mode, emit_rasters=emit_rasters,
            readout=readout, v_init=vi or None,
            use_sparse=mode == "gated", gate_granularity=gran,
            use_events=mode == "events", event_crossover=crossover,
            block_b=block_b)

    return trace(run, (spec(spikes), [spec(w) for w in ws],
                       [spec(v) for v in v_init]), _val(spikes).device)


# ---------------------------------------------------------------------------
# program surfaces: trace the real dispatches of one backend
# ---------------------------------------------------------------------------

def _program_calls(program) -> list:
    """(name, layer_names, logical widths, n_spiking) per fused dispatch,
    JAX's ``conv[i]`` and ``fc_stack``."""
    calls = []
    for i, spec in enumerate(program.int_conv_stack):
        calls.append((f"conv[{i}]",
                      (f"conv[{i}] {spec.n_in}x{spec.n_out}",),
                      (spec.n_in, spec.n_out), 1))
    stack = program.fc_stack
    if stack:
        names = tuple(f"{s.kind} {s.n_in}x{s.n_out}" for s in stack)
        widths = (stack[0].n_in,) + tuple(s.n_out for s in stack)
        calls.append(("fc_stack", names, widths, len(stack) - 1))
    return calls


def _call_params(program, name: str) -> tuple:
    """(thresholds, leaks, readout) of one fused call."""
    if name == "fc_stack":
        stack = program.fc_stack
        return (tuple(int(s.threshold) for s in stack[:-1]),
                tuple(int(s.leak) for s in stack[:-1]), True)
    idx = int(name[name.index("[") + 1:name.index("]")])
    spec = program.int_conv_stack[idx]
    return ((int(spec.threshold),), (int(spec.leak),), False)


def _conv_geometry(program, name: str) -> Optional[tuple]:
    """(kernel, stride, input map (H, W, C), output map (H, W, C)) of an
    on-macro conv call, its input the previous layer's state; None for the
    fc stack."""
    if name == "fc_stack":
        return None
    spec = program.int_conv_stack[int(name[name.index("[") + 1:-1])]
    j = next(j for j, ly in enumerate(program.layers) if ly is spec)
    return (int(spec.w.shape[0]), int(spec.stride),
            tuple(int(s) for s in program.layers[j - 1].state_shape),
            tuple(int(s) for s in spec.state_shape))


def _dispatch(program, backend: str, ths: tuple, lks: tuple, readout: bool,
              *, block_b: int, gate_granularity: int,
              event_crossover: float):
    """``run(spikes, ws, v_init=None)``: the fused call as `pipeline.
    _run_layers` makes it on ``backend`` (the plain version on
    ``int_ref``, its tile the whole batch; the kernel wrapper, whose CPU
    tensors take the plain version, on the ``cuda*`` backends)."""
    from repro_torch.kernels.fused_snn_net.ops import (fused_snn_net,
                                                       fused_snn_net_ref)
    kw = dict(neuron=program.neuron, clamp_mode=program.clamp_mode,
              emit_rasters=True, readout=readout)
    if backend == "int_ref":
        def run(s, ws, vi=None):
            return fused_snn_net_ref(s, ws, ths, lks, v_init=vi,
                                     block_b=max(int(s.shape[1]), 1), **kw)
        return run
    flags = dict(use_sparse=backend == "cuda_sparse",
                 gate_granularity=(gate_granularity
                                   if backend == "cuda_sparse" else 1),
                 use_events=backend == "cuda_events",
                 event_crossover=event_crossover)

    def run(s, ws, vi=None):
        return fused_snn_net(s, ws, thresholds=ths, leaks=lks, v_init=vi,
                             block_b=block_b, **flags, **kw)
    return run


def _mesh_ticks(program, backend: str, name: str, widths: tuple,
                n_spiking: int, ths: tuple, lks: tuple, *, batch: int,
                mesh_axes: tuple, device) -> list:
    """The mesh surface of one fused call: each model rank's row-partial
    tick (`ops.mesh_rowpartial_tick`) traced on fake tensors, its
    all-reduce one node. Empty below model extent 2."""
    from repro_torch.kernels.fused_snn_net.ops import (mesh_padded_widths,
                                                       mesh_rowpartial_tick)
    nm = int(dict(mesh_axes).get("model", 1))
    if nm < 2:
        return []
    pw = mesh_padded_widths(widths, nm)
    use_events = backend == "cuda_events"
    specs = (((batch, pw[0]), torch.int8),
             [((pw[i] // nm, pw[i + 1]), torch.int8)
              for i in range(len(widths) - 1)],
             [((batch, w), torch.int32) for w in pw[1:]])
    out = []
    for rank in range(nm):
        def tick(frame, ws_l, vs, _rank=rank):
            counts = (tuple(torch.zeros((w,), dtype=torch.int32,
                                        device=frame.device)
                            for w in widths[:len(ws_l)])
                      if use_events else ())
            return mesh_rowpartial_tick(
                vs, counts, frame, ws_l, widths=widths, n_spiking=n_spiking,
                thresholds=ths, leaks=lks, neuron=program.neuron,
                clamp_mode=program.clamp_mode, use_events=use_events,
                model_rank=_rank, group="model")
        g = trace(tick, specs, device)
        out.append(("mesh", f"{name}/model{rank}", g, TraceExpectation(
            where=f"{backend}:mesh:{name}:model{rank}",
            neuron=program.neuron, clamp_mode=program.clamp_mode,
            n_spiking=n_spiking, mesh_axes=tuple(mesh_axes),
            reductions=len(widths) - 1), 1))
    return out


def _trace_surfaces(program, backend: str, surfaces: tuple, *, batch: int,
                    block_b: int, megastep_k: int, gate_granularity: int,
                    event_crossover: float, device,
                    mesh_axes: tuple = ()) -> list:
    """[(surface, call, graph, TraceExpectation, steps), ...] for every
    requested dispatch surface of ``backend`` traced on ``device``."""
    from repro_torch.core import mapping
    from repro_torch.core.isa import int_matmul
    T = int(program.timesteps)
    i8, i32 = torch.int8, torch.int32
    out = []
    for name, _names, widths, n_spiking in _program_calls(program):
        ths, lks, readout = _call_params(program, name)
        run = _dispatch(program, backend, ths, lks, readout, block_b=block_b,
                        gate_granularity=gate_granularity,
                        event_crossover=event_crossover)
        conv = _conv_geometry(program, name)
        ws_spec = [((widths[i], widths[i + 1]), i8)
                   for i in range(len(widths) - 1)]
        expect_kw = dict(neuron=program.neuron,
                         clamp_mode=program.clamp_mode, n_spiking=n_spiking)

        def stream(k, _run=run, _conv=conv):
            """The streaming dispatch of this call over ``k`` frames:
            specs and the function, as `pipeline._on_macro` runs it."""
            if _conv is None:
                vi = [((batch, w), i32) for w in widths[1:]]
                if not readout:
                    return ((k, batch, widths[0]), i8), ws_spec, vi, _run

                def mega(s, w, v):
                    # the int tail of `pipeline.stream_megastep`
                    r, vf, _sk = _run(s, w, v)
                    ro_in = r[-1] if r else s
                    traj = v[-1][None] + torch.cumsum(
                        int_matmul(ro_in, w[-1]), dim=0, dtype=torch.int32)
                    return vf, traj
                return ((k, batch, widths[0]), i8), ws_spec, vi, mega
            kernel, stride, in_map, out_map = _conv

            def conv_call(maps, w, v):
                # `pipeline._conv_front_end`: im2col, then the call
                patches = mapping.im2col_raster(maps, kernel, stride)
                r, vf, sk = _run(patches, [mapping.pack_conv_weights(w[0])],
                                 [v[0].reshape(-1, widths[1])])
                return r, vf, sk
            w_spec = [((kernel, kernel, in_map[2], widths[1]), i8)]
            return (((k, batch) + in_map, i8), w_spec,
                    [((batch,) + out_map, i32)], conv_call)

        if "batch" in surfaces:
            g = trace(lambda s, w: run(s, w),
                      (((T, batch, widths[0]), i8), ws_spec), device)
            out.append(("batch", name, g, TraceExpectation(
                where=f"{backend}:batch:{name}", **expect_kw), T))
        for surface, k in (("step", 1), ("megastep", megastep_k)):
            if surface not in surfaces:
                continue
            s_spec, w_spec, v_spec, fn = stream(k)
            g = trace(fn, (s_spec, w_spec, v_spec), device)
            out.append((surface, name, g, TraceExpectation(
                where=f"{backend}:{surface}:{name}", **expect_kw), k))
        if "mesh" in surfaces:
            out.extend(_mesh_ticks(program, backend, name, widths, n_spiking,
                                   ths, lks, batch=batch,
                                   mesh_axes=mesh_axes, device=device))
    return out


def _geometry_signature(program, backend, surfaces, batch, block_b,
                        megastep_k, mesh_axes, gate_granularity,
                        event_crossover, device) -> tuple:
    calls = tuple((name, widths, ns, _conv_geometry(program, name))
                  for name, _ln, widths, ns in _program_calls(program))
    params = tuple((_call_params(program, name)[:2])
                   for name, _ln, _w, _ns in _program_calls(program))
    return (backend, tuple(surfaces), batch, block_b, megastep_k,
            tuple(mesh_axes), gate_granularity, float(event_crossover),
            program.neuron, program.clamp_mode, int(program.timesteps),
            calls, params, torch.device(device).type)


#: geometry-keyed memo: equivalence sweeps re-validate identical
#: geometries many times; tracing is pure in the signature
_TRACE_CACHE: dict = {}


def check_trace(program, backend: str = "cuda", *,
                surfaces: tuple = SURFACES, batch: Optional[int] = None,
                block_b: int = 8, megastep_k: int = 2,
                mesh: Any = None, gate_granularity: int = 1,
                event_crossover: float = 1.0, with_cost: bool = True,
                use_cache: bool = True, device=None) -> TraceReport:
    """Trace every requested dispatch ``surfaces`` of ``program`` on
    ``backend`` and verify the dtype / clamp / bounds / determinism /
    launch contracts; raise `TraceError` naming the property, the aten op
    and its node, and the backend on any violation. Host backends
    (`HOST_BACKENDS`) have no graph and return a named skip row.

    ``device`` (default the program's) is the device the dispatch is
    traced for, on fake tensors: on a CUDA device every ``cuda*`` call
    must show up as one kernel node, elsewhere the wrapper's plain version
    runs. ``batch`` (default ``block_b``) sizes the traced dispatch;
    ``with_cost`` attaches the `trace_cost.TraceCostReport` built from the
    batch surface. ``mesh`` (an `launch.mesh.SNNMesh` or an ``{axis:
    extent}`` dict) adds the mesh surface when its model extent is above
    1: each model rank's row-partial tick, checked for one reduction node
    per layer, unclamped partials and a clamp between every reduction and
    its SpikeCheck. Results are memoized by geometry (``use_cache``)."""
    if backend in HOST_BACKENDS:
        return TraceReport(
            backend=backend, surfaces=(), cost=None,
            checks=(TraceCheck(
                "host_backend", backend,
                "host-side executor (numpy/BitMacro): no device dispatch to "
                "trace; covered by the bit-equivalence tests"),))
    if backend not in TRACE_BACKENDS:
        raise TraceError(
            f"trace: backend {backend!r} has no int-domain trace "
            f"contract; traceable: {sorted(TRACE_BACKENDS)}, host "
            f"(skipped): {sorted(HOST_BACKENDS)}", where=backend)
    if program.domain != "int":
        raise TraceError(
            f"trace: program domain {program.domain!r} — the trace "
            "contract covers int-domain dispatches only", where=backend)
    mesh_axes = ()
    if mesh is not None:
        from repro_torch.launch.mesh import mesh_extents
        sizes = mesh_extents(mesh)
        if any(v < 1 for v in sizes.values()):
            raise TraceError(f"mesh: axis extents must be >= 1, got "
                             f"{sizes}", where="mesh")
        mesh_axes = tuple(sorted(sizes.items()))
    bad = [s for s in surfaces if s not in SURFACES]
    if bad:
        raise TraceError(f"trace: unknown surface(s) {bad}; have "
                         f"{SURFACES}", where=backend)
    if batch is None:
        batch = block_b
    device = torch.device(program.device if device is None else device)
    key = _geometry_signature(program, backend, surfaces, batch, block_b,
                              megastep_k, mesh_axes, gate_granularity,
                              event_crossover, device) + (bool(with_cost),)
    if use_cache and key in _TRACE_CACHE:
        return _TRACE_CACHE[key]

    from repro_torch.kernels.fused_snn_net.kernel import KernelRefused
    try:
        traced = _trace_surfaces(
            program, backend, tuple(surfaces), batch=batch, block_b=block_b,
            megastep_k=megastep_k, gate_granularity=gate_granularity,
            event_crossover=event_crossover, device=device,
            mesh_axes=mesh_axes)
    except KernelRefused as e:
        raise TraceError(f"launch: the kernel refuses the {backend} "
                         f"dispatch ({e.contract}): {e}",
                         where=backend) from e
    want_launches = 1 if device.type == "cuda" and backend != "int_ref" \
        else 0
    checks: list = []
    stats: list = []
    batch_graphs = {}
    for surface, call, graph, expect, steps in traced:
        cs, st = check_graph(graph, expect, steps=steps)
        if surface == "mesh":
            if st["launches"] or st["reductions"] != expect.reductions:
                raise TraceError(
                    f"mesh: the row-partial tick has {st['reductions']} "
                    f"reduction node(s) and {len(st['launches'])} kernel "
                    f"node(s); it must reduce each of its "
                    f"{expect.reductions} layer(s) once and launch nothing",
                    where=expect.where)
            checks.extend(cs)
            stats.append(SurfaceTrace(surface=surface, call=call, **st))
            continue
        if len(st["launches"]) != want_launches:
            raise TraceError(
                f"launch: {len(st['launches'])} kernel node(s) "
                f"{list(st['launches'])} in the traced dispatch, want "
                f"{want_launches} on a {device.type} device — every launch "
                "must show up as its named node", where=expect.where)
        checks.extend(cs)
        stats.append(SurfaceTrace(surface=surface, call=call, **st))
        if surface == "batch":
            batch_graphs[call] = graph
    cost = None
    if with_cost and batch_graphs:
        from repro_torch.analysis.trace_cost import build_cost_report
        cost = build_cost_report(program, backend, batch_graphs,
                                 batch=batch, block_b=block_b,
                                 checks=checks)
    report = TraceReport(backend=backend, surfaces=tuple(stats),
                         checks=tuple(checks), cost=cost)
    if use_cache:
        _TRACE_CACHE[key] = report
    return report
