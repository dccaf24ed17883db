"""Multi-GPU dry-run: trace every (architecture x input-shape x mesh)
cell on a fake process group of 256 or 512 ranks over fake CUDA tensors,
and take the roofline terms of one GPU from what rank 0 runs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Per cell this writes artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json
with the JAX package's keys (`repro.launch.dryrun`): flops/device,
bytes/device, per-collective byte totals, the memory of one GPU
(argument/output/temp/alias bytes), roofline terms (compute, memory and
collective seconds) against an NVIDIA H100 (`launch.mesh`), MODEL_FLOPS
and the useful-compute ratio; ``fits_hbm`` and ``hbm_bytes`` (the card's
memory, or 80e9 bytes without one) stand for JAX's ``fits_16GiB``.

How a cell is taken. `fake_world` starts a ``"fake"`` process group
(`torch.testing`'s `FakeStore`: collectives return at once) of the mesh's
size, rank 0, before any mesh is built; `make_production_mesh` lays it out
on ("data", "model") or ("pod", "data", "model"). The step's arguments are
DTensors on that mesh whose local shards are fake CUDA tensors (no
memory), placed by `dist.sharding`'s rules (`param_specs`, `batch_specs`,
and `serve_cache_specs` for a decode step's cache: `cache_specs` with a
stacked leaf's layer axis whole and its batch over data, the same bytes
where the extents divide); rank 0 holds the ceiling shard of an uneven
split. The step is the port's own: `train.make_train_step` (AdamW, or
Adafactor where the cell says), `lm.prefill` or `lm.decode_step`, under
`dist.sharding.activation_rules`, so every cell takes the card's path:
bf16 weights, the kernel dispatch the card takes (wkv6 is one node of the
custom operator ``repro_torch::wkv6``, counted by formula), caches written
in place. `CostCounter`, a dispatch mode, sees each operator that rank 0
runs on its local tensors, after DTensor has placed it:

  flops         torch's `flop_counter` formulas (matrix products, attention
                and convolutions; elementwise operations count none), and
                4 B*H*T*K*V for the wkv6 recurrence; DTensor's sharding
                propagation, which runs each new operator once on global
                fake tensors, is left out;
  bytes         every operator's input plus output bytes (a view moves
                none; an output written into an argument counts once; a
                broadcast axis counts one element deep).
                Eager PyTorch does not fuse, so this is what the eager
                program moves, not XLA's post-fusion ``bytes accessed``;
  collectives   the operand bytes of the functional collectives
                (``_c10d_functional``) in JAX's five kinds; ``wait_tensor``
                is not counted. JAX parses the compiled HLO
                (``parse_collectives``); here the collectives are seen as
                they run, so there is no HLO parsing by design;
  memory        a live-storage tracker (``meta`` tensors, which a sharded
                cache's layout is computed on, hold none and are not
                counted at all): ``argument_bytes`` (parameters or
                train state, batch, cache), ``output_bytes`` (with XLA's
                8-byte index table a leaf of a tuple output, so the two
                packages' lines compare byte for byte), ``alias_bytes``
                (the train state, which the compiled step updates in its
                buffers as JAX's donated one does, and the cache written in
                place) and ``temp_bytes``, the peak of live bytes less the
                arguments and the outputs not aliased to them, so that
                peak = argument + temp + output - alias is the tracker's
                peak.

Eager code counts every layer, so the full-depth trace's count is direct:
it is the cell's flops, bytes and collectives and its ``raw_rolled_costs``
(JAX extrapolates from depth 1 and 2 because XLA counts a loop body once;
the port has no such loop, and its placements depend on depth where a
stacked layer axis shards over data, so it does not extrapolate). The
collective rate is one GPU's network port (`NET_BW`: every axis of both
meshes crosses 8-GPU nodes). On a torch without CUDA a train cell traces
on fake CPU tensors (`trace_device`); ``device`` in the JSON says which.

No other module of the port imports this one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import sys
import threading
import time
import traceback
import weakref
from pathlib import Path

import torch

from repro_torch.analysis.trace_check import fake_device_indexing
from repro_torch.configs.base import (ASSIGNED_ARCHS, ModelConfig,
                                      ParallelConfig, RunConfig, SHAPES,
                                      ShapeConfig, get_config)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import (HBM_BW, NET_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# ---------------------------------------------------------------------------
# Per-cell parallel policy (the JAX package's tables, verbatim)
# ---------------------------------------------------------------------------

DEFAULT_TRAIN = dict(remat="block", fsdp=True, scan_layers=True,
                     vocab_chunking=4, microbatches=1)
DEFAULT_SERVE = dict(remat="none", fsdp=False, scan_layers=True,
                     vocab_chunking=1, microbatches=1)

OVERRIDES: dict[tuple[str, str], dict] = {
    # llama4-maverick: 400B params -> factored optimizer, more loss chunks
    ("llama4-maverick-400b-a17b", "train_4k"): dict(optimizer="adafactor",
                                                    vocab_chunking=8),
    ("starcoder2-15b", "train_4k"): dict(vocab_chunking=4),
}

# Hillclimb variants: selected by --tag; each entry overrides the baseline
# ParallelConfig / optimizer for one (arch, shape).
HILLCLIMB: dict[tuple[str, str, str], dict] = {
    # --- jamba train_4k (worst memory blowup; paper-representative SSM) ---
    # p1: shard the SSM scan tensors + remat chunk bodies
    ("jamba-v0.1-52b", "train_4k", "p1"): dict(state_constraints=True),
    # p2: + gather-only dispatch on its 16-expert MoE + blocked attention
    ("jamba-v0.1-52b", "train_4k", "p2"): dict(state_constraints=True,
                                               moe_gather_dispatch=True,
                                               attn_q_chunk=1024),
    # p3: + microbatching to halve live activations
    ("jamba-v0.1-52b", "train_4k", "p3"): dict(state_constraints=True,
                                               moe_gather_dispatch=True,
                                               attn_q_chunk=1024,
                                               microbatches=2),
    # --- llama4 train_4k (most collective-bound) ---
    ("llama4-maverick-400b-a17b", "train_4k", "p1"): dict(
        optimizer="adafactor", vocab_chunking=8, moe_constraints=True),
    ("llama4-maverick-400b-a17b", "train_4k", "p2"): dict(
        optimizer="adafactor", vocab_chunking=8, moe_gather_dispatch=True),
    ("llama4-maverick-400b-a17b", "train_4k", "p3"): dict(
        optimizer="adafactor", vocab_chunking=8, moe_gather_dispatch=True,
        attn_q_chunk=1024, microbatches=2),
    # --- deepseek train_4k (worst roofline fraction) ---
    ("deepseek-v2-lite-16b", "train_4k", "p1"): dict(moe_constraints=True),
    ("deepseek-v2-lite-16b", "train_4k", "p2"): dict(moe_gather_dispatch=True),
    ("deepseek-v2-lite-16b", "train_4k", "p3"): dict(moe_gather_dispatch=True,
                                                     attn_q_chunk=1024,
                                                     microbatches=2),
    ("deepseek-v2-lite-16b", "train_4k", "p4"): dict(moe_gather_dispatch=True,
                                                     microbatches=4),
    ("llama4-maverick-400b-a17b", "train_4k", "p4"): dict(
        optimizer="adafactor", vocab_chunking=8, moe_gather_dispatch=True,
        microbatches=4),
    ("jamba-v0.1-52b", "train_4k", "p4"): dict(state_constraints=True,
                                               moe_gather_dispatch=True,
                                               microbatches=4),
    # --- rwkv long_500k (paper's fused-state serving path) ---
    # p1: 2D tensor parallelism for decode (weights sharded over data x model)
    ("rwkv6-7b", "long_500k", "p1"): dict(fsdp=True),
    # --- bonus: blocked attention on the worst prefill cells ---
    ("whisper-large-v3", "prefill_32k", "p1"): dict(attn_q_chunk=2048),
    ("llama3-8b", "prefill_32k", "p1"): dict(attn_q_chunk=2048),
    ("phi3-medium-14b", "prefill_32k", "p1"): dict(attn_q_chunk=2048),
}

# long_500k applicability: sub-quadratic archs only
LONG_OK = {"rwkv6-7b", "jamba-v0.1-52b"}

#: the port's ParallelConfig carries neither (its layers and time scans
#: are Python loops)
_NOT_CARRIED = ("scan_layers", "unroll_time_scans")


def cell_list(archs, shapes) -> list[tuple[str, str, str | None]]:
    cells = []
    for a in archs:
        for s in shapes:
            skip = None
            if s == "long_500k" and a not in LONG_OK:
                skip = "full-attention arch: 500k dense decode skipped per assignment"
            cells.append((a, s, skip))
    return cells


def make_run(arch: str, shape_name: str, tag: str = "") -> RunConfig:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    base = dict(DEFAULT_TRAIN if shape.kind == "train" else DEFAULT_SERVE)
    ov = dict(OVERRIDES.get((arch, shape_name), {}))
    if tag:
        ov.update(HILLCLIMB.get((arch, shape_name, tag), {}))
    optimizer = ov.pop("optimizer", "adamw")
    base.update(ov)
    for name in _NOT_CARRIED:
        base.pop(name, None)
    return RunConfig(model=cfg, shape=shape, parallel=ParallelConfig(**base),
                     optimizer=optimizer)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch                     # decode: per token


# ---------------------------------------------------------------------------
# the fake world and fake CUDA tensors
# ---------------------------------------------------------------------------

def fake_world(world: int) -> None:
    """Make the default process group a ``"fake"`` one of ``world`` ranks,
    this process rank 0 (a group of another size is destroyed first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def trace_device(kind: str) -> torch.device:
    """The device of a cell's fake tensors: CUDA, except for a train cell
    on a torch built without CUDA, whose autograd cannot take a CUDA tensor
    (its input metadata takes a CUDA device guard, which aborts the
    process): that cell traces on the CPU, over a "cpu" DeviceMesh whose
    shard-to-shard moves take the CUDA mesh's all-to-all
    (`_cuda_all_to_all`), so its operators and collectives are the card's
    (the model code takes no device-dependent branch in training)."""
    if kind == "train" and not torch.backends.cuda.is_built():
        return torch.device("cpu")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def _cuda_all_to_all(mesh):
    """On a "cpu" DeviceMesh, DTensor's shard-to-shard redistribution as
    on a CUDA one (one ``_dtensor::shard_dim_alltoall``), not its gloo
    fallback (an all-gather and a chunk); nothing on another mesh."""
    if mesh is None or mesh.device_type != "cpu":
        yield
        return
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor import placement_types as pt

    def alltoall(input, gather_dim, shard_dim, m, mesh_dim):
        if hasattr(funcol, "_resolve_group"):       # torch 2.13
            name = funcol._group_or_group_name(
                funcol._resolve_group((m, mesh_dim)))
        else:                                       # torch 2.11
            name = funcol._resolve_group_name((m, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, name)
    users = [m for m in (cu, pt) if hasattr(m, "shard_dim_alltoall")]
    saved = [m.shard_dim_alltoall for m in users]
    for m in users:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m, fn in zip(users, saved):
            m.shard_dim_alltoall = fn


def mesh_for(mesh_kind: str, device_type: str = "cuda"):
    """The production mesh of ``mesh_kind`` ("single": (16, 16), "multi":
    (2, 16, 16)) over a fake world of its size."""
    multi = mesh_kind == "multi"
    fake_world(512 if multi else 256)
    return make_production_mesh(multi_pod=multi, device_type=device_type)


def _indexing_mode(device: torch.device):
    """`trace_check.fake_device_indexing` where the fake device has no
    device guard (CUDA on a torch without it), else nothing."""
    if device.type == "cuda" and not torch.cuda.is_available():
        return fake_device_indexing()
    return contextlib.nullcontext()


def local_shape(shape: tuple, placements, mesh_shape: tuple) -> tuple:
    """Rank 0's shard of a tensor of global ``shape`` under ``placements``
    (one a mesh dimension): the ceiling piece of each split, as
    `torch.chunk` gives rank 0 and as XLA pads an uneven split."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for p, n in zip(placements, mesh_shape):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // n)
    return tuple(out)


def fake_tree(spec, placements, mesh, device: torch.device):
    """A tree of DTensors on ``mesh`` (an `SNNMesh` with a DeviceMesh)
    whose local shards are fresh fake tensors on ``device`` of rank 0's
    shapes: one per leaf of ``spec`` (tensors of any device, e.g. ``meta``,
    giving the global shape and type), placed by ``placements`` (a tree of
    ``spec``'s structure). Must run under a `FakeTensorMode`. Without a
    mesh, plain fake tensors of the global shapes."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_map
    if mesh is None:
        return tree_map(lambda s: torch.empty(tuple(s.shape), dtype=s.dtype,
                                              device=device), spec)
    dm = mesh.device_mesh

    def leaf(s, p):
        shape = tuple(s.shape)
        local = torch.empty(local_shape(shape, p, tuple(mesh.shape)),
                            dtype=s.dtype, device=device)
        return DTensor.from_local(local, dm, list(p), run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))
    return tree_map(leaf, spec, placements)


def _contiguous_stride(shape: tuple) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

#: JAX's collective kinds, and the operators counted in each
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
_COLLECTIVE_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",        # DTensor's Shard -> Shard
    "send": "collective-permute",
    "recv_": "collective-permute",
    "isend": "collective-permute",
    "irecv": "collective-permute",
}

_PROPAGATING = threading.local()


def _uncounted(owner, name: str, on_host: bool = False) -> None:
    """Wrap ``owner.name`` so that the operators it dispatches are not
    counted (`CostCounter` skips them) and, with ``on_host``, run on real
    host tensors outside the fake mode."""
    fn = owner.__dict__[name]
    if getattr(fn, "_dryrun_marked", False):
        return

    def marked(*args, **kwargs):
        _PROPAGATING.depth = getattr(_PROPAGATING, "depth", 0) + 1
        try:
            if on_host:
                from torch._subclasses.fake_tensor import \
                    unset_fake_temporarily
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        finally:
            _PROPAGATING.depth -= 1
    marked._dryrun_marked = True
    setattr(owner, name, marked)


def _mark_dtensor_internals() -> None:
    """Leave DTensor's own bookkeeping out of the count: its sharding
    propagation, which runs each new operator once on global fake tensors
    to learn its output's shape, and a strided shard's offsets, which it
    computes from an index tensor it reads back (on the host here: a fake
    tensor cannot be read)."""
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if n in ShardingPropagator.__dict__), None)
    if name is not None:              # else `check_counter` fails loudly
        _uncounted(ShardingPropagator, name)
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and "local_shard_size_and_offset" in \
            strided.__dict__:
        _uncounted(strided, "local_shard_size_and_offset", on_host=True)


def _tensors(tree) -> list:
    """The tensors among ``tree``'s leaves (nested tuples, lists and dicts;
    a NamedTuple too), in order."""
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    """The bytes ``t`` addresses: a broadcast (stride-0) axis is one
    element deep, so an expanded operand counts its memory once, whichever
    way a product was decomposed (`mm` on folded rows or `bmm` on an
    expanded weight)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0 or size == 0:
            n *= size
    return n


def wkv6_cost(r, v) -> tuple:
    """(flops, bytes) of one wkv6 call on (BH, T, K) and (BH, T, V)
    operands: 4 float32 operations per state element per step (a
    multiply-add into y, a multiply and a multiply-add into S), and r, k,
    w, v, u, s0 read and y and the final state written once (`chip_smoke`'s
    ``wkv_bound_ms``)."""
    BH, T, K = r.shape
    V = v.shape[-1]
    moved = 4 * (BH * T * (3 * K + V) + BH * K + 2 * BH * K * V
                 + BH * T * V)
    return 4 * BH * T * K * V, moved


_PACKAGE = Path(__file__).resolve().parents[1]
_RELATIVE: dict = {}                 # a code object's file -> package path
_FRAME_LINE = re.compile(r'File "([^"]+)", line (\d+)')
#: distinct operand shapes kept a site and kind
ATTRIBUTE_SHAPES = 8


def _package_path(filename: str):
    """``filename`` relative to the port's package ("models/lm.py"), or
    None outside it."""
    rel = _RELATIVE.get(filename, False)
    if rel is False:
        try:
            rel = Path(filename).resolve().relative_to(_PACKAGE).as_posix()
        except ValueError:
            rel = None
        _RELATIVE[filename] = rel
    return rel


def _site_of(frames) -> str | None:
    """The site of ``frames`` ((package path or None, line, function),
    innermost first): the first frame of the package outside this module,
    as "path:line"; a frame under ``dist/`` names, after " < ", the first
    frame outside ``dist/`` that called it. The walk stops at autograd's
    engine: what a backward node runs has no forward caller."""
    inner = None
    for rel, line, name in frames:
        if rel is None:
            if name == "_engine_run_backward":
                break
            continue
        if rel == "launch/dryrun.py":
            continue
        if inner is None:
            inner = f"{rel}:{line}"
            if not rel.startswith("dist/"):
                return inner
        elif not rel.startswith("dist/"):
            return f"{inner} < {rel}:{line}"
    return inner


def call_site() -> str | None:
    """`_site_of` the calling thread's stack."""
    frames, f = [], sys._getframe(1)
    while f is not None:
        frames.append((_package_path(f.f_code.co_filename), f.f_lineno,
                       f.f_code.co_name))
        f = f.f_back
    return _site_of(frames)


_NODE_SITES: dict = {}               # a forward stack (text) -> its site


def _node_site(node) -> str | None:
    """The site that made autograd ``node`` in the forward pass, from the
    stack anomaly mode stored on it (outermost frame first)."""
    stack = node.metadata.get("traceback_") if node is not None else None
    if not stack:
        return None
    text = stack if isinstance(stack, str) else "".join(stack)
    if text not in _NODE_SITES:
        frames = [(_package_path(f), int(line), "")
                  for f, line in _FRAME_LINE.findall(text)]
        _NODE_SITES[text] = _site_of(reversed(frames))
    return _NODE_SITES[text]


def site_lines(fn) -> tuple:
    """(package path, first line, last line) of function ``fn``, in the
    terms of `call_site`'s keys."""
    import inspect
    src, start = inspect.getsourcelines(fn)
    return (_package_path(inspect.getsourcefile(fn)), start,
            start + len(src) - 1)


def line_of(fn, text: str) -> str:
    """The site key (``path:line``) of ``fn``'s first line holding
    ``text``."""
    import inspect
    src, start = inspect.getsourcelines(fn)
    i = next(i for i, line in enumerate(src) if text in line)
    return f"{site_lines(fn)[0]}:{start + i}"


def sites_in(sites: dict, fns) -> dict:
    """The rows of an ``attribution`` whose key names a line of one of
    the functions ``fns`` anywhere in its chain (``path:line < path:line
    (backward)``)."""
    ranges = [site_lines(f) for f in fns]

    def inside(key):
        return any(path == p and a <= int(line) <= b
                   for path, line in re.findall(r"([\w/]+\.py):(\d+)", key)
                   for p, a, b in ranges)
    return {k: v for k, v in sites.items() if inside(k)}


def _shape_of(t: torch.Tensor) -> list:
    return [str(t.dtype).removeprefix("torch."), list(t.shape)]


class CostCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """What one rank runs, operator by operator, on its local tensors:
    ``flops``, ``bytes``, ``collectives`` (operand bytes by JAX's kind)
    and live storage bytes (``live``, ``peak``). An operator on a DTensor
    is left to DTensor, whose local operators come back here; the
    operators of DTensor's sharding propagation are not counted.
    `register` adds storages that exist before the step (the arguments).
    With ``attribute``, ``sites`` holds the flops and collective bytes by
    `call_site` (run it under `attributing`, so that a backward node
    knows its forward site)."""

    def __init__(self, attribute: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        _mark_dtensor_internals()
        self._flop = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {k: 0.0 for k in COLLECTIVE_KINDS}
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._seen: dict = {}            # id(storage) -> bytes
        self.sites: dict | None = {} if attribute else None

    def register(self, t: torch.Tensor) -> bool:
        """Track ``t``'s storage as live until it is freed; False when it
        already is."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return False
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return True

    def _free(self, key) -> None:
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_PROPAGATING, "depth", 0):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        if ns == "prim":                     # metadata queries (prim.device)
            return
        name = func._schema.name.split("::")[-1]
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if outs and all(t.is_meta for t in outs):
            return          # shapes only (a cache's layout): no memory, no work
        for t in outs:
            self.register(t)
        if ns in ("_c10d_functional", "c10d", "_dtensor"):
            kind = _COLLECTIVE_OF.get(name)
            if kind is not None:
                moved = sum(_nbytes(t) for t in ins)
                self.collectives[kind] += moved
                self._attribute(kind, moved, ins)
            return
        if func.is_view or name in ("detach", "alias", "lift_fresh",
                                    "empty", "empty_strided", "empty_like"):
            return
        self.ops += 1
        if ns == "repro_torch" and name == "wkv6":
            flops, moved = wkv6_cost(args[0], args[2])
            self.flops += flops
            self.bytes += moved
            self._attribute("flops", flops, ins, name)
            return
        fn = self._flop.get(func._overloadpacket)
        if fn is not None:
            flops = fn(*args, **kwargs, out_val=out)
            self.flops += flops
            self._attribute("flops", flops, ins, name)
        written = {id(t.untyped_storage()) for t in outs}
        self.bytes += sum(_nbytes(t) for t in outs)
        self.bytes += sum(_nbytes(t) for t in ins
                          if id(t.untyped_storage()) not in written)

    def _attribute(self, kind: str, amount: float, ins: list,
                   name: str = "") -> None:
        """Add ``amount`` (flops, or a collective kind's operand bytes) to
        the calling site in `sites`, with its operands' shapes."""
        if self.sites is None or not amount:
            return
        site = call_site()
        if site is None:
            node = _node_site(torch._C._current_autograd_node())
            site = f"{node} (backward)" if node else "(no site)"
        row = self.sites.setdefault(site, {"flops": 0.0, "collectives": {},
                                           "shapes": {}})
        if kind == "flops":
            row["flops"] += amount
        else:
            row["collectives"][kind] = row["collectives"].get(kind, 0) + \
                amount
        shapes = row["shapes"].setdefault(kind, [])
        entry = [name] + [_shape_of(t) for t in ins] if name else \
            [_shape_of(t) for t in ins]
        if entry not in shapes and len(shapes) < ATTRIBUTE_SHAPES:
            shapes.append(entry)


@contextlib.contextmanager
def attributing(on: bool = True):
    """Autograd's anomaly mode (no NaN check: fake tensors have no values)
    when ``on``: every node keeps the stack that made it, which
    `CostCounter` reads to key a backward node's operators."""
    if not on:
        yield
        return
    import warnings
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Anomaly Detection")
        with torch.autograd.detect_anomaly(check_nan=False):
            yield


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def measure(fn, args: tuple, alias_of, device: torch.device,
            attribute: bool = False) -> dict:
    """Run ``fn(*args)`` (fake tensors, the mesh's rules active) under a
    `CostCounter`: flops, bytes and collectives of the run, and the memory
    of one rank (``argument_bytes`` of ``args``' local storages,
    ``output_bytes``, ``alias_bytes`` = ``alias_of(args, out)``'s local
    bytes, ``temp_bytes``, ``peak``); with ``attribute``, ``sites`` too
    (`CostCounter.sites`)."""
    counter = CostCounter(attribute)
    arg_leaves = [_local(t) for t in _tensors(args)]
    for t in arg_leaves:
        counter.register(t)
    argument_bytes = counter.live
    with _indexing_mode(device), attributing(attribute), counter:
        out = fn(*args)
    out_leaves = [_local(t) for t in _tensors(out)]
    seen, output_bytes = set(), 0
    for t in out_leaves:
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            output_bytes += st.nbytes()
    if len(out_leaves) > 1:
        output_bytes += 8 * len(out_leaves)      # XLA's tuple index table
    alias_bytes = sum(_local(t).untyped_storage().nbytes()
                      for t in _tensors(alias_of(args, out)))
    peak = counter.peak
    temp = max(peak - argument_bytes - output_bytes + alias_bytes, 0)
    res = {"flops": counter.flops, "bytes": counter.bytes,
           "coll": dict(counter.collectives), "ops": counter.ops,
           "memory": {"argument_bytes": int(argument_bytes),
                      "output_bytes": int(output_bytes),
                      "temp_bytes": int(temp),
                      "alias_bytes": int(alias_bytes)},
           "peak": int(argument_bytes + temp + output_bytes - alias_bytes)}
    if attribute:
        res["sites"] = counter.sites
    return res


# ---------------------------------------------------------------------------
# step builders: (fn, args, alias_of) on fake tensors
# ---------------------------------------------------------------------------

def _placed(spec, specs_of, mesh, device: torch.device):
    """`fake_tree` of ``spec`` placed by ``specs_of(spec)`` on ``mesh``
    (plain fake tensors without one)."""
    return fake_tree(spec, None if mesh is None else specs_of(spec), mesh,
                     device)


def build_train(run: RunConfig, mesh, device: torch.device):
    from repro_torch.dist import sharding as shd
    from repro_torch.models import io_spec, lm
    from repro_torch.optim import make_optimizer
    from repro_torch.train.train_state import TrainState, make_train_step
    cfg, parallel = run.model, run.parallel
    opt = make_optimizer(run.optimizer, run.learning_rate, run.weight_decay)
    params = _placed(lm.init_params(0, cfg, device="meta"),
                     lambda t: shd.param_specs(t, mesh, parallel), mesh,
                     device)
    batch = _placed(io_spec.train_batch_spec(cfg, run.shape),
                    lambda t: shd.batch_specs(t, mesh, parallel), mesh,
                    device)
    with _indexing_mode(device):
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32, device=device))

    def alias_of(args, out):
        return args[0]                         # the state, updated in place
    return make_train_step(run, opt), (state, batch), alias_of


def build_prefill(run: RunConfig, mesh, device: torch.device):
    from repro_torch.dist import sharding as shd
    from repro_torch.models import io_spec, lm
    cfg, parallel = run.model, run.parallel
    params = _placed(lm.init_params(0, cfg, device="meta"),
                     lambda t: shd.param_specs(t, mesh, parallel), mesh,
                     device)
    batch = _placed(io_spec.prefill_batch_spec(cfg, run.shape),
                    lambda t: shd.batch_specs(t, mesh, parallel), mesh,
                    device)

    def fn(p, b):
        logits, cache = lm.prefill(p, b, cfg, run.shape.seq_len, parallel)
        return _placed_logits(logits, mesh), cache
    return fn, (params, batch), lambda args, out: ()


def build_decode(run: RunConfig, mesh, device: torch.device):
    from repro_torch.dist import sharding as shd
    from repro_torch.models import io_spec, lm
    cfg, parallel = run.model, run.parallel
    params = _placed(lm.init_params(0, cfg, device="meta"),
                     lambda t: shd.param_specs(t, mesh, parallel), mesh,
                     device)
    tokens, cache = io_spec.decode_spec(cfg, run.shape)
    tokens = _placed(tokens, lambda t: shd.batch_specs(t, mesh, parallel),
                     mesh, device)
    cache = _placed(cache,
                    lambda t: shd.serve_cache_specs(t, mesh, parallel, cfg),
                    mesh, device)

    def fn(p, t, c):
        logits, new = lm.decode_step(p, t, c, cfg, parallel)
        return _placed_logits(logits, mesh), new

    def alias_of(args, out):
        # the cache leaves the step wrote in place (the same tensors)
        ids = {id(x) for x in _tensors(args[2])}
        return [x for x in _tensors(out[1]) if id(x) in ids]
    return fn, (params, tokens, cache), alias_of


def _placed_logits(logits, mesh):
    """(batch, vocab) logits placed by `logits_spec` (JAX's out_shardings
    of a serving step)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import sharding as shd
    if mesh is None or not isinstance(logits, DTensor):
        return logits
    return logits.redistribute(mesh.device_mesh, list(shd.logits_spec(
        mesh, tuple(logits.shape))))


_BUILDERS = {"train": build_train, "prefill": build_prefill,
             "decode": build_decode}


def trace_cell(run: RunConfig, mesh, device=None,
               attribute: bool = False) -> dict:
    """`measure` of ``run``'s step on fake tensors of ``device`` (the first
    CUDA device by default) placed on ``mesh`` (None: one device, plain
    tensors), under the mesh's activation rules; ``attribute`` adds
    ``sites``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist import sharding as shd
    device = (trace_device(run.shape.kind) if device is None
              else torch.device(device))
    rules = (shd.activation_rules(mesh, run.parallel) if mesh is not None
             else contextlib.nullcontext())
    with FakeTensorMode(allow_non_fake_inputs=False), rules, \
            _cuda_all_to_all(mesh):
        fn, args, alias_of = _BUILDERS[run.shape.kind](run, mesh, device)
        if run.shape.kind == "train":
            return measure(fn, args, alias_of, device, attribute)
        # a serving step on DTensors: the plain tensors it makes (RoPE
        # tables, positions, masks) act as replicated, as in the train step
        with torch.no_grad(), _replicating(mesh):
            return measure(fn, args, alias_of, device, attribute)


def _replicating(mesh):
    """``implicit_replication()`` on a mesh, else nothing."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


# ---------------------------------------------------------------------------
# the cell
# ---------------------------------------------------------------------------

def roofline(flops: float, bytes_: float, coll_bytes: float) -> dict:
    """The three terms (seconds) of one H100 at its datasheet peaks."""
    return {"compute_s": flops / PEAK_FLOPS_BF16,
            "memory_s": bytes_ / HBM_BW,
            "collective_s": coll_bytes / NET_BW}


def run_cell(arch: str, shape_name: str, mesh_kind: str, tag: str = "",
             device=None, attribute: bool = False) -> dict:
    run = make_run(arch, shape_name, tag)
    device = (trace_device(run.shape.kind) if device is None
              else torch.device(device))
    mesh = mesh_for(mesh_kind, device.type)
    n_chips = math.prod(mesh.shape)
    t0 = time.time()
    raw = trace_cell(run, mesh, device, attribute)         # the PROOF trace
    t_trace = time.time() - t0
    sites = raw.pop("sites", None)
    mem = raw.pop("memory")
    peak = raw.pop("peak")
    raw.pop("ops")
    costs = raw
    coll = costs["coll"]
    coll_bytes = float(sum(coll.values()))
    flops_dev = costs["flops"]
    bytes_dev = costs["bytes"]
    terms = roofline(flops_dev, bytes_dev, coll_bytes)
    dominant = max(terms, key=terms.get)
    mf = model_flops(run.model, run.shape)
    hlo_global = flops_dev * n_chips
    hbm = mesh_lib.hbm_bytes()
    cell = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "chips": n_chips,
        "kind": run.shape.kind,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_bytes,
        "collectives": coll,
        "raw_rolled_costs": raw,
        "memory": mem,
        "peak_bytes_per_device": int(peak),
        "fits_hbm": bool(peak <= hbm),
        "hbm_bytes": hbm,
        "roofline_terms_s": terms,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_ratio": mf / hlo_global if hlo_global else 0.0,
        "lower_s": 0.0, "compile_s": round(t_trace, 1),
        "parallel": dataclasses.asdict(run.parallel),
        "optimizer": run.optimizer,
        "device": device.type,
    }
    if sites is not None:
        cell["attribution"] = sites
    return cell


#: (flops, all-gather bytes) of one GPU's share of a 4096^3 bf16 product,
#: X [Shard(0), Replicate()] by W [Shard(0), Shard(1)] on (16, 16): its
#: (256, 4096) rows by the (4096, 256) columns it gathers over data
CHECK_PRODUCT = (2 * 256 * 4096 * 256, 256 * 256 * 2)


def check_counter(mesh) -> dict:
    """Count `CHECK_PRODUCT`'s product on ``mesh`` (a (16, 16) `SNNMesh`)
    and raise unless the counter saw one GPU's local work: neither the
    global product nor DTensor's propagation of it (a torch whose DTensor
    internals moved would show here first). Returns the counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    dev = trace_device("prefill")
    dm = mesh.device_mesh
    with FakeTensorMode(), _indexing_mode(dev):
        x, w = (torch.empty(4096, 4096, dtype=torch.bfloat16, device=dev)
                for _ in range(2))
        X = distribute_tensor(x, dm, [Shard(0), Replicate()],
                              src_data_rank=None)
        W = distribute_tensor(w, dm, [Shard(0), Shard(1)],
                              src_data_rank=None)
        counter = CostCounter()
        with counter:
            X @ W
    got = (counter.flops, counter.collectives["all-gather"])
    if got != CHECK_PRODUCT:
        raise RuntimeError(f"the counter saw (flops, all-gather bytes) = "
                           f"{got} for one GPU's share of a 4096^3 product, "
                           f"expected {CHECK_PRODUCT}")
    return {"flops": counter.flops, "coll": dict(counter.collectives)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(ART_DIR))
    ap.add_argument("--tag", default="", help="suffix for artifact files (perf iterations)")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose artifact already exists")
    ap.add_argument("--attribute", action="store_true",
                    help="add rank 0's flops and collective bytes by the "
                         "code line that ran them ('attribution')")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    check_counter(mesh_for("single"))
    failures = []
    for mesh_kind in meshes:
        outdir = Path(args.out) / mesh_kind
        outdir.mkdir(parents=True, exist_ok=True)
        for arch, shape, skip in cell_list(archs, shapes):
            tag = f"__{args.tag}" if args.tag else ""
            fp = outdir / f"{arch}__{shape}{tag}.json"
            if args.resume and fp.exists():
                print(f"[skip] {mesh_kind} {arch} {shape}: artifact exists")
                continue
            if skip:
                fp.write_text(json.dumps(
                    {"arch": arch, "shape": shape, "mesh": mesh_kind,
                     "skipped": skip}, indent=1))
                print(f"[skip] {mesh_kind} {arch} {shape}: {skip}")
                continue
            try:
                res = run_cell(arch, shape, mesh_kind, args.tag,
                               attribute=args.attribute)
                fp.write_text(json.dumps(res, indent=1))
                t = res["roofline_terms_s"]
                print(f"[ok]   {mesh_kind} {arch} {shape}: dominant={res['dominant']}"
                      f" compute={t['compute_s']:.3e}s memory={t['memory_s']:.3e}s"
                      f" coll={t['collective_s']:.3e}s peak={res['peak_bytes_per_device']/2**30:.2f}GiB"
                      f" fits={res['fits_hbm']} (trace {res['compile_s']}s)",
                      flush=True)
            except Exception as e:  # noqa: BLE001 — a failing cell is a bug to fix
                traceback.print_exc()
                failures.append((mesh_kind, arch, shape, repr(e)))
                print(f"[FAIL] {mesh_kind} {arch} {shape}: {e!r}"[:500],
                      flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f[0], f[1], f[2], f[3][:200])
        sys.exit(1)
    print("\nall requested cells traced.")


if __name__ == "__main__":
    main()
