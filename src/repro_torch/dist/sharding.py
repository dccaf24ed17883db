"""Sharding rules: logical axes to mesh placements, with divisibility
fitting, for the SNN mesh path and for LM sharding.

A placement is torch's DTensor form: one `Shard(dim)` or `Replicate()` for
each mesh dimension, in the mesh's axis order (the port's counterpart of a
JAX ``PartitionSpec``; with the mesh's `DeviceMesh` it is a
``NamedSharding``). The module has three layers, as the JAX package's:

  1. `_fit(axes, shape, mesh)`, the one primitive every rule goes through:
     a per-dimension proposal (a mesh axis name, a tuple of names, or
     None) is kept only when the dimension divides the product of the
     proposed extents, and otherwise degrades to replication, logged on
     the ``repro_torch.dist.sharding`` logger with the axis and the
     extents; a *required* axis that cannot shard raises `ShardingError`.
  2. spec builders, trees of placements: `param_specs` (tensor-parallel on
     each parameter's last axis, FSDP on its first), `batch_specs` (the
     batch over data, the sequence over model under sequence
     parallelism), `cache_specs` (heads, axis 2, over model; a serving
     step's stacked cache by `serve_cache_specs`),
     `logits_spec`, `replicated`, `logical_spec`/`logical_sharding` and
     the SNN streaming state's `snn_state_specs`. `place_tree` puts a tree
     of global tensors onto a mesh by such a tree (`distribute_tensor` a
     leaf, the port's ``jax.device_put(x, sharding)``) and `gather_tree`
     gathers one back (``full_tensor``).
  3. `activation_rules(mesh, parallel)` and `constrain(x, logical_axes)`:
     a thread-local context that maps *logical* activation axes onto the
     mesh. `constrain` is the identity outside the context and on a plain
     tensor, and redistributes a DTensor inside it (the port's
     ``with_sharding_constraint``), so model code pins activations
     unconditionally and every single-device path is unchanged.
     `head_local(fn, args, ...)` runs attention's score products and the
     RWKV recurrence with each model rank on its own heads (JAX's
     placement: XLA keeps the heads where the projections shard them),
     `fn` itself outside the rules.

The logical axes: ``batch``, ``lane`` and ``bank`` (serving lanes, frame
banks) partition over data; ``vocab``, ``experts``, ``ffn``, ``heads``,
``embed`` and ``seq`` (only under ``parallel.seq_parallel``) over model,
and so does ``macro_row_tile``, the row-tiled fan-in of the IMPULSE macro
(each model rank owns a row tile and adds its unclamped int32 partial V in
the cross-rank AccV2V reduction).

A mesh is an `launch.mesh.SNNMesh` or, for the spec builders, a plain
``{axis: extent}`` dict; placing and constraining need the mesh's
`DeviceMesh`.
"""
from __future__ import annotations

import contextlib
import logging
import math
import threading
from typing import Any, Optional

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import mesh_extents
from repro_torch.tree import tree_leaves, tree_map

logger = logging.getLogger("repro_torch.dist.sharding")

#: logical axis -> mesh axis: "batch" always to data, the model-parallel
#: names onto the model axis, the SNN axes as the module says
_LOGICAL_TO_MESH = {
    "batch": "data",
    "vocab": "model",
    "experts": "model",
    "ffn": "model",
    "heads": "model",
    "embed": "model",
    "seq": "model",          # only applied when parallel.seq_parallel
    # --- SNN axes (core.pipeline / serve.snn_engine) ---
    "macro_row_tile": "model",
    "bank": "data",
    "lane": "data",
}


class ShardingError(ValueError):
    """A logical axis that was explicitly required could not be honoured:
    its dimension does not divide the proposed mesh extent, or the mesh
    has no such axis. Raised by `_fit`/`logical_spec` instead of silently
    degrading to replication."""


def _axis_names(mesh) -> tuple:
    return tuple(mesh_extents(mesh))


def _fit(axes: tuple, shape: tuple, mesh, *, required: tuple = ()) -> tuple:
    """Fit a per-dimension mesh-axis proposal ``axes`` onto the dimension
    sizes ``shape``: returns one placement per mesh dimension.

    A proposal is dropped (the dimension replicates) when the dimension
    does not divide the proposed extent, or when its axis was consumed by
    an earlier dimension; every divisibility drop is logged with the axis
    and the extents. ``required``: mesh-axis names that must not degrade;
    dropping one raises `ShardingError` (a size-1 mesh axis counts as
    honoured: sharding over it is replication)."""
    sizes = mesh_extents(mesh)
    names_order = _axis_names(mesh)
    required = set(required)
    used: set = set()
    placements = {n: Replicate() for n in names_order}
    for i, (dim, prop) in enumerate(
            zip(shape, tuple(axes) + (None,) * (len(shape) - len(axes)))):
        if prop is None:
            continue
        names = prop if isinstance(prop, tuple) else (prop,)
        if any(n not in sizes or n in used for n in names):
            if required.intersection(names):
                raise ShardingError(
                    f"required mesh axis {sorted(required & set(names))} "
                    f"cannot shard dim {i} (size {dim}) of shape {shape}: "
                    f"axis missing from mesh {sorted(sizes)} or already "
                    f"consumed by an earlier dimension")
            continue
        extent = 1
        for n in names:
            extent *= sizes[n]
        if extent == 1:
            continue              # sharding over size 1 is replication
        if dim % extent == 0:
            for n in names:
                placements[n] = Shard(i)
            used.update(names)
        else:
            logger.warning(
                "sharding._fit: dropping axis %r on dim %d of shape %s — "
                "size %d does not divide mesh extent %d; degrading to "
                "replication", prop, i, tuple(shape), dim, extent)
            if required.intersection(names):
                raise ShardingError(
                    f"required mesh axis {sorted(required & set(names))} "
                    f"cannot shard dim {i} of shape {tuple(shape)}: size "
                    f"{dim} does not divide mesh extent {extent}")
    return tuple(placements[n] for n in names_order)


def logical_spec(mesh, logical_axes: tuple, shape: tuple, *,
                 required: tuple = ()) -> tuple:
    """Resolve per-dimension *logical* axis names onto ``mesh``: one
    placement per mesh dimension.

    ``logical_axes``: one entry per dimension of ``shape``, a logical name
    of `_LOGICAL_TO_MESH` (``lane``, ``macro_row_tile``, ``bank``,
    ``batch``), a raw mesh-axis name, a tuple of such names, or None.
    Fitting and degradation follow `_fit`. ``required``: logical names
    that must be honoured; an unknown name there raises `ShardingError`
    (a typo would otherwise replicate silently)."""
    sizes = mesh_extents(mesh)

    def to_mesh(name):
        if name is None:
            return None
        if isinstance(name, tuple):
            resolved = tuple(m for m in (to_mesh(n) for n in name)
                             if m is not None)
            return resolved or None
        return _LOGICAL_TO_MESH.get(name, name if name in sizes else None)

    req_mesh = []
    for name in required:
        m = to_mesh(name)
        if m is None:
            raise ShardingError(
                f"required logical axis {name!r} resolves to no mesh axis "
                f"(known logical names: {sorted(_LOGICAL_TO_MESH)}; mesh "
                f"axes: {sorted(sizes)})")
        req_mesh.extend(m if isinstance(m, tuple) else (m,))
    prop = tuple(to_mesh(n) for n in logical_axes)
    return _fit(prop, tuple(shape), mesh, required=tuple(req_mesh))


def logical_sharding(mesh, logical_axes: tuple, shape: tuple, *,
                     required: tuple = ()) -> tuple:
    """`logical_spec`'s placements: the form `place_tree` and
    `distribute_tensor` take with the mesh's `DeviceMesh` (JAX's
    ``NamedSharding`` of the spec; a torch placement names no mesh)."""
    return logical_spec(mesh, logical_axes, shape, required=required)


def replicated(mesh) -> tuple:
    """Full replication on ``mesh``: `Replicate()` on every axis."""
    return tuple(Replicate() for _ in _axis_names(mesh))


# ---------------------------------------------------------------------------
# parameter / batch / cache placement
# ---------------------------------------------------------------------------

def _param_rule(shape: tuple, parallel) -> tuple:
    """The generic parameter rule: tensor-parallel on the trailing (output)
    axis, FSDP on the leading (input) axis; `_fit` drops what does not
    divide, so one rule covers embeddings, dense kernels, stacked layers
    and experts, and norm scales."""
    if len(shape) == 0:
        return ()
    if len(shape) == 1:
        return ("data",) if parallel.fsdp else (None,)
    prop: list = [None] * len(shape)
    prop[-1] = "model"
    if parallel.fsdp:
        prop[0] = "data"
    return tuple(prop)


def param_specs(params: Any, mesh, parallel) -> Any:
    """A tree of parameters (tensors, ``meta`` tensors too) -> the tree of
    their placements on ``mesh``."""
    def spec(leaf):
        shape = tuple(leaf.shape)
        return _fit(_param_rule(shape, parallel), shape, mesh)
    return tree_map(spec, params)


def batch_specs(batch: Any, mesh, parallel) -> Any:
    """Placements of an input ``batch`` tree: each leaf's leading axis over
    data and, with ``parallel.seq_parallel``, its sequence axis (axis 1)
    over model."""
    def spec(leaf):
        shape = tuple(leaf.shape)
        prop: list = [None] * len(shape)
        if len(shape) >= 1:
            prop[0] = "data"
        if parallel.seq_parallel and len(shape) >= 2:
            prop[1] = "model"
        return _fit(tuple(prop), shape, mesh)
    return tree_map(spec, batch)


def cache_specs(cache: Any, mesh, parallel, cfg=None) -> Any:
    """Placements of a K/V, latent or state ``cache`` tree: the batch over
    data and, where a leaf has three axes or more, axis 2 (the heads of a
    (B, S, H, D) layout) over model when it divides (``parallel`` and
    ``cfg`` are JAX's, kept for rule variants)."""
    def spec(leaf):
        shape = tuple(leaf.shape)
        prop: list = [None] * len(shape)
        if len(shape) >= 1:
            prop[0] = "data"
        if len(shape) >= 3:
            prop[2] = "model"
        return _fit(tuple(prop), shape, mesh)
    return tree_map(spec, cache)


def logits_spec(mesh, shape: tuple) -> tuple:
    """Placements of (batch, vocab) logits of ``shape``: batch over data,
    vocab over model."""
    return _fit(("data", "model"), tuple(shape), mesh)


def device_mesh_of(mesh):
    """The `DeviceMesh` that DTensors of ``mesh`` (an `SNNMesh`) live on.
    A dict or a mesh built without a process group has none: raises
    `ValueError` (placing onto it would have no ranks to place on)."""
    dm = getattr(mesh, "device_mesh", None)
    if dm is None:
        raise ValueError(
            f"{mesh!r} has no DeviceMesh: LM placements need a mesh made by "
            "launch.mesh.make_mesh over an initialized process group (a "
            "world of one for a (1, 1) mesh)")
    return dm


def place_tree(tree: Any, mesh, specs: Any) -> Any:
    """Each leaf of ``tree``, a global tensor (the same on every rank), as
    a DTensor on ``mesh`` with its placements in ``specs`` (a tree of
    ``tree``'s structure, e.g. `param_specs`'): every rank keeps its own
    shard, cut locally (no collective)."""
    dm = device_mesh_of(mesh)
    return tree_map(lambda x, p: distribute_tensor(
        x, dm, list(p), src_data_rank=None), tree, specs)


def gather_tree(tree: Any) -> Any:
    """`place_tree`'s inverse: every DTensor leaf of ``tree`` as its
    global tensor on every rank (``full_tensor``, an all-gather); other
    leaves as they are."""
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)


def _register_flip_rule() -> None:
    """DTensor's rule for ``aten.flip`` (``cumsum``'s backward reverses
    with it; torch 2.11's DTensor has no rule, 2.13's allows the same
    placements): replicated, or sharded on a dimension it does not
    reverse."""
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.flip.default)
    def rule(x, dims):
        flipped = {d % x.ndim for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None]) for d in range(x.ndim)
            if d not in flipped]


_register_flip_rule()


def replicated_call(fn, *args):
    """``fn`` on the global values of its DTensor arguments: each is
    redistributed to replicated and ``fn`` runs on its local (= global)
    tensor on every rank; tensor outputs come back as replicated DTensors
    of the first DTensor argument's mesh. For operations without a DTensor
    sharding rule (a sort-based dispatch); differentiable, and the values
    are ``fn``'s own."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    rep = [Replicate()] * mesh.ndim
    local = [a.redistribute(mesh, rep).to_local()
             if isinstance(a, DTensor) else a for a in args]
    out = fn(*local)

    def wrap(t):
        return (DTensor.from_local(t, mesh, rep, run_check=False)
                if torch.is_tensor(t) else t)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def local_lookup(table: DTensor, idx: torch.Tensor) -> DTensor:
    """``table[idx]`` with each rank on its own rows of ``idx``: the table
    is gathered (replicated, as `replicated_call` gathers it), ``idx``
    keeps its placements (a plain tensor acts as replicated) and each rank
    looks up its local shard, so the output is placed as ``idx`` (a batch
    over data stays there: no rank holds the global batch's
    embeddings). The lookup and its backward run on local tensors (the
    accumulating ``index_put`` has no sound DTensor rule in every torch);
    the table's gradient is partial over the mesh axes that split
    ``idx``."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    rep = [Replicate()] * mesh.ndim
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, rep, run_check=False)
    rows = list(idx.placements)
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in rows]
    return local_map(_index, rows, in_placements=(rep, rows),
                     in_grad_placements=(grad, rows), device_mesh=mesh,
                     redistribute_inputs=True)(table, idx)


def _index(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx]


def snn_state_specs(state: Any, mesh) -> Any:
    """Placements of a streaming state (`core.pipeline.StreamState`): every
    tensor leaf's leading axis is the serving lane and shards over the
    data axis when it divides; a shapeless leaf (the tick counter)
    replicates. `SNNServeEngine(mesh=)` places each page of its pool by
    these, and `pipeline.stream_step`/`stream_megastep` take a state so
    placed."""
    def spec(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        prop = ("lane",) + (None,) * (len(shape) - 1) if shape else ()
        return logical_spec(mesh, prop, shape)
    return tree_map(spec, state)


def local_shard(x: torch.Tensor, placements: tuple, mesh) -> torch.Tensor:
    """This rank's piece of the global tensor ``x`` under ``placements``
    (`logical_spec`'s form): a contiguous chunk along each sharded
    dimension, in mesh order, for the rank's coordinates."""
    for axis, p in zip(_axis_names(mesh), placements):
        if isinstance(p, Shard):
            n = mesh_extents(mesh)[axis]
            size = x.shape[p.dim] // n
            x = x.narrow(p.dim, mesh.coord(axis) * size, size)
    return x


def shard_state(state: Any, mesh) -> Any:
    """The rank's shard of a global streaming state, placed by
    `snn_state_specs`: each tensor leaf's lane slice when its lanes divide
    the data extent, the whole leaf otherwise; the tick counter as is."""
    specs = snn_state_specs(state, mesh)
    vs = tuple(local_shard(v, p, mesh).clone()
               for v, p in zip(state.vs, specs.vs))
    return state._replace(vs=vs)


# ---------------------------------------------------------------------------
# activation rules context + constrain
# ---------------------------------------------------------------------------

class _Rules(threading.local):
    mesh: Optional[Any] = None
    parallel: Any = None


_RULES = _Rules()


@contextlib.contextmanager
def activation_rules(mesh, parallel):
    """Activate logical-axis constraints onto ``mesh`` (an `SNNMesh` with
    a `DeviceMesh`), read under the ``parallel`` flags, for the code run
    inside the context on this thread (a checkpointed region's recompute
    takes them along through `recompute_contexts`). Outside it `constrain`
    is the identity."""
    prev = (_RULES.mesh, _RULES.parallel)
    _RULES.mesh, _RULES.parallel = mesh, parallel
    try:
        yield
    finally:
        _RULES.mesh, _RULES.parallel = prev


def recompute_contexts():
    """``context_fn`` of `torch.utils.checkpoint`: (the forward's context,
    the recompute's), the recompute re-entering the rules active at the
    forward. Autograd recomputes a checkpointed region on its device
    thread (CUDA), where the thread-local rules are not set, and a
    recompute must place its activations as the forward did."""
    return (contextlib.nullcontext(),
            activation_rules(_RULES.mesh, _RULES.parallel))


def recomputed(fn, *args):
    """``fn(*args)`` recomputed in the backward pass (the JAX package's
    ``jax.checkpoint``): non-reentrant `torch.utils.checkpoint` under
    `recompute_contexts`. The RNG state is not stashed: no loss draws
    random numbers inside a recomputed region, so the recompute's values
    are the forward's without it, and stashing reads the CUDA generator,
    which a CUDA graph capture (a compiled train step) forbids."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=recompute_contexts)


def whole_axis(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``x`` with axis ``dim`` whole on every rank: a DTensor sharded there
    is redistributed to replication on those mesh axes (its other
    placements kept; DTensor cannot unbind a sharded axis); any other
    tensor as it is."""
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Shard) and p.dim == dim for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == dim else p
        for p in x.placements])


def _laid_out(x: DTensor) -> DTensor:
    """``x`` with a contiguous local shard and contiguous global strides
    (a copy of the shard only when it is not contiguous)."""
    from torch.distributed.tensor._utils import compute_global_tensor_info
    local = x.to_local().contiguous()
    shape, stride = compute_global_tensor_info(local, x.device_mesh,
                                               x.placements)
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _laid_out(g) if isinstance(g, DTensor) else g.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient comes back with a contiguous local shard and
    contiguous global strides when ``x`` is a DTensor that requires one. A
    permuted gradient's layout is otherwise decided twice, on the global
    shape by DTensor and on the shard by the operator, and the two can
    differ (the next view of the shard then fails). A plain tensor is
    returned as it is."""
    if isinstance(x, DTensor) and x.requires_grad:
        return _ContiguousGrad.apply(x)
    return x


def _resolved(logical_axes: tuple) -> tuple:
    """``logical_axes`` as mesh axis names under the active rules."""
    parallel, sizes = _RULES.parallel, mesh_extents(_RULES.mesh)

    def to_mesh(name):
        if name is None:
            return None
        if isinstance(name, tuple):
            resolved = tuple(m for m in (to_mesh(n) for n in name)
                             if m is not None)
            return resolved or None
        if (name == "seq" and parallel is not None
                and not parallel.seq_parallel):
            return None
        return _LOGICAL_TO_MESH.get(name, name if name in sizes else None)
    return tuple(to_mesh(n) for n in logical_axes)


def shards_all(logical_axes: tuple, shape: tuple) -> bool:
    """Whether `constrain` would shard every axis that ``logical_axes``
    names on a tensor of ``shape``: under active rules, each named axis
    resolves to a mesh axis whose extent divides it. False without
    rules."""
    mesh = _RULES.mesh
    if mesh is None:
        return False
    prop = _resolved(logical_axes)
    placements = _fit(prop, tuple(shape), mesh)
    named = {i for i, a in enumerate(prop) if a is not None}
    return named <= {p.dim for p in placements if isinstance(p, Shard)}


def constrain(x: torch.Tensor, logical_axes: tuple) -> torch.Tensor:
    """Pin an activation's logical axes onto the active mesh. ``x`` itself
    when no rules are active or when ``x`` is a plain tensor; a DTensor is
    redistributed to `_fit`'s placements of the resolved axes (a value
    moves between ranks, never changes). Entries of ``logical_axes`` are
    logical names ("batch", "seq", "vocab", "experts", "ffn", "heads"), a
    mesh axis name, tuples of names, or None; "seq" resolves to nothing
    unless ``parallel.seq_parallel``."""
    mesh = _RULES.mesh
    if mesh is None or not isinstance(x, DTensor):
        return x
    placements = _fit(_resolved(logical_axes), tuple(x.shape), mesh)
    if tuple(x.placements) == placements:
        return x
    out = x.redistribute(device_mesh_of(mesh), placements)
    # a permuted global layout (an einsum's output) with freshly cut local
    # shards trips DTensor's view rules in the next op: lay it out anew
    return out if out.is_contiguous() else out.contiguous()


def contracted_as(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """An output projection's weight ``w`` (in, out) that takes a
    gradient, placed for ``x @ w``: under active rules, its input axis as
    ``x``'s last axis (over model where that is) and its output axis
    whole, which the parameter rule puts on model. DTensor moves the
    weight so inside the forward product anyway, but autograd keeps the
    stored weight for the backward, which then contracts the output's
    gradient over its model shard and makes every input column in partial
    sums (a reduce-scatter of a (rows, hidden) tensor a layer); placed
    here, each rank's backward makes its own columns. ``w`` itself
    without active rules, without DTensors, for a weight without a
    gradient (serving: the forward is DTensor's own either way), or where
    no mesh axis splits ``x``'s last axis (heads gathered onto every rank:
    the product is then DTensor's column-parallel one, and gathering
    ``w`` whole would only move more)."""
    if _RULES.mesh is None or not (isinstance(w, DTensor)
                                   and splits_last(x) and w.requires_grad):
        return w
    last = x.dim() - 1
    placements = tuple(Shard(0) if isinstance(p, Shard) and p.dim == last
                       else Replicate() for p in x.placements)
    if tuple(w.placements) == placements:
        return w
    return w.redistribute(w.device_mesh, placements)


def splits_last(x: torch.Tensor) -> bool:
    """Whether ``x`` is a DTensor whose last axis a mesh axis of more than
    one rank splits."""
    return isinstance(x, DTensor) and any(
        isinstance(p, Shard) and p.dim == x.dim() - 1
        and x.device_mesh.size(i) > 1 for i, p in enumerate(x.placements))


def pick_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x.gather(-1, idx[..., None])[..., 0]``. For ``x`` sharded on its
    last axis (`splits_last`) each rank picks the indices that fall in its
    shard (0 elsewhere), so the result is a partial sum over those mesh
    axes, reduced where it is used, and no rank gathers the axis; ``idx``
    is placed as ``x``'s leading axes. The gradient reaches the owner's
    element alone (a replicated gradient of a partial output is not
    divided in the backward). The plain gather otherwise."""
    if not splits_last(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh, last = x.device_mesh, x.dim() - 1
    coord = mesh.get_coordinate()
    offset, width = 0, x.shape[last]
    for i, p in enumerate(x.placements):       # torch.chunk's split
        if isinstance(p, Shard) and p.dim == last:
            width = -(-width // mesh.size(i))
            offset += coord[i] * width
    rows = [Replicate() if isinstance(p, Shard) and p.dim == last else p
            for p in x.placements]
    out = [Partial() if isinstance(p, Shard) and p.dim == last else p
           for p in x.placements]
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)

    def pick(x, idx):
        local = idx - offset
        inside = (local >= 0) & (local < x.shape[-1])
        got = torch.gather(x, -1, local.clamp(0, x.shape[-1] - 1)[..., None])
        return torch.where(inside, got[..., 0], torch.zeros_like(got[..., 0]))
    return local_map(pick, out, in_placements=(list(x.placements), rows),
                     in_grad_placements=(list(x.placements), rows),
                     device_mesh=mesh, redistribute_inputs=True)(x, idx)


def split_heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """``x`` (..., H * head_dim) as (..., H, head_dim). Under active rules,
    a DTensor whose last axis is sharded over extents that do not divide
    H is gathered on that axis first: DTensor cannot cut a sharded axis
    into heads unevenly (XLA reshards there by itself). The plain reshape
    otherwise."""
    n_heads = x.shape[-1] // head_dim
    mesh = _RULES.mesh
    if mesh is not None and isinstance(x, DTensor):
        sizes = mesh_extents(mesh)
        last = x.dim() - 1
        extent = 1
        for name, p in zip(_axis_names(mesh), x.placements):
            if isinstance(p, Shard) and p.dim == last:
                extent *= sizes[name]
        if n_heads % extent:
            placements = tuple(Replicate() if isinstance(p, Shard)
                               and p.dim == last else p
                               for p in x.placements)
            x = x.redistribute(device_mesh_of(mesh), placements)
    return x.reshape(tuple(x.shape[:-1]) + (n_heads, head_dim))


def head_branch(n_heads: int, kv_heads: int, model: int) -> str:
    """How `head_local` places ``n_heads`` query heads that read
    ``kv_heads`` group heads (GQA) on a model extent ``model``:
    ``"local"`` when the group heads divide it (every input on its own
    heads), ``"grouped"`` when the query heads divide it and it divides
    the group heads' count (each rank's queries read one group head),
    ``"gathered"`` otherwise (every head on every model rank)."""
    if kv_heads % model == 0:
        return "local"
    if n_heads % model == 0 and model % kv_heads == 0:
        return "grouped"
    return "gathered"


def head_local(fn, args: tuple, axes: tuple, out_axes: tuple):
    """``fn(*args)`` with each model rank on its own heads, as JAX's
    attention and RWKV recurrence run (XLA keeps the heads where the
    tensor-parallel projections put them, on model).

    ``args``: tensors, or None for an absent one; ``axes``: one layout per
    argument, naming each dimension ``"batch"``, ``"heads"``,
    ``"kv_heads"`` (a GQA group's K or V) or None; the first argument
    carries the batch and the query heads. ``out_axes``: the layout of
    ``fn``'s output, or a tuple of layouts for a tuple of outputs.

    Outside the rules, or with no DTensor argument, this is ``fn(*args)``.
    Under them every argument is placed with its batch over data and its
    heads over model where `_fit` says the extents divide (a sequence-
    sharded input is resharded to its heads, an all-to-all, and a plain
    tensor acts as replicated), ``fn`` runs on the local tensors, and its
    outputs come back as DTensors with the batch and heads so placed. The
    branch is `head_branch`'s: in ``"grouped"`` K and V stay whole over
    model and each rank slices the one group head its queries read (q
    head h reads group head h // (H / KV)); ``"gathered"`` is logged with
    the shape. Differentiable: an input replicated on a mesh axis that
    splits the work (K and V over model when grouped, RWKV's bonus over
    data) takes a partial gradient there."""
    mesh = _RULES.mesh
    if mesh is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    model = mesh_extents(mesh).get("model", 1)
    q = args[0]
    n_heads = q.shape[axes[0].index("heads")]
    kv_heads = next((a.shape[ax.index("kv_heads")] for a, ax in
                     zip(args, axes) if a is not None and "kv_heads" in ax),
                    n_heads)
    branch = head_branch(n_heads, kv_heads, model)
    if branch == "gathered":
        logger.warning(
            "sharding.head_local: %d query heads of %d groups (shape %s) "
            "do not split over model extent %d; gathering every head onto "
            "each model rank", n_heads, kv_heads, tuple(q.shape), model)
    heads = _LOGICAL_TO_MESH["heads"]
    to_mesh = {"batch": _LOGICAL_TO_MESH["batch"],
               "heads": None if branch == "gathered" else heads,
               "kv_heads": heads if branch == "local" else None}
    dm = device_mesh_of(mesh)
    present = [i for i, a in enumerate(args) if a is not None]
    ins = [args[i] if isinstance(args[i], DTensor) else DTensor.from_local(
        args[i], dm, [Replicate()] * dm.ndim, run_check=False)
        for i in present]
    in_pl = [_fit(tuple(to_mesh.get(n) for n in axes[i]),
                  tuple(args[i].shape), mesh) for i in present]
    work = in_pl[0]
    grad_pl = [tuple(p if isinstance(p, Shard) else
                     Partial() if isinstance(w, Shard) else Replicate()
                     for p, w in zip(pl, work)) for pl in in_pl]
    lead = axes[0]
    layouts = out_axes if isinstance(out_axes[0], tuple) else (out_axes,)
    out_pl = tuple(tuple(Shard(layout.index(lead[w.dim]))
                         if isinstance(w, Shard) else Replicate()
                         for w in work) for layout in layouts)
    group = (mesh.coord(heads) // (model // kv_heads)
             if branch == "grouped" else None)

    def local(*xs):
        full = [None] * len(args)
        for i, x in zip(present, xs):
            if x.requires_grad:
                # a product's gradient comes back permuted; its DTensor
                # would take contiguous strides for it (`contiguous_grad`)
                x = _ContiguousGrad.apply(x)
            if group is not None and "kv_heads" in axes[i]:
                x = x.narrow(axes[i].index("kv_heads"), group, 1)
            full[i] = x
        return fn(*full)
    # one output takes a list of placements: local_map reads a tuple as
    # one placement list per output
    out_pl = out_pl if layouts is out_axes else list(out_pl[0])
    return local_map(local, out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=dm,
                     redistribute_inputs=True)(*ins)


# ---------------------------------------------------------------------------
# serving caches under a mesh
# ---------------------------------------------------------------------------

def serve_cache_specs(cache: Any, mesh, parallel, cfg=None) -> Any:
    """Placements a serving step keeps its cache in: `cache_specs`, except
    that a stacked leaf (``cache["blocks"]``, the layer axis first) keeps
    the layer axis whole and puts the mesh axes `cache_specs` gives it on
    the batch (axis 1) where they divide it (else replicated): a layer's
    slice is then a view of this rank's shard, which the step writes in
    place. Where the extents divide, a rank holds as many bytes as under
    `cache_specs` (JAX's rule, whose stacked layer axis is scanned)."""
    specs = cache_specs(cache, mesh, parallel, cfg)
    if not isinstance(cache, dict) or "blocks" not in cache:
        return specs
    sizes, names = mesh_extents(mesh), _axis_names(mesh)

    def per_layer(leaf, placements):
        on1 = math.prod(sizes[n] for n, p in zip(names, placements)
                        if isinstance(p, Shard) and p.dim == 1)
        out = []
        for n, p in zip(names, placements):
            if isinstance(p, Shard) and p.dim == 0:
                if leaf.dim() > 1 and leaf.shape[1] % (on1 * sizes[n]) == 0:
                    on1 *= sizes[n]
                    p = Shard(1)
                else:
                    p = Replicate()
            out.append(p)
        return tuple(out)
    specs = dict(specs)
    specs["blocks"] = tree_map(per_layer, cache["blocks"], specs["blocks"])
    return specs


def cache_zeros(make, like, cfg=None) -> Any:
    """A zero serving cache: ``make(device)`` (e.g. `lm.init_cache` of the
    right sizes) on ``like``'s device, or, under active rules with
    ``like`` a DTensor, the same tree as DTensors placed by
    `serve_cache_specs` on the active mesh, each rank allocating only its
    shards."""
    mesh = _RULES.mesh
    if mesh is None or not isinstance(like, DTensor):
        return make(like.device)
    from torch.distributed.tensor import zeros
    meta = make(torch.device("meta"))
    dm = device_mesh_of(mesh)
    return tree_map(lambda m, p: zeros(tuple(m.shape), dtype=m.dtype,
                                       device_mesh=dm, placements=list(p)),
                    meta, serve_cache_specs(meta, mesh, _RULES.parallel,
                                            cfg))


def placed_as(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` redistributed to ``like``'s placements when both are DTensors
    whose placements differ; ``x`` itself otherwise."""
    if (isinstance(x, DTensor) and isinstance(like, DTensor)
            and tuple(x.placements) != tuple(like.placements)):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def check_layer_sliceable(tree: Any) -> None:
    """Raise `ValueError` when a DTensor leaf of a stacked cache tree
    shards its layer axis (0): its layer slice would be a gathered copy,
    and the step's in-place writes would be lost (`serve_cache_specs`
    places a cache for the step)."""
    for x in tree_leaves(tree):
        if isinstance(x, DTensor) and any(
                isinstance(p, Shard) and p.dim == 0
                and x.device_mesh.size(i) > 1
                for i, p in enumerate(x.placements)):
            raise ValueError(
                f"a stacked cache leaf of shape {tuple(x.shape)} is sharded "
                f"on its layer axis ({x.placements}): place the cache by "
                "serve_cache_specs")


def _local_box(x: DTensor) -> tuple:
    """(local shape, global offset) of this rank's shard of ``x``, by
    `torch.chunk`'s split (a ceiling piece a rank), mesh dimension by mesh
    dimension, from the mesh coordinate (no tensor is read)."""
    shape, off = list(x.shape), [0] * x.dim()
    coord = x.device_mesh.get_coordinate()
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            n, k = shape[p.dim], x.device_mesh.size(i)
            piece = -(-n // k)
            start = min(coord[i] * piece, n)
            off[p.dim] += start
            shape[p.dim] = max(0, min(piece, n - start))
    return tuple(shape), tuple(off)


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def put_rows(cache: torch.Tensor, pos: torch.Tensor,
             row: torch.Tensor) -> None:
    """``cache[b, pos[b]] = row[b]`` in place for every lane b of a (B, S,
    ...) cache whose ``pos[b]`` < S; a lane at or past S writes nothing
    (JAX's out-of-bounds scatter). On a DTensor cache each rank writes the
    rows that fall in its shard of (B, S, ...), from the gathered
    positions and rows (one token a lane)."""
    B, S = cache.shape[0], cache.shape[1]
    if not isinstance(cache, DTensor):
        b_idx = torch.arange(B, device=cache.device)
        at = pos.long().clamp(max=S - 1)
        inside = (pos < S).reshape((B,) + (1,) * (row.dim() - 1))
        cache.index_put_((b_idx, at), torch.where(inside, row,
                                                  cache[b_idx, at]))
        return
    shape, off = _local_box(cache)
    local = cache.to_local()
    lanes = slice(off[0], off[0] + shape[0])
    at = _full(pos).long()[lanes] - off[1]
    r = _full(row).to(local.dtype)[lanes]
    for d in range(1, r.dim()):
        r = r.narrow(d, off[d + 1], shape[d + 1])
    ok = ((at >= 0) & (at < shape[1])).reshape(
        (shape[0],) + (1,) * (r.dim() - 1))
    at = at.clamp(0, max(shape[1] - 1, 0))
    b_idx = torch.arange(shape[0], device=local.device)
    local.index_put_((b_idx, at), torch.where(ok, r, local[b_idx, at]))


def put_prefix(cache: torch.Tensor, x: torch.Tensor) -> None:
    """``cache[:, :T] = x`` in place for x (B, T, ...) and a (B, S, ...)
    cache, T <= S. On a DTensor cache ``x`` is placed as the cache but
    whole along axis 1, and each rank copies the part of its shard's
    positions that lies below T."""
    T = x.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, :T].copy_(x)
        return
    want = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in cache.placements]
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, cache.device_mesh,
                               [Replicate()] * cache.device_mesh.ndim,
                               run_check=False)
    xl = x.redistribute(cache.device_mesh, want).to_local()
    shape, off = _local_box(cache)
    lo, hi = off[1], min(off[1] + shape[1], T)
    if hi > lo:
        cache.to_local().narrow(1, 0, hi - lo).copy_(
            xl.narrow(1, lo, hi - lo).to(cache.dtype))

