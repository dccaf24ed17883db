"""Sharding rules of the SNN mesh path: logical axes to mesh placements,
with divisibility fitting.

A placement is torch's DTensor form: one `Shard(dim)` or `Replicate()` for
each mesh dimension, in the mesh's axis order. Every rule goes through
`_fit`: a per-dimension proposal (a mesh axis name, a tuple of names, or
None) is kept only when the dimension divides the product of the proposed
extents, and otherwise degrades to replication, logged on the
``repro_torch.dist.sharding`` logger with the axis and the extents; a
*required* axis that cannot shard raises `ShardingError` instead.

The SNN logical axes map the IMPULSE macro onto the mesh: ``lane`` and
``bank`` (serving lanes, frame banks: the batch) partition over the data
axis, since lanes never interact; ``macro_row_tile`` (the row-tiled
fan-in) over the model axis, each model rank owning a row tile and adding
its unclamped int32 partial V in the cross-rank AccV2V reduction.

A mesh is an `launch.mesh.SNNMesh` or a plain ``{axis: extent}`` dict.
"""
from __future__ import annotations

import logging
from typing import Any

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import mesh_extents
from repro_torch.tree import tree_map

logger = logging.getLogger("repro_torch.dist.sharding")

#: logical axis -> mesh axis (the SNN rows; the LM rows come with LM
#: sharding)
_LOGICAL_TO_MESH = {
    "batch": "data",
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
