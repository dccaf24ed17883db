"""Device meshes on `torch.distributed`, shared by the SNN mesh path and
LM sharding.

A mesh lays the ranks of one process group out row-major on named axes:

  data   -- serving lanes and macro banks (the batch), split over data
            ranks: lanes never interact; for a language model the batch,
            and under FSDP each parameter's leading axis;
  model  -- the macro's row-tiled fan-in, split over model ranks: each
            holds a row tile of every layer's weights and the tiles'
            unclamped int32 partial V add up in one integer all-reduce;
            for a language model the tensor-parallel (last) axis of each
            parameter, the vocabulary, the heads, and the sequence under
            sequence parallelism.

`make_mesh` and `make_host_mesh` build an `SNNMesh` over the default
process group, whose size must equal the mesh's: one sub-group per axis
(the ranks that differ only along it), made collectively on every rank,
and a `torch.distributed.device_mesh.DeviceMesh` over the same ranks in
the same layout (``device_mesh``), on which `dist.sharding` places
DTensors. A mesh whose extents are all 1 needs no process group and runs
no collective; without one it has no DeviceMesh (``device_mesh`` None),
and the LM placements refuse it by name (`dist.sharding.device_mesh_of`):
a world of one (``init_process_group`` with world size 1) gives it one.
The device type is explicit: ``"cuda"`` (the rank's current CUDA device)
unless the caller asks for ``"cpu"``; collectives run on the tensors of
that device through whatever backend the group was built with (NCCL, or
gloo, which takes CPU and CUDA tensors), and nothing falls back to the
host.

`make_production_mesh` is the JAX package's production geometry, (16, 16)
on ("data", "model") or (2, 16, 16) on ("pod", "data", "model"); beside
it stand the card's constants for the roofline terms of `launch.dryrun`
(the NVIDIA H100 SXM5 80GB at 700 W; the JAX package's TPU constants are
not carried over).

A plain ``{axis: extent}`` dict stands in for a mesh wherever only the
geometry matters (`analysis.check_kernel_contracts`, `check_trace`,
`dist.sharding`'s spec builders): `mesh_extents` reads either.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

#: the SNN mesh's axis names, in layout order
AXES = ("data", "model")

#: all-reduce groups by key, for the `accv2v_all_reduce` operator (an
#: operator's arguments cannot hold a process group)
_GROUPS: dict = {}

# NVIDIA H100 SXM5 80GB (700 W) datasheet rates, one GPU: the roofline
# terms of `launch.dryrun`
PEAK_FLOPS_BF16 = 989.4e12      # dense bf16 tensor-core flop/s
HBM_BW = 3.35e12                # HBM3 bytes/s
#: one GPU's 400 Gb/s NDR InfiniBand port, bytes/s: with nodes of 8 GPUs
#: every axis of (16, 16) and (2, 16, 16) crosses nodes (data has stride
#: 16, model spans 2 nodes), so collectives run at this rate and not at
#: NVLink's 450e9 bytes/s a direction inside a node
NET_BW = 50e9


def hbm_bytes() -> int:
    """One GPU's memory (JAX's ``HBM_BYTES``): the card's total memory
    where there is one, else the datasheet's 80e9 bytes. A function, so
    that importing the module never initializes CUDA."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return int(80e9)


class SNNMesh:
    """Ranks of the default process group laid out row-major on named axes
    (``shape``, ``axis_names``), with this rank's coordinate on each axis
    (``coords``) and, per axis, the sub-group of the ranks that differ from
    this one only along it (None for an axis of extent 1).

    ``device`` is where the mesh's tensors and collectives live;
    ``capturable`` says whether its collectives can be recorded in a CUDA
    graph (an NCCL group on a CUDA device, or no collective at all);
    ``device_mesh`` is the `DeviceMesh` of the same ranks and axis names
    (None without a process group), where DTensors live."""

    def __init__(self, shape: tuple, axis_names: tuple, *, device_type: str,
                 rank: int = 0, groups: Optional[dict] = None,
                 backend: Optional[str] = None, device_mesh=None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.device_type = device_type
        self.rank = rank
        self.backend = backend
        self.groups = dict(groups or {})
        self.device_mesh = device_mesh
        coords, r = [], rank
        for size in reversed(self.shape):
            coords.append(r % size)
            r //= size
        self.coords = dict(zip(self.axis_names, reversed(coords)))

    @property
    def device(self) -> torch.device:
        """This rank's device: its current CUDA device, or the CPU."""
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)

    @property
    def capturable(self) -> bool:
        """True when a CUDA graph can record this mesh's collectives."""
        if all(g is None for g in self.groups.values()):
            return self.device_type == "cuda"
        return self.device_type == "cuda" and self.backend == "nccl"

    def extent(self, axis: str) -> int:
        """The extent of ``axis``, 1 for an axis the mesh does not name."""
        return dict(zip(self.axis_names, self.shape)).get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 for an unnamed axis)."""
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """This rank's sub-group along ``axis`` (None at extent 1)."""
        return self.groups.get(axis)

    def group_key(self, axis: str) -> str:
        """The key of this rank's ``axis`` group in the operator registry
        (`kernels.fused_snn_net.ops.accv2v_all_reduce` takes it)."""
        return f"{id(self)}:{axis}"

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names,
                                                     self.shape))
        return (f"SNNMesh({axes}; rank {self.rank}, {self.device_type}, "
                f"{self.backend or 'no group'})")


def mesh_extents(mesh) -> dict:
    """``{axis: extent}`` of an `SNNMesh` or of a plain dict."""
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    return {str(n): int(s) for n, s in zip(mesh.axis_names, mesh.shape)}


def make_mesh(shape: tuple, axes: tuple = AXES, *, device_type: str = "cuda"
              ) -> SNNMesh:
    """An `SNNMesh` of ``shape`` on the named ``axes`` over the default
    process group (one rank a mesh point, row-major). Every rank must call
    it, in the same order as every other collective: each axis's
    sub-groups are made with `torch.distributed.new_group`, then the
    `DeviceMesh` of the same layout (``device_mesh``), which makes its own.
    A gloo group on CUDA installs `dist.collectives` (DTensor's functional
    collectives through gloo's blocking calls, which take CUDA tensors).

    ``device_type`` is ``"cuda"`` (each rank on its current CUDA device)
    or ``"cpu"``. A mesh of extent 1 everywhere needs no process group
    (and then has no DeviceMesh). Raises `ValueError` when the mesh's size
    is not the group's."""
    import torch.distributed as dist
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    size = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        if size != 1:
            raise ValueError(f"a mesh of {size} ranks needs an initialized "
                             "torch.distributed process group")
        return SNNMesh(shape, axes, device_type=device_type)
    world, rank = dist.get_world_size(), dist.get_rank()
    if size != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} has {size} ranks "
                         f"but the process group has {world}")
    backend = dist.get_backend()
    mesh = SNNMesh(shape, axes, device_type=device_type, rank=rank,
                   backend=backend)
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    for i, axis in enumerate(axes):
        if shape[i] == 1:
            continue
        # one group per line along this axis: fix every other coordinate
        others = [j for j in range(len(shape)) if j != i]
        lines = [[]]
        for j in others:
            lines = [line + [c] for line in lines for c in range(shape[j])]
        for line in lines:
            base = sum(c * strides[j] for c, j in zip(line, others))
            ranks = [base + k * strides[i] for k in range(shape[i])]
            group = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[axis] = group
                _GROUPS[mesh.group_key(axis)] = group
    if device_type == "cuda" and backend == "gloo":
        from repro_torch.dist import collectives
        collectives.install("CUDA")
    from torch.distributed.device_mesh import DeviceMesh
    mesh.device_mesh = DeviceMesh(
        device_type, torch.arange(size).reshape(shape), mesh_dim_names=axes)
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> SNNMesh:
    """The JAX package's production mesh: (16, 16) on ("data", "model"),
    or with ``multi_pod`` (2, 16, 16) on ("pod", "data", "model"), over
    the default process group. Raises `make_mesh`'s `ValueError` when the
    world is another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    return make_mesh(shape, axes, device_type=device_type)


def make_host_mesh(n_devices: int = 0, model: int = 1, *,
                   device_type: str = "cuda") -> SNNMesh:
    """A ``("data", "model")`` mesh of ``n_devices`` ranks (default: the
    process group's size, or 1 without one), ``model`` of them on the
    model axis."""
    import torch.distributed as dist
    n = n_devices or (dist.get_world_size() if dist.is_available()
                      and dist.is_initialized() else 1)
    if n % model:
        raise ValueError(f"model extent {model} does not divide {n} ranks")
    return make_mesh((n // model, model), AXES, device_type=device_type)


def mesh_from_env(shape: tuple, *, device_type: str = "cuda") -> SNNMesh:
    """A ``("data", "model")`` mesh of ``shape`` for a launcher: under
    ``torchrun`` (``WORLD_SIZE`` > 1 in the environment) the default
    process group is initialized from the environment first, on NCCL for
    CUDA and gloo for the CPU, each rank on CUDA device ``LOCAL_RANK``
    modulo the devices there are; alone, the world is this process.
    Raises `ValueError` when the mesh's size is not the world's (a mesh
    larger than the world cannot run)."""
    import os

    import torch.distributed as dist
    size = math.prod(int(s) for s in shape)
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if env_world > 1 and not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                                  % torch.cuda.device_count())
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if size != world:
        raise ValueError(f"a ({', '.join(map(str, shape))}) mesh needs "
                         f"{size} ranks but the world has {world}; run it "
                         f"under torchrun --nproc-per-node {size}")
    return make_mesh(shape, AXES, device_type=device_type)
