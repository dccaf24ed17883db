"""Functional collectives through blocking `torch.distributed` calls, for
gloo groups on CUDA tensors.

DTensor moves values between ranks with the functional collectives of
``torch.ops._c10d_functional`` (all-gather into one tensor, all-reduce,
reduce-scatter), each waited for with ``wait_tensor``. On a gloo group with CUDA tensors those kernels crash the
process (a segmentation fault in ``wait_tensor`` after an all-gather, torch
2.11 on an H100), while gloo's blocking list collectives take CUDA tensors
(`dist.all_gather` of a list, `dist.all_reduce`, `dist.broadcast`).

`install()` replaces the CUDA kernels of those functional ops with
implementations through the blocking calls, on the tensors' own device:
an all-gather of a list then one concatenation, an all-reduce, and a
reduce-scatter as an all-reduce and this rank's chunk (the three that the
sharded train step moves values with). Each returns a finished tensor, so
``wait_tensor`` finds no pending work. The values are the collectives' own; only the overlap of an
asynchronous collective is lost. `launch.mesh.make_mesh` installs it for a
gloo group on CUDA (it applies to every group of the process, which is
right for any backend); NCCL processes keep the native kernels.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
        "product": dist.ReduceOp.PRODUCT, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}

#: the `torch.library` handle of the installed kernels (None before)
_LIB = None

#: calls of each installed kernel in this process
COUNTS: dict = {}


def _group(group_name):
    if isinstance(group_name, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(group_name)
    return group_name


def _all_reduce(x: torch.Tensor, reduce_op: str, group) -> torch.Tensor:
    if reduce_op not in _OPS:
        raise ValueError(f"functional all-reduce {reduce_op!r} has no "
                         "blocking counterpart")
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[reduce_op], group=group)
    if reduce_op == "avg":
        out = out / dist.get_world_size(group)
    return out


def _k_all_gather_into_tensor(x, group_size, group_name):
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(group_size)]
    dist.all_gather(parts, x.contiguous(), group=_group(group_name))
    return torch.cat(parts, dim=0)


def _k_all_reduce(x, reduce_op, group_name):
    return _all_reduce(x, reduce_op, _group(group_name))



def _k_reduce_scatter_tensor(x, reduce_op, group_size, group_name):
    group = _group(group_name)
    full = _all_reduce(x, reduce_op, group)
    return full.chunk(group_size, dim=0)[dist.get_rank(group)].clone()




def _counted(name: str, fn):
    def kernel(*args):
        COUNTS[name] = COUNTS.get(name, 0) + 1
        return fn(*args)
    return kernel


def install(dispatch_key: str = "CUDA") -> None:
    """Replace the functional collectives' ``dispatch_key`` kernels by the
    blocking implementations above (once a process); `COUNTS` counts their
    calls."""
    global _LIB
    if _LIB is not None:
        return
    import warnings
    lib = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "overriding a kernel"
        for name, fn in (("all_gather_into_tensor",
                          _k_all_gather_into_tensor),
                         ("all_reduce", _k_all_reduce),
                         ("reduce_scatter_tensor", _k_reduce_scatter_tensor)):
            lib.impl(name, _counted(name, fn), dispatch_key)
    _LIB = lib
