"""GPipe pipeline parallelism over one mesh axis.

`make_pipeline_fn(stage_fn, mesh, axis_name, n_micro)` returns a function
``pipe(Ws, xs)``: ``Ws`` stacks one stage's parameters per pipeline rank
(leading axis == the axis's extent; each rank uses its own) and ``xs``
stacks the microbatches (leading axis == n_micro), the same on every rank.
The schedule is the classic one, the JAX package's: microbatch m enters
stage 0 at tick m and moves one stage a tick around the ring; the last
stage emits microbatch m at tick m + S - 1, so the run takes
n_micro + S - 1 ticks with every stage busy in the steady state. The last
stage's buffer is then summed over the axis with every other rank's zeros
(JAX's masked ``psum``), so every rank returns the outputs. The result
equals composing the stages over each microbatch in order: the bubble
changes the time, not the values.

The ring shift (JAX's ``ppermute``) sends each stage's output to the next
rank: point-to-point (`torch.distributed.batch_isend_irecv`) on NCCL and
on gloo with CPU tensors; on gloo with CUDA tensors, whose point-to-point
calls abort the process, an all-gather of every stage's output over the
axis, of which each rank keeps its predecessor's (`ring_of`).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _ring_p2p(y: torch.Tensor, group, idx: int, n: int) -> torch.Tensor:
    """This rank's predecessor's ``y``, by one send and one receive."""
    out = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(),
                      dist.get_global_rank(group, (idx + 1) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (idx - 1) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def _ring_all_gather(y: torch.Tensor, group, idx: int, n: int
                     ) -> torch.Tensor:
    """This rank's predecessor's ``y``, out of an all-gather of all."""
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y.contiguous(), group=group)
    return parts[(idx - 1) % n]


def ring_of(mesh) -> str:
    """The ring shift ``mesh`` takes: ``"all_gather"`` for a gloo mesh on
    CUDA, else ``"p2p"``."""
    if mesh.device_type == "cuda" and mesh.backend == "gloo":
        return "all_gather"
    return "p2p"


def make_pipeline_fn(stage_fn: Callable, mesh, axis_name: str,
                     n_micro: int) -> Callable:
    """The GPipe executor of the module docs: ``stage_fn(w, x)`` is one
    stage, staged over the ``axis_name`` extent of ``mesh`` (an
    `launch.mesh.SNNMesh`); the returned ``pipe(Ws, xs)`` runs the
    ``n_micro`` microbatches through the fill, steady and drain ticks and
    returns the last stage's outputs (n_micro, ...) on every rank."""
    n_stages = mesh.extent(axis_name)
    group = mesh.group(axis_name)
    shift = _ring_p2p if ring_of(mesh) == "p2p" else _ring_all_gather

    def pipe(Ws, xs: torch.Tensor) -> torch.Tensor:
        if xs.shape[0] != n_micro:
            raise ValueError(f"{xs.shape[0]} microbatches, the pipeline "
                             f"was built for {n_micro}")
        idx = mesh.coord(axis_name)
        w = Ws[idx]
        x_cur = torch.zeros_like(xs[0])
        buf = torch.zeros_like(xs)
        for t in range(n_micro + n_stages - 1):
            # stage 0 takes microbatch t; past the end it recomputes the
            # last one, whose output is never emitted
            inp = xs[min(t, n_micro - 1)] if idx == 0 else x_cur
            y = stage_fn(w, inp)
            m = t - (n_stages - 1)                # microbatch done this tick
            if idx == n_stages - 1 and m >= 0:
                buf[m] = y
            if group is not None:
                x_cur = shift(y, group, idx, n_stages)
            else:
                x_cur = y
        if group is None:
            return buf
        # only the last stage holds outputs; the sum replicates them
        out = buf if idx == n_stages - 1 else torch.zeros_like(buf)
        dist.all_reduce(out, group=group)
        return out

    return pipe
