"""int8-wire gradient reduction with error feedback.

The cross-data-axis gradient mean is the dominant wire cost of
data-parallel training. `compressed_psum_mean` quantizes each rank's
contribution to int8 with one float32 scale before it crosses the wire (a
quarter of float32's bytes) and carries the quantization error in a
per-leaf residual that is added back at the next step, the standard
error-feedback construction, which makes the time-averaged reduction
unbiased although each step is quantized.

`fake_compress` applies the same quantize-dequantize to a gradient tree
without a collective: the single-device numerics of the int8 wire
(``ParallelConfig.grad_compress``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: (q int8, f32 scale)."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_mean(grads: Any, residuals: Any, axis_name: str,
                         mesh) -> tuple[Any, Any]:
    """Mean-reduce the gradient tree ``grads`` (this rank's tensors) over
    the ``axis_name`` axis of ``mesh`` (an `launch.mesh.SNNMesh`) on an
    int8 wire: the JAX package's function, with the mesh and the axis in
    place of a bound axis name.

    Per leaf: the rank's contribution, the gradient in float32 plus its
    carried residual, is quantized to int8 and one float32 scale; the
    int8 values and the scales are what crosses the wire (an all-gather
    of each over the axis's group, on the tensors' device); every rank
    dequantizes each contribution and adds them in rank order, then
    divides by the extent. The new residual is the local quantization
    error, input minus its dequantized value. Returns (mean grads in each
    gradient's dtype, new float32 residuals), both of ``grads``'
    structure."""
    import torch.distributed as dist
    group = mesh.group(axis_name)
    n = mesh.extent(axis_name)

    def leaf(g, r):
        inp = g.to(torch.float32) + r
        q, scale = _quantize_int8(inp)
        deq = _dequantize(q, scale)
        if group is None:                    # extent 1: the mean is deq
            return deq.to(g.dtype), inp - deq
        qs = [torch.empty_like(q) for _ in range(n)]
        scales = [torch.empty((1,), dtype=scale.dtype, device=scale.device)
                  for _ in range(n)]
        dist.all_gather(qs, q, group=group)
        dist.all_gather(scales, scale.reshape(1), group=group)
        total = _dequantize(qs[0], scales[0][0])
        for qi, si in zip(qs[1:], scales[1:]):
            total += _dequantize(qi, si[0])
        return total.div_(n).to(g.dtype), inp - deq

    out = [leaf(g, r) for g, r in zip(tree_leaves(grads),
                                      tree_leaves(residuals))]
    return (tree_unflatten_like(grads, [m for m, _ in out]),
            tree_unflatten_like(grads, [r for _, r in out]))


def fake_compress(grads: Any) -> Any:
    """Quantize-dequantize each leaf of ``grads`` through the int8 wire
    format, in the leaf's dtype."""
    def leaf(g):
        q, scale = _quantize_int8(g.to(torch.float32))
        return _dequantize(q, scale).to(g.dtype)
    return tree_map(leaf, grads)
