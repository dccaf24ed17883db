"""Layer -> multi-macro tiling and the conv lowering onto the macro grid.

A single macro serves fan-in <= 128 and 12 output neurons. Larger layers
tile onto a (row_tiles x col_tiles) macro grid whose fan-in partial sums
reduce with AccV2V instructions. Conv layers map through im2col with the
paper's fan-in rule (k*k*c_in <= 128 per macro row block, e.g. 3*3*14 =
126): `im2col` extracts the (kh, kw, c_in)-ordered patch vector of every
output position, so one conv layer becomes an FC layer of fan-in k*k*c_in
over B*H_out*W_out frames, each frame claiming one neuron set of the macro
grid (`pack_conv_weights` flattens the HWIO kernel onto the matching W_MEM
rows). Padding is XLA's "SAME" geometry, so the lowering equals the JAX
package's conv exactly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.isa import MACRO_IN, MACRO_OUT


@dataclass(frozen=True)
class FCTiling:
    """A layer's macro grid: fan-in splits and output-neuron splits."""
    n_in: int
    n_out: int
    row_tiles: int          # fan-in splits (partial-sum groups)
    col_tiles: int          # output-neuron splits

    @property
    def n_macros(self) -> int:
        return self.row_tiles * self.col_tiles


def fc_tiling(n_in: int, n_out: int) -> FCTiling:
    """The macro grid of an (n_in -> n_out) layer."""
    return FCTiling(n_in, n_out,
                    row_tiles=math.ceil(n_in / MACRO_IN),
                    col_tiles=math.ceil(n_out / MACRO_OUT))


@dataclass(frozen=True)
class ConvTiling:
    """A conv layer's macro grid, re-used at every output position."""
    fan_in: int             # k*k*c_in
    n_out_ch: int
    out_positions: int      # H_out * W_out
    fc: FCTiling

    @property
    def n_macros(self) -> int:
        return self.fc.n_macros


def conv_tiling(kernel: int, c_in: int, c_out: int,
                out_hw: tuple[int, int]) -> ConvTiling:
    """The macro grid of a k x k conv from ``c_in`` to ``c_out`` channels
    with ``out_hw`` output positions."""
    fan_in = kernel * kernel * c_in
    return ConvTiling(fan_in=fan_in, n_out_ch=c_out,
                      out_positions=out_hw[0] * out_hw[1],
                      fc=fc_tiling(fan_in, c_out))


def tile_weights(w: np.ndarray) -> np.ndarray:
    """(n_in, n_out) integer weights -> (row_tiles, col_tiles, 128, 12),
    each macro's tile, zero padded (host numpy: the bit-level macros'
    input)."""
    n_in, n_out = w.shape
    t = fc_tiling(n_in, n_out)
    out = np.zeros((t.row_tiles, t.col_tiles, MACRO_IN, MACRO_OUT),
                   dtype=w.dtype)
    for r in range(t.row_tiles):
        for c in range(t.col_tiles):
            blk = w[r * MACRO_IN:(r + 1) * MACRO_IN,
                    c * MACRO_OUT:(c + 1) * MACRO_OUT]
            out[r, c, :blk.shape[0], :blk.shape[1]] = blk
    return out


def untile_outputs(v: np.ndarray, n_out: int) -> np.ndarray:
    """(col_tiles, 12) per-macro outputs -> (n_out,), padding dropped."""
    return v.reshape(-1)[:n_out]


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int, int]:
    """XLA "SAME" geometry along one spatial axis: (out_size, pad_lo,
    pad_hi), the odd padding element at the high end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    lo = total // 2
    return out, lo, total - lo


def conv_out_hw(in_hw: tuple[int, int], kernel: int, stride: int
                ) -> tuple[int, int]:
    """Output (H, W) of a SAME-padded conv."""
    return (same_pads(in_hw[0], kernel, stride)[0],
            same_pads(in_hw[1], kernel, stride)[0])


def im2col(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H_out, W_out, k*k*C) SAME-padded patches, in x's
    dtype and on its device. Patch features are ordered (kh, kw, c), the
    row order `pack_conv_weights` flattens the HWIO kernel with, so
    ``im2col(x) @ pack_conv_weights(w)`` is the conv exactly in integer
    arithmetic (padding contributes zero rows)."""
    b, h, w, c = x.shape
    h_out, lo_h, hi_h = same_pads(h, kernel, stride)
    w_out, lo_w, hi_w = same_pads(w, kernel, stride)
    xp = x.new_zeros((b, h + lo_h + hi_h, w + lo_w + hi_w, c))
    xp[:, lo_h:lo_h + h, lo_w:lo_w + w] = x
    cols = [xp[:, di:di + (h_out - 1) * stride + 1:stride,
               dj:dj + (w_out - 1) * stride + 1:stride, :]
            for di in range(kernel) for dj in range(kernel)]
    return torch.cat(cols, dim=-1)


def pack_conv_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO conv kernel (k, k, c_in, c_out) -> W_MEM layout
    (k*k*c_in, c_out): one macro row per patch feature, in `im2col`
    order."""
    return w.reshape(-1, w.shape[-1])


def im2col_raster(raster: torch.Tensor, kernel: int, stride: int
                  ) -> torch.Tensor:
    """(T, B, H, W, C) spike maps -> (T, B*P, k*k*C) patch raster, P =
    H_out*W_out: the conv layer's input raster in the shape the fc
    executors take (one frame per (example, output position))."""
    t, b = raster.shape[:2]
    patches = im2col(raster.reshape(t * b, *raster.shape[2:]), kernel, stride)
    return patches.reshape(t, -1, patches.shape[-1])
