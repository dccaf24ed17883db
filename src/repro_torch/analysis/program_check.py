"""Static range / bit-width verification of compiled `SNNProgram`s.

`check_program` abstract-interprets the word-level ISA semantics
(isa.layer_timestep_int, the contract every backend is tested against)
over the interval lattice of `intervals.py` and proves, per macro-stack
layer, that:

  * every weight lies on the 6-bit QAT grid [-W_MAX, W_MAX];
  * every threshold / leak constant lies in the 11-bit V word
    [V_MIN, V_MAX] (what `quant.quantize_neuron_const` guarantees by
    construction — a constant outside the word cannot be stored in a
    const row);
  * the **unclamped int32 accumulator can never overflow**. Spiking
    layers clamp once per timestep, so their pre-clamp value is bounded
    by ``V_interval + [sum min(w,0), sum max(w,0)]`` independent of T —
    and in wrap mode even int32 rollover is harmless, because 2^11
    divides 2^32 (``v mod 2^32 mod 2^11 == v mod 2^11``): the silicon's
    wrap composes through any wider two's-complement container. Saturate
    mode has no such algebra — clamping a value that already overflowed
    clips the wrong number — so there the analyzer demands the proof.
    The readout is the genuinely T-dependent hazard: it accumulates
    **unclamped across every frame of the presentation** in all backends,
    so its bound scales linearly in the frame count and `max_safe_frames`
    is the largest horizon the int32 word survives.

Matmul intermediates are covered by the same bounds: a prefix sum over
input rows of column j lies in [sum_i min(w_ij, 0), sum_i max(w_ij, 0)]
(dropping terms can only move toward zero from either end), so no
partial-row accumulation order — including the multi-macro row-tiled
AccV2V reduction, which is exactly these partial sums — escapes the
per-frame increment interval.

Spiking-layer membrane invariants are found by fixed-point iteration:
start at V = [0, 0], push one timestep through the transfer functions
(accumulate -> clamp -> leak -> SpikeCheck -> reset/soft-reset), widen by
hull, repeat until the post-update interval is contained. Every
post-update interval is a subset of the clamped V domain, so the chain is
finite and convergence is guaranteed (in practice 2-3 iterations).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.analysis.intervals import (INT32, AnalysisError, Interval,
                                            V_DOMAIN, clamp_interval,
                                            wrap_is_exact)
from repro_torch.core import mapping
from repro_torch.core.quant import W_MAX, W_MIN

_MAX_FIXPOINT_ITERS = 4096       # > 2 * V_SPAN: hull growth is integral


class RangeError(AnalysisError):
    """A value range escaped its word: weight off the 6-bit grid, constant
    outside the 11-bit V word, or an int32 accumulator that can overflow."""


@dataclass(frozen=True)
class LayerRange:
    """Proven value ranges of one macro-stack layer."""
    index: int                 # position in program.macro_stack
    name: str                  # e.g. "fc[1] 128x128"
    kind: str                  # conv | fc | readout
    n_in: int
    n_out: int
    row_tiles: int             # multi-macro fan-in split (mapping.fc_tiling)
    increment: Interval        # per-frame AccW2V sum, hull over columns
    v_pre_clamp: Interval      # widest unclamped accumulator value seen
    v_post: Interval           # post-update membrane invariant (V at rest)
    wrap_exact: bool           # wrap-mode clamp transfer lost no precision
    max_safe_frames: Optional[int] = None   # None: any horizon is safe


@dataclass(frozen=True)
class RangeReport:
    """Per-layer proven ranges of one program at one frame horizon."""
    domain: str
    clamp_mode: str
    neuron: str
    frames: int                # horizon the readout bound was proven for
    layers: tuple              # tuple[LayerRange, ...]

    @property
    def max_safe_frames(self) -> Optional[int]:
        """Largest frame count every layer's int32 word survives
        (None: unbounded — e.g. a zero readout increment)."""
        bounds = [ly.max_safe_frames for ly in self.layers
                  if ly.max_safe_frames is not None]
        return min(bounds) if bounds else None


def _layer_name(idx: int, spec) -> str:
    return f"{spec.kind}[{idx}] {spec.n_in}x{spec.n_out}"


def _weight_matrix(spec) -> Optional[np.ndarray]:
    """(n_in, n_out) integer weight matrix of a macro-stack layer, copied
    to the host once (the tensor may live on any device), or None when the
    spec carries no weights (synthetic geometry: worst case)."""
    if spec.w is None:
        return None
    w = spec.w
    if spec.kind == "conv":                  # HWIO -> im2col row-major
        w = mapping.pack_conv_weights(w)
    return w.cpu().numpy().astype(np.int64)


def _increment_interval(spec, name: str) -> Interval:
    """Per-frame AccW2V sum bound of one layer: hull over output columns of
    [sum_i min(w_ij, 0), sum_i max(w_ij, 0)] — attained by the spike frame
    that activates exactly the negative (resp. positive) rows. With no
    weights, the worst case over the whole 6-bit grid."""
    w = _weight_matrix(spec)
    if w is None:
        bound = spec.n_in * W_MAX
        return Interval(-bound, bound)
    if w.size == 0:
        return Interval.point(0)
    wmin, wmax = int(w.min()), int(w.max())
    if wmin < W_MIN - 1 or wmax > W_MAX:     # -32 is representable on chip
        raise RangeError(
            f"weight range [{wmin}, {wmax}] leaves the 6-bit grid "
            f"[{W_MIN - 1}, {W_MAX}]", where=name)
    lo = int(np.minimum(w, 0).sum(axis=0).min())
    hi = int(np.maximum(w, 0).sum(axis=0).max())
    return Interval(lo, hi)


def _row_tiles(spec) -> int:
    return mapping.fc_tiling(spec.n_in, spec.n_out).row_tiles


def _check_const(value, what: str, name: str) -> int:
    """A neuron constant must fit the 11-bit V word of its const row."""
    v = int(value)
    if not V_DOMAIN.contains_value(v):
        raise RangeError(
            f"{what}={v} does not fit the 11-bit V word {V_DOMAIN} "
            "(quantize via quant.quantize_neuron_const)", where=name)
    return v


def _spike_update(v: Interval, th: int, neuron: str, mode: str) -> Interval:
    """Transfer of SpikeCheck + reset on a clamped membrane interval."""
    if mode == "wrap":
        # the comparator itself wraps (quant.spike_compare), so the fired
        # set is non-contiguous in v — hull both branches (sound, not tight)
        if neuron == "rmp":
            return v.hull(clamp_interval(v.shift(-th), "wrap"))
        return v.hull(Interval.point(0))
    fired = v.intersect(Interval(th, max(v.hi, th)))
    unfired = v.intersect(Interval(min(v.lo, th - 1), th - 1))
    parts = []
    if unfired is not None:
        parts.append(unfired)
    if fired is not None:
        if neuron == "rmp":                  # soft reset: v - th, clamped
            parts.append(clamp_interval(fired.shift(-th), "saturate"))
        else:                                # if / lif: hard reset to 0
            parts.append(Interval.point(0))
    out = parts[0]
    for p in parts[1:]:
        out = out.hull(p)
    return out


def _check_spiking_layer(idx: int, spec, neuron: str, mode: str
                         ) -> LayerRange:
    name = _layer_name(idx, spec)
    inc = _increment_interval(spec, name)
    th = _check_const(spec.threshold, "threshold", name)
    lk = _check_const(spec.leak, "leak", name)

    v = Interval.point(0)
    widest_pre = v
    wrap_exact = True
    for _ in range(_MAX_FIXPOINT_ITERS):
        acc = v + inc                        # unclamped int32 accumulator
        widest_pre = widest_pre.hull(acc)
        if mode == "saturate" and not INT32.contains(acc):
            raise RangeError(
                f"unclamped accumulator {acc} can overflow int32 {INT32} "
                f"before the saturate clamp (fan-in {spec.n_in}, per-frame "
                f"increment {inc}); wrap mode would compose through "
                "overflow, saturate cannot", where=name)
        if mode == "wrap" and not wrap_is_exact(acc):
            wrap_exact = False
        vc = clamp_interval(acc, mode)
        if neuron == "lif":                  # AccV2V(-leak), clamped
            vc = clamp_interval(vc.shift(-lk), mode)
        post = _spike_update(vc, th, neuron, mode)
        if v.contains(post):
            break
        v = v.hull(post)
    else:                                    # pragma: no cover - lattice is
        raise AnalysisError("membrane fixed point did not converge",
                            where=name)      # finite; unreachable
    return LayerRange(
        index=idx, name=name, kind=spec.kind, n_in=spec.n_in,
        n_out=spec.n_out, row_tiles=_row_tiles(spec), increment=inc,
        v_pre_clamp=widest_pre, v_post=v, wrap_exact=wrap_exact,
        max_safe_frames=None)                # per-timestep clamp: T-free


def _check_readout_layer(idx: int, spec, frames: int) -> LayerRange:
    """The readout accumulates UNCLAMPED int32 across all frames in every
    backend — the one genuinely T-dependent overflow hazard."""
    name = _layer_name(idx, spec)
    inc = _increment_interval(spec, name)
    total = Interval(frames * min(inc.lo, 0), frames * max(inc.hi, 0))
    safe = []
    if inc.hi > 0:
        safe.append(INT32.hi // inc.hi)
    if inc.lo < 0:
        safe.append(INT32.lo // inc.lo)
    max_safe = min(safe) if safe else None
    if not INT32.contains(total):
        raise RangeError(
            f"unclamped readout accumulator reaches {total} over {frames} "
            f"frames and overflows int32 {INT32} (per-frame increment "
            f"{inc}; max safe frames: {max_safe})", where=name)
    return LayerRange(
        index=idx, name=name, kind=spec.kind, n_in=spec.n_in,
        n_out=spec.n_out, row_tiles=_row_tiles(spec), increment=inc,
        v_pre_clamp=total, v_post=total, wrap_exact=False,
        max_safe_frames=max_safe)


def check_program(program, *, frames: Optional[int] = None) -> RangeReport:
    """Prove the per-layer value ranges of a compiled program, or raise a
    `RangeError` naming the first offending layer.

    ``frames`` is the presentation horizon the readout bound is proven for
    (default ``program.timesteps`` — one presentation step block). Pass the
    true total frame count for long streams; the report's
    ``max_safe_frames`` is horizon-independent and is what streaming
    admission control should budget against.

    Float-domain programs carry no word-level semantics to verify: they
    return an empty (trivially valid) report, whose ``max_safe_frames`` is
    None.
    """
    if frames is None:
        frames = int(program.timesteps)
    if frames < 0:
        raise ValueError(f"frames must be >= 0, got {frames}")
    if program.domain != "int":
        return RangeReport(domain=program.domain,
                           clamp_mode=program.clamp_mode,
                           neuron=program.neuron, frames=frames, layers=())
    mode = program.clamp_mode
    if mode not in ("saturate", "wrap"):
        raise AnalysisError(f"unknown clamp mode {mode!r}", where="program")
    layers = []
    for idx, spec in enumerate(program.macro_stack):
        if spec.kind == "readout":
            layers.append(_check_readout_layer(idx, spec, frames))
        else:
            layers.append(_check_spiking_layer(idx, spec, program.neuron,
                                               mode))
    return RangeReport(domain="int", clamp_mode=mode,
                       neuron=program.neuron, frames=frames,
                       layers=tuple(layers))
