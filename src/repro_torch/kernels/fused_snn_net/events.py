"""Spike-list compaction reference: the fully event-driven executor, on the
host in numpy.

Every (timestep, example) frame is compacted to its active-row index list
and the AccW2V accumulate becomes a gather of the weight rows of those rows
only, so the work is proportional to the event count. It is the upper bound
on skippable work and the word-level contract for per-row skip accounting:
the device event kernel's row counters are held equal to its `EventStats`.

Host and numpy on purpose: the compaction is data-dependent, and the
per-event arithmetic goes through `quant.clamp_v_np` /
`quant.spike_compare_np` in int32, so results are bit-identical to every
other backend. Callers move inputs off the card before calling it and the
results back onto their device after (`core.pipeline._run_fc_stack`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.quant import clamp_v_np as _clamp
from repro_torch.core.quant import spike_compare_np as _spike


class EventStats(NamedTuple):
    """Per-layer event statistics of one event-driven execution."""
    row_events: tuple            # per layer: (n_in,) int64 events per input row
    frames: int                  # (timestep, example) frames each layer ran
    dense_fallbacks: tuple = ()  # per layer: dense-crossover trips (device
    #                              event kernel only; the host executor never
    #                              falls back, so it reports ())

    @property
    def events(self) -> tuple:
        """Total input events (active compacted rows) per layer."""
        return tuple(int(r.sum()) for r in self.row_events)

    @property
    def skipped_rows(self) -> tuple:
        """Silent (frame, input-row) pairs per layer: AccW2V work an
        event-driven macro never issues."""
        return tuple(self.frames * len(r) - int(r.sum())
                     for r in self.row_events)

    @property
    def skipped_row_fraction(self) -> float:
        """Fraction of all (frame, row) gate sites that were silent."""
        possible = sum(self.frames * len(r) for r in self.row_events)
        return sum(self.skipped_rows) / possible if possible else 0.0


def fused_snn_net_events(spikes, ws, *, thresholds: tuple, leaks: tuple,
                         neuron: str = "rmp", clamp_mode: str = "saturate",
                         emit_rasters: bool = True, readout: bool = True,
                         v_init: list = None):
    """Event-list execution of the fused stack on host arrays: spikes
    (T, B, N0) {0, 1}, per-layer (n_in, n_out) int weights, one threshold
    and leak per spiking layer, optional per-layer (B, n_out) carried V.

    Returns (rasters, v_finals, stats): per spiking layer the (T, B, n_out)
    int8 output raster ([] without ``emit_rasters``), per layer the final
    (B, n_out) int32 V, and an `EventStats` of per-row event counts (the
    event list has no tiles or blocks to skip; every silent row is skipped
    by construction).

    The gather over active rows equals the dense product exactly (silent
    rows multiply their weight rows by zero); V clamps once after the full
    per-frame sum and the neuron update runs every timestep, as on every
    other backend. Raises `ValueError` on a misaligned stack."""
    spikes = np.asarray(spikes).astype(np.int8)
    if spikes.ndim != 3:
        raise ValueError(f"spikes must be (T, B, N), got {spikes.shape}")
    ws = [np.asarray(w, np.int32) for w in ws]
    prev = spikes.shape[2]
    for i, w in enumerate(ws):
        if w.ndim != 2 or w.shape[0] != prev:
            raise ValueError(f"layer chain misaligned at ws[{i}]: "
                             f"{w.shape} after {prev} lanes")
        prev = w.shape[1]
    T, B, _ = spikes.shape
    n_spiking = len(ws) - 1 if readout else len(ws)
    if len(thresholds) != n_spiking or len(leaks) != n_spiking:
        raise ValueError(f"need {n_spiking} thresholds/leaks, got "
                         f"{len(thresholds)}/{len(leaks)}")
    if v_init is not None:
        if len(v_init) != len(ws):
            raise ValueError(f"v_init needs one (B, n_out) state per layer "
                             f"({len(ws)}), got {len(v_init)}")
        vs = [np.array(v, np.int32, copy=True) for v in v_init]
    else:
        vs = [np.zeros((B, w.shape[1]), np.int32) for w in ws]
    row_events = [np.zeros(w.shape[0], np.int64) for w in ws]
    rasters = [np.zeros((T, B, w.shape[1]), np.int8)
               for w in ws[:n_spiking]] if emit_rasters else []
    for t in range(T):
        cur = spikes[t]
        for i, w in enumerate(ws):
            row_events[i] += cur.astype(np.int64).sum(axis=0)
            acc = np.zeros((B, w.shape[1]), np.int32)
            # batch-flattened event list: np.nonzero is the compaction (each
            # example's segment of r_idx is its active-row list) and one
            # reduceat sums every non-empty example's gathered rows; empty
            # examples are left out, since reduceat needs in-range starts
            b_idx, r_idx = np.nonzero(cur)
            if b_idx.size:
                counts = np.bincount(b_idx, minlength=B)
                nz = counts > 0
                starts = np.cumsum(counts) - counts
                acc[nz] = np.add.reduceat(w[r_idx], starts[nz], axis=0)
            v = vs[i] + acc                         # readout stays unclamped
            if i >= n_spiking:
                vs[i] = v
                continue
            v = _clamp(v, clamp_mode)
            th, lk = int(thresholds[i]), int(leaks[i])
            if neuron == "lif":
                v = _clamp(v - lk, clamp_mode)
            fired = _spike(v, th, clamp_mode)
            if neuron == "rmp":                     # soft reset, gated
                v = _clamp(np.where(fired, v - th, v), clamp_mode)
            elif neuron in ("if", "lif"):
                v = np.where(fired, 0, v)
            else:
                raise ValueError(f"unknown neuron {neuron!r}")
            vs[i] = v.astype(np.int32)
            cur = fired.astype(np.int8)
            if emit_rasters:
                rasters[i][t] = cur
    stats = EventStats(row_events=tuple(row_events), frames=T * B)
    return rasters, vs, stats
