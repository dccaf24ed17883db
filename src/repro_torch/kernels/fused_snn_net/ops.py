"""Public wrapper of the network-level fused SNN kernels, and their plain
PyTorch version.

`fused_snn_net` runs a (T, B, N0) encoder spike raster through a whole fc
stack: on CUDA tensors it launches a CUDA kernel (`kernel.py`), on CPU
tensors it runs `fused_snn_net_ref`. It never falls back from one to the
other: a CUDA input that a kernel refuses raises. Three kernels compute the
same function: the dense one, the row-block gated one (``use_sparse``,
which skips the product of a silent block of 128/G fan-in rows and counts
the skip) and the event-list one (``use_events``, which gathers the weight
rows of each lane's active inputs, falls back to the dense product above
``event_crossover`` occupancy, and counts events per input row).

`fused_snn_net_ref` is the same function in plain torch ops (the word-level
ISA of `core.isa` looped over time and layers) with the same counters. It
tiles the batch like the kernels (``block_b`` lanes per tile, a ragged last
tile's missing lanes silent), so its per-tile counters equal the kernels'
one for one; with ``block_b >= B`` its tile is the whole batch, the layout
of the JAX package's jnp reference. It runs on any device; the tests hold
it against the JAX package on the CPU and `chip_smoke.py` holds the kernels
against it on the card. The kernels work at logical widths, so unlike the
TPU wrapper there is no lane padding to slice off.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.isa import int_matmul, layer_timestep_int
from repro_torch.core.neuron import NEURON_TYPES
from repro_torch.core.quant import CLAMP_MODES
from repro_torch.kernels.fused_snn_net.events import EventStats
from repro_torch.kernels.fused_snn_net.kernel import (LANE, dense_thresholds,
                                                      fused_snn_net_cuda,
                                                      skip_layout)


def _ref_blocks(n_in: int, granularity: int) -> list:
    """Row spans of one layer's logical fan-in: the gate blocks
    `kernel.skip_layout` assigns skip columns to."""
    if granularity == 1:
        return [(0, n_in)]
    bw = LANE // granularity
    return [(lo, min(lo + bw, n_in)) for lo in range(0, n_in, bw)]


def _check_stack(spikes: torch.Tensor, ws: list) -> None:
    """Chain alignment on logical widths: layer i's fan-in equals layer
    i-1's fan-out. Raises `ValueError`."""
    if not ws:
        raise ValueError("fused_snn_net needs a non-empty weight stack "
                         "(spiking FCs first, readout last); got ws=[]")
    if spikes.dim() != 3:
        raise ValueError(f"spikes must be a (T, B, N0) raster, got shape "
                         f"{tuple(spikes.shape)}")
    prev = spikes.shape[2]
    for i, w in enumerate(ws):
        if w.dim() != 2:
            raise ValueError(f"ws[{i}] must be a 2-D (n_in, n_out) weight "
                             f"matrix, got shape {tuple(w.shape)}")
        if w.shape[0] != prev:
            raise ValueError(
                f"layer chain misaligned: ws[{i}] has fan-in {w.shape[0]} "
                f"but the previous layer emits {prev} lanes")
        prev = w.shape[1]


def _check_args(spikes, ws, thresholds, leaks, neuron, clamp_mode, readout,
                v_init, use_sparse, gate_granularity, use_events,
                event_crossover) -> None:
    _check_stack(spikes, ws)
    if neuron not in NEURON_TYPES:
        raise ValueError(f"unknown neuron {neuron!r}; have {NEURON_TYPES}")
    if clamp_mode not in CLAMP_MODES:
        raise ValueError(f"unknown clamp mode {clamp_mode!r}; have "
                         f"{CLAMP_MODES}")
    if v_init is not None and len(v_init) != len(ws):
        raise ValueError(f"v_init needs one (B, n_out) state per layer "
                         f"({len(ws)}), got {len(v_init)}")
    n_spiking = len(ws) - 1 if readout else len(ws)
    if len(thresholds) != n_spiking or len(leaks) != n_spiking:
        raise ValueError(
            f"need one threshold/leak per spiking layer ({n_spiking} with "
            f"readout={readout}), got {len(thresholds)}/{len(leaks)}")
    if gate_granularity != 1 and not use_sparse:
        raise ValueError("gate_granularity is an event-gating knob; pass "
                         "use_sparse=True to gate at granularity "
                         f"{gate_granularity}")
    if use_events and use_sparse:
        raise ValueError("use_events (event-list execution) and use_sparse "
                         "(row-block gating) are mutually exclusive")
    if use_events and not 0.0 <= event_crossover <= 1.0:
        raise ValueError("event_crossover is a fraction of tile event "
                         f"capacity and must lie in [0, 1], got "
                         f"{event_crossover}")
    if use_sparse:      # validates the granularity and the column cap
        skip_layout(tuple(w.shape[0] for w in ws), gate_granularity)


def _public_skips(counters, ws: list, use_sparse: bool,
                  gate_granularity: int, use_events: bool):
    """The kernels' raw counters in the JAX wrapper's layout: None when
    dense; gated at granularity 1 the (tiles, n_layers) skip counts, at
    G > 1 a per-layer list of (tiles, n_blocks_i) arrays; event-list
    ``{"row_events": [per-layer (tiles, n_in)], "dense_fallbacks":
    (tiles, n_layers)}``."""
    if use_events:
        row_counts, fallbacks = counters
        return {"row_events": list(row_counts), "dense_fallbacks": fallbacks}
    if not use_sparse:
        return None
    if gate_granularity == 1:
        return counters
    n_cols, offsets, _ = skip_layout(tuple(w.shape[0] for w in ws),
                                     gate_granularity)
    return [counters[:, off:off + n] for off, n in zip(offsets, n_cols)]


def fused_snn_net(spikes: torch.Tensor, ws: list, *, thresholds: tuple,
                  leaks: tuple, neuron: str = "rmp",
                  clamp_mode: str = "saturate", block_b: int = 8,
                  emit_rasters: bool = True, readout: bool = True,
                  v_init: list = None, use_sparse: bool = False,
                  gate_granularity: int = 1, use_events: bool = False,
                  event_crossover: float = 1.0) -> tuple:
    """Run a (T, B, N0) {0, 1} spike raster through the whole fc stack.

    ``ws``: per-layer int8 (n_in, n_out) weights, spiking FCs first and the
    accumulate-only readout last (``readout=False``: every layer spikes);
    ``thresholds``/``leaks``: one int per spiking layer on its grid;
    ``v_init`` (streaming entry): per-layer (B, n_out) int32 carried V,
    readout last. Integer arithmetic is exact, so chunked calls that thread
    the final V back in equal one whole call bit for bit. ``block_b`` is
    the gated and event-list kernels' lanes per CTA (a tile of their
    counters); the dense kernel checks it and takes its own tile
    (`kernel.dense_plan`), which does not change results.

    ``use_sparse`` selects the row-block gated kernel, ``gate_granularity``
    in {1, 2, 4, 8} its blocks (`kernel.skip_layout`); ``use_events`` the
    event-list kernel, whose tiles take the dense product when their event
    count is above ``event_crossover`` of ``block_b`` x the layer's fan-in
    (1.0 never, 0.0 always). The two are exclusive.

    Returns (rasters, v_finals, skips): per spiking layer the (T, B, N_i)
    int8 output raster ([] when ``emit_rasters=False``), per layer the
    final (B, N_i) int32 V, and the counters in the layout of
    `_public_skips` (None when dense).

    CUDA tensors launch a CUDA kernel; CPU tensors run `fused_snn_net_ref`.
    Raises `ValueError` on a misaligned stack or an invalid option."""
    thresholds = tuple(int(t) for t in thresholds)
    leaks = tuple(int(lk) for lk in leaks)
    flags = dict(use_sparse=use_sparse, gate_granularity=gate_granularity,
                 use_events=use_events, event_crossover=event_crossover)
    _check_args(spikes, ws, thresholds, leaks, neuron, clamp_mode, readout,
                v_init, **flags)
    if spikes.device.type == "cpu":
        return fused_snn_net_ref(spikes, ws, thresholds, leaks,
                                 neuron=neuron, clamp_mode=clamp_mode,
                                 emit_rasters=emit_rasters, readout=readout,
                                 v_init=v_init, block_b=block_b, **flags)
    mode = "events" if use_events else "gated" if use_sparse else "dense"
    rasters, v_finals, counters = fused_snn_net_cuda(
        spikes.to(torch.int8).contiguous(),
        [w.to(torch.int8).contiguous() for w in ws], thresholds, leaks,
        neuron=neuron, clamp_mode=clamp_mode, readout=readout,
        emit_rasters=emit_rasters, block_b=block_b, mode=mode,
        gate_granularity=gate_granularity, event_crossover=event_crossover,
        v_init=(None if v_init is None else
                [v.to(torch.int32).contiguous() for v in v_init]))
    return rasters, v_finals, _public_skips(counters, ws, use_sparse,
                                            gate_granularity, use_events)


def fused_snn_net_ref(spikes: torch.Tensor, ws: list, thresholds: tuple,
                      leaks: tuple, *, neuron: str, clamp_mode: str,
                      emit_rasters: bool = True, readout: bool = True,
                      v_init: list = None, use_sparse: bool = False,
                      gate_granularity: int = 1, use_events: bool = False,
                      event_crossover: float = 1.0, block_b: int = 8
                      ) -> tuple:
    """Plain PyTorch version of `fused_snn_net` on any device: per timestep,
    `isa.layer_timestep_int` over the spiking layers (reset to 0), then the
    unclamped int32 readout accumulate. Same arguments and results.

    The counters are taken on the batch cut into tiles of ``block_b`` lanes
    (the last one ragged, its missing lanes silent): a gate block is
    skipped when the tile's spikes in its rows are all 0, a tile falls back
    to the dense product when its event count is above the layer's
    `kernel.dense_thresholds`. A skipped block's partial product and a
    gathered sum equal the dense product's (silent rows add 0), so the
    values come from the dense product whatever the mode."""
    flags = dict(use_sparse=use_sparse, gate_granularity=gate_granularity,
                 use_events=use_events, event_crossover=event_crossover)
    _check_args(spikes, ws, thresholds, leaks, neuron, clamp_mode, readout,
                v_init, **flags)
    T, B, _ = spikes.shape
    dev = spikes.device
    n_spiking = len(ws) - 1 if readout else len(ws)
    in_widths = tuple(w.shape[0] for w in ws)
    n_tiles = -(-B // block_b)
    pad = n_tiles * block_b - B

    def tiles(cur: torch.Tensor) -> torch.Tensor:
        """(B, n) -> (tiles, block_b, n), the missing lanes silent."""
        if pad:
            cur = torch.cat([cur, cur.new_zeros((pad, cur.shape[1]))])
        return cur.reshape(n_tiles, block_b, cur.shape[1])

    if use_sparse:
        _, col_off, n_cols = skip_layout(in_widths, gate_granularity)
        blocks = [_ref_blocks(n, gate_granularity) for n in in_widths]
        skips = torch.zeros((n_tiles, n_cols), dtype=torch.int32, device=dev)
    if use_events:
        thr = dense_thresholds(in_widths, block_b, event_crossover)
        rows = [torch.zeros((n_tiles, n), dtype=torch.int32, device=dev)
                for n in in_widths]
        fallbacks = torch.zeros((n_tiles, len(ws)), dtype=torch.int32,
                                device=dev)

    def count(i: int, cur: torch.Tensor) -> None:
        """Layer i's gate or event counters on its (B, n_in) input."""
        tc = tiles(cur)
        if use_sparse:
            for g, (lo, hi) in enumerate(blocks[i]):
                silent = tc[:, :, lo:hi].sum(dim=(1, 2)) == 0
                skips[:, col_off[i] + g] += silent.to(torch.int32)
        if use_events:
            rows[i] += tc.sum(dim=1, dtype=torch.int32)
            fallbacks[:, i] += (tc.sum(dim=(1, 2)) > thr[i]).to(torch.int32)

    if v_init is not None:
        vs = [v.to(torch.int32) for v in v_init]
    else:
        vs = [torch.zeros((B, w.shape[1]), dtype=torch.int32, device=dev)
              for w in ws]
    rasters = [torch.empty((T, B, w.shape[1]), dtype=torch.int8, device=dev)
               for w in ws[:n_spiking]]
    for t in range(T):
        cur = spikes[t].to(torch.int32)
        for i in range(n_spiking):
            count(i, cur)
            vs[i], cur = layer_timestep_int(
                vs[i], ws[i], cur, neuron=neuron, threshold=thresholds[i],
                leak=leaks[i], reset=0, clamp_mode=clamp_mode)
            rasters[i][t] = cur
        if readout:
            count(len(ws) - 1, cur)
            vs[-1] = vs[-1] + int_matmul(cur, ws[-1])
    counters = (rows, fallbacks) if use_events else (
        skips if use_sparse else None)
    return ((rasters if emit_rasters else []), vs,
            _public_skips(counters, ws, use_sparse, gate_granularity,
                          use_events))


class DeviceEventCounts(NamedTuple):
    """The event-list kernel's counters as it leaves them, on its device:
    per layer the (tiles, n_in) int32 row-event counts, the
    (tiles, n_layers) int32 dense-fallback counts, and the frames the call
    ran. `fold` turns them into the `events.EventStats` the accounting
    layer takes; a caller that replays the call as a CUDA graph keeps
    the fold, a copy to the host, out of the graph."""
    row_events: list
    dense_fallbacks: torch.Tensor
    frames: int

    def fold(self) -> EventStats:
        """The counters summed over tiles in int64 on the host (per-layer
        totals over a long stream overflow int32)."""
        row_events = tuple(rc.to("cpu", torch.int64).sum(dim=0).numpy()
                           for rc in self.row_events)
        fallbacks = tuple(int(c) for c in np.asarray(
            self.dense_fallbacks.to("cpu", torch.int64).sum(dim=0)))
        return EventStats(row_events=row_events, frames=self.frames,
                          dense_fallbacks=fallbacks)


def fused_snn_net_device_events(spikes: torch.Tensor, ws: list, *,
                                thresholds: tuple, leaks: tuple,
                                neuron: str = "rmp",
                                clamp_mode: str = "saturate",
                                block_b: int = 8, emit_rasters: bool = True,
                                readout: bool = True, v_init: list = None,
                                event_crossover: float = 1.0,
                                fold: bool = True) -> tuple:
    """`fused_snn_net(use_events=True)` with the per-tile counters folded
    into an `events.EventStats`, the third element the host executor
    `events.fused_snn_net_events` returns, so the accounting layer treats
    both alike; with ``fold=False`` the third element is the
    `DeviceEventCounts` still on the device. Returns (rasters, v_finals,
    stats)."""
    rasters, v_finals, skips = fused_snn_net(
        spikes, ws, thresholds=thresholds, leaks=leaks, neuron=neuron,
        clamp_mode=clamp_mode, block_b=block_b, emit_rasters=emit_rasters,
        readout=readout, v_init=v_init, use_events=True,
        event_crossover=event_crossover)
    counts = DeviceEventCounts(
        row_events=list(skips["row_events"]),
        dense_fallbacks=skips["dense_fallbacks"],
        frames=int(spikes.shape[0]) * int(spikes.shape[1]))
    return rasters, v_finals, counts.fold() if fold else counts
