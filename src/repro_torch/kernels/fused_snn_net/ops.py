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

`fused_snn_net_mesh` runs the same stack on an `launch.mesh.SNNMesh`
(`torch.distributed`): lanes split over the data ranks, each running the
real single-device executor on its slice, or, above model extent 1, the
row-partial ticks of `mesh_rowpartial_tick`, whose row tiles' unclamped
int32 partial V one integer all-reduce (`accv2v_all_reduce`, a custom
operator) adds before the one clamp. The results equal one device's bit for
bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.isa import (int_matmul, layer_timestep_int,
                                  neuron_dynamics_int)
from repro_torch.core.neuron import NEURON_TYPES
from repro_torch.core.quant import CLAMP_MODES, clamp_v
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


# ---------------------------------------------------------------------------
# Mesh execution: the multi-GPU entry (`repro_torch.dist` wiring)
# ---------------------------------------------------------------------------

def mesh_axis_extents(mesh) -> tuple:
    """``(n_data, n_model)`` extents of the SNN mesh axes of an
    `launch.mesh.SNNMesh` or an ``{axis: extent}`` dict: "data" carries
    serving lanes and macro banks (the batch), "model" macro row tiles (the
    fan-in); 1 for an axis the mesh does not name."""
    from repro_torch.launch.mesh import mesh_extents
    sizes = mesh_extents(mesh)
    return int(sizes.get("data", 1)), int(sizes.get("model", 1))


def mesh_padded_widths(widths: tuple, n_model: int) -> tuple:
    """Layer widths padded up to multiples of the model extent, so every
    layer's fan-in rows split evenly over the model ranks. Shared with
    `analysis.check_kernel_contracts`, whose ``mesh_split`` row re-derives
    exactly these numbers."""
    return tuple(-(-int(w) // n_model) * n_model for w in widths)


@torch.library.custom_op("repro_torch::accv2v_all_reduce", mutates_args=())
def accv2v_all_reduce(partial: torch.Tensor, group: str) -> torch.Tensor:
    """The cross-rank AccV2V reduction: the integer sum of every model
    rank's unclamped partial V, one all-reduce (SUM) over the process group
    registered under ``group`` (`launch.mesh.SNNMesh.group_key`), on the
    tensor's own device. Its fake implementation returns the input's shape,
    so a trace sees the reduction as one node without a process group."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import _GROUPS
    out = partial.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_GROUPS[group])
    return out


@accv2v_all_reduce.register_fake
def _accv2v_all_reduce_fake(partial, group):
    return torch.empty_like(partial)


class LaneSplit(NamedTuple):
    """Where one call's lanes lie on the data ranks. The ``batch`` units
    (examples) split contiguously, ``per`` to a rank (the last ranks'
    spans padded past ``batch`` with silent lanes, so every rank holds the
    same shape); each unit is ``unit`` lanes of the call (P patch frames
    for an im2col'd conv, 1 for the fc stack)."""
    batch: int                   # global units
    n_data: int
    coord: int                   # this rank's data coordinate
    unit: int = 1

    @property
    def per(self) -> int:
        """Units a rank holds, padding included."""
        return -(-self.batch // self.n_data)

    @property
    def lo(self) -> int:
        """First global unit of this rank."""
        return self.coord * self.per

    @property
    def real(self) -> int:
        """Lanes of this rank that hold real units (the rest pad)."""
        return max(0, min(self.batch, self.lo + self.per) - self.lo) \
            * self.unit

    @property
    def lanes(self) -> int:
        """Lanes of the call on one rank, padding included."""
        return self.per * self.unit

    @property
    def total(self) -> int:
        """Lanes of the whole call on every rank, without padding."""
        return self.batch * self.unit

    def scaled(self, unit: int) -> "LaneSplit":
        """The same split for a call of ``unit`` lanes a unit."""
        return self._replace(unit=self.unit * unit)


def lane_split(batch: int, mesh) -> LaneSplit:
    """The `LaneSplit` of ``batch`` lanes on ``mesh``'s data axis for this
    rank."""
    n_data, _ = mesh_axis_extents(mesh)
    return LaneSplit(int(batch), n_data, mesh.coord("data"))


def lane_shard(x: torch.Tensor, dim: int, split: LaneSplit) -> torch.Tensor:
    """This rank's lanes of a global tensor ``x`` whose dimension ``dim``
    holds ``split.total`` lanes, zero-padded to ``split.lanes``."""
    lo = split.lo * split.unit
    real = split.real
    part = x.narrow(dim, min(lo, x.shape[dim]), real)
    if real == split.lanes:
        return part
    shape = list(x.shape)
    shape[dim] = split.lanes - real
    return torch.cat([part, x.new_zeros(shape)], dim=dim)


def all_gather_dim(x: torch.Tensor, dim: int, mesh, axis: str = "data"
                   ) -> torch.Tensor:
    """The pieces of ``x`` from every rank of ``mesh``'s ``axis`` group,
    concatenated along ``dim`` in rank order: one all-gather on the
    tensor's own device (the identity at extent 1)."""
    group = mesh.group(axis)
    n = mesh.extent(axis)
    if group is None or n == 1:
        return x
    if x.numel() == 0:
        shape = list(x.shape)
        shape[dim] *= n
        return x.new_empty(shape)
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_lanes(x: torch.Tensor, dim: int, split: LaneSplit, mesh
                 ) -> torch.Tensor:
    """The global tensor of a lane-sharded ``x``: every data rank's lanes
    gathered along ``dim`` and the padding sliced off."""
    return all_gather_dim(x, dim, mesh).narrow(dim, 0, split.total)


def gather_counters(skips, mesh):
    """Per-rank counter blocks (the layouts of `_public_skips`, one row
    per tile, or one row per rank) stacked in lane order over the data
    group: None stays None."""
    if skips is None:
        return None
    if isinstance(skips, dict):
        return {"row_events": [all_gather_dim(r, 0, mesh)
                               for r in skips["row_events"]],
                "dense_fallbacks": all_gather_dim(skips["dense_fallbacks"],
                                                  0, mesh)}
    if isinstance(skips, list):
        return [all_gather_dim(s, 0, mesh) for s in skips]
    return all_gather_dim(skips, 0, mesh)


def mesh_rowpartial_tick(vs, counts, frame, ws_l, *, widths: tuple,
                         n_spiking: int, thresholds: tuple, leaks: tuple,
                         neuron: str, clamp_mode: str, use_events: bool,
                         model_rank: int, group: str,
                         lanes: Optional[int] = None) -> tuple:
    """One model-parallel frame tick, the AccV2V reduction across ranks, at
    module level so `analysis.check_trace` traces exactly the dispatched
    body on fake tensors (one rank's tick, the all-reduce one node).

    Each model rank owns row tile ``model_rank`` of every layer's padded
    weights (``ws_l``, (pw[i] / n_model, pw[i+1]) int8) and computes that
    tile's UNCLAMPED int32 partial V from its rows of the input; the
    integer all-reduce (`accv2v_all_reduce` over the model group
    ``group``) sums the partials, exact under the mod-2^11 wrap too since
    int32 addition is associative and `clamp_v` composes after the full
    sum; the one clamp and the neuron update run after the reduction.
    ``vs``/``counts`` are the per-layer carry at padded widths (``counts``
    empty unless ``use_events``: per-row events of the logical input rows
    of the first ``lanes`` lanes, the rest being padding); ``frame`` is the
    (B_l, pw[0]) {0, 1} frame, the same on every model rank. Returns
    ``(vs, counts, rasters_t)``."""
    vs, counts = list(vs), list(counts)
    cur = frame.to(torch.int32)                  # (B_l, pw[0])
    real = cur.shape[0] if lanes is None else lanes
    rasters_t = []
    for i, w_l in enumerate(ws_l):
        if use_events:
            counts[i] = counts[i] + cur[:real, :widths[i]].sum(
                dim=0, dtype=torch.int32)
        rows = w_l.shape[0]                      # pw[i] // n_model
        lo = model_rank * rows
        total = accv2v_all_reduce(int_matmul(cur[:, lo:lo + rows], w_l),
                                  group)
        if i < n_spiking:
            v = clamp_v(vs[i] + total, clamp_mode)
            vs[i], cur = neuron_dynamics_int(
                v, neuron=neuron, threshold=thresholds[i], leak=leaks[i],
                reset=0, clamp_mode=clamp_mode)
            rasters_t.append(cur.to(torch.int8))
        else:                                    # unclamped readout
            vs[i] = vs[i] + total
    return tuple(vs), tuple(counts), tuple(rasters_t)


def _pad_to(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``x`` zero-padded along ``dim`` to ``size``."""
    if x.shape[dim] == size:
        return x
    shape = list(x.shape)
    shape[dim] = size - x.shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _rowpartial_run(spikes: torch.Tensor, ws: list, v_init: list, *, mesh,
                    lanes: int, thresholds: tuple, leaks: tuple, neuron: str,
                    clamp_mode: str, emit_rasters: bool, readout: bool,
                    use_events: bool) -> tuple:
    """Model extent > 1: the row-partial ticks over this rank's (T, B_l,
    N0) lanes. Widths pad to the model extent; padded output lanes may
    fire junk spikes (their V only integrates leak) but feed zero weight
    rows downstream, and are sliced off. Returns (rasters, v_finals,
    counters): the rank's local results at logical widths; on the event
    path the counters are {"row_events": per layer (1, n_in) int32,
    "dense_fallbacks": (1, 0)} (no dense fallback on this path), else
    None (gate counters are a per-device kernel feature)."""
    _, n_model = mesh_axis_extents(mesh)
    rank = mesh.coord("model")
    T, B_l, N0 = spikes.shape
    widths = (N0,) + tuple(w.shape[1] for w in ws)
    pw = mesh_padded_widths(widths, n_model)
    n_spiking = len(ws) - 1 if readout else len(ws)
    s = _pad_to(spikes.to(torch.int8), 2, pw[0])
    ws_l = []
    for i, w in enumerate(ws):
        rows = pw[i] // n_model
        w = _pad_to(_pad_to(w.to(torch.int8), 0, pw[i]), 1, pw[i + 1])
        ws_l.append(w[rank * rows:(rank + 1) * rows].contiguous())
    vs = tuple(_pad_to(v.to(torch.int32), 1, p)
               for v, p in zip(v_init, pw[1:]))
    counts = tuple(torch.zeros((widths[i],), dtype=torch.int32,
                               device=spikes.device)
                   for i in range(len(ws))) if use_events else ()
    rasters = [[] for _ in range(n_spiking)]
    group = mesh.group_key("model")
    for t in range(T):
        vs, counts, r_t = mesh_rowpartial_tick(
            vs, counts, s[t], ws_l, widths=widths, n_spiking=n_spiking,
            thresholds=thresholds, leaks=leaks, neuron=neuron,
            clamp_mode=clamp_mode, use_events=use_events, model_rank=rank,
            group=group, lanes=lanes)
        if emit_rasters:
            for i, r in enumerate(r_t):
                rasters[i].append(r[:, :widths[i + 1]])
    rasters = ([torch.stack(r) for r in rasters] if emit_rasters and T
               else [])
    v_finals = [v[:, :w].contiguous() for v, w in zip(vs, widths[1:])]
    counters = None
    if use_events:
        counters = {"row_events": [c[None] for c in counts],
                    "dense_fallbacks": torch.zeros(
                        (1, 0), dtype=torch.int32, device=spikes.device)}
    return rasters, v_finals, counters


def fused_snn_net_mesh_local(spikes: torch.Tensor, ws: list, *, mesh,
                             thresholds: tuple, leaks: tuple,
                             neuron: str = "rmp",
                             clamp_mode: str = "saturate", block_b: int = 8,
                             use_kernel: bool = True,
                             emit_rasters: bool = True,
                             use_sparse: bool = False,
                             gate_granularity: int = 1, readout: bool = True,
                             v_init: list = None, use_events: bool = False,
                             event_crossover: float = 1.0,
                             lanes: Optional[int] = None) -> tuple:
    """One rank's part of `fused_snn_net_mesh`: ``spikes`` (T, B_l, N0)
    and ``v_init`` hold this rank's lanes (the first ``lanes`` real, the
    rest padding), the weights are global. Returns the rank's (rasters,
    v_finals, counters), counters in the layouts of `_public_skips` with
    one row per tile of this rank (or one per rank on the row-partial
    path); `gather_counters` stacks them over the data group.

    At model extent 1 the rank runs the real single-device executor: the
    kernel wrapper (``use_kernel``, the CUDA kernel on a CUDA tensor) or
    its plain version (its tile the rank's whole batch, as
    `pipeline._run_layers` gives it). Above 1 it runs `_rowpartial_run`,
    whatever ``use_kernel`` says (a kernel cannot span the cross-rank
    reduction)."""
    _, n_model = mesh_axis_extents(mesh)
    thresholds = tuple(int(t) for t in thresholds)
    leaks = tuple(int(lk) for lk in leaks)
    B_l = int(spikes.shape[1])
    if v_init is None:
        v_init = [torch.zeros((B_l, w.shape[1]), dtype=torch.int32,
                              device=spikes.device) for w in ws]
    if n_model == 1:
        kw = dict(neuron=neuron, clamp_mode=clamp_mode,
                  emit_rasters=emit_rasters, readout=readout, v_init=v_init,
                  use_sparse=use_sparse, gate_granularity=gate_granularity,
                  use_events=use_events, event_crossover=event_crossover)
        if use_kernel:
            return fused_snn_net(spikes, ws, thresholds=thresholds,
                                 leaks=leaks, block_b=block_b, **kw)
        return fused_snn_net_ref(
            spikes, ws, thresholds, leaks,
            block_b=max(B_l, 1), **kw)
    _check_args(spikes, ws, thresholds, leaks, neuron, clamp_mode, readout,
                v_init, use_sparse, gate_granularity, use_events,
                event_crossover)
    return _rowpartial_run(
        spikes, ws, v_init, mesh=mesh,
        lanes=B_l if lanes is None else lanes, thresholds=thresholds,
        leaks=leaks, neuron=neuron, clamp_mode=clamp_mode,
        emit_rasters=emit_rasters, readout=readout, use_events=use_events)


def fused_snn_net_mesh(spikes: torch.Tensor, ws: list, *, mesh,
                       thresholds: tuple, leaks: tuple, neuron: str = "rmp",
                       clamp_mode: str = "saturate", block_b: int = 8,
                       use_kernel: bool = True, emit_rasters: bool = True,
                       use_sparse: bool = False, gate_granularity: int = 1,
                       readout: bool = True, v_init: list = None,
                       use_events: bool = False,
                       event_crossover: float = 1.0) -> tuple:
    """`fused_snn_net` on an `launch.mesh.SNNMesh`: the same stack and the
    same results, global in and global out on every rank. Lanes (the
    batch) split contiguously over the data ranks, padded with silent
    lanes to a multiple of the data extent; the results come back with an
    all-gather over the data group, the padding sliced off.

      * model extent 1: every rank runs the real single-device executor
        (the CUDA kernel in its dense, gated or event-list mode, or the
        plain version) on its lane slice; lanes never interact, so the
        results concatenate. The counters are the per-rank tile blocks
        stacked in lane order, equal to the single-device counters
        whenever ``block_b`` divides the per-rank batch.
      * model extent > 1: the row-partial ticks of `mesh_rowpartial_tick`,
        one unclamped int32 all-reduce per layer and frame, the clamp
        after it. Row-event counters add over the data group; the gate
        counters are None and there are no dense fallbacks.

    Arguments and shapes are `fused_snn_net`'s (``use_kernel`` False runs
    the plain version). Returns (rasters, v_finals, skips), ``skips`` an
    `events.EventStats` on the event path. Raises `ValueError` on a bad
    stack or flag combination: ``gate_granularity`` without
    ``use_sparse``, events with ``use_sparse``, and events without the
    kernel (the host executor splits lanes at the pipeline level,
    `pipeline._host_events_sharded`)."""
    _check_stack(spikes, ws)
    if v_init is not None and len(v_init) != len(ws):
        raise ValueError(f"v_init needs one (B, n_out) state per layer "
                         f"({len(ws)}), got {len(v_init)}")
    if gate_granularity != 1 and not use_sparse:
        raise ValueError("gate_granularity is an event-gating knob; pass "
                         "use_sparse=True to gate at granularity "
                         f"{gate_granularity}")
    if use_events and use_sparse:
        raise ValueError("use_events (event-list execution) and use_sparse "
                         "(row-block gating) are mutually exclusive")
    if use_events and not use_kernel:
        raise ValueError("use_events is the device event-list path; the "
                         "host executor shards at the pipeline level "
                         "(core.pipeline._host_events_sharded)")
    T, B = int(spikes.shape[0]), int(spikes.shape[1])
    split = lane_split(B, mesh)
    s_l = lane_shard(spikes, 1, split)
    vi = (None if v_init is None else
          [lane_shard(v, 0, split) for v in v_init])
    rasters, v_finals, skips = fused_snn_net_mesh_local(
        s_l, ws, mesh=mesh, thresholds=thresholds, leaks=leaks,
        neuron=neuron, clamp_mode=clamp_mode, block_b=block_b,
        use_kernel=use_kernel, emit_rasters=emit_rasters,
        use_sparse=use_sparse, gate_granularity=gate_granularity,
        readout=readout, v_init=vi, use_events=use_events,
        event_crossover=event_crossover, lanes=split.real)
    rasters = [gather_lanes(r, 1, split, mesh) for r in rasters]
    v_finals = [gather_lanes(v, 0, split, mesh) for v in v_finals]
    skips = gather_counters(skips, mesh)
    if use_events:
        skips = DeviceEventCounts(row_events=skips["row_events"],
                                  dense_fallbacks=skips["dense_fallbacks"],
                                  frames=T * B).fold()
    return rasters, v_finals, skips
