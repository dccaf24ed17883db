"""Streaming SNN serving engine: continuous batching over persistent
membrane-potential slots.

A request's state is its membrane-potential lanes, one per layer (the
SNN's counterpart of an LM's KV-cache lane). The engine keeps:

  * a paged V-slot pool: ``pages`` pages of ``batch_slots`` lanes, each
    page owning one `pipeline.StreamState`. A request is admitted into any
    free lane (its zero state is copied into the lane) and each engine tick
    dispatches only the occupied pages;
  * K-frame megasteps: every dispatch advances a page ``megastep`` frames
    through `pipeline.stream_megastep`. The next K frames of each lane are
    staged into one (K, B, d) block; lanes whose stream runs out inside the
    block integrate zero current (the active mask), and requests that
    finish mid-block are finalized from the block's exact per-tick readout
    trajectory. Lanes never interact, so each request's output is
    bit-identical to serving it alone, at any K;
  * compiled dispatch: on the ``int_ref`` and ``cuda*`` backends each page
    owns a `graphed.PageMegastep`, one CUDA graph of its megastep captured
    when the engine is built (the counterpart of JAX's ``jax.jit``), fed
    through static block and active-count buffers and writing V back into
    the page's state in place; ``float`` and ``ref_events`` dispatch
    eagerly, as JAX leaves them unjitted. On the CPU the same static-buffer
    dispatch runs without a graph;
  * double-buffered upload (``double_buffer=True``): after dispatching
    tick t's blocks, tick t+1's are built and uploaded while the device
    computes (on CUDA into pinned host buffers, two per page used in turn,
    copied on a side stream that the dispatch waits on). A staged block is
    keyed by per-lane (admission serial, cursor, frames) and rebuilt on any
    mismatch (early exit, admission, eviction), so results never change;
  * admission by ``arrival_tick`` on the engine's frame clock (``clock``
    advances K per engine tick, idle ticks included);
  * with ``validate`` (the default), the static analysis of
    `repro_torch.analysis` when the engine is built: the kernel contracts
    of its exact dispatch (`check_kernel_contracts`) are checked before
    the first tick, and `submit` refuses with `RangeError` a request whose
    K-rounded tick budget passes the readout's proven ``max_safe_frames``,
    the horizon past which its unclamped int32 accumulator can overflow;
  * conv programs: a request is (T, H, W, C) images; each on-macro conv
    runs P = H_out * W_out frames per lane (lane l owns frames
    [l * P, (l + 1) * P) of its patch raster), which the accounting and the
    ledger scale by;
  * the ``float`` backend: the float program's (or an int program's f32
    rendering's) eager per-tick `_float_step`, f32 logits and V; with
    ``validate`` a float program has no accumulator bound and no cap;
  * per-slot stop conditions: the tick budget (the frames run out, or
    ``max_ticks``) or the readout-confidence early exit
    (max |logit| >= ``stop_threshold``);
  * a vacated lane is re-seeded with zero state, so idle lanes are silent;
  * per-slot event accounting: each block's input rasters are credited to
    a request only up to the tick it actually served, and finalize into a
    per-request `pipeline.SparsityReport`;
  * on the event backends (``ref_events``, ``cuda_events``) a pooled
    device ledger: the per-row event counters the executor itself reports,
    over all lanes of every dispatched page (`device_event_stats`). Idle
    lanes are silent, so the ledger equals the summed per-request tallies
    whenever no request finishes mid-block (a finished lane's remaining
    ticks of the block, its ghost ticks, reach the ledger but not the
    request's report; a conv layer can fire on them);
  * ``mesh`` (an `launch.mesh.SNNMesh`): the pool is partitioned. Each
    page's state is placed by `dist.sharding.snn_state_specs`, so a rank
    holds only its lanes of it (every lane when the page's lanes do not
    divide the data extent), and every megastep runs on the mesh: lanes
    over the data ranks, the row-tiled fan-in over the model ranks. Every
    rank runs the same scheduler on the same requests and sees the global
    block outputs, so every per-request result and both ledgers equal the
    single-device engine's.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis import (RangeError, check_kernel_contracts,
                                  check_program)
from repro_torch.core import pipeline
from repro_torch.core.pipeline import SNNProgram, SparsityReport
from repro_torch.dist.sharding import shard_state
from repro_torch.kernels.fused_snn_net.ops import lane_split
from repro_torch.kernels.fused_snn_net.events import EventStats
from repro_torch.serve import graphed
from repro_torch.serve.engine import SlotEngine, lane_scatter


class ReportUnavailable(RuntimeError):
    """`aggregate_report` has nothing to aggregate: event tracking is off on
    this engine, or no request has finished yet."""


@dataclass
class SNNRequest:
    rid: int
    frames: np.ndarray                    # (T, *in_shape) f32 input currents
    max_ticks: Optional[int] = None       # default: len(frames)
    stop_threshold: Optional[float] = None  # early exit when max|logit| >= thr
    arrival_tick: int = 0                 # earliest admission, engine clock
    # -- filled at finish ----------------------------------------------------
    logits: Optional[np.ndarray] = None
    v_out: Optional[np.ndarray] = None
    ticks: int = 0
    finish_clock: Optional[int] = None    # engine clock at the finish tick
    report: Optional[SparsityReport] = None

    @property
    def latency_ticks(self) -> Optional[int]:
        """Frame-clock latency, arrival to finish (None until finished)."""
        if self.finish_clock is None:
            return None
        return self.finish_clock - self.arrival_tick


@dataclass
class _Slot:
    req: Optional[SNNRequest] = None
    cursor: int = 0                       # next frame index to present
    ticks: int = 0
    serial: int = -1                      # admission sequence number
    row_events: list = field(default_factory=list)


class _Upload:
    """One of a page's two double-buffer upload buffers on CUDA: a pinned
    host block and counts, their device copies, an event recorded after the
    copy (the dispatch waits on it) and one recorded after the dispatch
    that read the device block. The host rewrites the pinned block only
    after both have passed, so no copy in flight reads a changing buffer
    and no dispatch reads a block being overwritten."""

    def __init__(self, shape: tuple, device: torch.device):
        self.host = torch.zeros(shape, dtype=torch.float32, pin_memory=True)
        self.host_counts = torch.zeros(shape[1], dtype=torch.int32,
                                       pin_memory=True)
        self.block = torch.zeros(shape, dtype=torch.float32, device=device)
        self.counts = torch.zeros(shape[1], dtype=torch.int32, device=device)
        self.copied = torch.cuda.Event()
        self.read = torch.cuda.Event()


class _ArrivalQueue:
    """Submission-order FIFO with head peek: arrival-gated admission looks
    at the head's ``arrival_tick`` without consuming it."""

    def __init__(self):
        self._q: deque = deque()

    def put(self, item) -> None:
        self._q.append(item)

    def get(self):
        return self._q.popleft()

    def peek(self):
        return self._q[0]

    def empty(self) -> bool:
        return not self._q

    def qsize(self) -> int:
        return len(self._q)


def merge_reports(reports: list) -> SparsityReport:
    """Pool per-request reports (batch 1 each) into one workload report:
    events, row events and frame counts add."""
    if not reports:
        raise ValueError("merge_reports needs at least one report")
    head = reports[0]
    for r in reports[1:]:
        if (r.n_in, r.n_out, r.neurons) != (head.n_in, head.n_out,
                                            head.neurons):
            raise ValueError("cannot merge reports of different programs")
    return SparsityReport(
        n_in=head.n_in, n_out=head.n_out, neurons=head.neurons,
        events=tuple(sum(r.events[i] for r in reports)
                     for i in range(len(head.n_in))),
        frames=sum(r.frames for r in reports),
        timesteps=sum(r.timesteps for r in reports),
        batch=1,
        layer_frames=tuple(sum(r.frames_by_layer[i] for r in reports)
                           for i in range(len(head.n_in))),
        row_events=tuple(
            sum(np.asarray(r.row_events[i], np.int64) for r in reports)
            for i in range(len(head.n_in))))


class SNNServeEngine(SlotEngine):
    """Continuous batching for streaming SNN inference (see module docs).

    ``backend`` is a `pipeline.STREAM_BACKENDS` entry: ``"cuda"`` runs the
    fc stack of each megastep in one launch of the fused-network kernel,
    ``"cuda_sparse"`` of the row-block gated kernel, ``"cuda_events"`` of
    the event-list kernel, ``"int_ref"`` the plain version,
    ``"ref_events"`` the host event executor and ``"float"`` the float
    backend (a dispatch runs without autograd). ``step_kw`` passes through to
    `pipeline.stream_megastep` (``block_b``, ``gate_granularity``,
    ``use_sparse``, ``event_crossover``). ``pages`` x ``batch_slots`` is
    the lane pool and ``megastep`` is K, the frames advanced per dispatch;
    ``double_buffer`` stages the next block while this one computes.
    ``track_events=False`` turns off raster emission and per-request
    reports. ``validate`` (default on) checks the dispatch's kernel
    contracts now and sets ``max_safe_ticks``, the admission cap of
    `submit` (None with ``validate=False``). ``device`` defaults to the
    CUDA device (raises without one) and must be the program's device.

    The class attribute ``_compiled`` (True) selects the compiled
    static-buffer dispatch on the backends of `graphed.GRAPHED_BACKENDS`;
    a subclass that sets it False dispatches `pipeline.stream_megastep`
    eagerly, the form the compiled one is held against.

    ``mesh`` (an `launch.mesh.SNNMesh` on the engine's device type)
    partitions the pool (see the module docs); ``float`` rejects it with
    `ValueError`. A page keeps its CUDA graph only where the mesh's
    collectives can be captured (`SNNMesh.capturable`: NCCL, or a mesh of
    extent 1 that runs none); on a gloo mesh the engine dispatches every
    megastep eagerly, with the same results."""

    _compiled = True

    def __init__(self, program: SNNProgram, *, batch_slots: int = 4,
                 backend: str = "int_ref", track_events: bool = True,
                 step_kw: Optional[dict] = None, pages: int = 1,
                 megastep: int = 1, double_buffer: bool = False,
                 validate: bool = True, device=None, mesh=None):
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        if pages < 1:
            raise ValueError(f"pages must be >= 1, got {pages}")
        if megastep < 1:
            raise ValueError(f"megastep must be >= 1, got {megastep}")
        if backend not in pipeline.STREAM_BACKENDS:
            raise KeyError(f"unknown streaming backend {backend!r}; have "
                           f"{pipeline.STREAM_BACKENDS}")
        if mesh is not None and backend == "float":
            raise ValueError(
                "backend 'float' has no mesh execution: float reductions "
                "are not order-exact, so a sharded engine could not stay "
                "bit-identical to the single-device path")
        self.device = resolve_device(device)
        if program.device != self.device:
            raise ValueError(f"the program lives on {program.device} but the "
                             f"engine serves on {self.device}")
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh runs on {mesh.device_type} but the "
                             f"engine serves on {self.device}")
        self.mesh = mesh
        self.program = program
        self.backend = backend
        self.B = batch_slots                  # lanes per page
        self.pages = pages
        self.K = megastep
        self.double_buffer = double_buffer
        self.track_events = track_events
        self.step_kw = dict(step_kw or {})
        self.max_safe_ticks: Optional[int] = None
        if validate:
            check_kernel_contracts(
                program, backend, frames=megastep, batch=batch_slots,
                streaming=True, emit_rasters=track_events, mesh=mesh,
                **self.step_kw)
            self.max_safe_ticks = check_program(
                program, frames=1).max_safe_frames
        self.states = [pipeline.init_stream_state(program, batch_slots,
                                                  backend)
                       for _ in range(pages)]
        self._split = None                # this rank's lanes of a page
        if mesh is not None:
            self.states = [shard_state(st, mesh) for st in self.states]
            self._split = lane_split(batch_slots, mesh)
        self._fresh = pipeline.init_stream_state(program, 1, backend)
        self.slots = [_Slot() for _ in range(pages * batch_slots)]
        self.queue = _ArrivalQueue()
        self.finished: list[SNNRequest] = []
        self._n_in, self._n_out, self._neurons = \
            pipeline._report_geometry(program)
        self._frame_shape = program.in_shape
        # frames each macro-stack layer runs per lane and tick: P = H_out *
        # W_out output positions for a conv, 1 for an FC layer
        self._lane_frames = tuple(
            int(np.prod(ly.state_shape[:-1])) if ly.kind == "conv" else 1
            for ly in program.macro_stack)
        self.ticks = 0                    # engine ticks executed
        self.dispatches = 0               # page megasteps dispatched
        self.clock = 0                    # frame clock: K per engine tick
        # pooled device ledger (event backends only): per-layer row-event
        # counters as the executor reports them, over all dispatched lanes
        self._event_backend = backend in ("ref_events", "cuda_events")
        self.device_row_events: Optional[list] = None
        self.device_dense_fallbacks: Optional[list] = None
        self.device_ticks = 0             # frame ticks dispatched, all pages
        self._dispatch = None             # per page: its compiled megastep
        if (self._compiled and backend in graphed.GRAPHED_BACKENDS
                and (mesh is None or mesh.capturable)):
            self._dispatch = [graphed.PageMegastep(
                program, st, backend, megastep, emit_rasters=track_events,
                step_kw=self.step_kw, batch=batch_slots, mesh=mesh)
                for st in self.states]
        self._admit_seq = 0
        self._staged: dict = {}           # page -> (meta, block, counts, upload)
        self._uploads = None              # per page: two `_Upload`s (CUDA)
        if double_buffer and self.device.type == "cuda":
            shape = (megastep, batch_slots, *self._frame_shape)
            self._uploads = [[_Upload(shape, self.device) for _ in range(2)]
                             for _ in range(pages)]
            self._upload_turn = [0] * pages
            self._upload_stream = torch.cuda.Stream(self.device)
        self._staged_used = 0             # staged blocks dispatched
        self._staged_rebuilt = 0          # staged blocks dropped and rebuilt

    @property
    def state(self) -> pipeline.StreamState:
        """Page 0's state (the single-page engine's handle)."""
        return self.states[0]

    # -- request intake ------------------------------------------------------
    def submit(self, req: SNNRequest) -> None:
        """Enqueue ``req`` (its ``frames`` a (T, *in_shape) current block)
        for arrival-gated FIFO admission. Raises `ValueError` when its
        frame shape does not match the program input, and `RangeError`
        when its tick budget, rounded up to whole K-frame blocks (a lane
        runs to the block's end), passes ``max_safe_ticks``."""
        if tuple(req.frames.shape[1:]) != self._frame_shape:
            raise ValueError(
                f"request {req.rid}: frame shape {req.frames.shape[1:]} "
                f"does not match the program input {self._frame_shape}")
        budget = self._tick_budget(req)
        horizon = -(-budget // self.K) * self.K
        if self.max_safe_ticks is not None and horizon > self.max_safe_ticks:
            raise RangeError(
                f"request {req.rid} streams {budget} ticks ({horizon} at "
                f"megastep K={self.K}) but the readout's unclamped int32 "
                f"accumulator is only proven safe for {self.max_safe_ticks} "
                "frames; split the stream or cap max_ticks", where="readout")
        self.queue.put(req)

    @staticmethod
    def _tick_budget(req: SNNRequest) -> int:
        """Ticks this request may stream: its frame count, clipped by an
        explicit non-negative max_ticks."""
        if req.max_ticks is None:
            return len(req.frames)
        return min(len(req.frames), max(req.max_ticks, 0))

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.req is not None:
                continue
            # a request with nothing to stream finishes at admission and
            # never occupies a slot; keep draining until one needs ticks
            while not self.queue.empty():
                if self.queue.peek().arrival_tick > self.clock:
                    return    # FIFO: the head gates later submissions too
                req = self.queue.get()
                if self._tick_budget(req) == 0:
                    req.logits = np.zeros(self._n_out[-1], np.float32)
                    req.v_out = np.zeros(
                        self._n_out[-1],
                        np.float32 if self.backend == "float" else np.int32)
                    req.finish_clock = self.clock
                    if self.track_events:
                        req.report = self._finalize_report(_Slot(
                            req=req, row_events=[np.zeros(n, np.int64)
                                                 for n in self._n_in]))
                    self.finished.append(req)
                    continue
                page, lane = divmod(i, self.B)
                self._reseed(page, lane)
                self.slots[i] = _Slot(req=req, serial=self._admit_seq,
                                      row_events=[np.zeros(n, np.int64)
                                                  for n in self._n_in])
                self._admit_seq += 1
                break

    def _reseed(self, page: int, lane: int) -> None:
        """Write fresh (zero) state into lane ``lane`` of page ``page``: on
        a mesh, into the rank's shard when the rank holds that lane (every
        rank holds it when the page is replicated)."""
        vs = self.states[page].vs
        if self._split is not None and int(vs[0].shape[0]) != self.B:
            lane -= self._split.lo
            if not 0 <= lane < self._split.per:
                return
        lane_scatter(self._fresh.vs, vs, lane)

    # -- per-slot event accounting ------------------------------------------
    def _account(self, rasters: list, served: list) -> None:
        """Fold one block's macro-stack input rasters into the served slots'
        per-row event tallies. ``served`` is [(slot, lane, ticks)]: a
        request is credited only the ticks it actually served. A conv
        layer's maps count as their patch raster, lane l owning its P
        frames [l * P, (l + 1) * P)."""
        rs = pipeline._stack_input_rasters(self.program, rasters)
        for li, (r, p) in enumerate(zip(rs, self._lane_frames)):
            counts = r.astype(np.int64)       # (K, B * P_l, n_in_l)
            for i, lane, n in served:
                self.slots[i].row_events[li] += counts[
                    :n, lane * p:(lane + 1) * p].sum(axis=(0, 1))

    def _account_device(self, out) -> None:
        """Pool one dispatch's executor-reported `EventStats` (one per conv
        in ``out.conv_skips``, then the fc stack's in ``out.skips``; all
        lanes of the page, K frames each) into the engine-lifetime device
        ledger. A compiled dispatch's counters arrive unfolded
        (`ops.DeviceEventCounts`, on the device) and are folded here."""
        stats = [s if isinstance(s, EventStats) else s.fold()
                 for s in list(out.conv_skips or []) + [out.skips]]
        rows = [np.asarray(r, np.int64) for st in stats
                for r in st.row_events]
        fbs = [int(f) for st in stats for f in st.dense_fallbacks]
        if self.device_row_events is None:
            self.device_row_events = rows
            self.device_dense_fallbacks = fbs if fbs else None
        else:
            self.device_row_events = [a + b for a, b in
                                      zip(self.device_row_events, rows)]
            if fbs:
                self.device_dense_fallbacks = [
                    a + b for a, b in zip(self.device_dense_fallbacks, fbs)]
        self.device_ticks += self.K

    def _check_ledger(self) -> None:
        if self.device_row_events is None:
            raise ValueError("no device ledger: the engine has not ticked "
                             "on an event backend (ref_events/cuda_events)")

    def device_event_stats(self) -> EventStats:
        """The pooled device ledger as an `events.EventStats`: per-layer
        row-event counters summed over every dispatch so far, frames =
        device_ticks x batch_slots lane-frames (a conv layer runs P frames
        a lane-frame, see `device_skipped_row_fraction`), and the per-layer
        dense
        fallback counts of the event kernel (() on ``ref_events``). Raises
        `ValueError` before the first dispatch on an event backend."""
        self._check_ledger()
        return EventStats(
            row_events=tuple(self.device_row_events),
            frames=self.device_ticks * self.B,
            dense_fallbacks=tuple(self.device_dense_fallbacks or ()))

    def device_skipped_row_fraction(self) -> float:
        """Share of the device ledger's (frame, input-row) sites that were
        silent, each layer's lane-frames scaled by its P. Raises
        `ValueError` like `device_event_stats`."""
        self._check_ledger()
        possible = sum(self.device_ticks * self.B * p * n
                       for p, n in zip(self._lane_frames, self._n_in))
        events = sum(int(r.sum()) for r in self.device_row_events)
        return 1.0 - events / possible if possible else 0.0

    def _finalize_report(self, slot: _Slot) -> SparsityReport:
        """The per-request SparsityReport: batch 1, one timestep per served
        tick, as `pipeline.sparsity_report` gives on an isolated run."""
        t = slot.ticks
        row_events = tuple(np.asarray(r, np.int64) for r in slot.row_events)
        return SparsityReport(
            n_in=self._n_in, n_out=self._n_out, neurons=self._neurons,
            events=tuple(int(r.sum()) for r in row_events),
            frames=t, timesteps=t, batch=1,
            layer_frames=tuple(t * p for p in self._lane_frames),
            row_events=row_events)

    # -- frame staging -------------------------------------------------------
    def _block_meta(self, page: int) -> tuple:
        """Identity of the block a page would dispatch right now: per
        occupied lane (admission serial, cursor, staged frame count), the
        key that validates a staged block."""
        meta = []
        for i in self.page_lanes(page):
            slot = self.slots[i]
            if slot.req is None:
                continue
            n = min(self._tick_budget(slot.req) - slot.cursor, self.K)
            meta.append((slot.serial, slot.cursor, n))
        return tuple(meta)

    def _build_block(self, page: int, at_next: bool = False,
                     out: Optional[tuple] = None) -> tuple:
        """One page's (K, B, *in_shape) host frame block and per-lane active
        counts, from each lane's cursor or (``at_next``) from its cursor
        after this tick's dispatch, for the double buffer; written into
        ``out`` (a block and counts pair of numpy arrays) when given.
        Returns (meta, block, counts); all None when no lane would be
        active."""
        if out is None:
            out = (np.zeros((self.K, self.B, *self._frame_shape), np.float32),
                   np.zeros(self.B, np.int32))
        block, counts = out
        block.fill(0)
        counts.fill(0)
        meta = []
        for i in self.page_lanes(page):
            slot = self.slots[i]
            if slot.req is None:
                continue
            budget = self._tick_budget(slot.req)
            cursor = slot.cursor
            if at_next:
                cursor += min(budget - cursor, self.K)
                if cursor >= budget:
                    continue              # finished by then
            n = min(budget - cursor, self.K)
            block[:n, i % self.B] = slot.req.frames[cursor:cursor + n]
            counts[i % self.B] = n
            meta.append((slot.serial, cursor, n))
        if not meta:
            return None, None, None
        return tuple(meta), block, counts

    def _stage_block(self, page: int) -> tuple:
        """The block a page dispatches this tick: the staged one when its
        meta still matches the page's lanes (no early exit, admission or
        eviction since it was staged), else one built now. Returns (block,
        counts, upload): host arrays and None, or on CUDA the staged
        device tensors and their `_Upload`."""
        staged = self._staged.pop(page, None)
        if staged is not None:
            if staged[0] == self._block_meta(page):
                self._staged_used += 1
                return staged[1:]
            self._staged_rebuilt += 1
        _, block, counts = self._build_block(page)
        return block, counts, None

    def _stage_next(self, pages: list) -> None:
        """Double buffer: build and upload tick t+1's blocks while tick t's
        dispatches compute. `_stage_block` checks each against the live
        meta, so a wrong guess costs one rebuild, never a changed
        result."""
        for page in pages:
            if self._uploads is None:
                meta, block, counts = self._build_block(page, at_next=True)
                if meta is not None:
                    self._staged[page] = (meta, block, counts, None)
                continue
            up = self._uploads[page][self._upload_turn[page]]
            up.copied.synchronize()       # no copy still reads the host block
            up.read.synchronize()         # no dispatch still reads the device one
            meta, _, _ = self._build_block(
                page, at_next=True, out=(up.host.numpy(),
                                         up.host_counts.numpy()))
            if meta is None:
                continue
            self._upload_turn[page] ^= 1
            with torch.cuda.stream(self._upload_stream):
                up.block.copy_(up.host, non_blocking=True)
                up.counts.copy_(up.host_counts, non_blocking=True)
                up.copied.record()
            self._staged[page] = (meta, up.block, up.counts, up)

    # -- engine tick ---------------------------------------------------------
    def _dispatch_page(self, page: int):
        """Dispatch one page's megastep on its staged or freshly built
        block: through its compiled `graphed.PageMegastep` (the state
        advances in place), or eagerly through `pipeline.stream_megastep`.
        Returns its `MegastepOut`."""
        block, counts, up = self._stage_block(page)
        if up is not None:                # wait for the staged upload
            up.copied.wait(torch.cuda.current_stream(self.device))
        state = self.states[page]
        if self._dispatch is not None:
            out = self._dispatch[page](block, counts)
            self.states[page] = state._replace(t=state.t + self.K)
        else:
            with torch.no_grad():
                self.states[page], out = pipeline.stream_megastep(
                    self.program, state, block, self.backend, active=counts,
                    emit_rasters=self.track_events, mesh=self.mesh,
                    **self.step_kw)
        if up is not None:
            up.read.record(torch.cuda.current_stream(self.device))
        return out

    def step(self) -> int:
        """One engine tick: admit, then one K-frame megastep per occupied
        page (then, with the double buffer, the next tick's blocks are
        staged). Returns the number of active slots after evictions."""
        self._admit()
        by_page = self.active_by_page()
        if not by_page:
            if not self.queue.empty():
                # only future arrivals remain: idle ticks still advance the
                # frame clock so arrival schedules are reached
                self.clock += self.K
            return 0
        outs = {page: self._dispatch_page(page) for page in sorted(by_page)}
        if self.double_buffer:
            self._stage_next(sorted(by_page))
        self.ticks += 1
        self.dispatches += len(by_page)
        self.clock += self.K
        for page in sorted(by_page):
            self._retire_page(page, by_page[page], outs[page])
        return sum(1 for s in self.slots if s.req is not None)

    def _retire_page(self, page: int, lanes: list, out) -> None:
        """Account one page's megastep and finalize the requests that
        finished inside it, from the block's per-tick readout trajectory at
        the tick a K=1 drain would have stopped on."""
        logits = out.logits_traj.cpu().numpy()       # (K, B, n_out)
        v_traj = out.v_out_traj.cpu().numpy()
        consumed = out.frames_consumed.cpu().numpy()
        served, fins = [], []
        for i in lanes:
            slot = self.slots[i]
            req = slot.req
            lane = i % self.B
            n = int(consumed[lane])
            fin = None
            for t in range(n):
                if (req.stop_threshold is not None
                        and float(np.max(np.abs(logits[t, lane])))
                        >= req.stop_threshold):
                    fin = t                        # confident readout: stop
                    break
                if slot.cursor + t + 1 >= self._tick_budget(req):
                    fin = t                        # budget exhausted
                    break
            credit = n if fin is None else fin + 1
            served.append((i, lane, credit))
            slot.cursor += credit
            slot.ticks += credit
            if fin is not None:
                fins.append((i, lane, fin))
        if self.track_events and out.rasters is not None:
            self._account(out.rasters, served)
        if self._event_backend and out.skips is not None:
            self._account_device(out)
        for i, lane, fin in fins:
            slot = self.slots[i]
            req = slot.req
            req.logits = logits[fin, lane].copy()
            req.v_out = v_traj[fin, lane].copy()
            req.ticks = slot.ticks
            req.finish_clock = self.clock - self.K + fin + 1
            if self.track_events:
                req.report = self._finalize_report(slot)
            self.finished.append(req)
            # idle lanes are silent: re-seed the vacated lane with zero
            # state so deeper layers cannot keep leaking or firing
            self._reseed(page, lane)
            self.slots[i] = _Slot()

    # -- workload accounting -------------------------------------------------
    def aggregate_report(self) -> SparsityReport:
        """Pooled SparsityReport over every finished request. Raises
        `ReportUnavailable` when event tracking is off or nothing has
        finished."""
        if not self.track_events:
            raise ReportUnavailable(
                "event tracking is disabled (track_events=False); build the "
                "engine with track_events=True for accounting")
        reps = [r.report for r in self.finished if r.report is not None]
        if not reps:
            raise ReportUnavailable(
                "no finished requests yet: the aggregate report pools "
                "per-request reports, which exist once a request finishes")
        return merge_reports(reps)
