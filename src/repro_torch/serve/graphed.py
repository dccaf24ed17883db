"""Compiled dispatch for the serving engines: a call captured once as a CUDA
graph and replayed, the counterpart of the JAX package's ``jax.jit`` of the
page megastep (`serve/snn_engine.py::_jit_megastep` there), of the decode
tick and of each prompt-length bucket's prefill.

A graph replays the kernels its capture recorded on the same addresses, so
every tensor it reads or writes is static: the caller copies its inputs
into the call's own buffers before a replay, and the captured body writes
its carried state back into the state tensors in place. No Python runs
during a replay, so nothing in a captured body may read device data on the
host (no ``.item()``, no ``.cpu()``, no branch on a tensor).

`Graphed` captures a body on a CUDA device and runs it eagerly on the CPU,
where the same static-buffer plumbing runs without a graph (the CPU tests
hold it against the eager dispatch). There is no fallback: on CUDA a
capture or replay error raises.

Launch counts (`repro_torch.kernels.LAUNCH_COUNTS`): a kernel wrapper counts
on the host when it launches, which a replay never runs. So the warm-up and
the capture count nothing, and each replay adds the launches its capture
recorded: a drain counts what the eager drain counts.
"""
from __future__ import annotations

import gc
from typing import Callable, Optional

import torch

from repro_torch import kernels
from repro_torch.core import pipeline
from repro_torch.core.pipeline import MegastepOut, SNNProgram, StreamState

# the backends whose page megastep runs as a graph; ``float`` and the host
# event executor ``ref_events`` stay eager, as JAX leaves them unjitted
GRAPHED_BACKENDS = ("int_ref", "cuda", "cuda_sparse", "cuda_events")

_CAPTURE_STREAMS: dict = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per device for every warm-up and capture (a new
    stream per graph would leave a cuBLAS workspace behind each)."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


class Graphed:
    """``body()`` compiled for ``device``. On CUDA: one eager warm-up run
    on a side stream (kernel builds, plans and library handles happen
    here), after which the tensors of ``keep`` get back the values they
    had, then one capture with Python's automatic garbage collection held
    off; each call replays the graph and returns the capture's outputs,
    which the next replay overwrites. On the CPU each call runs
    ``body()``. ``body`` must take its inputs from static tensors
    and write its results into static tensors or return them.

    ``body`` runs with autograd off unless ``autograd`` is set (a train
    step: forward, backward and the optimizer in one graph). Then the
    warm-up's freed memory (its activations, gradients and new state) is
    handed back to the device before the capture, since the graph's
    private memory pool cannot reuse the blocks cached for it."""

    def __init__(self, body: Callable, device: torch.device,
                 keep: tuple = (), autograd: bool = False):
        self.body = body
        self.autograd = autograd
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: dict = {}
        if device.type != "cuda":
            return
        counts = dict(kernels.LAUNCH_COUNTS)
        saved = [t.clone() for t in keep]
        side = _capture_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side), torch.set_grad_enabled(autograd):
            body()
            for t, s in zip(keep, saved):
                t.copy_(s)
            saved = s = None
            if autograd:
                side.synchronize()
                torch.cuda.empty_cache()
            before = dict(kernels.LAUNCH_COUNTS)
            # no automatic collection while capturing: one that frees
            # another graph held in a reference cycle destroys it
            # mid-capture, which invalidates this capture
            collecting = gc.isenabled()
            gc.disable()
            try:
                graph.capture_begin()
                try:
                    self.out = body()
                finally:
                    graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
        torch.cuda.current_stream(device).wait_stream(side)
        self.launches = {k: n - before[k]
                         for k, n in kernels.LAUNCH_COUNTS.items()
                         if n != before[k]}
        kernels.LAUNCH_COUNTS.update(counts)
        self.graph = graph

    def __call__(self):
        if self.graph is None:
            with torch.set_grad_enabled(self.autograd):
                return self.body()
        self.graph.replay()
        for name, n in self.launches.items():
            kernels.LAUNCH_COUNTS[name] += n
        return self.out


class StaticPrefill:
    """One prompt-length bucket's prefill as a static-buffer dispatch: a
    (1, bucket) int64 token buffer and a (1,) int64 length buffer, and
    ``fn(tokens, length) -> (logits, cache)`` over them, captured once
    (one CUDA graph per bucket; on the CPU the body runs each call). The
    outputs live in the graph's memory until its next replay."""

    def __init__(self, fn: Callable, bucket: int, device: torch.device):
        self.tokens = torch.zeros((1, bucket), dtype=torch.int64,
                                  device=device)
        self.length = torch.ones((1,), dtype=torch.int64, device=device)
        self._run = Graphed(lambda: fn(self.tokens, self.length), device)

    def __call__(self, tokens, length: int):
        """Copy ``tokens`` (1, bucket), right-padded, and the true
        ``length`` into the buffers and run the prefill."""
        self.tokens.copy_(torch.as_tensor(tokens))
        self.length.fill_(length)
        return self._run()


class PageMegastep:
    """One engine page's K-frame megastep as a static-buffer dispatch: a
    (K, B, *in_shape) f32 block and a (B,) int32 active-count buffer of its
    own, and the page's `StreamState.vs` tensors, which the body reads and
    writes back in place (admission and eviction write the same tensors
    through `engine.lane_scatter`). On CUDA it is one graph per page, so
    the outputs of one page survive the dispatch of the next. The
    ``cuda_events`` counters come back unfolded, as
    `ops.DeviceEventCounts`; the caller folds them after the replay.

    With ``mesh`` the body is `pipeline.stream_megastep(mesh=)`: the
    buffers hold the page's ``batch`` global lanes and ``state`` is the
    rank's shard; the caller captures only a mesh whose collectives a
    graph can record (`launch.mesh.SNNMesh.capturable`)."""

    def __init__(self, program: SNNProgram, state: StreamState, backend: str,
                 megastep: int, *, emit_rasters: bool, step_kw: dict,
                 batch: Optional[int] = None, mesh=None):
        if backend not in GRAPHED_BACKENDS:
            raise ValueError(f"backend {backend!r} has no compiled megastep; "
                             f"have {GRAPHED_BACKENDS}")
        dev = program.device
        self.vs = state.vs
        if batch is None:
            batch = int(state.vs[0].shape[0])
        self.frames = torch.zeros((megastep, batch, *program.in_shape),
                                  dtype=torch.float32, device=dev)
        self.active = torch.zeros((batch,), dtype=torch.int32, device=dev)

        def body() -> MegastepOut:
            st, out = pipeline.stream_megastep(
                program, StreamState(vs=self.vs), self.frames, backend,
                active=self.active, emit_rasters=emit_rasters,
                fold_events=False, mesh=mesh, **step_kw)
            for dst, src in zip(self.vs, st.vs):
                dst.copy_(src)
            return out

        self._run = Graphed(body, dev, keep=self.vs)

    def __call__(self, frames, active) -> MegastepOut:
        """Copy ``frames`` (K, B, *in_shape) and ``active`` (B,) (numpy or
        tensors, host or device) into the static buffers and run the
        megastep; the page's state advances in place."""
        self.frames.copy_(torch.as_tensor(frames))
        self.active.copy_(torch.as_tensor(active))
        return self._run()
