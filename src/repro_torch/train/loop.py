"""Fault-tolerant training loop.

  * checkpoint/restart -- an asynchronous `CheckpointManager` save every
    ``ckpt_every`` steps; at start the latest step is restored and the
    deterministic data stream fast-forwarded (loader batches are pure
    functions of the step);
  * preemption -- SIGTERM sets a flag; the loop finishes the current step,
    writes a final blocking checkpoint and exits cleanly;
  * straggler watchdog -- per-step wall time is tracked; steps slower than
    ``straggler_factor`` x the running median of the last 50 are counted.

Each step ends in ``float(loss)``, which waits for the device, so the step
time covers the device work.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.train.train_state import TrainState


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    straggler_factor: float = 3.0
    keep_ckpts: int = 3


@dataclass
class LoopResult:
    state: Any
    metrics_history: list = field(default_factory=list)
    straggler_steps: int = 0
    resumed_from: Optional[int] = None
    preempted: bool = False


class PreemptionGuard:
    """SIGTERM -> graceful checkpoint-and-exit."""

    def __init__(self):
        self.requested = False
        self._prev = None

    def install(self):
        def handler(signum, frame):
            self.requested = True
        try:
            self._prev = signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass                                # not the main thread
        return self

    def uninstall(self):
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)


def train_loop(train_step: Callable, state: TrainState, loader,
               loop_cfg: LoopConfig, *, device_put_fn: Callable = None,
               on_metrics: Callable = None) -> LoopResult:
    """Run ``train_step`` over ``loader``'s (step, batch) pairs up to
    ``loop_cfg.total_steps``, with auto-resume from ``loop_cfg.ckpt_dir``
    (``resumed_from``), periodic and final checkpoints, the SIGTERM guard
    and the straggler count. ``device_put_fn`` moves a batch to the device;
    ``on_metrics`` gets each logged metrics dict (floats, plus
    ``sec_per_step``). The loader is closed at the end."""
    result = LoopResult(state=state)
    ckpt = (CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep_ckpts)
            if loop_cfg.ckpt_dir else None)

    if ckpt is not None and ckpt.latest_step() is not None:
        step, state = ckpt.restore(like=state)
        result.resumed_from = step
        result.state = state

    guard = PreemptionGuard().install()
    times: list[float] = []
    try:
        for step_idx, batch in loader:
            if int(state.step) > step_idx:
                continue                        # fast-forward after resume
            if step_idx >= loop_cfg.total_steps:
                break
            if device_put_fn is not None:
                batch = device_put_fn(batch)
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            float(metrics["loss"])              # wait for the device
            dt = time.perf_counter() - t0
            if len(times) >= 5:
                med = float(np.median(times[-50:]))
                if dt > loop_cfg.straggler_factor * med:
                    result.straggler_steps += 1
            times.append(dt)
            if (step_idx + 1) % loop_cfg.log_every == 0 or step_idx == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["sec_per_step"] = dt
                result.metrics_history.append(m)
                if on_metrics:
                    on_metrics(m)
            if ckpt is not None and (step_idx + 1) % loop_cfg.ckpt_every == 0:
                ckpt.save(int(state.step), state)
            if guard.requested:
                result.preempted = True
                break
        if ckpt is not None:
            ckpt.save(int(state.step), state, blocking=True)
    finally:
        guard.uninstall()
        if hasattr(loader, "close"):
            loader.close()
    result.state = state
    return result
