"""Compiled train steps: the counterpart of the JAX package's
``jax.jit(make_train_step(...), donate_argnums=(0,))``. Forward, backward
(with `torch.utils.checkpoint`'s recomputation), the gradient clip, the
optional int8 ``fake_compress`` and the optimizer update are captured as
one CUDA graph (`serve.graphed.Graphed` with autograd on) and replayed
each step.

A graph replays its kernels on the addresses it captured, so the step
runs on static tensors:

  * the state -- the `TrainState` leaves (parameters, the optimizer state
    with its step, the step) are buffers of the compiled step; the captured
    body runs the functional ``train_step`` on them and copies the new
    leaves back in, the counterpart of donation. The returned state *is*
    the buffers. A state whose leaves are not the buffers (the first call,
    a checkpoint restored by `train_loop`) is copied into them first. As
    with JAX's donation, a state handed to the compiled step is consumed:
    the next call overwrites it;
  * the batch -- copied into buffers of its own, one graph per batch
    signature (keys, shapes and dtypes), as ``jax.jit`` traces once per
    shape;
  * the metrics -- ``loss``, ``grad_norm`` and ``step`` are the capture's
    outputs, overwritten by the next replay; `train_loop` reads them
    before it.

On the CPU the body runs each call with the same static-buffer plumbing.
On CUDA a capture or replay error raises; there is no eager fallback.
Nothing in the body may read device data on the host (``.item()``,
``float(t)``, a branch on a tensor) or copy host data to the device.

A sharded (DTensor) state is refused: its collectives run on gloo, which
a graph cannot record, and graphs over NCCL ranks need several cards.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.serve.graphed import Graphed
from repro_torch.train.train_state import TrainState
from repro_torch.tree import tree_leaves, tree_map


class CompiledTrainStep:
    """``train_step`` (a `make_train_step` step: ``(state, batch) ->
    (state, metrics)``) compiled for ``device``; called with the eager
    step's signature. ``state`` holds the buffers once a step has run,
    ``graphs`` one (batch buffers, `Graphed`) pair per batch signature."""

    def __init__(self, train_step: Callable, device):
        self.train_step = train_step
        self.device = torch.device(device)
        self.state = None
        self.graphs: dict = {}

    def __call__(self, state: TrainState, batch: dict):
        if any(isinstance(x, DTensor) for x in tree_leaves(state)):
            raise ValueError(
                "compile_train_step: a sharded (DTensor) train state cannot "
                "be captured; run the sharded step eagerly")
        self._load(state)
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        key = tuple(sorted((k, tuple(v.shape), v.dtype)
                           for k, v in batch.items()))
        if key not in self.graphs:
            buffers = {k: torch.empty(v.shape, dtype=v.dtype,
                                      device=self.device)
                       for k, v in batch.items()}
            _copy_batch(buffers, batch)     # the warm-up reads real data
            # the warm-up advances the buffers; a state handed in that is
            # not them still holds the step's input, so only a state that
            # is them is copied aside to be put back
            mine = tree_leaves(self.state)
            source = (_clone(self.state) if any(
                a is b for a, b in zip(tree_leaves(state), mine))
                else state)
            self.graphs[key] = (buffers, Graphed(
                lambda: self._body(buffers), self.device, autograd=True))
            self._load(source)
        buffers, run = self.graphs[key]
        _copy_batch(buffers, batch)
        return self.state, run()

    def _load(self, state: TrainState) -> None:
        """Make ``state`` the buffers' contents (the first call allocates
        them)."""
        if self.state is None:
            self.state = tree_map(
                lambda x: torch.empty(x.shape, dtype=x.dtype,
                                      device=self.device), state)
        mine, theirs = tree_leaves(self.state), tree_leaves(state)
        if len(mine) != len(theirs):
            raise ValueError(f"compile_train_step: a state of {len(theirs)} "
                             f"leaves for buffers of {len(mine)}")
        for dst, src in zip(mine, theirs):
            if src is dst:
                continue
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"compile_train_step: a state leaf {tuple(src.shape)} "
                    f"{src.dtype} for a buffer {tuple(dst.shape)} "
                    f"{dst.dtype}")
            dst.copy_(src)

    def _body(self, batch: dict) -> dict:
        new, metrics = self.train_step(self.state, batch)
        for dst, src in zip(tree_leaves(self.state), tree_leaves(new)):
            dst.copy_(src)
        return metrics


def _clone(tree):
    return tree_map(lambda x: x.clone(), tree)


def _copy_batch(buffers: dict, batch: dict) -> None:
    for k, v in batch.items():
        buffers[k].copy_(v)


def compile_train_step(train_step: Callable, device) -> CompiledTrainStep:
    """``train_step`` as one CUDA graph per batch signature on ``device``
    (on the CPU: the same static-buffer plumbing, run eagerly); see the
    module docstring for what the returned callable consumes and
    returns."""
    return CompiledTrainStep(train_step, device)
