"""Train state and the train step builder (microbatching, gradient
clipping, optional int8 gradient compression), on one device or sharded
over a mesh (DTensor parameters, `dist.sharding`)."""
from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import resolve_device
from repro_torch.configs.base import RunConfig
from repro_torch.models import lm
from repro_torch.optim import (apply_updates, clip_by_global_norm,
                               make_optimizer)
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor          # 0-d int32


def init_train_state(seed: int, run: RunConfig, total_steps: int = 10_000,
                     dtype=torch.bfloat16, device=None
                     ) -> tuple[TrainState, Any]:
    """A language model's train state and its optimizer: `lm.init_params`
    from ``seed`` in ``dtype`` on ``device`` (the CUDA device unless
    given), ``run.optimizer`` at ``run.learning_rate`` with a cosine
    warm-up over ``run.warmup_steps`` to ``total_steps``, and step 0. An
    SNN's state is built from its parameters with
    ``TrainState(params, opt.init(params), step)``."""
    device = resolve_device(device)
    params = lm.init_params(seed, run.model, dtype=dtype, device=device)
    opt = _make_opt(run, total_steps)
    return (TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device)),
            opt)


def _make_opt(run: RunConfig, total_steps: int):
    lr = cosine_warmup(run.learning_rate, run.warmup_steps, total_steps)
    return make_optimizer(run.optimizer, lr, run.weight_decay)


def make_train_step(run: RunConfig, opt, loss_fn: Callable | None = None,
                    max_grad_norm: float = 1.0) -> Callable:
    """train_step(state, batch) -> (new state, metrics). ``loss_fn(params,
    batch)`` returns (loss, aux). The gradient is taken with
    `torch.autograd.grad`, a leaf the loss does not use getting zeros (as
    JAX returns them). With ``run.parallel.microbatches`` = m > 1 the
    batch splits on its leading axis and the f32 gradients (and the loss)
    accumulate as sums of the m parts over m. Then `fake_compress` when
    ``run.parallel.grad_compress`` is set, the global-norm clip at
    ``max_grad_norm``, ``opt.update`` and `apply_updates`. The step builds
    new parameter tensors and changes none in place, so a restored state
    and a live one step alike. metrics: ``loss``, ``grad_norm`` and
    ``step``, as detached tensors.

    ``loss_fn`` None means the language-model loss, `lm.loss_fn` of
    ``run.model`` under ``run.parallel``.

    Sharded: the same step runs on DTensor parameters (placed by
    `dist.sharding.param_specs` with `place_tree`) and a batch placed by
    `batch_specs`, called inside `dist.sharding.activation_rules(mesh,
    run.parallel)` so the model's `constrain` sites pin activations. The
    whole step then runs under torch's ``implicit_replication``, entered
    here, so the plain tensors made inside the model and the optimizer
    (RoPE tables, positions, masks, the aux accumulators, the step count
    and learning rate) act as replicated. Each gradient is redistributed
    to its parameter's placements, the optimizer state (``opt.init`` of
    DTensors) follows them, the global-norm clip reduces across ranks,
    and ``loss`` and ``grad_norm`` come back as full values on every
    rank."""
    parallel = run.parallel
    if loss_fn is None:
        cfg = run.model

        def loss_fn(p, b):
            return lm.loss_fn(p, b, cfg, parallel)

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, aux = loss_fn(tree_unflatten_like(params, leaves), batch)
        if isinstance(loss, DTensor):
            loss = loss.redistribute(placements=[Replicate()]
                                     * loss.device_mesh.ndim)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else _like(g, p)
                 for p, g in zip(leaves, grads)]
        return loss.detach(), aux, tree_unflatten_like(params, grads)

    def train_step(state: TrainState, batch: dict):
        sharded = any(isinstance(p, DTensor)
                      for p in tree_leaves(state.params))
        with _replicating(sharded):
            new, metrics = step(state, batch)
        if sharded:
            metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}
        return new, metrics

    def step(state: TrainState, batch: dict):
        mb = parallel.microbatches
        if mb > 1:
            def part(x, i):
                n = x.shape[0] // mb
                return x.reshape((mb, n) + tuple(x.shape[1:]))[i]
            loss = torch.zeros((), device=state.step.device)
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params)
            for i in range(mb):
                m_loss, _, m_grads = grads_of(
                    state.params, tree_map(lambda x: part(x, i), batch))
                grads = tree_map(lambda a, g: a + g.to(torch.float32) / mb,
                                 grads, m_grads)
                loss = loss + m_loss / mb
        else:
            loss, _aux, grads = grads_of(state.params, batch)

        with torch.no_grad():
            if parallel.grad_compress:
                from repro_torch.dist.compress import fake_compress
                grads = fake_compress(grads)
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            params = apply_updates(state.params, updates)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": state.step + 1}
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


def _like(g, p):
    """A gradient with its parameter's placements (itself when plain)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _replicating(sharded: bool):
    """``implicit_replication()`` for a sharded step, else nothing."""
    if not sharded:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()
