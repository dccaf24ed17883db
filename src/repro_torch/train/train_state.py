"""Train state and the train step builder (microbatching, gradient
clipping, optional int8 gradient compression)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.optim import apply_updates, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor          # 0-d int32


def init_train_state(*args, **kwargs):
    """The language-model train state needs `models.lm.init_params` and
    `lm.loss_fn` for a trainable family; the port serves RWKV only, so
    this raises `NotImplementedError`. Build an SNN's state from its
    parameters with `TrainState(params, opt.init(params), step)`."""
    raise NotImplementedError(
        "init_train_state builds a language model's train state, which "
        "needs lm.loss_fn; the port has no LM training yet")


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

    ``loss_fn`` None means the language-model loss, which the port does not
    have yet (raises `NotImplementedError`)."""
    if loss_fn is None:
        raise NotImplementedError(
            "make_train_step needs loss_fn: the default, lm.loss_fn (the "
            "language-model loss), is not part of the port yet")
    parallel = run.parallel

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, aux = loss_fn(tree_unflatten_like(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), aux, tree_unflatten_like(params, grads)

    def train_step(state: TrainState, batch: dict):
        mb = parallel.microbatches
        if mb > 1:
            def part(x, i):
                n = x.shape[0] // mb
                return x.reshape((mb, n) + tuple(x.shape[1:]))[i]
            loss = torch.zeros((), device=state.step.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
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
