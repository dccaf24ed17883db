"""Optimizers from scratch, with the JAX package's math: SGD with momentum,
Adam, AdamW (decoupled decay on tensors of two or more dimensions only,
applied with the step, b2 = 0.95 by default) and Adafactor (factored second
moment). `torch.optim` is not a counterpart: its AdamW decays every tensor
it is given, before the step.

    opt = make_optimizer("adamw", lr=..., weight_decay=...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Parameters, gradients and states are trees of tensors (`repro_torch.tree`);
``update`` builds new tensors and changes none in place. The state's step
is a 0-d int32 tensor on the parameters' device.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]   # (grads, state, params) -> (updates, state)


def apply_updates(params, updates):
    """``params + updates`` leaf by leaf, in each parameter's dtype."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of all leaves together, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(``grads`` scaled so their global norm is at most ``max_norm``, the
    norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else None)


def _lr_at(lr, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


# ---------------------------------------------------------------------------

def sgd(lr: float | Callable, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params),
                "step": _step0(params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        mu = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                      state["mu"], grads)
        updates = tree_map(lambda m: -lr_t * m, mu)
        return updates, {"mu": mu, "step": step}

    return Optimizer(init, update)


def _adam_core(lr, b1, b2, eps, weight_decay) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "step": _step0(params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2)
                     * torch.square(g.to(torch.float32)), state["v"], grads)
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)

        def upd(m_, v_, p=None):
            u = -lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay and p is not None and p.dim() >= 2:
                u = u - lr_t * weight_decay * p.to(torch.float32)
            return u

        if params is None:
            updates = tree_map(upd, m, v)
        else:
            updates = tree_map(upd, m, v, params)
        return updates, {"m": m, "v": v, "step": step}

    return Optimizer(init, update)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay=0.0)


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay=weight_decay)


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moment: a (..., r, c) tensor keeps row and column
    statistics (r + c floats instead of r * c) over its last two axes;
    smaller tensors keep a full accumulator."""

    def init(params):
        def z(p):
            if p.dim() >= 2:
                return {"row": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                           device=p.device),
                        "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                           dtype=torch.float32,
                                           device=p.device)}
            return {"full": torch.zeros_like(p, dtype=torch.float32)}
        return {"v": tree_map(z, params), "step": _step0(params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        beta = 1.0 - step.to(torch.float32) ** (-decay)

        def upd(g, v):
            gf = g.to(torch.float32)
            g2 = torch.square(gf) + eps
            if "full" in v:
                v_new = {"full": beta * v["full"] + (1 - beta) * g2}
                u = gf * torch.rsqrt(v_new["full"] + eps)
            else:
                row = beta * v["row"] + (1 - beta) * torch.mean(g2, dim=-1)
                col = beta * v["col"] + (1 - beta) * torch.mean(g2, dim=-2)
                v_new = {"row": row, "col": col}
                r_factor = torch.rsqrt(
                    row / torch.clamp(torch.mean(row, dim=-1, keepdim=True),
                                      min=eps) + eps)
                c_factor = torch.rsqrt(col + eps)
                u = gf * r_factor[..., None] * c_factor[..., None, :]
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return -lr_t * u, v_new

        out = tree_map(upd, grads, state["v"])
        updates = tree_map(lambda _, o: o[0], grads, out)
        v_state = tree_map(lambda _, o: o[1], grads, out)
        return updates, {"v": v_state, "step": step}

    return Optimizer(init, update)


def make_optimizer(name: str, lr, weight_decay: float = 0.1) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "adam":
        return adam(lr)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay)
    if name == "adafactor":
        return adafactor(lr)
    raise ValueError(f"unknown optimizer {name!r}")
