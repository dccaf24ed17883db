"""RWKV6 (Finch) blocks — attention-free, data-dependent decay.

The wkv state is the LM-scale analogue of the IMPULSE membrane potential
(decay == learned leak). Prefill runs the recurrence through
`kernels.wkv6.ops.wkv6`: the hand-written CUDA kernel on the card, its plain
version on the CPU. Training runs it through the same wrapper's
differentiable chunked form (``use_kernel=False``), the jnp form the JAX
package trains through. Decode runs the one-step update as plain tensor
code.

Block = time-mix (ddlerp token shift -> r, k, v, g, w -> wkv6 ->
groupnorm * silu(g) -> out proj) + channel-mix (token shift -> relu^2 FFN
with receptance gate).

Types follow the JAX package's promotion, written out where torch differs:
the prefill output path is float32 (the float32 wkv output, its group norm,
times the bf16 gate, then the out projection with bf16 weights promoted to
float32), while the decode path casts the wkv output back to the
activations' type first, so its group norm, gate and out projection run in
that type. Group norm uses the population variance, as ``jnp.var`` does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (constrain, contracted_as, head_local,
                                      split_heads)
from repro_torch.kernels.wkv6.ops import wkv6, wkv6_decode_step
from repro_torch.models.layers import dense_init, gen_device, normal

LORA_R = 32
N_MIX = 5  # r, k, v, g, w


def init_rwkv_block(gen: torch.Generator, cfg: ModelConfig,
                    dtype: torch.dtype = torch.bfloat16) -> dict:
    """One block's parameters, drawn from ``gen`` on its device (``meta``
    tensors for a ``gen`` of None)."""
    d, ff = cfg.d_model, cfg.d_ff
    H, K = cfg.n_heads, cfg.rwkv.head_size
    dev = gen_device(gen)

    def const(fill, shape, dt=dtype):
        return torch.full(shape, fill, dtype=dt, device=dev)

    decay_base = (-np.linspace(0.0, 3.0, d)).astype(np.float32)  # w0, as JAX
    return {
        "tm": {  # time mix
            "mu": const(0.0, (N_MIX, d)),
            "ddlerp_w1": dense_init(gen, (d, N_MIX * LORA_R), dtype=dtype),
            "ddlerp_w2": dense_init(gen, (N_MIX, LORA_R, d), dtype=dtype),
            "decay_base": torch.from_numpy(decay_base).to(dev),  # w0 (fp32)
            "decay_w1": dense_init(gen, (d, LORA_R * 2), dtype=dtype),
            "decay_w2": dense_init(gen, (LORA_R * 2, d), dtype=dtype),
            "bonus": normal(gen, (H, K)) * 0.3,
            "wr": dense_init(gen, (d, d), dtype=dtype),
            "wk": dense_init(gen, (d, d), dtype=dtype),
            "wv": dense_init(gen, (d, d), dtype=dtype),
            "wg": dense_init(gen, (d, d), dtype=dtype),
            "wo": dense_init(gen, (d, d), dtype=dtype),
            "gn_scale": const(1.0, (d,)),
        },
        "cm": {  # channel mix
            "mu_k": const(0.0, (d,)),
            "mu_r": const(0.0, (d,)),
            "wk": dense_init(gen, (d, ff), dtype=dtype),
            "wv": dense_init(gen, (ff, d), dtype=dtype),
            "wr": dense_init(gen, (d, d), dtype=dtype),
        },
    }


def _whole(v: torch.Tensor) -> torch.Tensor:
    """A mixing parameter whole on every rank under a mesh: its ``d``,
    which the parameter rule puts on model, gathered (8 KB a vector at
    d = 4,096). A mix of a (batch, ...)-placed activation then keeps its
    contraction axis whole, and each data rank's next product runs on its
    own rows (DTensor otherwise computes it over partial sums and
    reduce-scatters them). The identity without active rules."""
    return constrain(v, (None,) * v.dim())


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor],
                 whole: bool = True) -> torch.Tensor:
    """x: (B, T, d) -> previous-token tensor; `last` is the carry from the
    preceding segment ((B, d)) or None for zeros. ``whole``: under a mesh
    the carry's ``d``, which the cache's rule puts on model, is gathered
    first, for the reason `_whole` gives."""
    if last is not None and whole:
        last = constrain(last, ("batch", None))
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([first.to(x.dtype), x[:, :-1]], dim=1)


def _carry(x: torch.Tensor) -> torch.Tensor:
    """The last token of (B, T, d) ``x``, the next segment's token-shift
    carry, as a copy: a view would keep all of ``x`` alive in the cache
    until the stack is restacked (two (B, T, d) tensors a layer in a
    prefill)."""
    return x[:, -1].clone()


def _group_norm(y: torch.Tensor, scale: torch.Tensor, n_heads: int,
                eps: float = 1e-5) -> torch.Tensor:
    B, T, d = y.shape
    yh = split_heads(y, d // n_heads).float()
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return (yh.reshape(B, T, d) * scale).to(y.dtype)


def _mix_inputs(x: torch.Tensor, xx: torch.Tensor, p: dict,
                whole: bool = True) -> tuple:
    """ddlerp: the five token-shift mixes (r, k, v, g, w) of (B, T, d) x;
    ``whole``: ``mu`` and the LoRA's ``ddlerp_w2`` are `_whole` under a
    mesh."""
    mu, w2 = p["mu"], p["ddlerp_w2"]
    if whole:
        mu, w2 = _whole(mu), _whole(w2)
    base = x + xx * mu[0]
    a = split_heads(torch.tanh(base @ p["ddlerp_w1"]), LORA_R)
    mix = torch.einsum("btnr,nrd->btnd", a, w2) + mu[None, None]
    xs = x[:, :, None, :] + xx[:, :, None, :] * mix           # (B, T, 5, d)
    return xs.unbind(2)


def _decay(xw: torch.Tensor, p: dict, whole: bool = True) -> torch.Tensor:
    """Data-dependent decay in (0, 1), float32. ``whole``: under a mesh the
    LoRA's (B, T, 64) hidden is gathered over model before its
    up-projection, so the decay comes out on each rank's own channels with
    no partial sums to reduce (the identity without active rules)."""
    h = torch.tanh(xw @ p["decay_w1"])
    if whole:
        h = constrain(h, ("batch", None, None))
    dlora = h @ p["decay_w2"]
    return torch.exp(-torch.exp(torch.clamp(p["decay_base"] + dlora.float(),
                                            -8.0, 1.0)))


def time_mix(x: torch.Tensor, p: dict, cfg: ModelConfig,
             state: Optional[dict] = None, *, use_kernel: bool = True,
             chunk: int = 64):
    """x: (B, T, d). state: {"shift": (B, d), "wkv": (B, H, K, K)} or None.
    ``use_kernel`` and ``chunk`` choose the wkv6 route (`ops.wkv6`): the
    kernel, or the differentiable chunked form in chunks of ``chunk``.
    Returns (out (B, T, d) float32, new_state)."""
    B, T, d = x.shape
    H, K = cfg.n_heads, cfg.rwkv.head_size
    prev = _token_shift(x, None if state is None else state["shift"])
    xr, xk, xv, xg, xw = _mix_inputs(x, prev - x, p)
    r = split_heads(xr @ p["wr"], K)
    k = split_heads(xk @ p["wk"], K)
    v = split_heads(xv @ p["wv"], K)
    g = F.silu(xg @ p["wg"])
    w = split_heads(_decay(xw, p), K)

    def recurrence(r, k, v, w, u, s0):
        return wkv6(r, k, v, w, u, s0=s0, use_kernel=use_kernel, chunk=chunk)
    # under a mesh each model rank runs the recurrence on its own heads
    # (B_local x H_local rows), as the projections left them
    th, sh = ("batch", None, "heads", None), ("batch", "heads", None, None)
    y, s_new = head_local(
        recurrence, (r, k, v, w, p["bonus"],
                     None if state is None else state["wkv"]),
        (th, th, th, th, ("heads", None), sh), (th, sh))
    y = y.reshape(B, T, d)
    y = _group_norm(y, p["gn_scale"], H) * g
    out = y @ contracted_as(p["wo"], y).float()
    return out, {"shift": _carry(x), "wkv": s_new}


def time_mix_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
                    state: dict):
    """Single-token decode. x: (B, 1, d). Mirrors time_mix with T == 1 via
    the O(1) wkv state update (the fused-membrane serving path)."""
    B, _, d = x.shape
    H, K = cfg.n_heads, cfg.rwkv.head_size
    prev = state["shift"][:, None].to(x.dtype)
    xr, xk, xv, xg, xw = (m[:, 0] for m in _mix_inputs(x, prev - x, p,
                                                       whole=False))
    r = split_heads(xr @ p["wr"], K)
    k = split_heads(xk @ p["wk"], K)
    v = split_heads(xv @ p["wv"], K)
    g = F.silu(xg @ p["wg"])
    w = split_heads(_decay(xw, p, whole=False), K)
    # the step's products flatten (lanes, heads) into one batch axis, which
    # DTensor cannot do with both sharded: gather the heads (the identity
    # without active rules)
    r, k, v, w = (constrain(t, ("batch", None, None)) for t in (r, k, v, w))
    y, s_new = wkv6_decode_step(r.float(), k.float(), v.float(), w,
                                p["bonus"], constrain(state["wkv"],
                                                      ("batch", None, None,
                                                       None)))
    y = y.reshape(B, 1, d).to(x.dtype)
    out = (_group_norm(y, p["gn_scale"], H) * g[:, None]) @ p["wo"]
    return out, {"shift": x[:, -1], "wkv": s_new}


def channel_mix(x: torch.Tensor, p: dict,
                state: Optional[torch.Tensor] = None, *,
                decode: bool = False):
    """ReLU^2 channel mix with receptance gate. state: (B, d) last token.
    Under a mesh the carry and the mixing vectors are `_whole`, except in
    ``decode`` (the one-token step keeps DTensor's placement, as
    `time_mix_decode` does)."""
    prev = _token_shift(x, state, whole=not decode)
    mu_k, mu_r = p["mu_k"], p["mu_r"]
    if not decode:
        mu_k, mu_r = _whole(mu_k), _whole(mu_r)
    xk = x + (prev - x) * mu_k
    xr = x + (prev - x) * mu_r
    k = torch.square(torch.relu(xk @ p["wk"]))
    r = torch.sigmoid(xr @ p["wr"])
    if decode:
        return r * (k @ p["wv"]), x[:, -1]
    # the projection's partial sums reduced onto r's channels in the
    # forward as an autograd step, so its backward gathers the gradient
    # and the product's backward runs on this rank's hidden columns
    h = constrain(k @ contracted_as(p["wv"], k), ("batch", None, "embed"))
    return r * h, _carry(x)


def init_rwkv_state(cfg: ModelConfig, batch: int,
                    dtype: torch.dtype = torch.float32, device=None) -> dict:
    """Zero recurrent state of ``batch`` lanes on ``device`` (the CUDA
    device unless given)."""
    device = resolve_device(device)
    H, K = cfg.n_heads, cfg.rwkv.head_size
    return {"shift_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device),
            "shift_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device),
            "wkv": torch.zeros((batch, H, K, K), dtype=torch.float32,
                               device=device)}
