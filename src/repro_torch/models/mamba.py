"""Mamba (selective SSM) block of the Jamba hybrid architecture
(`repro.models.mamba`'s counterpart).

The SSM hidden state h (d_inner x d_state per token stream) is another
membrane-potential analogue: h_t = a_t * h_{t-1} + b_t with a data-dependent
decay a_t = exp(dt_t * A). Prefill (and the loss) runs a chunked scan: a
Python loop over chunks of ``chunk`` steps carrying h, with an associative
scan inside each chunk; decode is the O(1) state update. Plain tensor code:
the JAX package computes this block in plain `jnp` too.

Numerics follow the JAX package: the projections run in the activations'
type, dt, the decay, dt * B * x, the scan and the skip path in float32.
The associative scan is `associative_scan`, a copy of
``jax.lax.associative_scan``'s odd/even recursion, so the adds and products
of the combine happen in JAX's tree, not a sequential scan's; softplus is
JAX's ``logaddexp(x, 0)`` (no threshold, as `F.softplus` has at 20).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import constrain, recomputed
from repro_torch.models.layers import dense_init, gen_device

CHUNK = 128                       # the JAX package's scan chunk


def init_mamba_block(gen, cfg: ModelConfig,
                     dtype: torch.dtype = torch.bfloat16) -> dict:
    """One Mamba block's parameters, drawn from ``gen`` on its device
    (``meta`` tensors for a ``gen`` of None) in the JAX package's order:
    the matrices are `dense_init` draws of ``dtype``; ``conv_b`` zeros of
    ``dtype``; ``dt_bias`` = log(expm1(0.01)), ``a_log`` = log(1..N) on
    every row and ``d_skip`` ones, all float32."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    dev = gen_device(gen)
    a_init = np.tile(np.arange(1, s.d_state + 1, dtype=np.float32),
                     (d_in, 1))
    return {
        "in_proj": dense_init(gen, (d, 2 * d_in), dtype=dtype),
        "conv_w": dense_init(gen, (s.d_conv, d_in), dtype=dtype),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, (d_in, s.dt_rank + 2 * s.d_state),
                             dtype=dtype),
        "dt_proj": dense_init(gen, (s.dt_rank, d_in), dtype=dtype),
        "dt_bias": torch.from_numpy(np.log(np.expm1(np.full(
            d_in, 0.01))).astype(np.float32)).to(dev),
        "a_log": torch.from_numpy(np.log(a_init)).to(dev),    # (d_in, N)
        "d_skip": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (d_in, d), dtype=dtype),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)) at every x."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time. x: (B, T, d_in); w: (d_conv,
    d_in); conv_state: (B, d_conv - 1, d_in) carry-in (zeros if None). The
    taps are added in order from 0, as JAX's Python ``sum``, then ``b``.
    Returns (y, new_state), the state the last d_conv - 1 inputs."""
    d_conv = w.shape[0]
    T = x.shape[1]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], d_conv - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + T] * w[i] for i in range(d_conv)) + b
    return y, xp[:, -(d_conv - 1):]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int
                ) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along ``axis`` (a may hold one more)."""
    n = b.shape[axis]
    pairs = torch.stack([a.narrow(axis, 0, n), b], dim=axis + 1)
    out = pairs.flatten(axis, axis + 1)
    if a.shape[axis] > n:
        out = torch.cat([out, a.narrow(axis, n, 1)], dim=axis)
    return out


def associative_scan(fn: Callable, elems: tuple, axis: int) -> list:
    """Inclusive scan of the tensors ``elems`` along ``axis`` under the
    associative ``fn(earlier, later)`` (tuples of tensors), by
    ``jax.lax.associative_scan``'s recursion: combine the pairs ``[0:-1:2]``
    and ``[1::2]``, scan those (the results at odd places), combine them
    with ``[2::2]`` for the even places, and interleave. Every element is
    combined in the same tree as JAX's."""

    def sl(t, start, stop, step=1):
        idx = [slice(None)] * t.dim()
        idx[axis] = slice(start, stop, step)
        return t[tuple(idx)]

    def scan(elems):
        n = elems[0].shape[axis]
        if n < 2:
            return list(elems)
        reduced = fn([sl(e, 0, n - 1, 2) for e in elems],
                     [sl(e, 1, None, 2) for e in elems])
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn([sl(e, 0, e.shape[axis] - 1) for e in odd],
                      [sl(e, 2, None, 2) for e in elems])
        else:
            even = fn(odd, [sl(e, 2, None, 2) for e in elems])
        even = [torch.cat([sl(e, 0, 1), r], dim=axis)
                for e, r in zip(elems, even)]
        return [_interleave(e, o, axis) for e, o in zip(even, odd)]

    return scan(tuple(elems))


def _combine(p, q):
    """The scan's operator on (log decay, state) pairs: p before q."""
    (la1, b1), (la2, b2) = p, q
    return [la1 + la2, torch.exp(la2) * b1 + b2]


def _scan_chunk(h, la, b, cc):
    """One chunk of the scan: the associative scan of (``la``, ``b``) with
    the carry-in ``h`` added, read out through ``cc``. Returns (h at the
    chunk's end, y of the chunk)."""
    la_cum, b_scan = associative_scan(_combine, (la, b), axis=1)
    h_all = b_scan + torch.exp(la_cum) * h[:, None]         # carry-in
    return h_all[:, -1], torch.einsum("btdn,btn->btd", h_all, cc)


def _ssm_chunked(a_log_dt: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                 h0: torch.Tensor, chunk: int, remat_chunks: bool = False):
    """Selective scan. a_log_dt (= dt * A, the log decay) and bx (= dt * B
    * x): both (B, T, d_in, N) float32; c: (B, T, N); h0: (B, d_in, N).
    A loop over T / chunk chunks carrying h, an associative scan inside
    each. Returns (y (B, T, d_in), h_T).

    ``remat_chunks`` (with grad mode on): each chunk body is recomputed in
    the backward pass (`torch.utils.checkpoint`, JAX's ``jax.checkpoint``
    of the chunk), which keeps only the (B, d_in, N) chunk-boundary states
    instead of the (B, T, d_in, N) scan residuals; the values are the
    same."""
    B, T, d_in, N = bx.shape
    if T % chunk != 0:
        raise ValueError(f"chunked ssm scan needs T % chunk == 0, got "
                         f"T={T}, chunk={chunk}")
    remat = remat_chunks and torch.is_grad_enabled()
    h, ys = h0, []
    for i in range(T // chunk):
        part = slice(i * chunk, (i + 1) * chunk)
        args = (h, a_log_dt[:, part], bx[:, part], c[:, part])
        h, y = (recomputed(_scan_chunk, *args) if remat
                else _scan_chunk(*args))
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _split_proj(proj: torch.Tensor, s) -> tuple:
    """(dt_r, B, C) of the x projection's last axis."""
    return proj.split([s.dt_rank, s.d_state, s.d_state], dim=-1)


def mamba_forward(x: torch.Tensor, p: dict, cfg: ModelConfig,
                  state: Optional[dict] = None, chunk: int = CHUNK,
                  constraints: bool = False):
    """x: (B, T, d). state: {"conv": (B, d_conv - 1, d_in), "ssm": (B,
    d_in, N) float32} or None (zeros). The scan runs over T padded to a
    multiple of ``chunk`` with a zero log decay and a zero input, so the
    padded steps keep h. Returns (out (B, T, d), new_state): the conv
    state in the activations' type, the SSM state float32.
    ``constraints`` pins the (B, T, d_in, N) scan tensors to (batch, ffn)
    under `dist.sharding.activation_rules` (the identity otherwise) and
    recomputes each scan chunk in the backward pass (``remat_chunks``)."""
    s = cfg.ssm
    B, T, _ = x.shape
    d_in = s.expand * cfg.d_model
    xs, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xs, conv_new = _causal_conv(xs, p["conv_w"], p["conv_b"],
                                None if state is None else state["conv"])
    xs = F.silu(xs)
    dt_r, b_mat, c_mat = _split_proj(xs @ p["x_proj"], s)
    # the (B, T, dt_rank) low-rank input gathered over model (the identity
    # without active rules): dt then comes out on each rank's own
    # channels, not in partial sums over all of d_in
    dt_r = constrain(dt_r, ("batch", None, None))
    dt = softplus((dt_r @ p["dt_proj"]).float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])                                # (d_in, N)
    la = dt[..., None] * a                                    # (B, T, d_in, N)
    bx = dt[..., None] * b_mat[:, :, None, :].float() * xs[..., None].float()
    h0 = (torch.zeros((B, d_in, s.d_state), dtype=torch.float32,
                      device=x.device)
          if state is None else state["ssm"])
    if constraints:
        la = constrain(la, ("batch", None, "ffn", None))
        bx = constrain(bx, ("batch", None, "ffn", None))
    c_pad = c_mat.float()
    pad = (-T) % chunk
    if pad:
        la = F.pad(la, (0, 0, 0, 0, 0, pad))
        bx = F.pad(bx, (0, 0, 0, 0, 0, pad))
        c_pad = F.pad(c_pad, (0, 0, 0, pad))
    y, h = _ssm_chunked(la, bx, c_pad, h0, chunk, remat_chunks=constraints)
    y = y[:, :T] + xs.float() * p["d_skip"]
    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return out, {"conv": conv_new, "ssm": h}


def mamba_decode(x: torch.Tensor, p: dict, cfg: ModelConfig, state: dict):
    """One-token decode. x: (B, 1, d). The O(1) state update: the conv
    window slides by one, h = exp(dt A) h + dt B x. Returns (out (B, 1,
    d), new_state), new tensors (the caller's state is not written)."""
    s = cfg.ssm
    xs, z = (x[:, 0] @ p["in_proj"]).chunk(2, dim=-1)
    window = torch.cat([state["conv"].to(xs.dtype), xs[:, None]], dim=1)
    xc = torch.einsum("bcd,cd->bd", window, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc)
    dt_r, b_mat, c_mat = _split_proj(xc @ p["x_proj"], s)
    dt = softplus((dt_r @ p["dt_proj"]).float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt[..., None] * a)                      # (B, d_in, N)
    bx = dt[..., None] * b_mat[:, None, :].float() * xc[..., None].float()
    h = decay * state["ssm"] + bx
    y = (torch.einsum("bdn,bn->bd", h, c_mat.float())
         + xc.float() * p["d_skip"])
    out = (y.to(x.dtype) * F.silu(z))[:, None] @ p["out_proj"]
    return out, {"conv": window[:, 1:], "ssm": h}


def init_mamba_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16, device=None
                     ) -> dict:
    """Zero state of ``batch`` lanes on ``device`` (the CUDA device unless
    given): the conv window (B, d_conv - 1, d_in) of ``dtype`` and the
    float32 SSM state (B, d_in, N)."""
    device = resolve_device(device)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return {"conv": torch.zeros((batch, s.d_conv - 1, d_in), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, d_in, s.d_state), dtype=torch.float32,
                               device=device)}
