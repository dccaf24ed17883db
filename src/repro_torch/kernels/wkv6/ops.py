"""Public wrapper of the wkv6 recurrence, and the one-token decode step.

`wkv6` takes model-layout tensors (B, T, H, K/V) and an optional carried
state and moves them to the (B*H, T, K/V) float32 layout. By default it runs
the CUDA kernel (`kernel.wkv6_cuda`) on CUDA tensors or its plain version
(`ref.wkv6_sequential`, through the operator `kernel.OP` for DTensors)
on CPU tensors, and never falls back from one to
the other: a CUDA input that the kernel refuses raises. The kernel takes
any T, so there is no padding to a chunk.

``use_kernel=False`` is the differentiable route, the counterpart of the
JAX wrapper's ``use_pallas=False``: the chunked form (`ref.wkv6_chunked`),
with T padded to a multiple of ``chunk`` as the JAX wrapper pads it (steps
of w = 1, k = r = v = 0, which leave the state alone, their outputs
dropped). The language models' loss takes it; the kernel is forward-only.

`wkv6_decode_step` is plain tensor code, as in the JAX package, where it is
jnp and not Pallas.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.wkv6.kernel import OP, wkv6_cuda
from repro_torch.kernels.wkv6.ref import wkv6_chunked, wkv6_sequential


def to_bh_layout(r, k, v, w, u, s0=None) -> tuple:
    """Model-layout r, k, w (B, T, H, K), v (B, T, H, V), u (H, K) and the
    optional state s0 (B, H, K, V) as contiguous float32 (B*H, T, K/V),
    (B*H, K) and (B*H, K, V) tensors, s0 zero when not given: the layout of
    `kernel.wkv6_cuda` and `ref.wkv6_sequential`."""
    B, T, H, K = r.shape
    V = v.shape[-1]

    def to_bh(x):
        return x.float().transpose(1, 2).reshape(B * H, T, x.shape[-1]
                                                  ).contiguous()

    ub = u.float()[None].expand(B, H, K).reshape(B * H, K).contiguous()
    sb = (torch.zeros((B * H, K, V), dtype=torch.float32, device=r.device)
          if s0 is None else s0.float().reshape(B * H, K, V).contiguous())
    return (*map(to_bh, (r, k, v, w)), ub, sb)


def from_bh_layout(y, s_out, B: int, H: int) -> tuple:
    """(B*H, T, V) outputs and (B*H, K, V) state back to (B, T, H, V) and
    (B, H, K, V)."""
    _, T, V = y.shape
    return (y.reshape(B, H, T, V).transpose(1, 2),
            s_out.reshape(B, H, s_out.shape[1], V))


def wkv6(r, k, v, w, u, s0=None, *, use_kernel: bool = True,
         chunk: int = 64):
    """r, k, w: (B, T, H, K); v: (B, T, H, V); u: (H, K); s0: optional
    (B, H, K, V) initial state (serving continuation). ``use_kernel``: the
    kernel (or its plain version on the CPU); False: the differentiable
    chunked form, padded to a multiple of ``chunk``.
    Returns (y (B, T, H, V) float32, s_out (B, H, K, V) float32)."""
    B, T, H, _ = r.shape
    args = to_bh_layout(r, k, v, w, u, s0)
    if not use_kernel:
        y, s_out = _chunked(*args, chunk)
    elif r.device.type == "cpu":
        # a DTensor takes the operator, whose rule keeps each rank's rows
        y, s_out = (OP if isinstance(args[0], DTensor)
                    else wkv6_sequential)(*args)
    else:
        y, s_out = wkv6_cuda(*args)
    return from_bh_layout(y[:, :T], s_out, B, H)


def _chunked(r, k, v, w, u, s0, chunk: int) -> tuple:
    """`wkv6_chunked` on (B*H, T, K/V) inputs, T padded with ``pad`` steps
    of w = 1 and r = k = v = 0 to a multiple of ``chunk``; y keeps the
    padding's rows (the caller drops them)."""
    pad = (-r.shape[1]) % chunk
    if pad:
        def padded(x, fill):
            tail = x.new_full((x.shape[0], pad, x.shape[2]), fill)
            return torch.cat([x, tail], dim=1)
        r, k, v, w = (padded(r, 0.0), padded(k, 0.0), padded(v, 0.0),
                      padded(w, 1.0))
    return wkv6_chunked(r, k, v, w, u, s0, chunk=chunk)


def wkv6_decode_step(r, k, v, w, u, s):
    """Single-token decode: r, k, w (B, H, K); v (B, H, V); u (H, K);
    s (B, H, K, V). Returns (y (B, H, V), s'). The serving-path state
    update: one 'AccW2V + leak' on the wkv membrane."""
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r, s + u[None, :, :, None] * kv)
    s = w[..., :, None] * s + kv
    return y, s
