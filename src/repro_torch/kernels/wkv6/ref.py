"""Plain PyTorch versions of the RWKV6 (wkv) recurrence.

Sequential semantics per head (state S: (K, V), decay w_t in (0, 1), bonus u):
    y_t = r_t @ (S + diag(u) k_t v_t^T)        # read with bonus on current token
    S   = diag(w_t) S + k_t v_t^T              # decay-then-accumulate update

This is IMPULSE's membrane update with a learned, data-dependent leak: S is
the membrane potential, w_t the leak, k v^T the synaptic accumulate.

  * `wkv6_sequential` -- a loop over T, the ground-truth oracle and the plain
    version the CUDA kernel (`kernel.py`) is held against;
  * `wkv6_chunked`    -- the chunked-parallel form of the JAX package's
    `wkv6_chunked` (the algorithm its TPU kernel implements, and the form
    the JAX package trains through). It is the differentiable route of
    `ops.wkv6(use_kernel=False)`, which the language models' loss takes.
    It scales k by exp(-L) over a chunk, which overflows float32 once the
    summed log-decay of a chunk passes about -88.7: at the model's decay
    clip (log w >= -e) a chunk of 64 steps can reach -174. A chunk of 32
    cannot (-87.0), but its r exp(L) then nears float32's smallest normal
    value; one of 16 keeps both factors within exp(+-43.5). Nothing on the
    serving path calls it.

Both take the (B*H, T, K/V) layout and return float32.
"""
from __future__ import annotations

import torch


def wkv6_sequential(r, k, v, w, u, s0=None):
    """r, k, w: (BH, T, K); v: (BH, T, V); u: (BH, K); s0: optional
    (BH, K, V) initial state. Returns (y (BH, T, V), s_final (BH, K, V)),
    both float32, computed in float32."""
    BH, T, K = r.shape
    V = v.shape[-1]
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    s = (torch.zeros((BH, K, V), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    y = torch.empty((BH, T, V), dtype=torch.float32, device=r.device)
    uk = u[:, :, None]
    for t in range(T):
        kv = k[:, t, :, None] * v[:, t, None, :]              # (BH, K, V)
        y[:, t] = torch.bmm(r[:, t, None, :], s + uk * kv)[:, 0]
        s = w[:, t, :, None] * s + kv
    return y, s


def wkv6_chunked(r, k, v, w, u, s0=None, chunk: int = 64):
    """Chunked-parallel form; same signature and returns as
    `wkv6_sequential`. T must be a multiple of ``chunk``. Raises
    `ValueError` otherwise."""
    BH, T, K = r.shape
    V = v.shape[-1]
    if T % chunk != 0:
        raise ValueError(f"wkv6 chunked form needs T % chunk == 0, got "
                         f"T={T}, chunk={chunk}")
    C = chunk
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    s = (torch.zeros((BH, K, V), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ii = torch.arange(C, device=r.device)
    lower = ii[:, None] > ii[None, :]                         # strictly causal
    diag = ii[:, None] == ii[None, :]
    ys = []
    for c0 in range(0, T, C):
        rr, kk, vv, ww = (x[:, c0:c0 + C] for x in (r, k, v, w))
        lw = torch.log(ww)                                    # (BH, C, K), <= 0
        L = torch.cumsum(lw, dim=1)                           # inclusive
        r_d = rr * torch.exp(L - lw)                          # decayed receptance
        k_d = kk * torch.exp(-L)                              # growth-compensated key
        y_inter = torch.einsum("bck,bkv->bcv", r_d, s)
        a = torch.einsum("bik,bjk->bij", r_d, k_d)
        bonus = torch.einsum("bck,bck->bc", rr * u[:, None, :], kk)
        a = (torch.where(lower[None], a, 0.0)
             + torch.where(diag[None], bonus[:, :, None], 0.0))
        ys.append(y_inter + torch.einsum("bij,bjv->biv", a, vv))
        ltot = L[:, -1, :]                                    # (BH, K)
        k2 = kk * torch.exp(ltot[:, None, :] - L)
        s = torch.exp(ltot)[..., None] * s + torch.einsum("bck,bcv->bkv",
                                                          k2, vv)
    return torch.cat(ys, dim=1), s
