"""Layer library of the language models: weight init, norms, RoPE and
sinusoidal positions, FFNs, GQA attention with its cross-attention form,
multi-head latent attention (MLA) and the MoE FFN (`repro.models.layers`'
dense-family, encoder-decoder, MLA and MoE layers).

Numerics as in the JAX package: params and activations bf16 by default;
norms accumulate in float32, and attention upcasts q, k and v to float32
and runs its softmax there. Attention is plain tensor code in the JAX
package's order of operations (no fused or library attention kernel: one
in bf16 would be another function).
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.dist.sharding import (constrain, contiguous_grad,
                                      contracted_as, group_local, head_local,
                                      put_rows, reduced, replicated_call,
                                      split_heads, splits_batch)

#: `head_local` layouts: (B, T, H, D) queries, (B, S, KV, D) keys/values
_QH = ("batch", None, "heads", None)
_KVH = ("batch", None, "kv_heads", None)
#: `group_local` layouts: (B, T, d) rows, (G, n * k) routing tensors,
#: (G, E, cap, d) buckets
_ROWS = ("batch", None, None)
_GROUPS = ("batch", None)
_BUCKETS = ("batch", None, None, None)

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def gen_device(gen) -> torch.device:
    """The device the init draws on: the generator's, or ``meta`` (shapes
    only) for a ``gen`` of None."""
    return torch.device("meta") if gen is None else gen.device


def normal(gen, shape: tuple) -> torch.Tensor:
    """Standard normal float32 draws of ``shape`` from ``gen`` on its
    device; a ``gen`` of None gives an empty ``meta`` tensor."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def dense_init(gen, shape: tuple, in_axis: int = 0,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Normal(0, 1 / fan_in) weights drawn in float32 from ``gen`` on the
    generator's device, then cast to ``dtype``; ``fan_in`` is
    ``shape[in_axis]``."""
    return (normal(gen, shape) / math.sqrt(shape[in_axis])).to(dtype)


def dense_draw_(gen, leaf: torch.Tensor) -> torch.Tensor:
    """Fill ``leaf`` in place with `dense_init`'s draws for its shape
    (fan-in ``leaf.shape[0]``); a 3-D leaf (stacked experts) is drawn one
    expert at a time, so the float32 draw never holds more than one."""
    scale = math.sqrt(leaf.shape[0])
    for part in (leaf if leaf.dim() == 3 else leaf[None]):
        part.copy_(normal(gen, part.shape).div_(scale))
    return leaf


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., T, H, D); positions: (..., T) integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    ang = positions[..., None].float() * freqs                # (..., T, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int) -> torch.Tensor:
    """(seq, d_model) float32 table [sin | cos] of pos / 10000^(2i/d),
    computed in float64 with numpy and rounded once to float32, as the JAX
    package computes it (bit for bit)."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d_model // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d_model)
    return torch.from_numpy(np.concatenate([np.sin(ang), np.cos(ang)],
                                           axis=-1).astype(np.float32))


def sinusoidal_at(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """The [sin | cos] positional term of each lane's position ``pos`` (B,)
    in float32 on ``pos``'s device, as the JAX package's decode step
    computes it: the angle is pos / 10000^(2i/d) in float32, with the
    exponent 2i/d rounded to float32 and the power taken in float64 and
    rounded once (the value of XLA:CPU's float32 power on every exponent;
    `torch.pow` in float32 is an ulp off on some). The angles then equal
    JAX's; float32 sin and cos differ from XLA's by at most an ulp.
    Device code only, so a CUDA graph can capture it. Returns (B, d)."""
    i = torch.arange(d_model // 2, dtype=torch.float32, device=pos.device)
    div = torch.pow(10000.0, (2 * i / d_model).double()).float()
    ang = pos[:, None].float() / div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def init_ffn(gen, d_model: int, d_ff: int, ffn_type: str,
             dtype=torch.bfloat16) -> dict:
    if ffn_type == "swiglu":
        return {"gate": dense_init(gen, (d_model, d_ff), dtype=dtype),
                "up": dense_init(gen, (d_model, d_ff), dtype=dtype),
                "down": dense_init(gen, (d_ff, d_model), dtype=dtype)}
    return {"up": dense_init(gen, (d_model, d_ff), dtype=dtype),
            "down": dense_init(gen, (d_ff, d_model), dtype=dtype)}


def ffn(x: torch.Tensor, p: dict, ffn_type: str) -> torch.Tensor:
    """swiglu, or gelu in its tanh form (``jax.nn.gelu``'s default).
    Under a mesh the down projection reads its weight placed as the hidden
    axis (`sharding.contracted_as`)."""
    if ffn_type == "swiglu":
        h = F.silu(x @ p["gate"]) * (x @ p["up"])
    else:
        h = F.gelu(x @ p["up"], approximate="tanh")
    return h @ contracted_as(p["down"], h)


# ---------------------------------------------------------------------------
# Attention (GQA; cross-attention; decode with a pre-allocated KV cache)
# ---------------------------------------------------------------------------

def init_attention(gen, cfg, cross: bool = False,
                   dtype=torch.bfloat16) -> dict:
    """``wq``, ``wk``, ``wv`` and ``wo``; ``cross`` (a cross-attention or
    an encoder layer) is MHA: as many K/V heads as query heads."""
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.n_heads, (cfg.n_heads if cross else cfg.n_kv_heads)
    return {"wq": dense_init(gen, (d, nh * hd), dtype=dtype),
            "wk": dense_init(gen, (d, nkv * hd), dtype=dtype),
            "wv": dense_init(gen, (d, nkv * hd), dtype=dtype),
            "wo": dense_init(gen, (nh * hd, d), dtype=dtype)}


def _sdpa(q, k, v, *, causal: bool, q_pos=None, kv_len=None):
    """q: (B, T, H, D); k, v: (B, S, KV, D). GQA by head repetition,
    float32 softmax. ``kv_len`` masks a pre-allocated cache to its valid
    length; ``q_pos`` gives the queries' absolute positions for the causal
    mask."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qf = q.float() / np.sqrt(D)
    kf, vf = k.float(), v.float()
    qf = qf.reshape(B, T, KV, rep, D)
    logits = torch.einsum("btkrd,bskd->bkrts", qf, kf)       # (B,KV,rep,T,S)
    sp = torch.arange(S, device=q.device)[None]
    mask = None
    if causal:
        qp = (q_pos if q_pos is not None
              else torch.arange(T, device=q.device)[None])
        mask = qp[:, :, None] >= sp[:, None, :]               # (B, T, S)
    if kv_len is not None:
        valid = sp < (kv_len[:, None] if kv_len.dim() else kv_len)
        valid = valid[:, None, :].expand(B, T, S)
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrts,bskd->btkrd", probs, vf)
    return out.reshape(B, T, H, v.shape[-1]).to(q.dtype)


def blocked_attention(q, k, v, *, causal: bool, q_chunk: int,
                      kv_block: int) -> torch.Tensor:
    """Flash-style two-level blocked attention: a loop over q chunks and,
    within one, over kv blocks carrying the running (max, denominator,
    accumulator); a causal q chunk skips the kv blocks wholly in its
    future. Positions are ``arange(T)`` (prefill self-attention)."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    rep = H // KV
    q_chunk = min(q_chunk, T)
    kv_block = min(kv_block, S)
    if T % q_chunk != 0 or S % kv_block != 0:
        raise ValueError(
            f"chunked attention needs T % q_chunk == 0 and S % kv_block "
            f"== 0, got T={T}, q_chunk={q_chunk}, S={S}, "
            f"kv_block={kv_block}")
    qf = (q.float() / np.sqrt(D)).reshape(B, T, KV, rep, D)
    kf, vf = k.float(), v.float()
    dev = q.device

    outs = []
    for ci in range(T // q_chunk):
        qs = ci * q_chunk
        qc = qf[:, qs:qs + q_chunk]                          # (B,QC,KV,rep,D)
        n_blocks = S // kv_block
        if causal:                                           # causal skip
            n_blocks = min(n_blocks, (qs + q_chunk + kv_block - 1) // kv_block)
        qpos = qs + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KV, rep, q_chunk), -1e30, device=dev)
        den = torch.zeros((B, KV, rep, q_chunk), device=dev)
        acc = torch.zeros((B, KV, rep, q_chunk, D), device=dev)
        for bi in range(n_blocks):
            blk = slice(bi * kv_block, (bi + 1) * kv_block)
            s = torch.einsum("bqkrd,bskd->bkrqs", qc, kf[:, blk])
            if causal:
                kpos = bi * kv_block + torch.arange(kv_block, device=dev)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            den = den * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkrqs,bskd->bkrqd", p, vf[:, blk])
            m = m_new
        o = acc / torch.clamp(den[..., None], min=1e-30)    # (B,KV,rep,QC,D)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, D))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor, *,
              causal: bool = True, kv_x: Optional[torch.Tensor] = None,
              use_rope: bool = True, q_chunk: int = 0,
              kv_block: int = 1024) -> torch.Tensor:
    """Full (prefill) attention; ``q_chunk`` > 0 selects the blocked form.
    ``kv_x`` (B, S, d) is a cross-attention's source: K and V come from it,
    with no RoPE and no causal mask."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    src = x if kv_x is None else kv_x
    S = src.shape[1]
    causal = causal and kv_x is None
    q = split_heads(x @ p["wq"], hd)
    k = split_heads(src @ p["wk"], hd)
    v = split_heads(src @ p["wv"], hd)
    if use_rope and cfg.rope_theta > 0 and kv_x is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    def scores(q, k, v):
        if q_chunk and T > 1:
            return blocked_attention(q, k, v, causal=causal,
                                     q_chunk=q_chunk, kv_block=kv_block)
        return _sdpa(q, k, v, causal=causal, q_pos=positions)
    # under a mesh each model rank runs its own heads, as the
    # tensor-parallel projections left them (`fn(q, k, v)` without rules)
    out = head_local(scores, (q, k, v), (_QH, _KVH, _KVH), _QH)
    out = out.reshape(B, T, -1)
    return out @ contracted_as(p["wo"], out)


def attention_decode(x: torch.Tensor, p: dict, cfg, cache: dict,
                     pos: torch.Tensor, *, use_rope: bool = True,
                     cross_kv: Optional[tuple] = None
                     ) -> tuple[torch.Tensor, dict]:
    """One-token decode against a pre-allocated cache.
    x: (B, 1, d); cache: {"k": (B, S_max, KV, D), "v": ...}; pos: (B,)
    integer, each lane's own position (continuous-batching lanes sit at
    different lengths).

    The new K and V are written into ``cache``'s tensors in place (the JAX
    package's ``.at[b, pos].set``), which are returned. A lane at or past
    S_max writes nothing, as the JAX scatter drops an out-of-bounds
    update. ``cross_kv``: a fixed (k, v) (B, S, KV, D) that the query
    attends unmasked (an encoder-decoder's cross-attention), with no RoPE
    and ``cache`` returned untouched."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    q = split_heads(x @ p["wq"], hd)
    # the heads gathered as `attention` gathers them (identity w/o rules)
    q = constrain(q, ("batch", None, None, None))
    if cross_kv is not None:
        k, v = cross_kv
        out = _sdpa(q, k, v, causal=False)
        return out.reshape(B, T, -1) @ p["wo"], cache
    k_new = split_heads(x @ p["wk"], hd)
    v_new = split_heads(x @ p["wv"], hd)
    if use_rope and cfg.rope_theta > 0:
        q = constrain(apply_rope(q, pos[:, None], cfg.rope_theta),
                      ("batch", None, None, None))
        k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    for c, new in ((k_cache, k_new), (v_cache, v_new)):
        put_rows(c, pos, new[:, 0].to(c.dtype))
    out = _sdpa(q, k_cache, v_cache, causal=False, kv_len=pos + 1)
    return out.reshape(B, T, -1) @ p["wo"], {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention): a compressed, shared KV cache
# ---------------------------------------------------------------------------

def init_mla(gen, cfg, dtype=torch.bfloat16) -> dict:
    """MLA's params: ``wq`` (d, nh * (nope + rope)), the latent's down
    projection ``w_dkv`` (d, r + rope), the up projections ``w_uk`` (r,
    nh * nope) and ``w_uv`` (r, nh * v), and ``wo`` (nh * v, d)."""
    m = cfg.mla
    d, nh = cfg.d_model, cfg.n_heads
    qd = nh * (m.nope_head_dim + m.rope_head_dim)
    r = m.kv_lora_rank
    return {"wq": dense_init(gen, (d, qd), dtype=dtype),
            "w_dkv": dense_init(gen, (d, r + m.rope_head_dim), dtype=dtype),
            "w_uk": dense_init(gen, (r, nh * m.nope_head_dim), dtype=dtype),
            "w_uv": dense_init(gen, (r, nh * m.v_head_dim), dtype=dtype),
            "wo": dense_init(gen, (nh * m.v_head_dim, d), dtype=dtype)}


def mla_attention(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor,
                  latent_cache: Optional[torch.Tensor] = None,
                  pos: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """MLA over the latent ``[c_kv, rotated k_rope]`` (B, S, r + rope),
    as the JAX package computes it: K and V are re-expanded from the
    latent at every call (``w_uk``, ``w_uv``) and the one rope key is
    broadcast over the heads; the q head (nope + rope) is wider than the v
    head. Prefill (causal) when ``latent_cache`` is None; else a one-token
    decode step (T == 1) at each lane's ``pos`` (B,), whose latent row is
    written into ``latent_cache`` in place (a lane at or past its length
    writes nothing, as the JAX package's ``.at[].set`` drops it) and which
    attends the cache up to ``pos``. Returns (out (B, T, d), the latent:
    the prompt's (B, T, r + rope) in prefill, ``latent_cache`` in
    decode)."""
    m = cfg.mla
    B, T, _ = x.shape
    nh, r = cfg.n_heads, m.kv_lora_rank
    q = split_heads(x @ p["wq"], m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = (x @ p["w_dkv"]).split([r, m.rope_head_dim], dim=-1)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    latent_new = torch.cat([c_kv, k_rope[:, :, 0]], dim=-1)
    if latent_cache is None:
        latent, kv_len, causal = latent_new, None, True
    else:
        put_rows(latent_cache, pos, latent_new[:, 0].to(latent_cache.dtype))
        latent, kv_len, causal = latent_cache, pos + 1, False
    # a bf16 cache under float32 weights is promoted, as JAX promotes it
    latent_w = latent.to(torch.promote_types(latent.dtype, p["w_uk"].dtype))
    # the up-projections flatten (lanes, positions) into rows, which DTensor
    # cannot do with the positions sharded: the lanes over data only (the
    # identity without active rules)
    latent_w = constrain(latent_w, ("batch", None, None))
    c_all, kr_all = latent_w.split([r, m.rope_head_dim], dim=-1)
    k_nope = split_heads(c_all @ p["w_uk"], m.nope_head_dim)
    v = split_heads(c_all @ p["w_uv"], m.v_head_dim)

    def scores(q_nope, q_rope, k_nope, kr, v, kv_len):
        # the one rope key broadcast over this rank's heads
        k_full = torch.cat([k_nope, kr[:, :, None, :].expand(
            *k_nope.shape[:3], m.rope_head_dim)], dim=-1)
        return _sdpa(torch.cat([q_nope, q_rope], dim=-1), k_full, v,
                     causal=causal, q_pos=positions, kv_len=kv_len)
    # each model rank on its own heads, as `attention` (identity w/o rules)
    out = head_local(scores, (q_nope, q_rope, k_nope, kr_all, v, kv_len),
                     (_QH, _QH, _QH, ("batch", None, None), _QH,
                      ("batch",)), _QH)
    return out.reshape(B, T, nh * m.v_head_dim) @ p["wo"], latent


# ---------------------------------------------------------------------------
# MoE: sort-based, capacity-bounded top-k dispatch
# ---------------------------------------------------------------------------

def init_moe(gen, cfg, dtype=torch.bfloat16) -> dict:
    """The MoE FFN's params: a float32 (d, E) router, stacked expert leaves
    ``gate``/``up`` (E, d, f) and ``down`` (E, f, d), each `dense_init` of
    the whole leaf as the JAX package draws it (fan-in E) but drawn one
    expert at a time, and with shared experts a swiglu FFN of
    ``d_ff * n_shared_experts``."""
    m = cfg.moe
    d, E, f = cfg.d_model, m.n_experts, m.d_ff
    dev = gen_device(gen)

    def stacked(shape):
        leaf = torch.empty(shape, dtype=dtype, device=dev)
        return leaf if gen is None else dense_draw_(gen, leaf)
    p = {"router": dense_init(gen, (d, E), dtype=torch.float32),
         "experts": {name: stacked(shape) for name, shape in (
             ("gate", (E, d, f)), ("up", (E, d, f)), ("down", (E, f, d)))}}
    if m.n_shared_experts:
        p["shared"] = init_ffn(gen, d, f * m.n_shared_experts, "swiglu",
                               dtype)
    return p


def _topk_first(probs: torch.Tensor, k: int):
    """The k largest values along the last axis and their indices, ties to
    the lower index (``lax.top_k``'s order; `torch.topk` promises none)."""
    idx = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(probs, -1, idx), idx


def _combine(contrib: torch.Tensor, order: torch.Tensor, k: int
             ) -> torch.Tensor:
    """The MoE combine: ``contrib`` (G, n * k, d) holds the gated expert
    outputs in sorted order, where place i belongs to token
    ``order[g, i] // k``. Each token's k contributions are added from zero
    one at a time in ``contrib``'s type, in ascending order of place, as
    XLA:CPU adds the updates of JAX's ``.at[g, tok].add`` (one rounding
    after each add); `Tensor.scatter_add_` rounds a bf16 sum once on the
    CPU and adds in a varying order by atomics on CUDA. Returns (G, n,
    d)."""
    G, nk, d = contrib.shape
    n = nk // k
    at = torch.argsort(order, dim=-1).reshape(G, n, k).sort(dim=-1).values
    per_tok = torch.gather(contrib, 1, at.reshape(G, nk, 1).expand(
        -1, -1, d)).reshape(G, n, k, d)
    out = torch.zeros((G, n, d), dtype=contrib.dtype, device=contrib.device)
    for j in range(k):
        out = out + per_tok[:, :, j]
    return out


def moe_ffn(x: torch.Tensor, p: dict, cfg, capacity_factor: float = 1.25,
            groups: Optional[int] = None, constraints: bool = False,
            gather_dispatch: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k routing with capacity, as the JAX package's
    ``moe_ffn``: float32 router softmax, top-k gates renormalised, the
    Switch load-balance aux; tokens are routed within groups of the
    flattened token axis (default one group per batch row for T > 1, a
    single group when decoding), sorted by expert (stable, so the first
    ``cap`` tokens of an expert in token order keep their slot and later
    ones overflow to a trash slot), bucketed (G, E, cap, d), run through
    all E experts in three batched products and combined by `_combine`
    in JAX's order of adds, the same on every run. Every shape is fixed by
    (x.shape, cfg, capacity_factor): no host sync, so a decode tick can be
    a CUDA graph. ``constraints`` pins the bucket tensors ``be`` and ``h``
    to (batch groups, experts) under `dist.sharding.activation_rules`
    (expert parallelism; the identity otherwise). On a DTensor ``x`` under
    the rules, where the data extent divides the batch and the groups
    (`dist.sharding.splits_batch`), the dispatch (`_route`) and the
    combine run group-local (`dist.sharding.group_local`): each data rank
    routes its own groups (every model rank of the row the same) and
    combines them from the expert outputs gathered over model, in the
    one-device order of adds, and the aux is each rank's share of the
    mean (a partial sum over data). Otherwise (a decode tick's single
    group, or outside the rules) a DTensor's dispatch and combine run
    replicated (`dist.sharding.replicated_call`). The expert products are
    DTensor's either way.
    ``gather_dispatch`` is taken for the JAX signature and gives the same
    result: the JAX package's gather form only works round an XLA lowering
    of wide scatters under a mesh, which PyTorch does not have, so the
    port has the one dispatch. Returns (out, load-balance aux float32)."""
    m = cfg.moe
    B, T, d = x.shape
    k, E = m.top_k, m.n_experts
    G = groups if groups else (B if T > 1 else 1)
    n = B * T // G
    cap = max(int(np.ceil(n * k / E * capacity_factor)), 4)
    grouped = isinstance(x, DTensor) and splits_batch(B, G)
    if grouped:
        # each data rank on its own groups (batch rows), its aux a share;
        # a sequence-sharded input is gathered once, for the shared
        # experts too (torch 2.11's DTensor cannot flatten it into rows)
        x = constrain(x, _ROWS)
        be, dest, keep, gate_sorted, order, lb_loss = group_local(
            partial(_route_rows, n=n, k=k, cap=cap, groups=G),
            (x, p["router"]), (_ROWS, (None, None)),
            (_BUCKETS,) + (_GROUPS,) * 4 + ("sum",))
    else:
        route, combine = _route, _gather_combine
        if isinstance(x, DTensor):
            # the sort-based dispatch and the ordered combine have no
            # DTensor sharding rules: run them on the global values
            route, combine = (partial(replicated_call, _route),
                              partial(replicated_call, _gather_combine))
        buckets, dest, keep, gate_sorted, order, lb_loss = route(
            x.reshape(G, n, d), p["router"], k, cap)
        be = buckets.reshape(G, E, cap, d)
    if constraints:
        be = constrain(be, ("batch", "experts", None, None))
    ex = p["experts"]
    h = (F.silu(_experts(be, ex["gate"])) * _experts(be, ex["up"]))
    if constraints:
        h = constrain(h, ("batch", "experts", None, None))
    ye = _experts(h, ex["down"])
    if grouped:
        out = group_local(partial(_combine_rows, k=k, T=T, dtype=x.dtype),
                          (ye, dest, keep, gate_sorted, order),
                          (_BUCKETS,) + (_GROUPS,) * 4, (_ROWS,))
    else:
        out = combine(ye.reshape(G, E * cap, d), dest, keep, gate_sorted,
                      order, k, x.dtype).reshape(B, T, d)
    if "shared" in p:
        shared = ffn(x, p["shared"], "swiglu")
        if grouped:
            # the sum on the routed rows' placement: left to DTensor, torch
            # 2.11 scatters it over the sequence, and the shared experts'
            # backward cannot flatten that gradient into rows
            shared = constrain(shared, _ROWS)
        out = out + shared
    return out, lb_loss.float()


def _experts(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Every expert's product: x (G, E, cap, a) by w (E, a, b) -> (G, E,
    cap, b), ``einsum("gecd,edf->gecf")``. On DTensors the experts-first
    layout that the einsum takes inside is made explicitly, with a copy:
    the einsum's backward views a permuted gradient whose local shard is
    laid out otherwise than DTensor's global strides say, and fails; the
    gradient of ``x`` comes back laid out (`contiguous_grad`). A product
    over an input axis that a mesh axis splits (the down projection's
    d_ff, over model) is reduced where it is made (`reduced`): left in
    partial sums, the reshape scatters it onto the groups, and the
    backward then makes the weight's gradient in partial sums over every
    mesh axis, the whole (E, d_ff, d) on every rank."""
    if not isinstance(x, DTensor):
        return torch.einsum("gecd,edf->gecf", x, w)
    G, E, C, a = x.shape
    xe = contiguous_grad(x).permute(1, 0, 2, 3).contiguous().reshape(
        E, G * C, a)
    y = reduced(torch.bmm(xe, w))
    return y.reshape(E, G, C, -1).permute(1, 0, 2, 3).contiguous()


def _route(xg: torch.Tensor, router: torch.Tensor, k: int, cap: int):
    """`moe_ffn`'s routing and dispatch of the grouped tokens ``xg`` (G,
    n, d): the float32 router softmax, the top-k gates renormalised, the
    Switch load-balance aux, the stable sort by expert and the (G, E * cap,
    d) buckets (overflow in a trash slot, dropped). Returns (buckets,
    dest, keep, gate_sorted, order, lb_loss)."""
    G, n, d = xg.shape
    E = router.shape[1]
    logits = torch.einsum("gnd,de->gne", xg.float(), router)
    probs = torch.softmax(logits, dim=-1)                     # (G, n, E)
    gate_vals, eidx = _topk_first(probs, k)                   # (G, n, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    assign = torch.zeros_like(probs).scatter_add_(
        -1, eidx, torch.ones_like(gate_vals)) / k
    lb_loss = E * torch.mean(torch.mean(probs, dim=1)
                             * torch.mean(assign, dim=1))

    flat_e = eidx.reshape(G, n * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)        # group-local
    e_sorted = torch.gather(flat_e, 1, order)
    tok_sorted = order // k
    gate_sorted = torch.gather(gate_vals.reshape(G, n * k), 1, order)
    experts = torch.arange(E, device=xg.device).expand(G, E).contiguous()
    starts = torch.searchsorted(e_sorted, experts)            # (G, E)
    slot = (torch.arange(n * k, device=xg.device)[None]
            - torch.gather(starts, 1, e_sorted))
    keep = slot < cap
    # overflow goes to a trash slot so it cannot clobber a real token
    dest = torch.where(keep, e_sorted * cap + slot,
                       torch.full_like(slot, E * cap))

    gathered = torch.gather(xg, 1, tok_sorted[..., None].expand(-1, -1, d))
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=xg.dtype, device=xg.device))
    buckets = torch.zeros((G, E * cap + 1, d), dtype=xg.dtype,
                          device=xg.device).scatter_(
        1, dest[..., None].expand(-1, -1, d), gathered)[:, :-1]
    return buckets, dest, keep, gate_sorted, order, lb_loss


def _route_rows(x: torch.Tensor, router: torch.Tensor, n: int, k: int,
                cap: int, groups: int):
    """`_route` of the rows ``x`` (b, T, d), a data rank's share of the
    batch, as their groups of ``n`` tokens, for `group_local`: the buckets
    as (g, E, cap, d) and the load-balance aux as this rank's share of the
    mean over all ``groups`` groups (its g / ``groups`` of its own mean)."""
    d, E = x.shape[-1], router.shape[1]
    buckets, dest, keep, gate_sorted, order, lb_loss = _route(
        x.reshape(-1, n, d), router, k, cap)
    g = buckets.shape[0]
    return (buckets.reshape(g, E, cap, d), dest, keep, gate_sorted, order,
            lb_loss * (g / groups))


def _combine_rows(ye: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
                  gate_sorted: torch.Tensor, order: torch.Tensor, k: int,
                  T: int, dtype: torch.dtype) -> torch.Tensor:
    """`_gather_combine` of a data rank's groups from their expert outputs
    ``ye`` (g, E, cap, d), for `group_local`: the rank's rows (b, T, d)."""
    g, E, cap, d = ye.shape
    return _gather_combine(ye.reshape(g, E * cap, d), dest, keep,
                           gate_sorted, order, k, dtype).reshape(-1, T, d)


def _gather_combine(ye: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
                    gate_sorted: torch.Tensor, order: torch.Tensor, k: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Each routed place's expert output ``ye`` (G, E * cap, d) gathered
    and gated, then `_combine`d per token in ``dtype``. Returns (G, n,
    d)."""
    d = ye.shape[-1]
    safe_dest = torch.clamp(dest, max=ye.shape[1] - 1)        # trash masked
    weight = (gate_sorted * keep)[..., None].to(ye.dtype)
    contrib = (torch.gather(ye, 1, safe_dest[..., None].expand(-1, -1, d))
               * weight).to(dtype)
    return _combine(contrib, order, k)
