"""Language models of the port: the dense attention family (GQA, RoPE,
swiglu or gelu FFNs, or the spiking FFN), its MoE variants (dense and MoE
FFN layers interleaved, as llama4-maverick's super-block; leading dense
layers and multi-head latent attention, as deepseek-v2-lite), the hybrid
Mamba/attention stacks (jamba's super-block of 7 Mamba layers and one
attention layer, MoE every 2), the RWKV family, the encoder-decoder family
(whisper: an encoder over stub frame embeddings, sinusoidal positions,
cross-attention in every decoder layer) and the vision-stub family
(llava: stub patch embeddings ahead of the text tokens).

The functional API of `repro.models.lm`, for every family:

  init_params(seed, cfg)                        -> params tree
  loss_fn(params, batch, cfg, parallel)         -> (loss, aux)      [train]
  prefill(params, batch, cfg, max_len, parallel, length)
                                                -> (logits_last, cache)
  decode_step(params, tokens, cache, cfg)       -> (logits, cache)  [serve]
  init_cache(cfg, batch, max_len, enc_len=)     -> cache tree
  params_from_jax(tree)                         -> the JAX package's params
                                                   (or cache) as torch tensors

Params and caches are nested dicts of tensors laid out as the JAX package's
pytrees: every block leaf is stacked over the layer stack's super-blocks
under ``params["blocks"]["pos<j>"]``, j the layer's place in its
super-block. A super-block is one layer for the dense and RWKV families and
``lcm(attn_layer_period, moe.every)`` layers for a MoE or hybrid stack
(llama4: a dense layer, then a MoE layer; jamba: 8 layers, attention at
place 4 and Mamba elsewhere, MoE at the odd places). A MoE's
``first_k_dense`` leading dense layers (deepseek's prelude) come before
the body, unstacked, as the list
``params["prelude"]`` (and ``cache["prelude"]``); body layer j of
super-block s is global layer ``n_prelude + s * period + j``. The stack is
a Python loop over the prelude, then over the stacked leaves in place of
``lax.scan``; in the loss, with ``parallel.remat`` set and grad mode on,
each super-block (not a prelude layer, as in JAX) runs under
`torch.utils.checkpoint.checkpoint` (the JAX package's ``jax.checkpoint``
per super-block), and RWKV's wkv recurrence takes the differentiable
chunked form. The serving paths take neither. The MoE layers' load-balance
aux adds to the loss's aux, as in the JAX package. The attention cache is
written in place: prefill fills the cache it allocates, and a decode step
writes each lane's new K and V (MLA: its latent row, ``cache["latent"]``
(B, max_len, r + rope)) into the caller's cache tensors, which the new
cache keeps. The recurrent caches (RWKV's, and a Mamba layer's conv window
and float32 SSM state) are returned as new tensors; prefill starts them
from the cache's state.

An encoder-decoder config (whisper) adds ``params["encoder"]`` (its
``blocks`` stacked over ``n_encoder_layers``: norm1, MHA, norm2, FFN; and
its ``final_norm``) and, in every decoder block, ``cross`` (MHA) and
``norm_cross`` after ``attn``. Its batches carry ``frames`` (B, S, d), the
encoder's input; prefill runs the encoder once and keeps its output as
``cache["enc_out"]`` (B, S, d), which every decode step cross-attends,
recomputing the cross K and V from it as the JAX package does. A
vision-stub config (llava) takes an optional ``patches`` (B, P, d) ahead
of the tokens: the positions, ``cache["len"]`` and prefill's ``length``
count the patches, and the loss reads the text positions only. A stack
with non-attention layers and no ``cfg.ssm`` raises JAX's `ValueError`;
a family the JAX package does not model raises `NotImplementedError`.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.dist.sharding import (cache_zeros, check_layer_sliceable,
                                      constrain, local_lookup, pick_last,
                                      placed_as, put_prefix, recomputed,
                                      shards_all, split_heads, splits_last,
                                      whole_axis)
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import rwkv as R
from repro_torch.models import spiking_ffn as S


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts (and lists) of equal
    structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


LM_FAMILIES = ("dense", "moe", "hybrid", "audio", "vlm")


def check_family(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` unless ``cfg`` is an RWKV model, a dense
    attention stack (with or without the spiking FFN), a MoE stack (with
    or without leading dense layers), a hybrid stack, an encoder-decoder
    (audio) or a vision-stub (vlm) model, with GQA or MLA; raise the JAX
    package's `ValueError` for non-attention (Mamba) layers without
    ``cfg.ssm``."""
    if cfg.rwkv is not None:
        return
    if cfg.family not in LM_FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch_id}: family {cfg.family!r} is not a language model "
            f"family of the JAX package's lm ({', '.join(LM_FAMILIES)}, "
            "and RWKV)")
    if cfg.ssm is None and not all(cfg.is_attention_layer(i)
                                   for i in range(cfg.n_layers)):
        raise ValueError(f"{cfg.arch_id}: ssm layer kind requested but "
                         "cfg.ssm is unset")


# ---------------------------------------------------------------------------
# structure helpers
# ---------------------------------------------------------------------------

def super_period(cfg: ModelConfig) -> int:
    """Layers per super-block: the least common multiple of the attention
    period and the MoE interleave (1 for the dense and RWKV families, 2 for
    llama4's dense/MoE alternation, 8 for jamba's)."""
    p = cfg.attn_layer_period
    if cfg.moe is not None and cfg.moe.n_experts:
        p = math.lcm(p, cfg.moe.every)
    return p


def n_prelude(cfg: ModelConfig) -> int:
    """Leading layers outside the stacked super-blocks: a MoE's
    ``first_k_dense`` dense layers (deepseek's first layer)."""
    if cfg.moe is not None and cfg.moe.first_k_dense:
        return cfg.moe.first_k_dense
    return 0


def n_super(cfg: ModelConfig) -> int:
    check_family(cfg)
    body = cfg.n_layers - n_prelude(cfg)
    sp = super_period(cfg)
    if body % sp != 0:
        raise ValueError(
            f"{cfg.arch_id}: {body} body layers do not divide into "
            f"super-blocks of period {sp}")
    return body // sp


def layer_kind(cfg: ModelConfig, idx: int) -> tuple[str, str]:
    """(mixer, ffn) kinds of global layer ``idx``: mixer ``rwkv``,
    ``attn`` or ``ssm`` (Mamba), FFN ``none`` (RWKV), ``spiking``,
    ``moe`` or ``dense``."""
    if cfg.rwkv is not None:
        return "rwkv", "none"
    mixer = "attn" if cfg.is_attention_layer(idx) else "ssm"
    if cfg.spiking is not None:
        return mixer, "spiking"
    return mixer, "moe" if cfg.is_moe_layer(idx) else "dense"


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(gen, cfg: ModelConfig, idx: int, dtype) -> dict:
    mixer, f = layer_kind(cfg, idx)
    dev = L.gen_device(gen)
    d = cfg.d_model
    p: dict = {"norm1": torch.ones((d,), dtype=dtype, device=dev)}
    if mixer == "rwkv":
        p["rwkv"] = R.init_rwkv_block(gen, cfg, dtype)
    elif mixer == "ssm":
        p["ssm"] = M.init_mamba_block(gen, cfg, dtype)
    elif cfg.mla is not None:
        p["attn"] = L.init_mla(gen, cfg, dtype=dtype)
    else:
        p["attn"] = L.init_attention(gen, cfg, dtype=dtype)
    if mixer == "attn" and cfg.is_encoder_decoder:
        p["cross"] = L.init_attention(gen, cfg, cross=True, dtype=dtype)
        p["norm_cross"] = torch.ones((d,), dtype=dtype, device=dev)
    p["norm2"] = torch.ones((d,), dtype=dtype, device=dev)
    if f == "moe":
        p["moe"] = L.init_moe(gen, cfg, dtype)
    elif f == "spiking":
        p["ffn"] = S.init_spiking_ffn(gen, d, cfg.d_ff, dtype)
    elif f == "dense":
        d_ff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.dense_d_ff:
            d_ff = cfg.moe.dense_d_ff
        p["ffn"] = L.init_ffn(gen, d, d_ff, cfg.ffn_type, dtype)
    return p


def _init_encoder_block(gen, cfg: ModelConfig, dtype) -> dict:
    """An encoder layer: norm1, MHA self-attention, norm2, the FFN."""
    dev = L.gen_device(gen)
    d = cfg.d_model
    return {"norm1": torch.ones((d,), dtype=dtype, device=dev),
            "attn": L.init_attention(gen, cfg, cross=True, dtype=dtype),
            "norm2": torch.ones((d,), dtype=dtype, device=dev),
            "ffn": L.init_ffn(gen, d, cfg.d_ff, cfg.ffn_type, dtype)}


def _draw_block_(gen, cfg: ModelConfig, idx: Optional[int], dtype,
                 slot: dict) -> None:
    """Draw layer ``idx`` (None: an encoder layer) into ``slot``, its view
    of the stacked block leaves, with the draws `_init_block` (or
    `_init_encoder_block`) makes in its order: the norms (``norm_cross``
    too) are ones, every attention, cross-attention, dense-FFN and MoE
    weight is a `dense_init` of its leaf drawn in place (the experts one
    expert at a time), and the RWKV, Mamba and spiking-FFN leaves are
    drawn by their own init and copied (a Mamba block's constant leaves,
    ``a_log``, ``dt_bias``, ``d_skip`` and ``conv_b``, are not draws)."""
    f = "dense" if idx is None else layer_kind(cfg, idx)[1]
    for key, sub in slot.items():                   # _init_block's order
        if key in ("norm1", "norm_cross", "norm2"):
            sub.fill_(1)
        elif key == "rwkv":
            tree_map(torch.Tensor.copy_, sub,
                     R.init_rwkv_block(gen, cfg, dtype))
        elif key == "ssm":
            tree_map(torch.Tensor.copy_, sub,
                     M.init_mamba_block(gen, cfg, dtype))
        elif key == "ffn" and f == "spiking":
            tree_map(torch.Tensor.copy_, sub,
                     S.init_spiking_ffn(gen, cfg.d_model, cfg.d_ff, dtype))
        else:                                   # attn, cross, ffn, moe
            tree_map(lambda a: L.dense_draw_(gen, a), sub)


def init_params(seed: int, cfg: ModelConfig, dtype=torch.bfloat16,
                device=None) -> dict:
    """Random parameters from ``seed``, drawn on ``device`` (the CUDA
    device unless given) by one `torch.Generator` there: the embedding,
    the head, the prelude layers, the stacked body, then an
    encoder-decoder's stacked encoder layers, as the JAX package orders
    them. The prelude's and the stacked block leaves are allocated first
    and each layer is drawn straight into its slot (`_draw_block_`), so
    the peak memory is the model plus the float32 draw of one weight (of
    one expert, for a MoE leaf). On ``device="meta"`` the same code gives
    the tree's shapes and types without drawing."""
    device = resolve_device(device)
    n = n_super(cfg)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    d = cfg.d_model
    params: dict = {
        "embed": (L.normal(gen, (cfg.vocab_size, d)) * 0.02).to(dtype),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (d, cfg.vocab_size), dtype=dtype)
    off = n_prelude(cfg)
    if off:
        params["prelude"] = [tree_map(
            lambda a: torch.empty(a.shape, dtype=a.dtype, device=device),
            _init_block(None, cfg, i, dtype)) for i in range(off)]
        if gen is not None:
            for i, slot in enumerate(params["prelude"]):
                _draw_block_(gen, cfg, i, dtype, slot)
    sp = super_period(cfg)
    shape = {f"pos{j}": _init_block(None, cfg, off + j, dtype)
             for j in range(sp)}
    blocks = tree_map(lambda a: torch.empty((n,) + a.shape, dtype=a.dtype,
                                            device=device), shape)
    if gen is not None:
        for s in range(n):
            for j in range(sp):
                _draw_block_(gen, cfg, off + s * sp + j, dtype,
                             tree_map(lambda full: full[s], blocks[f"pos{j}"]))
    params["blocks"] = blocks
    if cfg.is_encoder_decoder:
        n_enc = cfg.n_encoder_layers
        enc = tree_map(lambda a: torch.empty((n_enc,) + a.shape,
                                             dtype=a.dtype, device=device),
                       _init_encoder_block(None, cfg, dtype))
        if gen is not None:
            for i in range(n_enc):
                _draw_block_(gen, cfg, None, dtype,
                             tree_map(lambda full: full[i], enc))
        params["encoder"] = {
            "blocks": enc,
            "final_norm": torch.ones((d,), dtype=dtype, device=device)}
    return params


def params_from_jax(tree, device=None):
    """A JAX params (or cache) pytree, its leaves as numpy arrays (bf16
    leaves as ``ml_dtypes.bfloat16``), as the port's tree of tensors on
    ``device`` (the CUDA device unless given), with the same nesting,
    blocks stacked over super-blocks as they are there."""
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t.to(device)
    return tree_map(leaf, tree)


# ---------------------------------------------------------------------------
# block application (shared by prefill / decode)
# ---------------------------------------------------------------------------

def _norm(x, w, cfg: ModelConfig):
    """RMS norm. Its output feeds projections that read every position, so
    under sequence parallelism the sequence is gathered here (Megatron's
    all-gather after the sequence-parallel norm; DTensor cannot flatten a
    sequence-sharded activation into a product's rows); the identity
    without active rules."""
    return constrain(L.rms_norm(x, w, cfg.norm_eps), ("batch", None, None))


def _residual(x, h):
    """``x + h`` in ``x``'s type. Under a mesh ``h``, a projection's
    output, is pinned to (batch, ...) first, so the gradient it takes from
    the sequence-sharded residual stream is gathered before the
    projection's backward reads it (DTensor cannot flatten a
    sequence-sharded gradient into the product's rows); the identity
    without active rules."""
    return x + constrain(h, ("batch", None, None)).to(x.dtype)


def _apply_rwkv(x, p, cfg: ModelConfig, cache: Optional[dict], decode: bool,
                wkv_chunk: int = 0):
    """One RWKV layer. Returns (x, new_cache_entry). ``wkv_chunk`` > 0
    runs the recurrence through the differentiable chunked form in chunks
    of that length (the loss); 0 through the kernel."""
    h_in = _norm(x, p["norm1"], cfg)
    st = (None if cache is None
          else {"shift": cache["shift_tm"], "wkv": cache["wkv"]})
    if decode:
        h, st = R.time_mix_decode(h_in, p["rwkv"]["tm"], cfg, st)
    elif wkv_chunk:
        h, st = R.time_mix(h_in, p["rwkv"]["tm"], cfg, st, use_kernel=False,
                           chunk=wkv_chunk)
    else:
        h, st = R.time_mix(h_in, p["rwkv"]["tm"], cfg, st)
    x = _residual(x, h)
    h, shift_cm = R.channel_mix(_norm(x, p["norm2"], cfg), p["rwkv"]["cm"],
                                None if cache is None else cache["shift_cm"],
                                decode=decode)
    x = _residual(x, h)
    return x, {"shift_tm": st["shift"], "wkv": st["wkv"], "shift_cm": shift_cm}


def _apply_block(x, p, cfg: ModelConfig, idx: int, positions, *,
                 cache: Optional[dict], pos=None, enc_out=None,
                 parallel: Optional[ParallelConfig] = None,
                 train: bool = False):
    """One layer. Returns (x, new_cache_entry, aux): aux is the spiking
    FFN's mean spike rate or the MoE FFN's load-balance loss (0
    otherwise). Decode (the one-token update) when a cache and ``pos`` are
    given and T == 1; prefill writes the prompt's K and V (MLA: its latent)
    into ``cache`` in place, and a Mamba layer's prefill starts from the
    cache's conv and SSM state. An encoder-decoder's attention layer then
    cross-attends ``enc_out`` (B, S, d) through ``cross`` (full, unmasked
    attention over K and V projected from it, in train, prefill and
    decode alike). ``train``: the loss's pass, where RWKV takes the
    differentiable wkv6 form in chunks of ``parallel.wkv_chunk``."""
    mixer, f = layer_kind(cfg, idx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    decode = cache is not None and x.shape[1] == 1 and pos is not None
    if mixer == "rwkv":
        chunk = (parallel or ParallelConfig()).wkv_chunk if train else 0
        x, new_cache = _apply_rwkv(x, p, cfg, cache, decode, chunk)
        return x, new_cache, aux

    h_in = _norm(x, p["norm1"], cfg)
    if mixer == "ssm":
        st = (None if cache is None
              else {"conv": cache["conv"], "ssm": cache["ssm"]})
        if decode:
            h, new_cache = M.mamba_decode(h_in, p["ssm"], cfg, st)
        else:
            h, new_cache = M.mamba_forward(
                h_in, p["ssm"], cfg, st,
                constraints=parallel.state_constraints if parallel else False)
    elif cfg.mla is not None:
        h, latent = L.mla_attention(
            h_in, p["attn"], cfg, positions,
            latent_cache=cache["latent"] if decode else None,
            pos=pos if decode else None)
        new_cache = None
        if cache is not None:
            if not decode:                          # prefill: fill the cache
                put_prefix(cache["latent"], latent)
            new_cache = {"latent": cache["latent"]}
    elif decode:
        h, new_cache = L.attention_decode(
            h_in, p["attn"], cfg, {"k": cache["k"], "v": cache["v"]}, pos)
    else:
        parallel = parallel or ParallelConfig()
        h = L.attention(h_in, p["attn"], cfg, positions,
                        q_chunk=parallel.attn_q_chunk,
                        kv_block=parallel.attn_kv_block)
        new_cache = None
        if cache is not None:                       # prefill: fill the cache
            hd = cfg.head_dim
            k = split_heads(h_in @ p["attn"]["wk"], hd)
            v = split_heads(h_in @ p["attn"]["wv"], hd)
            if cfg.rope_theta > 0:
                k = L.apply_rope(k, positions, cfg.rope_theta)
            put_prefix(cache["k"], k)
            put_prefix(cache["v"], v)
            new_cache = {"k": cache["k"], "v": cache["v"]}
    x = _residual(x, h)
    if mixer == "attn" and cfg.is_encoder_decoder and enc_out is not None:
        h = L.attention(_norm(x, p["norm_cross"], cfg), p["cross"], cfg,
                        positions, causal=False, kv_x=enc_out)
        x = _residual(x, h)

    h_in = _norm(x, p["norm2"], cfg)
    if f == "moe":
        h, lb = L.moe_ffn(h_in, p["moe"], cfg,
                          constraints=(parallel.moe_constraints if parallel
                                       else False))
        aux = aux + lb
    elif f == "spiking":
        h, rate = S.spiking_ffn(h_in, p["ffn"], cfg)
        aux = aux + rate
    else:
        h = L.ffn(h_in, p["ffn"], cfg.ffn_type)
    x = _residual(x, h)
    return x, new_cache, aux


def _unstack(tree, n: int) -> list:
    """The n per-layer trees of a tree of stacked leaves, each leaf
    `unbind` once: the gradient of the n slices is one stack of theirs,
    where n separate indexings would each add a zero tensor of the whole
    stack in the backward pass (a cost quadratic in depth). A stack
    sharded on its layer axis is gathered once first (`whole_axis`)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][s] for k in tree} for s in range(n)]
    return list(whole_axis(tree).unbind(0))


def _run_stack(params, x, cfg: ModelConfig, positions, *, cache=None,
               pos=None, enc_out=None,
               parallel: Optional[ParallelConfig] = None,
               train: bool = False):
    """The layer stack: the prelude layers, then a loop over the stacked
    super-block leaves, every layer given ``enc_out`` (an
    encoder-decoder's encoder output, or None). Returns (x, new_cache, aux
    summed over layers). A cache leaf that every layer updated in place is
    the same tensor in the new cache; any other is stacked anew from the
    layers' entries.
    ``train`` (the loss's pass, no cache): with ``parallel.remat`` other
    than ``"none"`` and grad mode on, each super-block is recomputed in the
    backward pass instead of keeping its activations (``"block"`` and
    ``"full"`` alike, as in the JAX package)."""
    parallel = parallel or ParallelConfig()
    sp = super_period(cfg)
    off = n_prelude(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    cache_blocks = None if cache is None else cache["blocks"]
    if cache_blocks is not None:
        check_layer_sliceable(cache_blocks)
    remat = train and parallel.remat != "none" and torch.is_grad_enabled()

    new_pre = []
    for i, p in enumerate(params.get("prelude", [])):
        x, c_new, aux = _apply_block(
            x, p, cfg, i, positions,
            cache=None if cache is None else cache["prelude"][i], pos=pos,
            enc_out=enc_out, parallel=parallel, train=train)
        new_pre.append(c_new)
        aux_total = aux_total + aux

    def super_block(x, aux_total, p_s, c_s, s, enc_out):
        # boundary activations: batch over data, seq over model (sequence
        # parallelism); the identity without active rules
        x = constrain(x, ("batch", "seq", None))
        c_new = {}
        for j in range(sp):
            x, c_new[f"pos{j}"], aux = _apply_block(
                x, p_s[f"pos{j}"], cfg, off + s * sp + j, positions,
                cache=None if c_s is None else c_s[f"pos{j}"], pos=pos,
                enc_out=enc_out, parallel=parallel, train=train)
            aux_total = aux_total + aux
        return x, aux_total, c_new

    def block_of(x, aux_total, p_s, s, enc_out):
        return super_block(x, aux_total, p_s, None, s, enc_out)[:2]

    olds, news = [], []
    per_block = _unstack(params["blocks"], n_super(cfg))
    for s in range(n_super(cfg)):
        p_s = per_block[s]
        c_s = (None if cache_blocks is None
               else tree_map(lambda a: a[s], cache_blocks))
        if remat:
            x, aux_total = recomputed(block_of, x, aux_total, p_s, s,
                                      enc_out)
            continue
        x, aux_total, c_new = super_block(x, aux_total, p_s, c_s, s, enc_out)
        olds.append(c_s)
        news.append(c_new)
    new_cache = None
    if cache is not None:
        n = len(news)

        def restack(full, *entries):
            if all(new is old for old, new in zip(entries[:n], entries[n:])):
                return full
            # a leaf made anew (a recurrent state) keeps the cache's layout
            return placed_as(torch.stack(entries[n:]), full)
        new_cache = dict(cache)
        new_cache["blocks"] = tree_map(restack, cache_blocks, *olds, *news)
        if new_pre:
            new_cache["prelude"] = new_pre
    return x, new_cache, aux_total


def _run_encoder(params, frames, cfg: ModelConfig,
                 parallel: Optional[ParallelConfig] = None,
                 train: bool = False):
    """The encoder over stub frame embeddings ``frames`` (B, S, d): the
    sinusoidal table added in the frames' type, then each stacked layer
    (unmasked self-attention without RoPE, the blocked form when
    ``parallel.attn_q_chunk`` is set, then the FFN, both pre-norm and
    residual), then ``final_norm``. ``train`` with ``parallel.remat``
    other than ``"none"`` and grad mode on: each layer is recomputed in
    the backward pass (JAX's ``jax.checkpoint`` per encoder layer)."""
    parallel = parallel or ParallelConfig()
    enc = params["encoder"]
    S = frames.shape[1]
    x = frames + L.sinusoidal_positions(S, cfg.d_model).to(
        device=frames.device, dtype=frames.dtype)[None]
    positions = torch.arange(S, device=frames.device)[None]

    def layer(x, p):
        h = L.attention(_norm(x, p["norm1"], cfg), p["attn"], cfg, positions,
                        causal=False, use_rope=False,
                        q_chunk=parallel.attn_q_chunk,
                        kv_block=parallel.attn_kv_block)
        # each projection's output pinned as `_residual` pins it (in its
        # own type; the identity without active rules)
        x = x + constrain(h, ("batch", None, None))
        h = L.ffn(_norm(x, p["norm2"], cfg), p["ffn"], cfg.ffn_type)
        return x + constrain(h, ("batch", None, None))

    remat = train and parallel.remat != "none" and torch.is_grad_enabled()
    for p in _unstack(enc["blocks"], cfg.n_encoder_layers):
        x = recomputed(layer, x, p) if remat else layer(x, p)
    return _norm(x, enc["final_norm"], cfg)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def _embed_inputs(params, batch: dict, cfg: ModelConfig):
    """tokens (B, T) and the modality stubs -> (x, positions (1, T'),
    enc_src). An encoder-decoder adds the sinusoidal table to the token
    embeddings and returns ``batch["frames"]`` as ``enc_src`` (a batch
    without frames raises JAX's `KeyError`); a vision-stub config puts
    ``batch["patches"]`` (B, P, d), cast to the embeddings' type, ahead of
    the tokens (T' = P + T) when the batch has them; ``enc_src`` is None
    otherwise."""
    check_family(cfg)
    embed, tokens = params["embed"], batch["tokens"]
    if isinstance(embed, DTensor):
        # each rank looks up its own rows in the gathered table
        x = local_lookup(embed, tokens)
    else:
        x = embed[tokens]
    if cfg.is_encoder_decoder:
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model).to(
            device=x.device, dtype=x.dtype)[None]
        positions = torch.arange(x.shape[1], device=x.device)[None]
        return x, positions, batch["frames"]
    if cfg.frontend == "vision_stub" and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    return x, positions, None


def _head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _placed_head(params, cfg: ModelConfig):
    """The loss's head under a mesh whose model axis splits the
    vocabulary: gathered to its whole ``d`` with the vocabulary over
    model (XLA's FSDP gathers it so), once a step, so each rank's product
    is its own batch rows by its own vocabulary columns, with no partial
    sums, and its backward computes only those columns. None without
    active rules, or where the vocabulary does not split (a whole head on
    every rank would multiply its flops): the loss then reads the head as
    `_logits` does."""
    head = _head(params, cfg)
    if not shards_all((None, "vocab"), tuple(head.shape)):
        return None
    return constrain(head, (None, "vocab"))


def _logits(params, x, cfg: ModelConfig, head=None):
    """``x`` times the float32 head (``head``, else the params' own)."""
    head = _head(params, cfg) if head is None else head
    return x.float() @ head.float()


def _token_nll(lg, targets):
    """``-log_softmax(lg)`` at each target. Under a mesh whose model axis
    splits the vocabulary (`sharding.splits_last`), the log-sum-exp
    reduces over it (a max and a sum a token, all-reduced) and each rank
    picks the targets in its own columns (`sharding.pick_last`), as XLA
    partitions the reductions: no rank gathers the (rows, vocab) logits,
    and their gradient comes back on each rank's own columns. Otherwise
    torch's ``log_softmax`` and ``gather``."""
    if not splits_last(lg):
        lp = torch.log_softmax(lg, dim=-1)
        return -torch.gather(lp, -1, targets[..., None])[..., 0]
    z = lg - lg.amax(-1, keepdim=True).detach()
    rows = ("batch", None)
    return (torch.log(constrain(torch.exp(z).sum(-1), rows))
            - constrain(pick_last(z, targets), rows))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def loss_fn(params, batch: dict, cfg: ModelConfig,
            parallel: Optional[ParallelConfig] = None):
    """Causal-LM (or encoder-decoder) cross entropy. batch: ``tokens`` and
    ``targets`` (B, T) (integer arrays or tensors), and an
    encoder-decoder's ``frames`` (B, S, d) or a vision-stub model's
    ``patches`` (B, P, d) (tensors, or float arrays); the encoder runs
    first, and with patches only the T text positions are scored. The
    logits head runs in float32, then
    `log_softmax`; with ``parallel.vocab_chunking`` = n > 1 the head and
    the cross entropy run over n sequence chunks, each recomputed in the
    backward pass, so one (B, T/n, vocab) logits buffer is live at a time
    (n must divide T). Returns (loss, {"ce", "aux"}) with loss = ce +
    0.01 * aux, aux the spiking FFNs' spike rates or the MoE FFNs'
    load-balance losses summed over layers (0 for the other FFNs)."""
    parallel = parallel or ParallelConfig()
    device = params["embed"].device
    batch = {k: (torch.as_tensor(v, device=device).long()
                 if k in ("tokens", "targets")
                 else torch.as_tensor(v, device=device))
             for k, v in batch.items()}
    x, positions, enc_src = _embed_inputs(params, batch, cfg)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = _run_encoder(params, enc_src, cfg, parallel, train=True)
    x, _, aux = _run_stack(params, x, cfg, positions, enc_out=enc_out,
                           parallel=parallel, train=True)
    x = _norm(x, params["final_norm"], cfg)
    if cfg.frontend == "vision_stub" and "patches" in batch:
        x = x[:, batch["patches"].shape[1]:]        # text positions only
    targets = batch["targets"]
    n_chunks = max(parallel.vocab_chunking, 1)
    B, T, _ = x.shape
    if T % n_chunks != 0:
        raise ValueError(f"vocab_chunking={n_chunks} must divide the "
                         f"sequence length, got T={T}")

    head = _placed_head(params, cfg)

    def ce(xc, tc):
        lg = constrain(_logits(params, xc, cfg, head),
                       ("batch", None, "vocab"))
        return _token_nll(lg, tc)

    if n_chunks == 1:
        losses = ce(x, targets)
    else:
        step = T // n_chunks
        parts = [(x[:, i * step:(i + 1) * step],
                  targets[:, i * step:(i + 1) * step])
                 for i in range(n_chunks)]
        if torch.is_grad_enabled():
            losses = torch.cat([recomputed(ce, xc, tc) for xc, tc in parts],
                               dim=1)
        else:
            losses = torch.cat([ce(xc, tc) for xc, tc in parts], dim=1)
    mean = losses.mean()
    loss = mean + 0.01 * aux
    return loss, {"ce": mean, "aux": aux}


def _cache_entry(cfg: ModelConfig, idx: int, batch: int, max_len: int,
                 dtype, device) -> dict:
    """Layer ``idx``'s serving cache: RWKV's token-shift carries and wkv
    state, a Mamba layer's conv window and SSM state, MLA's (B, max_len,
    r + rope) latent, or the attention layer's (B, max_len, KV, D) K and
    V."""
    mixer, _ = layer_kind(cfg, idx)
    if mixer == "rwkv":
        return R.init_rwkv_state(cfg, batch, dtype, device)
    if mixer == "ssm":
        return M.init_mamba_state(cfg, batch, dtype, device)
    if cfg.mla is not None:
        m = cfg.mla
        return {"latent": torch.zeros(
            (batch, max_len, m.kv_lora_rank + m.rope_head_dim), dtype=dtype,
            device=device)}
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None, enc_len: int = 0) -> dict:
    """Pre-allocated serving cache on ``device`` (the CUDA device unless
    given), of ``dtype`` (bf16 by default whatever the params' type, as in
    the JAX package), stacked over super-blocks, each place ``pos<j>``
    from its own layer's kind: per RWKV layer the token-shift carries (B,
    d) and the float32 wkv state (B, H, K, K), per Mamba layer the conv
    window (B, d_conv - 1, d_in) and the float32 SSM state (B, d_in, N),
    per attention layer K and V (B, max_len, KV, D) or MLA's latent (B,
    max_len, r + rope); the per-lane length; for a prelude a list of its
    layers' entries; and for an encoder-decoder the encoder output
    ``enc_out`` (B, enc_len, d). A recurrent cache does not grow with
    ``max_len``."""
    device = resolve_device(device)
    n = n_super(cfg)
    off = n_prelude(cfg)
    # a fresh entry per position: with one super-block the expand is
    # already contiguous and would share the entry's storage
    stacked = {f"pos{j}": tree_map(
        lambda a: a[None].expand((n,) + a.shape).contiguous(),
        _cache_entry(cfg, off + j, batch, max_len, dtype, device))
        for j in range(super_period(cfg))}
    cache = {"blocks": stacked,
             "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if off:
        cache["prelude"] = [_cache_entry(cfg, i, batch, max_len, dtype,
                                         device) for i in range(off)]
    if cfg.is_encoder_decoder:
        cache["enc_out"] = torch.zeros((batch, enc_len, cfg.d_model),
                                       dtype=dtype, device=device)
    return cache


def prefill(params, batch: dict, cfg: ModelConfig, max_len: int,
            parallel: Optional[ParallelConfig] = None, length=None):
    """Process the prompt ``batch["tokens"]`` (B, T) (an encoder-decoder's
    with its ``frames``, a vision-stub model's with its ``patches`` ahead
    of the tokens); return (last-token logits (B, vocab) float32,
    populated cache). An encoder-decoder runs the encoder here and keeps
    its output as ``cache["enc_out"]``.

    ``length`` (an int, or an integer tensor of one element on the tokens'
    device): the true prompt length when the tokens are right-padded to a
    bucket. The logits are read at position length - 1 (a tensor index,
    so one captured graph serves every length of its bucket) and
    ``cache["len"]`` is set to length. Exact for causal attention stacks:
    position length - 1 never attends the padding, and decode masks the
    padded K/V slots by ``kv_len`` and overwrites them as it advances. Not
    valid for recurrent mixers, whose state would integrate the padding;
    the engine gates on the config. With patches, T, ``length`` and
    ``cache["len"]`` count the patch positions too."""
    x, positions, enc_src = _embed_inputs(params, batch, cfg)
    B, T = x.shape[:2]
    enc_out = None
    enc_len = enc_src.shape[1] if cfg.is_encoder_decoder else 0
    cache = cache_zeros(lambda dev: init_cache(cfg, B, max_len, device=dev,
                                               enc_len=enc_len), x, cfg)
    if cfg.is_encoder_decoder:
        enc_out = _run_encoder(params, enc_src, cfg, parallel)
        cache["enc_out"] = enc_out
    x, cache, _ = _run_stack(params, x, cfg, positions, cache=cache,
                             enc_out=enc_out, parallel=parallel)
    x = _norm(x, params["final_norm"], cfg)
    if length is None:
        length = T
    n = torch.as_tensor(length, device=x.device).reshape(1).long()
    last = x.index_select(1, n - 1)
    logits = _logits(params, last, cfg)[:, 0]
    cache["len"] = n.to(torch.int32).expand(B).clone()
    return logits, cache


def decode_step(params, tokens: torch.Tensor, cache: dict, cfg: ModelConfig,
                parallel: Optional[ParallelConfig] = None):
    """One serving step: tokens (B, 1) -> (logits (B, vocab), cache'). The
    attention layers write their K and V (MLA: the latent) into
    ``cache``'s tensors in place. An encoder-decoder adds each lane's
    sinusoidal term at its position (`layers.sinusoidal_at`, computed on
    the device) and cross-attends ``cache["enc_out"]``."""
    pos = cache["len"]
    x = params["embed"][tokens]
    if cfg.is_encoder_decoder:
        x = x + L.sinusoidal_at(pos, cfg.d_model)[:, None].to(x.dtype)
    x, cache, _ = _run_stack(params, x, cfg, pos[:, None], cache=cache,
                             pos=pos, enc_out=cache.get("enc_out"),
                             parallel=parallel)
    x = _norm(x, params["final_norm"], cfg)
    logits = _logits(params, x, cfg)[:, 0]
    cache = dict(cache)
    cache["len"] = pos + 1
    return logits, cache
