"""Language models of the port: the RWKV family.

The functional API of `repro.models.lm`, for the RWKV family only:

  init_params(seed, cfg)                        -> params tree
  prefill(params, batch, cfg, max_len)          -> (logits_last, cache)
  decode_step(params, tokens, cache, cfg)       -> (logits, cache)  [serve]
  init_cache(cfg, batch, max_len)               -> cache tree
  params_from_jax(tree)                         -> the JAX package's params
                                                   (or cache) as torch tensors

Params and caches are nested dicts of tensors laid out as the JAX package's
pytrees: every block leaf is stacked over the layer stack's super-blocks
(one RWKV layer each), under ``params["blocks"]["pos0"]``. The stack is a
Python loop over those stacked leaves in place of ``lax.scan``. Any other
family raises `NotImplementedError`: attention, MoE, Mamba, the spiking FFN,
encoder-decoder and the modality frontends, training (`loss_fn`) and the
parallelism config are not ported.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts (and lists) of equal
    structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def check_family(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` unless ``cfg`` is an RWKV model."""
    if cfg.rwkv is None:
        raise NotImplementedError(
            f"{cfg.arch_id}: the port runs the RWKV family only, not family "
            f"{cfg.family!r} (attention, MoE, Mamba and the other families "
            "are not ported)")


def n_super(cfg: ModelConfig) -> int:
    """Super-blocks of the stack: one RWKV layer each."""
    check_family(cfg)
    return cfg.n_layers


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d = cfg.d_model
    return {"norm1": torch.ones((d,), dtype=dtype, device=gen.device),
            "rwkv": R.init_rwkv_block(gen, cfg, dtype),
            "norm2": torch.ones((d,), dtype=dtype, device=gen.device)}


def init_params(seed: int, cfg: ModelConfig, dtype=torch.bfloat16,
                device=None) -> dict:
    """Random parameters from ``seed``, drawn on ``device`` (the CUDA
    device unless given) by one `torch.Generator` there. The block leaves
    are filled one super-block at a time into their stacked tensors, so the
    peak memory is the model plus one block."""
    device = resolve_device(device)
    n = n_super(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = cfg.d_model
    params: dict = {
        "embed": (torch.randn((cfg.vocab_size, d), generator=gen,
                              dtype=torch.float32, device=device)
                  * 0.02).to(dtype),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (d, cfg.vocab_size), dtype=dtype)
    blocks = None
    for s in range(n):
        block = {"pos0": _init_block(gen, cfg, dtype)}
        if blocks is None:
            blocks = tree_map(lambda a: torch.empty((n,) + a.shape,
                                                    dtype=a.dtype,
                                                    device=device), block)
        tree_map(lambda full, a: full[s].copy_(a), blocks, block)
    params["blocks"] = blocks
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
    return L.rms_norm(x, w, cfg.norm_eps)


def _apply_block(x, p, cfg: ModelConfig, *, cache: Optional[dict], pos=None):
    """One RWKV layer. Returns (x, new_cache_entry). Decode (the one-step
    state update) when a cache and ``pos`` are given and T == 1."""
    decode = cache is not None and x.shape[1] == 1 and pos is not None
    h_in = _norm(x, p["norm1"], cfg)
    if decode:
        st = {"shift": cache["shift_tm"], "wkv": cache["wkv"]}
        h, st = R.time_mix_decode(h_in, p["rwkv"]["tm"], cfg, st)
    else:
        h, st = R.time_mix(h_in, p["rwkv"]["tm"], cfg,
                           None if cache is None else
                           {"shift": cache["shift_tm"], "wkv": cache["wkv"]})
    x = x + h.to(x.dtype)
    h, shift_cm = R.channel_mix(_norm(x, p["norm2"], cfg), p["rwkv"]["cm"],
                                None if cache is None else cache["shift_cm"])
    x = x + h.to(x.dtype)
    return x, {"shift_tm": st["shift"], "wkv": st["wkv"], "shift_cm": shift_cm}


def _run_stack(params, x, cfg: ModelConfig, *, cache=None, pos=None):
    """The layer stack, a loop over the stacked super-block leaves.
    Returns (x, new_cache)."""
    cache_blocks = None if cache is None else cache["blocks"]
    new = []
    for s in range(n_super(cfg)):
        p_s = tree_map(lambda a: a[s], params["blocks"])
        c_s = (None if cache_blocks is None
               else tree_map(lambda a: a[s], cache_blocks))
        x, c_new = _apply_block(x, p_s["pos0"], cfg,
                                cache=None if c_s is None else c_s["pos0"],
                                pos=pos)
        new.append({"pos0": c_new})
    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["blocks"] = tree_map(lambda *xs: torch.stack(xs), *new)
    return x, new_cache


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def _embed_inputs(params, batch: dict, cfg: ModelConfig):
    """tokens (B, T) -> x (B, T, d). RWKV has no positional encoding."""
    check_family(cfg)
    return params["embed"][batch["tokens"]]


def _logits(params, x, cfg: ModelConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x.float() @ head.float()


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Pre-allocated serving cache on ``device`` (the CUDA device unless
    given): per super-block the token-shift carries (B, d) of ``dtype`` —
    bf16 by default whatever the params' type, as in the JAX package — and
    the float32 wkv state (B, H, K, K); and the per-lane length. A
    recurrent cache does not grow with ``max_len``."""
    device = resolve_device(device)
    n = n_super(cfg)
    entry = R.init_rwkv_state(cfg, batch, dtype, device)
    return {"blocks": {"pos0": tree_map(
                lambda a: a[None].expand((n,) + a.shape).contiguous(), entry)},
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill(params, batch: dict, cfg: ModelConfig, max_len: int):
    """Process the whole prompt ``batch["tokens"]`` (B, T); return
    (last-token logits (B, vocab) float32, populated cache). Exact length
    only: a recurrent state would integrate right-padding."""
    x = _embed_inputs(params, batch, cfg)
    cache = init_cache(cfg, x.shape[0], max_len, device=x.device)
    x, cache = _run_stack(params, x, cfg, cache=cache)
    x = _norm(x, params["final_norm"], cfg)
    logits = _logits(params, x[:, -1:], cfg)[:, 0]
    cache["len"] = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                              device=x.device)
    return logits, cache


def decode_step(params, tokens: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One serving step: tokens (B, 1) -> (logits (B, vocab), cache')."""
    pos = cache["len"]
    x = params["embed"][tokens]
    x, cache = _run_stack(params, x, cfg, cache=cache, pos=pos)
    x = _norm(x, params["final_norm"], cfg)
    logits = _logits(params, x, cfg)[:, 0]
    cache = dict(cache)
    cache["len"] = pos + 1
    return logits, cache
