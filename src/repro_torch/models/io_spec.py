"""Input specifications per (architecture x shape), the counterpart of
`repro.models.io_spec`: the batches `lm.loss_fn`, `lm.prefill` and
`lm.decode_step` take, as trees of ``meta`` tensors (shape and type, no
memory) in place of ``jax.ShapeDtypeStruct``, and `materialize` to draw
them.

Shape semantics:
  train    -> loss_fn batch  {tokens, targets [, frames | patches]}
  prefill  -> prefill batch  {tokens [, frames | patches]}
  decode   -> decode_step    (tokens (B, 1), cache with len = seq_len)

Modality stubs: whisper gets precomputed frame embeddings (B, S, d_model);
llava gets patch embeddings for ``vision_patch_frac`` of the sequence.
Encoder-decoder: prefill runs the encoder over seq_len frames plus a
seq_len // 8-token decoder prefill; decode attends a seq_len self-cache and
a min(seq_len, 4096)-frame encoder output.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.tree import tree_flatten_with_paths, tree_unflatten_like


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_spec(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        return {"frames": _spec((B, S, cfg.d_model), torch.bfloat16),
                "tokens": _spec((B, S), torch.int32),
                "targets": _spec((B, S), torch.int32)}
    if cfg.frontend == "vision_stub":
        n_patch = int(S * cfg.vision_patch_frac)
        return {"patches": _spec((B, n_patch, cfg.d_model), torch.bfloat16),
                "tokens": _spec((B, S - n_patch), torch.int32),
                "targets": _spec((B, S - n_patch), torch.int32)}
    return {"tokens": _spec((B, S), torch.int32),
            "targets": _spec((B, S), torch.int32)}


def prefill_batch_spec(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        return {"frames": _spec((B, S, cfg.d_model), torch.bfloat16),
                "tokens": _spec((B, max(S // 8, 1)), torch.int32)}
    if cfg.frontend == "vision_stub":
        n_patch = int(S * cfg.vision_patch_frac)
        return {"patches": _spec((B, n_patch, cfg.d_model), torch.bfloat16),
                "tokens": _spec((B, S - n_patch), torch.int32)}
    return {"tokens": _spec((B, S), torch.int32)}


def decode_spec(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """(tokens spec, cache spec): the cache is `lm.init_cache` on the
    ``meta`` device, so nothing is allocated."""
    B, S = shape.global_batch, shape.seq_len
    enc_len = min(S, 4096) if cfg.is_encoder_decoder else 0
    cache = lm.init_cache(cfg, B, S, device="meta", enc_len=enc_len)
    return _spec((B, 1), torch.int32), cache


def materialize(spec, seed: int = 0, device=None):
    """A spec tree as tensors on ``device`` (the CUDA device unless given),
    drawn as the JAX package draws them: one numpy generator from
    ``seed``, the leaves taken in JAX's order (dict keys sorted: a whisper
    train batch draws frames, targets, then tokens), integers uniform in
    [0, 64), floats 0.02 x standard normal, each cast to its leaf's type
    (bit for bit with JAX's)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    leaves = []
    for _, s in tree_flatten_with_paths(spec):
        if s.dtype.is_floating_point:
            a = torch.from_numpy(rng.standard_normal(tuple(s.shape)) * 0.02)
        else:
            a = torch.from_numpy(rng.integers(0, 64, tuple(s.shape)))
        leaves.append(a.to(dtype=s.dtype).to(device))
    return tree_unflatten_like(spec, leaves)
