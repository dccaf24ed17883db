"""Learning-rate schedules (callables of the step)."""
from __future__ import annotations

import math

import torch


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """lr(step): linear warmup to ``peak_lr`` over ``warmup_steps``, then a
    cosine decay to ``final_frac * peak_lr`` at ``total_steps``; an f32
    tensor on the step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr
