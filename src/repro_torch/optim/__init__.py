"""Optimizers and learning-rate schedules as functional (init, update)
pairs over trees of tensors (`repro_torch.tree`), with the JAX package's
math."""
from repro_torch.optim.optimizers import (Optimizer, adafactor, adam, adamw,
                                          apply_updates, clip_by_global_norm,
                                          global_norm, make_optimizer, sgd)
from repro_torch.optim.schedule import cosine_warmup

__all__ = ["Optimizer", "adafactor", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "cosine_warmup", "global_norm",
           "make_optimizer", "sgd"]
