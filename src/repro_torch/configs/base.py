"""Model, shape, parallelism and run configurations of the port: the model
config, the registry, `reduced_config`, and the run configs training reads.

The port's own copy of the fields of `repro.configs.base` that the RWKV
serving path and the train step read (it imports nothing of the JAX
package). The other families' sub-configs (MoE, MLA, SSM, encoder-decoder,
frontends) are not here: the port serves only the RWKV family so far, and
`models.lm` raises `NotImplementedError` for any other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64             # rwkv6 head size; n_heads = d_model // head_size


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm | snn
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    rwkv: Optional[RWKVConfig] = None


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


@dataclass(frozen=True)
class ParallelConfig:
    """The train step's batch policies. The JAX package's sharding and
    layout policies (fsdp, sequence and expert parallelism, remat, scanned
    layers, blocked attention) come with multi-GPU execution and LM
    training."""
    microbatches: int = 1           # gradient accumulation splits
    grad_compress: bool = False     # int8 wire format on the gradients


@dataclass(frozen=True)
class RunConfig:
    """What a train step runs: the model, its shape cell and the batch
    policies (the optimizer is built by the caller and passed beside it;
    the JAX package's optimizer fields serve its LM `init_train_state`)."""
    model: Any                      # a ModelConfig, an SNNModelConfig, or None
    shape: Optional[ShapeConfig]
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch id {cfg.arch_id}")
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


_LOADED = False


def _ensure_loaded() -> None:
    """Import every config module once so registration side-effects run."""
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.configs import rwkv6_7b  # noqa: F401


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to smoke-test size with the numbers of
    `repro.configs.base.reduced_config`: 2 layers, d_model 128, d_ff 256,
    vocab 512, and for RWKV 4 heads of size 32."""
    kw: dict = dict(
        n_layers=2,
        d_model=128,
        n_heads=4,
        d_ff=256,
        vocab_size=512,
    )
    if cfg.rwkv is not None:
        kw["rwkv"] = RWKVConfig(head_size=32)
    return dataclasses.replace(cfg, arch_id=cfg.arch_id + "-smoke", **kw)
