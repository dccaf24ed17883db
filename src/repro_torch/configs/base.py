"""Model, shape, parallelism and run configurations of the port: the model
config, the registry, `reduced_config`, and the run configs training reads.

The port's own copy of the fields of `repro.configs.base` that the dense
attention family (GQA, RoPE, swiglu or gelu FFNs, the spiking FFN), the
MoE stacks (routed and shared experts interleaved with dense layers, and
deepseek's leading dense layers), multi-head latent attention (MLA), the
Mamba layers of a hybrid stack (jamba's SSM), the RWKV family, the
encoder-decoder family (whisper's encoder and cross-attention), the
modality frontend stubs (audio frames, vision patches) and the train step
read (it imports nothing of the JAX package). `ASSIGNED_ARCHS` and
`list_archs` name the language models, as the JAX package's do.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0              # routed experts (0 = dense)
    top_k: int = 1
    n_shared_experts: int = 0
    d_ff: int = 0                   # per-expert hidden dim
    every: int = 1                  # MoE on layers where (idx % every == every-1)
    first_k_dense: int = 0          # leading dense layers (deepseek style)
    dense_d_ff: int = 0             # ffn dim of the dense layers interleaved w/ MoE


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 = direct q projection (V2-Lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba block (Jamba's SSM layers)."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 256


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64             # rwkv6 head size; n_heads = d_model // head_size


@dataclass(frozen=True)
class SpikingConfig:
    """Neuron and number-format settings of a spiking network: the paper's
    SNNs and the spiking FFN of a language model."""
    neuron: str = "rmp"             # if | lif | rmp
    timesteps: int = 10
    threshold: float = 1.0
    leak: float = 0.0625
    w_bits: int = 6                 # paper: 6-bit signed weights
    v_bits: int = 11                # paper: 11-bit signed membrane potential


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm | snn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # attention on layers where idx % period == offset (period 1: all)
    attn_layer_period: int = 1
    attn_layer_offset: int = 0
    ffn_type: str = "swiglu"        # swiglu (3 mats) | gelu (2 mats)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    spiking: Optional[SpikingConfig] = None
    # encoder-decoder (whisper): decoder layers cross-attend the encoder's
    # output
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # modality frontend stubs
    frontend: str = "none"          # none | audio_stub | vision_stub
    vision_patch_frac: float = 0.25  # share of seq that is image patches

    def is_attention_layer(self, idx: int) -> bool:
        return idx % self.attn_layer_period == self.attn_layer_offset

    def is_moe_layer(self, idx: int) -> bool:
        if self.moe is None or self.moe.n_experts == 0:
            return False
        if idx < self.moe.first_k_dense:
            return False
        return idx % self.moe.every == self.moe.every - 1

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding, blocks, encoder and head),
        by the JAX package's formula: the norm1 and norm2 of every block
        but not ``final_norm``, the encoder's ``final_norm`` or a decoder
        block's ``norm_cross``, and a spiking FFN counted as its
        ``ffn_type``'s matrices."""
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return (n + sum(self._block_params(i) for i in range(self.n_layers))
                + self._encoder_params())

    def active_param_count(self) -> int:
        """Parameters one token touches: a MoE layer counts its routed
        top-k and shared experts only."""
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return (n + sum(self._block_params(i, active_only=True)
                        for i in range(self.n_layers))
                + self._encoder_params())

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla is not None:
            m = self.mla
            qd = self.n_heads * (m.nope_head_dim + m.rope_head_dim)
            n = (d * qd if m.q_lora_rank == 0
                 else d * m.q_lora_rank + m.q_lora_rank * qd)
            n += d * (m.kv_lora_rank + m.rope_head_dim)   # latent + rope key
            n += m.kv_lora_rank * self.n_heads * (m.nope_head_dim
                                                  + m.v_head_dim)
            return n + self.n_heads * m.v_head_dim * d    # o proj
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    def _ffn_params(self, d_ff: int) -> int:
        mats = 3 if self.ffn_type == "swiglu" else 2
        return mats * self.d_model * d_ff

    def _ssm_params(self) -> int:
        if self.ssm is None:
            raise ValueError(f"{self.arch_id}: ssm layer kind requested "
                             "but cfg.ssm is unset")
        s, d = self.ssm, self.d_model
        d_in = s.expand * d
        n = 2 * d * d_in                                # in_proj (x, z)
        n += d_in * s.d_conv                            # conv1d
        n += d_in * (s.dt_rank + 2 * s.d_state)         # x -> (dt, B, C)
        n += s.dt_rank * d_in                           # dt proj
        n += d_in * s.d_state + d_in                    # A_log, D
        return n + d_in * d                             # out proj

    def _block_params(self, idx: int, active_only: bool = False) -> int:
        d = self.d_model
        n = 2 * d                                               # norms
        if self.rwkv is not None:
            # time mix: r, k, v, g, o, decay and bonus, the token-shift
            # lora; channel mix: k (d -> ff), v (ff -> d), receptance
            return (n + 5 * d * d + 2 * d + 6 * d * 32 * 2
                    + 2 * d * self.d_ff + d * d)
        if self.is_attention_layer(idx):
            n += self._attn_params()
            if self.is_encoder_decoder:
                n += 4 * d * d                          # cross-attention
        else:
            n += self._ssm_params()
        if self.is_moe_layer(idx):
            m = self.moe
            k = (m.top_k if active_only else m.n_experts) + m.n_shared_experts
            return n + k * self._ffn_params(m.d_ff) + d * m.n_experts
        d_ff = self.d_ff
        if self.moe is not None and self.moe.dense_d_ff:
            d_ff = self.moe.dense_d_ff
        return n + self._ffn_params(d_ff)

    def _encoder_params(self) -> int:
        """An encoder-decoder's encoder layers: norms, MHA and the FFN."""
        if not self.is_encoder_decoder:
            return 0
        d = self.d_model
        return self.n_encoder_layers * (2 * d + 4 * d * d
                                        + self._ffn_params(self.d_ff))


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


#: the assigned input-shape cells, the JAX package's `SHAPES`
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ParallelConfig:
    """How logical axes map onto a mesh (`dist.sharding`), the train step's
    batch and memory policies and the prefill's attention form, with the
    JAX package's names and defaults. The sharding fields act only inside
    `dist.sharding.activation_rules` and in the spec builders; without a
    mesh they change nothing. JAX's ``scan_layers`` and
    ``unroll_time_scans`` are not carried: the port runs its layers and its
    time scans as Python loops (no ``lax.scan`` to choose), and the
    unrolled scans only serve JAX's TPU dry-run accounting."""
    fsdp: bool = True               # shard weights' leading axis over data
    seq_parallel: bool = True       # boundary activations' seq over model
    expert_parallel: bool = True    # JAX's name only: JAX reads it nowhere
                                    #   (experts shard by `_param_rule`)
    remat: str = "block"            # none | block | full: recompute each
                                    #   super-block in the backward pass
    microbatches: int = 1           # gradient accumulation splits
    grad_compress: bool = False     # int8 wire format on the gradients
    vocab_chunking: int = 0         # logits and loss in N seq chunks (0=off)
    attn_q_chunk: int = 0           # >0: blocked attention with this q chunk
    attn_kv_block: int = 1024       #   and this kv block
    moe_gather_dispatch: bool = False  # JAX's gather-only MoE dispatch;
                                       #   the port's one dispatch gives
                                       #   its result (`moe_ffn`)
    moe_constraints: bool = False   # pin the MoE bucket tensors to
                                    #   (batch, experts) under a mesh
    state_constraints: bool = False  # pin the Mamba scan tensors to
                                     #   (batch, ffn); remat each chunk
    wkv_chunk: int = 64             # chunk of the differentiable wkv6 form
                                    #   the loss takes: JAX's `ops.wkv6`
                                    #   default (the JAX config has no
                                    #   field); 16 cannot overflow at any
                                    #   decay the model allows


@dataclass(frozen=True)
class RunConfig:
    """What a train step runs: the model, its shape cell, the batch
    policies, and the optimizer that `train.init_train_state` builds for a
    language model (an SNN's caller builds its own and passes it beside
    the run)."""
    model: Any                      # a ModelConfig, an SNNModelConfig, or None
    shape: Optional[ShapeConfig]
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    optimizer: str = "adamw"        # sgd | adam | adamw | adafactor
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    seed: int = 0

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


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False

ASSIGNED_ARCHS = [
    "rwkv6-7b", "llama3-8b", "starcoder2-15b", "llama3.2-1b", "phi3-medium-14b",
    "whisper-large-v3", "jamba-v0.1-52b", "llama4-maverick-400b-a17b",
    "deepseek-v2-lite-16b", "llava-next-mistral-7b",
]


def _ensure_loaded() -> None:
    """Import every config module once so registration side-effects run."""
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_lite_16b, jamba_v0_1_52b, llama3_2_1b, llama3_8b,
        llama4_maverick_400b_a17b, llava_next_mistral_7b, phi3_medium_14b,
        rwkv6_7b, starcoder2_15b, whisper_large_v3)


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to smoke-test size with the numbers of
    `repro.configs.base.reduced_config`: 2 layers (one super-block period
    at least, the MoE interleave included, plus any leading dense layers),
    d_model 128, 4 heads of 32 with 2 KV heads under GQA (else 4), d_ff
    256, vocab 512; for MoE at most 4 experts and top-2, expert d_ff 64 and
    dense d_ff 256; for MLA a latent of 32, rope heads of 16 and nope and
    v heads of 32; for Mamba a state of 8, conv 4, expand 2 and dt rank
    16; for RWKV 4 heads of size 32; for an encoder-decoder 2 encoder
    layers."""
    period = cfg.attn_layer_period
    if cfg.moe is not None and cfg.moe.n_experts:
        period = math.lcm(period, cfg.moe.every)
    first_dense = cfg.moe.first_k_dense if cfg.moe is not None else 0
    kw: dict = dict(
        n_layers=max(period, 2) + first_dense,
        d_model=128,
        n_heads=4,
        n_kv_heads=(min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
                    else 4),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff=64 if cfg.moe.d_ff else 0,
            dense_d_ff=256 if cfg.moe.dense_d_ff else 0,
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                              rope_head_dim=16, nope_head_dim=32,
                              v_head_dim=32)
        kw["head_dim"] = 32
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=8, d_conv=4, expand=2, dt_rank=16)
    if cfg.rwkv is not None:
        kw["rwkv"] = RWKVConfig(head_size=32)
    if cfg.is_encoder_decoder:
        kw["n_encoder_layers"] = 2
    return dataclasses.replace(cfg, arch_id=cfg.arch_id + "-smoke", **kw)
