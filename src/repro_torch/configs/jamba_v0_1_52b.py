"""Jamba v0.1 52B: a hybrid stack of Mamba and attention layers (one
attention layer in every 8, at offset 4), with a MoE FFN of 16 experts at
top-2 on every other layer and a dense FFN on the rest: about 52 B
parameters, 12 B active a token. [arXiv:2403.19887; hf]

The SSM state of its 28 Mamba layers, h_t = exp(dt A) h_{t-1} + dt B x_t,
is the membrane-potential analogue: a fixed-size state carried from token
to token. RoPE is applied in the attention layers at the package's default
theta, as the JAX package's model does.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    # attention on 1 of every 8 layers (offset 4), Mamba elsewhere: 1:7
    attn_layer_period=8,
    attn_layer_offset=4,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
    # MoE every other layer, 16 experts top-2 (expert ffn = d_ff)
    moe=MoEConfig(n_experts=16, top_k=2, n_shared_experts=0, d_ff=14336,
                  every=2, dense_d_ff=14336),
))
