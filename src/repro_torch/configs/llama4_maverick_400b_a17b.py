"""Llama-4 Maverick 400B-A17B: GQA decoder whose layers alternate a dense
FFN (d_ff 16,384) and a MoE FFN of 128 routed experts (top-1, d_ff 8,192)
plus one shared expert, as the published HF config interleaves them
(interleave_moe_layer_step=2): about 400 B parameters, 17 B active a
token. [hf:meta-llama/Llama-4-Maverick-17B-128E]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,                  # dense (non-MoE) layers
    vocab_size=202048,
    rope_theta=500000.0,
    moe=MoEConfig(n_experts=128, top_k=1, n_shared_experts=1, d_ff=8192,
                  every=2, dense_d_ff=16384),
))
