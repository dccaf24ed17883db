"""Phi-3 Medium 14B: dense GQA (kv=10), RoPE, SwiGLU. [arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=10000.0,
))
