"""StarCoder2 15B: dense GQA (kv=4), RoPE, GELU FFN. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=100000.0,
    ffn_type="gelu",
))
