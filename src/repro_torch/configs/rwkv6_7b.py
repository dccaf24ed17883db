"""RWKV6 (Finch) 7B — attention-free, data-dependent decay. [arXiv:2404.05892; hf]

The wkv recurrent state is the analogue of IMPULSE's membrane potential: a
per-channel accumulator updated in place with a learned, data-dependent
decay, a LIF leak. The port's CUDA kernel (kernels/wkv6) keeps it in
registers across the prompt.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig, register

CONFIG = register(ModelConfig(
    arch_id="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                # d_model / head_size
    n_kv_heads=64,
    head_dim=64,               # rwkv6 head_size
    d_ff=14336,
    vocab_size=65536,
    rwkv=RWKVConfig(head_size=64),
))
