"""LLaVA-NeXT (1.6) Mistral-7B: a vision-language model whose backbone is
Mistral-7B (32 layers of 4096, 32 query and 8 KV heads of 128, SwiGLU
d_ff 14336, vocab 32000). [hf:llava-hf/llava-v1.6-mistral-7b-hf]

The vision frontend (CLIP, anyres tiling and the projector) is a stub:
`models.io_spec` supplies precomputed patch embeddings (batch, n_patches,
d_model), n_patches = vision_patch_frac * seq_len, which the model puts
ahead of the text tokens.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1000000.0,
    frontend="vision_stub",
    vision_patch_frac=0.25,
))
