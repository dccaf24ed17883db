"""Whisper large-v3: an encoder-decoder audio backbone (32 encoder and 32
decoder layers of 1280, 20 heads of 64, gelu FFN of 5120, vocab 51866,
tied embeddings). [arXiv:2212.04356; hf:openai/whisper-large-v3]

Only the transformer backbone is modelled: the conv/mel frontend is a
stub, and `models.io_spec` supplies precomputed frame embeddings (batch,
seq_len, d_model). Positions are sinusoidal (no RoPE); every decoder layer
cross-attends the encoder's output.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="whisper-large-v3",
    family="audio",
    n_layers=32,               # decoder layers
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,             # MHA
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    is_encoder_decoder=True,
    frontend="audio_stub",
    ffn_type="gelu",
    tie_embeddings=True,
    rope_theta=0.0,            # sinusoidal absolute positions, no rope
))
