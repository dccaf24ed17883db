"""DeepSeek-V2-Lite 16B: 27 layers x 2048, 16 heads of multi-head latent
attention (a 512-wide latent plus a 64-wide shared rope key cached in
place of per-head K and V; nope heads 128, v heads 128), the first layer a
dense FFN (d_ff 10,944), the other 26 MoE layers of 64 routed experts
(top-6, d_ff 1,408) plus two shared ones: about 15.7 B parameters, 2.7 B
active a token. [arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,                # nope (128) + rope (64) query head
    d_ff=1408,
    vocab_size=102400,
    rope_theta=10000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2, d_ff=1408,
                  every=1, first_k_dense=1, dense_d_ff=10944),
))
