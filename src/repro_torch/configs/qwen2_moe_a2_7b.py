"""qwen2-moe-a2.7b  [moe] 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 experts top-4 + 4 shared (shared hidden 5632 = 4x1408).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
Ports ``repro/configs/qwen2_moe_a2_7b.py`` unchanged.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=151936,
    qkv_bias=True, rope_theta=1e6,
    mlp_act="swiglu", norm_type="rmsnorm", tie_embeddings=False,
    n_experts=60, n_experts_active=4, moe_d_ff=1408, shared_d_ff=5632,
)
