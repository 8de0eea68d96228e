"""qwen3-0.6b  [dense] 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 — qk_norm, GQA, explicit head_dim=128.  [hf:Qwen/Qwen3-8B; hf]
Ports ``repro/configs/qwen3_0_6b.py`` unchanged.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936,
    qk_norm=True, qkv_bias=False, rope_theta=1e6,
    mlp_act="swiglu", norm_type="rmsnorm", tie_embeddings=True,
)
