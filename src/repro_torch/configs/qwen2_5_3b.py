"""qwen2.5-3b  [dense] 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]
Ports ``repro/configs/qwen2_5_3b.py`` unchanged.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab_size=151936,
    qk_norm=False, qkv_bias=True, rope_theta=1e6,
    mlp_act="swiglu", norm_type="rmsnorm", tie_embeddings=True,
)
