"""arctic-480b  [moe] 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual (Dense-MoE hybrid).
[hf:Snowflake/snowflake-arctic-base; hf]
Ports ``repro/configs/arctic_480b.py`` unchanged.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab_size=32000,
    rope_theta=1e6, mlp_act="swiglu", norm_type="rmsnorm",
    tie_embeddings=False,
    n_experts=128, n_experts_active=2, moe_d_ff=4864,
    dense_residual_d_ff=14336,
)
