"""hymba-1.5b  [hybrid] 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention+mamba heads per layer,
sliding-window attention (3 global layers), 128 meta tokens.
[arXiv:2411.13676; hf]
Ports ``repro/configs/hymba_1_5b.py`` unchanged.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    rope_theta=1e4, window=1024, n_global_layers=3, n_meta_tokens=128,
    mlp_act="swiglu", norm_type="rmsnorm", tie_embeddings=True,
    ssm_state=16, d_inner=3200, dt_rank=100,
)
