"""gemma-7b  [dense] 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000 — GeGLU, head_dim=256 (MQA only on the 2b variant).
[arXiv:2403.08295; hf]
Ports ``repro/configs/gemma_7b.py`` unchanged.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000,
    rope_theta=1e4, mlp_act="geglu", norm_type="rmsnorm",
    tie_embeddings=True,
)
