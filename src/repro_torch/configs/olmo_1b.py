"""olmo-1b  [dense] 16L d_model=2048 16H (GQA kv=16) d_ff=8192
vocab=50304 — non-parametric LN.  [arXiv:2402.00838; hf]
Ports ``repro/configs/olmo_1b.py`` unchanged.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab_size=50304,
    rope_theta=1e4, mlp_act="swiglu", norm_type="nonparam_ln",
    tie_embeddings=True,
)
