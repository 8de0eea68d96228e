"""falcon-mamba-7b  [ssm] 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — pure Mamba-1 architecture.  [arXiv:2410.05355; unverified]
Ports ``repro/configs/falcon_mamba_7b.py`` unchanged.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=65024,
    norm_type="rmsnorm", tie_embeddings=False,
    ssm_state=16, d_inner=8192, dt_rank=256,
)
