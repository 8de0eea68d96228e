"""llava-next-34b  [vlm] 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling; vision tower STUB (input_specs provides
precomputed patch embeddings, 2880 = 5 tiles x 576 patches).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
Ports ``repro/configs/llava_next_34b.py`` unchanged.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    rope_theta=5e6, mlp_act="swiglu", norm_type="rmsnorm",
    tie_embeddings=False, n_patches=2880,
)
