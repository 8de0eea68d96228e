"""whisper-tiny  [audio] 4L d_model=384 6H d_ff=1536 vocab=51865 —
enc-dec, conv frontend STUB (input_specs provides precomputed frame
embeddings, 1500 frames = 30 s).  [arXiv:2212.04356; unverified]
Ports ``repro/configs/whisper_tiny.py`` unchanged.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_encoder_layers=4,
    d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=51865,
    mlp_act="gelu", norm_type="layernorm", tie_embeddings=True,
    n_audio_frames=1500,
)
