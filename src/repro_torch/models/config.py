"""Model configuration shared by the model zoo and the arch configs.

Ports ``repro/models/config.py`` unchanged: plain values, no framework.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                   # query heads (0 = attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    window: Optional[int] = None   # sliding-window size (None = full)
    n_global_layers: int = 0       # hymba: this many layers use full attn
    logit_softcap: float = 0.0

    # mlp / norm
    mlp_act: str = "swiglu"        # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm | nonparam_ln
    tie_embeddings: bool = True

    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0           # shared-expert hidden size (qwen2-moe)
    dense_residual_d_ff: int = 0   # arctic: parallel dense FFN hidden size
    capacity_factor: float = 1.25

    # MoE execution: >1 enables DP-local grouped dispatch (see moe_apply)
    moe_groups: int = 0

    # SSM
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner: int = 0
    dt_rank: int = 0

    # hybrid (hymba)
    n_meta_tokens: int = 0

    # enc-dec (whisper)
    n_encoder_layers: int = 0
    n_audio_frames: int = 0        # stub frontend output length

    # vlm (llava)
    n_patches: int = 0

    # execution
    dtype: str = "float32"
    remat: bool = True
    attn_block: int = 1024         # chunked-attention KV block
    attn_dtype: str = "float32"    # score/AV compute dtype (bf16 = optimized)
    scan_dtype: str = "float32"    # selective-scan compute dtype
    ssm_shard_inner: bool = False  # constrain d_inner onto the model axis
    segmented_window_scan: bool = False  # static-window fast path (hymba)
    ssm_chunk: int = 256           # selective-scan sequence chunk
    weight_bits: int = 8           # packed-store precision for serving

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # reduced config of the same family for CPU smoke tests
    def smoke(self) -> "ModelConfig":
        return self.replace(
            n_layers=2,
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 8),
            n_experts_active=min(self.n_experts_active, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            shared_d_ff=64 if self.shared_d_ff else 0,
            dense_residual_d_ff=64 if self.dense_residual_d_ff else 0,
            d_inner=128 if self.d_inner else 0,
            dt_rank=8 if self.dt_rank else 0,
            n_meta_tokens=min(self.n_meta_tokens, 8),
            n_encoder_layers=min(self.n_encoder_layers, 2),
            n_audio_frames=min(self.n_audio_frames, 32) if self.n_audio_frames else 0,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            n_global_layers=min(self.n_global_layers, 1),
            window=min(self.window, 16) if self.window else None,
            remat=False,
        )
