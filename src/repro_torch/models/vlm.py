"""LLaVA-NeXT-style VLM backbone (reference: ``repro/models/vlm.py:22-57``).

The anyres vision tower is a stub, as in the reference: callers pass
precomputed patch embeddings (B, n_patches, d_model) that stand in for the
CLIP tower, the anyres tiling and the projector.  The language backbone is
the decoder LM of ``models/transformer.py``; the patches are prepended to
the token embeddings as ordinary prompt positions (``extra_embeds``), so
they enter the KV cache like prompt tokens and the first decode position is
``n_patches + prompt_len``.  Training (``vlm_loss``) is the LM's
``lm_loss``, which scores the text positions only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.device import DeviceLike
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, bits: Optional[int] = None
                ) -> Params:
    return tfm.init_params(cfg, generator, device, bits)


def forward(params: Params, tokens: torch.Tensor, patches: torch.Tensor,
            cfg: ModelConfig, *, engine: Optional[Any] = None
            ) -> torch.Tensor:
    """tokens (B, S_text), patches (B, P, D) -> logits over P + S_text."""
    return tfm.forward(params, tokens, cfg, engine=engine,
                       extra_embeds=patches)


def vlm_loss(params: Params, batch: Dict[str, torch.Tensor],
             cfg: ModelConfig, *, engine: Optional[Any] = None
             ) -> torch.Tensor:
    """Loss over the text positions only (patches carry no labels)."""
    return tfm.lm_loss(params, batch, cfg, engine=engine)


def prefill(params: Params, tokens: torch.Tensor, patches: torch.Tensor,
            cache: Dict[str, Any], cfg: ModelConfig, *,
            engine: Optional[Any] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Embed patches + tokens and fill the KV cache from position 0; the
    logits cover the token positions."""
    return tfm.step(params, tokens, cache, 0, cfg, engine=engine,
                    extra_embeds=patches)


def decode_step(params: Params, token: torch.Tensor, cache: Dict[str, Any],
                pos: Any, cfg: ModelConfig, *, engine: Optional[Any] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    return tfm.step(params, token, cache, pos, cfg, engine=engine)
