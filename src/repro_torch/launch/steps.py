"""The train and serve steps (reference: ``repro/launch/steps.py:40-140``).

``make_train_step`` takes the gradient of the family's loss
(``encdec.seq2seq_loss`` for the encoder-decoder, ``transformer.lm_loss``
for the rest), clips it to a global norm of 1.0 and applies the optimizer,
as the reference's does; it returns a plain function (no ``jit``).
``make_prefill_step`` / ``make_decode_step`` build the serve steps of
every family: the decoder-only LM's
``transformer.step``, the VLM's with patch embeddings prepended, and the
encoder-decoder's ``encode`` -> ``precompute_cross_kv`` -> ``encdec.step``.
They run under ``torch.no_grad``.  The reference's spec builders
(``param_specs``, ``*_specs``, ``build_cell``) serve the XLA dry-run
tooling (ROADMAP A12) and are not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import tree as T
from repro_torch.core.placement import PlacementPlan
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer, clip_by_global_norm


# the serve steps' placement when the caller gives none (the reference's
# DEFAULT_SERVE_PLAN)
DEFAULT_SERVE_PLAN = PlacementPlan.uniform()


def _loss_fn(cfg: ModelConfig) -> Callable:
    _init_fn(cfg)                       # refuse an unknown family now
    if cfg.family == "encdec":
        return encdec.seq2seq_loss
    return tfm.lm_loss


def _init_fn(cfg: ModelConfig) -> Callable:
    if cfg.family == "encdec":
        encdec.check_family(cfg)
        return encdec.init_params
    tfm.check_family(cfg)
    return tfm.init_params


def loss_and_grads(params: Any, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, engine: Optional[Any] = None
                   ) -> Tuple[torch.Tensor, Any]:
    """(loss, grads): ``jax.value_and_grad`` of the family's loss on
    detached copies of the leaves, so ``params`` is left as it was.  A leaf
    the loss never reads (hymba's ``ssm_norm``: its SSM heads take the
    attention's normalised input) gets zeros, as under JAX."""
    loss_fn = _loss_fn(cfg)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in T.leaves(params)]
        loss = loss_fn(T.unflatten(params, leaves), batch, cfg,
                       engine=engine)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), T.unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    lr: float = 3e-4, engine: Optional[Any] = None
                    ) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``; ``batch`` holds tensors on the params'
    device."""
    _loss_fn(cfg)                       # refuse an unknown family now

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg, engine=engine)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        new_params, new_opt = optimizer.update(
            grads, opt_state, params,
            torch.tensor(lr, dtype=torch.float32, device=loss.device))
        return new_params, new_opt, dict(loss=loss, grad_norm=gnorm)

    return train_step


def make_prefill_step(cfg: ModelConfig, engine: Optional[Any] = None
                      ) -> Callable:
    """The serve prefill: ``prefill(params, tokens, cache)``, for the VLM
    ``prefill(params, patches, tokens, cache)``, for the encoder-decoder
    ``prefill(params, frames, tokens, cache)``; each returns (logits over
    the token positions, cache) and fills the cache from position 0.
    ``engine`` is a PlacementPlan or the legacy engine dict (default: the
    uniform l1mram plan)."""
    engine = engine if engine is not None else DEFAULT_SERVE_PLAN
    _init_fn(cfg)                       # refuse an unknown family now
    if cfg.family == "encdec":
        @torch.no_grad()
        def prefill(params, frames, tokens, cache):
            enc_out = encdec.encode(params, frames, cfg, engine=engine)
            cache = encdec.precompute_cross_kv(params, enc_out, cfg, cache,
                                               engine=engine)
            return encdec.step(params, tokens, cache, 0, cfg, engine=engine)
        return prefill
    if cfg.family == "vlm":
        @torch.no_grad()
        def prefill(params, patches, tokens, cache):
            return tfm.step(params, tokens, cache, 0, cfg, engine=engine,
                            extra_embeds=patches)
        return prefill

    @torch.no_grad()
    def prefill(params, tokens, cache):
        return tfm.step(params, tokens, cache, 0, cfg, engine=engine)
    return prefill


def make_decode_step(cfg: ModelConfig, engine: Optional[Any] = None
                     ) -> Callable:
    """``decode(params, token, cache, pos) -> (logits, cache)``: one token
    a row at position ``pos`` (which counts a VLM's patches)."""
    engine = engine if engine is not None else DEFAULT_SERVE_PLAN
    _init_fn(cfg)
    step = encdec.step if cfg.family == "encdec" else tfm.step

    @torch.no_grad()
    def decode(params, token, cache, pos):
        return step(params, token, cache, pos, cfg, engine=engine)
    return decode
