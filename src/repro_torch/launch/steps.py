"""The train and serve steps (reference: ``repro/launch/steps.py:40-140``).

``make_train_step`` takes the gradient of the family's loss
(``encdec.seq2seq_loss`` for the encoder-decoder, ``transformer.lm_loss``
for the rest), clips it to a global norm of 1.0 and applies the optimizer,
as the reference's does; it returns a plain function (no ``jit``).
``make_prefill_step`` / ``make_decode_step`` build the serve steps of
every family: the decoder-only LM's
``transformer.step``, the VLM's with patch embeddings prepended, and the
encoder-decoder's ``encode`` -> ``precompute_cross_kv`` -> ``encdec.step``.
They run under ``torch.no_grad``.

``param_specs``, ``serve_param_specs`` and ``cache_specs``
(``:52-60, 143-157``) give a config's parameter, packed-store and cache
trees as ``meta`` tensors, PyTorch's counterpart of ``jax.eval_shape``:
every shape of a full-width config (arctic-480b's ~484 B parameters
among them) without allocating it, for the sharding rules.  The other
spec functions (``*_input_specs``, ``build_cell``) serve the XLA dry-run
tooling (ROADMAP A12 (d)) and are not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import packing
from repro_torch.core import tree as T
from repro_torch.core.placement import PlacementPlan
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.parallel import sharding


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
                   cfg: ModelConfig, engine: Optional[Any] = None,
                   denom: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Any]:
    """(loss, grads): ``jax.value_and_grad`` of the family's loss on
    detached copies of the leaves, so ``params`` is left as it was.  A leaf
    the loss never reads (hymba's ``ssm_norm``: its SSM heads take the
    attention's normalised input) gets zeros, as under JAX.  ``denom``
    replaces the loss's token count (``transformer.token_nll``)."""
    loss_fn = _loss_fn(cfg)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in T.leaves(params)]
        loss = loss_fn(T.unflatten(params, leaves), batch, cfg,
                       engine=engine, denom=denom)
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


def param_specs(cfg: ModelConfig) -> Any:
    """The parameter tree as ``meta`` tensors: every leaf's shape and
    dtype, nothing drawn or allocated."""
    return _init_fn(cfg)(cfg, device="meta")


def serve_param_specs(cfg: ModelConfig, bits: int = 8,
                      plan: Optional[PlacementPlan] = None) -> Any:
    """The packed At-MRAM store as ``meta`` tensors: each packable leaf a
    {"packed" uint8, "scale" f32} dict, as ``freeze_for_serving`` gives
    it; ``plan`` sets the bits per parameter path."""
    def walk(tree: Any, keys: Tuple[str, ...]) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in tree.items()}
        if not sharding.packable(keys[-1], tree):
            return tree
        b = plan.bits_for("/".join(keys)) if plan is not None else bits
        lead, k = tuple(tree.shape[:-1]), int(tree.shape[-1])
        return dict(
            packed=torch.empty(lead + (packing.packed_last_dim(k, b),),
                               dtype=torch.uint8, device="meta"),
            scale=torch.empty(lead, dtype=torch.float32, device="meta"))

    return walk(param_specs(cfg), ())


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Any:
    """The serve cache of ``batch`` rows of ``max_len`` as ``meta``
    tensors."""
    _init_fn(cfg)
    init = (encdec.init_serve_cache if cfg.family == "encdec"
            else tfm.init_serve_cache)
    return init(cfg, batch, max_len, device="meta")
