"""The train step (reference: ``repro/launch/steps.py:40-74``).

``make_train_step`` takes the gradient of ``lm_loss``, clips it to a global
norm of 1.0 and applies the optimizer, as the reference's does; it returns
a plain function (no ``jit``).  The reference's spec builders
(``param_specs``, ``*_specs``, ``build_cell``) serve the XLA dry-run
tooling (ROADMAP A12) and are not ported; the serve steps are
``models/transformer.step`` behind ``serving/engine.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import tree as T
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer, clip_by_global_norm


def _loss_fn(cfg: ModelConfig) -> Callable:
    tfm.check_trainable(cfg)
    return tfm.lm_loss


def _init_fn(cfg: ModelConfig) -> Callable:
    tfm.check_family(cfg)
    return tfm.init_params


def loss_and_grads(params: Any, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, engine: Optional[Any] = None
                   ) -> Tuple[torch.Tensor, Any]:
    """(loss, grads): ``jax.value_and_grad(lm_loss)`` on detached copies
    of the leaves, so ``params`` is left as it was."""
    loss_fn = _loss_fn(cfg)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in T.leaves(params)]
        loss = loss_fn(T.unflatten(params, leaves), batch, cfg,
                       engine=engine)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), T.unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    lr: float = 3e-4, engine: Optional[Any] = None
                    ) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``; ``batch`` holds tensors on the params'
    device."""
    _loss_fn(cfg)                       # refuse the untrained families now

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg, engine=engine)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        new_params, new_opt = optimizer.update(
            grads, opt_state, params,
            torch.tensor(lr, dtype=torch.float32, device=loss.device))
        return new_params, new_opt, dict(loss=loss, grad_norm=gnorm)

    return train_step
