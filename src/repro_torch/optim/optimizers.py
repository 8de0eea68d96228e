"""Optimizers as functions over parameter trees (reference:
``repro/optim/optimizers.py``).

AdamW for standard sizes; Adafactor (factored second moment, no first
moment) where AdamW's state would not fit.  Both keep the reference's
functional form, ``init(params) -> state`` and ``update(grads, state,
params, lr) -> (new_params, new_state)``, and its state layout --
``dict(mu, nu, count)`` for AdamW, ``dict(v=[...], count)`` for Adafactor
-- so a state carries over to and from the JAX package leaf for leaf
(``interop``, ``checkpoint``).  ``torch.optim`` is not used: its state is
keyed by parameter object, not by tree path.

Every list that lines up with a tree (Adafactor's ``v``, the global norm's
sum) follows ``jax.tree_util``'s order, dict keys sorted
(``core/tree.py``).  Updates run under ``torch.no_grad`` and return new
tensors; nothing is written in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.core import tree as T

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], Tuple[Any, Any]]


def _device(tree: Any) -> torch.device:
    flat = T.leaves(tree)
    return flat[0].device if flat else torch.device("cpu")


def _local_mean(x: torch.Tensor, dims=None, keepdim: bool = False
                ) -> torch.Tensor:
    return (torch.mean(x) if dims is None
            else torch.mean(x, dim=dims, keepdim=keepdim))


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    # a tensor operand: PyTorch's CUDA division by a Python number
    # multiplies by its rounded reciprocal, which is not an f32 division
    return torch.full_like(like, value, dtype=F32)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``;
    returns (clipped grads, the norm before clipping)."""
    flat = T.leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in flat))
    return scale_to_norm(grads, gn, max_norm), gn


@torch.no_grad()
def scale_to_norm(grads: Any, gn: torch.Tensor, max_norm: float) -> Any:
    """``grads`` (whole leaves or their blocks) scaled as
    :func:`clip_by_global_norm` scales them when their global norm is
    ``gn``."""
    scale = torch.clamp(_f32(max_norm, gn) / torch.clamp(gn, min=1e-9),
                        max=1.0)
    return T.tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
        return dict(mu=T.tree_map(zeros, params),
                    nu=T.tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=_device(params)))

    @torch.no_grad()
    def update(grads, state, params, lr):
        count = state["count"] + 1
        # f32 tensors, as the reference's b ** count.astype(f32)
        c1 = 1.0 - b1 ** count.to(F32)
        c2 = 1.0 - b2 ** count.to(F32)

        def upd(g, m, v, p):
            g = g.to(F32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            # decay on every leaf, norms included, as the reference does
            step = step + weight_decay * p.to(F32)
            return (p.to(F32) - lr * step).to(p.dtype), m, v

        out = [upd(*xs) for xs in zip(T.leaves(grads), T.leaves(state["mu"]),
                                      T.leaves(state["nu"]),
                                      T.leaves(params))]
        return (T.unflatten(params, [o[0] for o in out]),
                dict(mu=T.unflatten(params, [o[1] for o in out]),
                     nu=T.unflatten(params, [o[2] for o in out]),
                     count=count))

    return Optimizer("adamw", init, update)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern): factored second moments for >= 2-D params
# ---------------------------------------------------------------------------

def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay_rate: float = 0.8, weight_decay: float = 0.0) -> Optimizer:
    def _factored(p) -> bool:
        return p.ndim >= 2

    # a FLAT LIST aligned with the params' leaves in jax.tree_util order
    # (dict keys sorted), as the reference keeps it
    def init(params):
        states = []
        for p in T.leaves(params):
            z = lambda shape: torch.zeros(shape, dtype=F32, device=p.device)
            if _factored(p):
                states.append(dict(vr=z(p.shape[:-1]),
                                   vc=z(p.shape[:-2] + p.shape[-1:])))
            else:
                states.append(dict(v=z(p.shape)))
        return dict(v=states, count=torch.zeros(
            (), dtype=torch.int32, device=_device(params)))

    @torch.no_grad()
    def update(grads, state, params, lr, mean=None):
        """``mean``, one a leaf, is ``mean(x, dims=None, keepdim=False)``:
        the mean over ``dims`` (all of them when None) of the whole leaf
        whose block is ``x``, the block's ``vr`` / ``vc`` its rows and
        columns (the sharded step's ``launch/dist_steps.whole_mean``).
        By default each leaf is whole and the means are its own."""
        count = state["count"] + 1
        beta = 1.0 - count.to(F32) ** -decay_rate
        flat = T.leaves(params)
        means = [_local_mean] * len(flat) if mean is None else mean

        def upd(g, s, p, mean):
            g = g.to(F32)
            g2 = g * g + eps
            if _factored(p):
                vr = beta * s["vr"] + (1 - beta) * mean(g2, (-1,))
                vc = beta * s["vc"] + (1 - beta) * mean(g2, (-2,))
                denom = torch.clamp(mean(vr, (-1,), True),
                                    min=eps)[..., None]
                v_est = (vr[..., None] * vc[..., None, :]) / denom
                step = g * torch.rsqrt(v_est + eps)
                new_s = dict(vr=vr, vc=vc)
            else:
                v = beta * s["v"] + (1 - beta) * g2
                step = g * torch.rsqrt(v + eps)
                new_s = dict(v=v)
            # update clipping (RMS of step <= clip_threshold)
            rms = torch.sqrt(mean(torch.square(step)) + eps)
            step = step / torch.clamp(rms / _f32(clip_threshold, rms),
                                      min=1.0)
            if weight_decay:
                step = step + weight_decay * p.to(F32)
            return (p.to(F32) - lr * step).to(p.dtype), new_s

        results = [upd(g, s, p, m) for g, s, p, m in zip(
            T.leaves(grads), state["v"], flat, means)]
        return (T.unflatten(params, [r[0] for r in results]),
                dict(v=[r[1] for r in results], count=count))

    return Optimizer("adafactor", init, update)


def pick_optimizer(total_params: int, hbm_budget_per_chip: float = 16e9,
                   n_chips: int = 256) -> Optimizer:
    """AdamW (12 B/param incl. bf16 grads) if it fits; else Adafactor."""
    adamw_bytes = total_params * 12
    if adamw_bytes / n_chips < 0.6 * hbm_budget_per_chip:
        return adamw()
    return adafactor()
