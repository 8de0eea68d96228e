"""Shared model layers (reference: ``repro/models/layers.py:29-166``).

Weights are dense (N, K) tensors or packed dicts {"packed": uint8,
"scale": f32} made by ``parallel/sharding.freeze_for_serving`` (the At-MRAM
serving path), or, for the cold pages a ``wire_serve`` plan serves straight
from their wire form, packed levels with per-block scales.  Every matmul
goes through :func:`linear`, which dispatches between them; a weight with a
leading expert axis makes it the grouped linear of the MoE experts.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import placement, scenarios
from repro_torch.core.weight_store import PackedParam
from repro_torch.kernels import ops as kops
from repro_torch.parallel.distributed import ModelAxis, ModelBlock


def _subpath(prefix: Optional[str], leaf: str) -> str:
    return f"{prefix}/{leaf}" if prefix else leaf


def linear(x: torch.Tensor, w, *, engine: Optional[Any] = None,
           bias: Optional[torch.Tensor] = None,
           path: Optional[str] = None) -> torch.Tensor:
    """y = x @ W^T (+ bias).  W: dense (N, K) tensor or packed dict.

    ``engine`` is a :class:`~repro_torch.core.placement.PlacementPlan` or the
    legacy {"scenario", "mode", "bits"} dict; defaults l1mram / 8-bit.

    Grouped (the MoE experts, which the reference vmaps this function
    over): W dense (E, N, K) or packed (E, N, Kp) with scale (E, N), x
    (E, C, K) -> (E, C, N), expert e's rows times expert e's weight, with
    the same dispatch; packed l1mram weights take the grouped kernel.

    A :class:`ModelBlock` W (the train step on a rank mesh): the rank's
    columns of a weight split over its out-features, gathered over
    "model" (forward an all-gather, backward the rank's slice), from x
    entered through ``axis.copy``; a whole one, x @ W^T.
    """
    if isinstance(w, ModelBlock):
        if not w.split:
            w.axis.count_linear(x, w)
            out = torch.matmul(x, w.w.transpose(-1, -2))
        elif w.dim == 0 and w.w.ndim == 2:
            out = w.axis.gather(column(w.axis.copy(x), w), -1)
        else:
            raise ValueError(f"a linear of a weight split along dim {w.dim}"
                             f" of {w.w.ndim}")
        return out if bias is None else out + bias
    if isinstance(w, dict) and "packed" in w:
        scenario, _mode, bits = placement.linear_dispatch(engine, path)
        k_orig = x.shape[-1]
        wire_bits = placement.wire_served_bits(engine, path)
        if wire_bits is not None:
            # a wire-served cold page: "packed" / "scale" hold the page
            # codec's blockwise form, expanded next to the multiply-adds
            out = kops.quant_matmul_blockscale(x, w["packed"], w["scale"],
                                               bits=wire_bits, k_orig=k_orig)
        elif scenario == "l1mram":
            out = kops.quant_matmul(x, w["packed"], w["scale"], bits=bits,
                                    k_orig=k_orig)
        else:
            p = PackedParam(packed=w["packed"], scale=w["scale"], bits=bits,
                            orig_shape=(*w["packed"].shape[:-1], k_orig))
            out = scenarios.linear_apply(x, p, scenario=scenario)
        out = out.to(x.dtype)
    else:
        out = torch.matmul(x, w.transpose(-1, -2))
    if bias is not None:
        out = out + bias
    return out


def column(x: torch.Tensor, w: ModelBlock,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ W_blk^T: the rank's output columns of a weight split over
    "model" along its out-features, ``x`` whole on every model rank (the
    caller enters it through ``w.axis.copy``).  ``bias`` (whole) is sliced
    to the columns (``axis.split``)."""
    w.axis.count_linear(x, w)
    out = torch.matmul(x, w.w.transpose(-1, -2))
    return out if bias is None else out + w.axis.split(bias, -1)


def _columns(w: Any) -> bool:
    return isinstance(w, ModelBlock) and w.dim == 0 and w.w.ndim == 2


def head_split(p: Dict[str, Any], n_heads: int, n_kv_heads: int
               ) -> Optional[ModelAxis]:
    """The model axis over which an attention block splits by heads, or
    None: wq, wk and wv split over their out-features and both head counts
    divide by the axis, so that a rank holds n_heads / M query heads and
    the n_kv_heads / M kv heads of their GQA groups.  Elsewhere q, k and v
    are gathered (:func:`linear`) and attention runs whole.  On a rank
    mesh the axis counts which of the two it was."""
    if not isinstance(p["wq"], ModelBlock):
        return None
    axis = p["wq"].axis
    if (not all(_columns(p[k]) for k in ("wq", "wk", "wv"))
            or n_heads % axis.size or n_kv_heads % axis.size):
        axis.stats["attention_whole"] += 1
        return None
    axis.stats["attention_split"] += 1
    return axis


def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if scale is not None:
        x = x * (1.0 + scale.to(torch.float32))       # scale stored raw
    return x.to(dt)


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * scale.to(torch.float32)
    if bias is not None:
        x = x + bias.to(torch.float32)
    return x.to(dt)


def apply_norm(x: torch.Tensor, params: Optional[Dict[str, torch.Tensor]],
               kind: str) -> torch.Tensor:
    """kind: rmsnorm | layernorm | nonparam_ln (OLMo-1B's non-parametric LN)."""
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"] if params else None)
    if kind == "layernorm":
        return layernorm(x, params.get("scale") if params else None,
                         params.get("bias") if params else None)
    if kind == "nonparam_ln":
        return layernorm(x, None, None)
    raise ValueError(f"unknown norm {kind!r}")


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, H, S, head_dim); positions: (S,) shared or (B, S) per-batch.
    Split-halves rotation with f32 angles."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)       # (d/2,)
    if positions.ndim == 2:                                    # per-batch
        angles = positions[:, None, :, None].to(torch.float32) * freqs
    else:
        angles = positions[:, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# The reference's activations in a narrower dtype than f32 (a bf16 config):
# XLA computes jax.nn.silu, jax.nn.gelu and jax.nn.softplus op by op, each
# op's result rounded to the input's dtype, where PyTorch's fused F.silu /
# F.gelu / logaddexp round once; these follow XLA's ops in x's dtype (each
# bit-equal to the reference's on the CPU).  f32 keeps PyTorch's fused ops.

class _Logistic(torch.autograd.Function):
    """``lax.logistic`` below f32: 1 / (1 + exp(-x)) op by op, and its
    VJP as ``lax.py``'s ``logistic_p`` rule, g * (ans * (1 - ans)), each
    op rounded to x's dtype (autograd's own rule for the forward's ops
    rounds in another order, ROADMAP C20)."""

    @staticmethod
    def forward(ctx, x):
        ans = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        ans, = ctx.saved_tensors
        return g * (ans * (1 - ans))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * logistic(x), logistic as 1 / (1 + exp(-x))."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * _Logistic.apply(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``: x * 0.5 (1 + tanh(sqrt(2 / pi)
    (x + 0.044715 x^3))), the constants rounded to x's dtype as JAX does."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    return _GeluTanh.apply(x)


class _GeluTanh(torch.autograd.Function):
    """``jax.nn.gelu(approximate=True)`` below f32, op by op, and its VJP
    as JAX transposes the forward's ops: ``x ** 3`` through
    ``integer_pow``'s rule, g * (3 * x^2), ``tanh`` through ``tanh_p``'s,
    (ct * (1 - t)) + (ct * (1 - t)) * t, and x's three cotangents added
    in the order the backward pass meets them (ROADMAP C20)."""

    @staticmethod
    def forward(ctx, x):
        c0, c1 = (torch.tensor(v, dtype=x.dtype, device=x.device)
                  for v in ((2 / math.pi) ** 0.5, 0.044715))
        t = torch.tanh(c0 * (x + c1 * (x * x * x)))
        cdf = 0.5 * (1 + t)
        ctx.save_for_backward(x, t, cdf, c0, c1)
        return x * cdf

    @staticmethod
    def backward(ctx, g):
        x, t, cdf, c0, c1 = ctx.saved_tensors
        ct = 0.5 * (x * g)
        ct = ct * (1 - t)
        inner = c0 * (ct + ct * t)
        return (g * cdf + inner) + (c1 * inner) * (3 * (x * x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``jnp.logaddexp(x, 0)``): at f32 ``logaddexp``,
    else its expansion max(x, 0) + log1p(exp(-|x|))."""
    if x.dtype == torch.float32:
        return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                              device=x.device))
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def mlp(x: torch.Tensor, p: Dict[str, Any], act: str,
        engine: Optional[Any] = None,
        path: Optional[str] = None) -> torch.Tensor:
    """Gated (swiglu/geglu) or plain (gelu) MLP; ``path`` prefixes the
    weights' placement paths (e.g. "layers/mlp" -> "layers/mlp/w_down").

    Where "model" splits w_up (and w_gate) over F, the rank computes its
    F / M of the hidden units, gathers them over "model" before w_down,
    and w_down's output is gathered for the residual (:func:`linear`)."""
    if _columns(p["w_up"]) and (act == "gelu" or _columns(p["w_gate"])):
        axis = p["w_up"].axis
        xc = axis.copy(x)
        if act in ("swiglu", "geglu"):
            g = column(xc, p["w_gate"])
            h = (silu(g) if act == "swiglu" else gelu_tanh(g)) * column(
                xc, p["w_up"])
        elif act == "gelu":
            h = gelu_tanh(column(xc, p["w_up"], bias=p.get("b_up")))
        else:
            raise ValueError(f"unknown mlp act {act!r}")
        return linear(axis.gather(h, -1), p["w_down"], bias=p.get("b_down"))
    if act in ("swiglu", "geglu"):
        g = linear(x, p["w_gate"], engine=engine,
                   path=_subpath(path, "w_gate"))
        u = linear(x, p["w_up"], engine=engine, path=_subpath(path, "w_up"))
        h = (silu(g) if act == "swiglu" else gelu_tanh(g)) * u
    elif act == "gelu":
        h = gelu_tanh(linear(x, p["w_up"], engine=engine,
                             path=_subpath(path, "w_up"), bias=p.get("b_up")))
    else:
        raise ValueError(f"unknown mlp act {act!r}")
    return linear(h, p["w_down"], engine=engine,
                  path=_subpath(path, "w_down"), bias=p.get("b_down"))


def embed(tokens: torch.Tensor, table: Any) -> torch.Tensor:
    """table[tokens].  A table split over "model" by vocab rows: each rank
    looks up the tokens its rows hold, zeros for the rest, and the rows
    are summed over "model"."""
    if not isinstance(table, ModelBlock):
        return table[tokens]
    if not table.split:
        return table.w[tokens]
    local = tokens - table.start
    ours = (local >= 0) & (local < table.w.shape[0])
    rows = table.w[torch.where(ours, local, torch.zeros_like(local))]
    return table.axis.sum(rows.masked_fill(~ours[..., None], 0))


def unembed(x: torch.Tensor, table: Any) -> torch.Tensor:
    """logits = x @ table^T (tied or dedicated head).  A table split over
    "model" by vocab rows gives the rank's (tokens, V / M) logits, from x
    entered through ``axis.copy``; :func:`vocab_split` names the split for
    ``transformer.token_nll``."""
    if isinstance(table, ModelBlock):
        if not table.split:
            table = table.w
        else:
            axis = table.axis
            logits = torch.matmul(axis.copy(x), table.w.T.to(x.dtype))
            axis.logits = tuple(logits.shape)
            return logits
    return torch.matmul(x, table.T.to(x.dtype))


def vocab_split(table: Any) -> Optional[ModelBlock]:
    """The head's table where :func:`unembed` gives the rank's vocab
    block of the logits, else None."""
    return table if isinstance(table, ModelBlock) and table.split else None
