"""Shared model layers (reference: ``repro/models/layers.py:29-166``).

Weights are dense (N, K) tensors or packed dicts {"packed": uint8,
"scale": f32} made by ``parallel/sharding.freeze_for_serving`` (the At-MRAM
serving path), or, for the cold pages a ``wire_serve`` plan serves straight
from their wire form, packed levels with per-block scales.  Every matmul
goes through :func:`linear`, which dispatches between them; a weight with a
leading expert axis makes it the grouped linear of the MoE experts.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import placement, scenarios
from repro_torch.core.weight_store import PackedParam
from repro_torch.kernels import ops as kops


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
    """
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


def mlp(x: torch.Tensor, p: Dict[str, Any], act: str,
        engine: Optional[Any] = None,
        path: Optional[str] = None) -> torch.Tensor:
    """Gated (swiglu/geglu) or plain (gelu) MLP; ``path`` prefixes the
    weights' placement paths (e.g. "layers/mlp" -> "layers/mlp/w_down")."""
    if act in ("swiglu", "geglu"):
        g = linear(x, p["w_gate"], engine=engine,
                   path=_subpath(path, "w_gate"))
        u = linear(x, p["w_up"], engine=engine, path=_subpath(path, "w_up"))
        h = (F.silu(g) if act == "swiglu"
             else F.gelu(g, approximate="tanh")) * u
    elif act == "gelu":
        h = F.gelu(linear(x, p["w_up"], engine=engine,
                          path=_subpath(path, "w_up"), bias=p.get("b_up")),
                   approximate="tanh")
    else:
        raise ValueError(f"unknown mlp act {act!r}")
    return linear(h, p["w_down"], engine=engine,
                  path=_subpath(path, "w_down"), bias=p.get("b_down"))


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """logits = x @ table^T (tied or dedicated head)."""
    return torch.matmul(x, table.T.to(x.dtype))
