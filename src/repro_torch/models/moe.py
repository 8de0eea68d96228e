"""Mixture-of-Experts with capacity-based dispatch (qwen2-moe, arctic)
(reference: ``repro/models/moe.py``).

Dispatch is the reference's static-shape sort + scatter: the tokens' top-k
assignments are sorted by expert, each gets a rank within its expert from a
``searchsorted`` offset, assignments whose rank reaches the per-expert
capacity are dropped (capacity-factor routing), and the (E, C, D) dispatch
buffer is built with one indexed write.  The expert MLPs run over the
expert axis at once: packed experts go through :func:`layers.mlp` with
(E, F, D) weights, whose linears launch the grouped ``qmatmul_f32`` kernel
once for all experts (the reference vmaps the packed linear, one batched
Pallas launch), dense experts through batched matmuls.

Three points where PyTorch differs from JAX and the port follows the
reference's numbers anyway:

- top-k takes the k largest logits by a stable descending sort, so that a
  tie keeps the lower expert index first, as ``jax.lax.top_k`` does
  (``torch.topk`` promises no order);
- the dispatch sort is ``torch.sort(stable=True)`` for ``jnp.argsort(
  stable=True)``; every dropped assignment writes one trash row that is cut
  off afterwards, so the duplicate writes there (in no defined order on a
  card) never reach a result;
- the combine gathers each token's k expert rows back and adds them left to
  right in the reference's sorted order (expert order within a token), not
  with ``index_add_``, whose atomics on a card would add in a different
  order from run to run.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers

Aux = Dict[str, torch.Tensor]


def capacity(n_tokens: int, n_experts: int, k: int,
             capacity_factor: float) -> int:
    c = int(n_tokens * k / n_experts * capacity_factor)
    return max(8, -(-c // 8) * 8)     # padded to 8, as the reference


def route(x: torch.Tensor, router_w: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, D) -> (gates (T, k) softmaxed over the chosen, idx (T, k))."""
    logits = torch.matmul(x.to(torch.float32),
                          router_w.T.to(torch.float32))
    top = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(top.values[..., :k], dim=-1)
    return gates, top.indices[..., :k]


def dispatch(x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
             n_experts: int, cap: int) -> Tuple[torch.Tensor, Aux]:
    """Sort + scatter dispatch: x (T, D) -> (buf (E, cap, D), aux).

    ``aux`` holds the reference's arrays: ``e_sorted``, ``slot`` (``cap``
    for a dropped assignment), ``tok_sorted``, ``g_sorted`` and ``keep``."""
    t, d = x.shape
    k = idx.shape[1]
    dev = x.device
    flat_e = idx.reshape(-1)
    flat_g = gates.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)

    order = torch.sort(flat_e, stable=True).indices
    e_sorted = flat_e[order]
    tok_sorted = flat_tok[order]
    g_sorted = flat_g[order]

    # rank within expert: position - first index of that expert in the sort
    starts = torch.searchsorted(
        e_sorted, torch.arange(n_experts, device=dev, dtype=e_sorted.dtype),
        side="left")
    rank = torch.arange(t * k, device=dev) - starts[e_sorted]
    keep = rank < cap
    slot = torch.where(keep, rank, torch.full_like(rank, cap))

    # (E * cap + 1) rows, the last one the trash row of every dropped
    # assignment: the first E * cap rows are the contiguous (E, cap, D)
    # buffer with no copy
    rows = torch.where(keep, e_sorted * cap + rank,
                       torch.full_like(rank, n_experts * cap))
    flat = torch.zeros((n_experts * cap + 1, d), dtype=x.dtype, device=dev)
    flat[rows] = x[tok_sorted]
    buf = flat[:n_experts * cap].view(n_experts, cap, d)
    aux = dict(e_sorted=e_sorted, slot=slot, tok_sorted=tok_sorted,
               g_sorted=g_sorted, keep=keep)
    return buf, aux


def combine(expert_out: torch.Tensor, aux: Aux, t: int) -> torch.Tensor:
    """expert_out (E, cap, Dout) -> (T, Dout): each token's kept expert rows
    times their gates, added in the reference's sorted order."""
    e, cap, dout = expert_out.shape
    n = aux["e_sorted"].shape[0]
    k = n // t
    padded = torch.cat([expert_out, expert_out.new_zeros((e, 1, dout))],
                       dim=1)
    y_sorted = padded[aux["e_sorted"], aux["slot"]]           # (T*k, Dout)
    w = torch.where(aux["keep"], aux["g_sorted"],
                    torch.zeros_like(aux["g_sorted"]))[:, None]
    y_sorted = y_sorted * w.to(y_sorted.dtype)
    # each token's k positions in the sort, ascending: the order in which
    # the reference's scatter-add meets them
    pos = torch.sort(aux["tok_sorted"], stable=True).indices.view(t, k)
    y = y_sorted[pos]                                          # (T, k, Dout)
    out = torch.zeros((t, dout), dtype=y_sorted.dtype,
                      device=expert_out.device)
    for j in range(k):
        out = out + y[:, j]
    return out


def dispatch_combine(x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
                     n_experts: int, cap: int):
    """(buf, combine closure), as the reference's back-compat wrapper."""
    buf, aux = dispatch(x, gates, idx, n_experts, cap)
    t = x.shape[0]
    return buf, lambda expert_out: combine(expert_out, aux, t)


def expert_ffn(buf: torch.Tensor, p: Dict[str, Any], act: str = "swiglu",
               engine: Optional[Any] = None) -> torch.Tensor:
    """Expert MLPs over the expert axis: buf (E, C, D) with stacked weights
    (E, F, D) -> (E, C, D).  Packed experts take :func:`layers.mlp` under
    the reference's placement paths ("layers/moe/w_gate", ...): one grouped
    launch a linear, not one a expert."""
    if isinstance(p["w_gate"], dict):
        pe = {n: p[n] for n in ("w_gate", "w_up", "w_down")}
        return layers.mlp(buf, pe, act, engine=engine, path="layers/moe")
    g = torch.matmul(buf, p["w_gate"].transpose(-1, -2))
    u = torch.matmul(buf, p["w_up"].transpose(-1, -2))
    h = (F.silu(g) if act == "swiglu"
         else F.gelu(g, approximate="tanh")) * u
    return torch.matmul(h, p["w_down"].transpose(-1, -2))


def moe_apply(x: torch.Tensor, p: Dict[str, Any], *, n_experts: int, k: int,
              capacity_factor: float = 1.25, act: str = "swiglu",
              groups: int = 1, engine: Optional[Any] = None) -> torch.Tensor:
    """The MoE layer: x (..., D) -> (..., D).

    p: router (E, D), w_gate / w_up (E, F, D), w_down (E, D, F), optional
    shared-expert MLP under p["shared"] and arctic's dense-residual MLP
    under p["dense"].  ``groups > 1`` (when it divides the tokens) routes
    and dispatches each group of T / groups tokens on its own, with its own
    capacity, one group after another; the reference shards the groups
    over data-parallel axes, which the port refuses (ROADMAP A11)."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    t = xf.shape[0]

    if groups > 1 and t % groups == 0:
        if isinstance(engine, Mapping) and engine.get("dp_axes"):
            raise NotImplementedError(
                "data-parallel grouped MoE dispatch (dp_axes "
                f"{tuple(engine['dp_axes'])}) arrives with ROADMAP A11")
        tg = t // groups
        cap = capacity(tg, n_experts, k, capacity_factor)
        ys = []
        for xg in xf.reshape(groups, tg, d):
            gates, idx = route(xg, p["router"], k)
            buf, aux = dispatch(xg, gates, idx, n_experts, cap)
            ys.append(combine(expert_ffn(buf, p, act=act, engine=engine),
                              aux, tg))
        y = torch.cat(ys).to(x.dtype)
    else:
        gates, idx = route(xf, p["router"], k)
        cap = capacity(t, n_experts, k, capacity_factor)
        buf, aux = dispatch(xf, gates, idx, n_experts, cap)
        y = combine(expert_ffn(buf, p, act=act, engine=engine), aux,
                    t).to(x.dtype)

    if "shared" in p:
        y = y + layers.mlp(xf, p["shared"], act, engine=engine,
                           path="layers/moe/shared")
    if "dense" in p:
        y = y + layers.mlp(xf, p["dense"], act, engine=engine,
                           path="layers/moe/dense")
    return y.reshape(*lead, d)


def router_aux_loss(x: torch.Tensor, router_w: torch.Tensor,
                    idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    xf = x.reshape(-1, x.shape[-1])
    logits = torch.matmul(xf.to(torch.float32),
                          router_w.T.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top1 = F.one_hot(idx[..., 0].reshape(-1), n_experts).to(torch.float32)
    f = torch.mean(top1, dim=0)
    pbar = torch.mean(probs, dim=0)
    return n_experts * torch.sum(f * pbar)
