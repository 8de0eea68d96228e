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

from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.placement import dp_axes_of
from repro_torch.models import layers
from repro_torch.parallel.distributed import ModelBlock, share

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


def combine(expert_out: torch.Tensor, aux: Aux, t: int,
            first: Optional[int] = None) -> torch.Tensor:
    """expert_out (E, cap, Dout) -> (T, Dout): each token's kept expert rows
    times their gates, added in the reference's sorted order.

    ``first``: ``expert_out`` holds only experts [first, first + E) of the
    dispatch (a rank's share in the train step on a rank mesh); the
    assignments to the other experts add zeros, and the ranks' outputs sum
    to the whole combine."""
    e, cap, dout = expert_out.shape
    n = aux["e_sorted"].shape[0]
    k = n // t
    keep, e_sorted, slot = aux["keep"], aux["e_sorted"], aux["slot"]
    if first is not None:
        e_sorted = e_sorted - first
        keep = keep & (e_sorted >= 0) & (e_sorted < e)
        e_sorted = torch.where(keep, e_sorted, torch.zeros_like(e_sorted))
        slot = torch.where(keep, slot, torch.full_like(slot, cap))
    padded = torch.cat([expert_out, expert_out.new_zeros((e, 1, dout))],
                       dim=1)
    y_sorted = padded[e_sorted, slot]                          # (T*k, Dout)
    w = torch.where(keep, aux["g_sorted"],
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
    h = (layers.silu(g) if act == "swiglu" else layers.gelu_tanh(g)) * u
    return torch.matmul(h, p["w_down"].transpose(-1, -2))


def _routed(xf: torch.Tensor, p: Dict[str, Any], n_experts: int, k: int,
            capacity_factor: float, act: str, groups: int,
            engine: Optional[Any]) -> torch.Tensor:
    """The routed experts' output for the tokens ``xf`` (T, D): route,
    capacity, dispatch, experts and combine, over ``groups`` groups of the
    tokens where it divides them, else over all of them."""
    t, d = xf.shape
    if groups > 1 and t % groups == 0:
        tg = t // groups
        cap = capacity(tg, n_experts, k, capacity_factor)
        routed = []
        for xg in xf.reshape(groups, tg, d):
            gates, idx = route(xg, p["router"], k)
            routed.append(dispatch(xg, gates, idx, n_experts, cap))
        if dp_axes_of(engine):
            if isinstance(p["w_gate"], dict):
                raise ValueError("the dp_axes dispatch (training) takes "
                                 "dense experts, as the reference's")
            buf = torch.stack([b for b, _ in routed])
            g_ = torch.einsum("gecd,efd->gecf", buf, p["w_gate"])
            u_ = torch.einsum("gecd,efd->gecf", buf, p["w_up"])
            h_ = (layers.silu(g_) if act == "swiglu"
                  else layers.gelu_tanh(g_)) * u_
            outs = torch.einsum("gecf,edf->gecd", h_, p["w_down"])
        else:
            outs = [expert_ffn(b, p, act=act, engine=engine)
                    for b, _ in routed]
        return torch.cat([combine(eo, aux, tg) for eo, (_, aux) in
                          zip(outs, routed)])
    gates, idx = route(xf, p["router"], k)
    cap = capacity(t, n_experts, k, capacity_factor)
    buf, aux = dispatch(xf, gates, idx, n_experts, cap)
    return combine(expert_ffn(buf, p, act=act, engine=engine), aux, t)


def _routed_blocks(xf: torch.Tensor, p: Dict[str, Any], n_experts: int,
                   k: int, capacity_factor: float, act: str, groups: int,
                   engine: Optional[Any], rows: Optional[Any]
                   ) -> torch.Tensor:
    """The routed experts' output for the tokens ``xf`` in the train step
    on a rank mesh, where the experts' weights are the rank's
    ``ModelBlock`` s: expert-parallel (``dim`` 0, the rank's E / M
    experts) or TP-in-expert (w_gate / w_up split over F, w_down's rows
    over F: each expert's output a partial sum).

    Routing, capacity and drops run on the whole router, as on one device.
    On the gathered route (``rows``, a ``DPRows``) the dp ranks of a model
    row split its experts again, each a contiguous share (1 / (dp * M) of
    the experts where that divides E).  The rank runs only its experts'
    slots and combines their rows; the partials sum over "model" (and over
    the dp groups on the gathered route, whose rows the rank then keeps).
    Experts that "model" does not split (neither E nor F divides) are
    shared out over the model ranks the same way.  The tokens and the
    gates enter the split through ``axis.copy``: each rank's experts give
    a partial gradient of them."""
    wg = p["w_gate"]
    axis = wg.axis
    x_all = xf if rows is None else rows.gather(xf)
    t, d = x_all.shape
    held = wg.w.shape[0]                    # the experts of the rank's block
    first = wg.start if wg.dim == 0 else 0
    parts, part = (1, 0) if rows is None else (rows.count, rows.index)
    if not wg.split:            # every model rank holds every expert whole
        parts, part = parts * axis.size, part * axis.size + axis.index
    lo, hi = share(held, parts, part)
    n_groups = groups if groups > 1 and t % groups == 0 else 1
    tg = t // n_groups
    cap = capacity(tg, n_experts, k, capacity_factor)
    xg = x_all.reshape(n_groups, tg, d)
    routes = [route(g, p["router"], k) for g in xg]
    gates = axis.copy(torch.stack([g for g, _ in routes]))
    xc = axis.copy(xg)
    routed = [dispatch(xc[i], gates[i], idx, n_experts, cap)
              for i, (_, idx) in enumerate(routes)]
    buf = torch.stack([b for b, _ in routed])[:, first + lo:first + hi]
    w_gate, w_up, w_down = (p[n].w[lo:hi] for n in ("w_gate", "w_up",
                                                    "w_down"))
    g_ = torch.matmul(buf, w_gate.transpose(-1, -2))
    u_ = torch.matmul(buf, w_up.transpose(-1, -2))
    h_ = (layers.silu(g_) if act == "swiglu" else layers.gelu_tanh(g_)) * u_
    outs = torch.matmul(h_, w_down.transpose(-1, -2))      # (G, share, C, D)
    f_held = w_gate.shape[1]
    f_all = f_held * (axis.size if wg.dim == 1 else 1)
    axis.count_experts(
        n_groups * (hi - lo) * cap,
        n_groups * n_experts * cap * (axis.rows_scale if rows is None else 1),
        3 * d * f_held, 3 * d * f_all)
    y = axis.sum(torch.cat([combine(eo, aux, tg, first=first + lo)
                            for eo, (_, aux) in zip(outs, routed)]))
    if rows is None:
        return y
    return rows.own(rows.sum(y, axis), xf.shape[0])


def moe_apply(x: torch.Tensor, p: Dict[str, Any], *, n_experts: int, k: int,
              capacity_factor: float = 1.25, act: str = "swiglu",
              groups: int = 1, engine: Optional[Any] = None) -> torch.Tensor:
    """The MoE layer: x (..., D) -> (..., D).

    p: router (E, D), w_gate / w_up (E, F, D), w_down (E, D, F), optional
    shared-expert MLP under p["shared"] and arctic's dense-residual MLP
    under p["dense"].  ``groups > 1`` (when it divides the tokens) routes
    and dispatches each group of T / groups tokens on its own, with its own
    capacity, one group after another.  With ``engine["dp_axes"]`` set
    (the training path, ``moe.py:133-166``) the dense experts of all the
    groups run as the reference's two einsums, ``gecd,efd->gecf`` and
    ``gecf,edf->gecd``; the reference's sharding constraints there are
    layout hints with no value.

    On a rank mesh (``launch/dist_steps.make_distributed_train_step``) a
    rank holds its own rows of the batch.  Where ``groups`` is a multiple
    of the dp size the step gives each rank its own ``groups / dp`` groups;
    otherwise it sets ``engine["dp_rows"]`` (``parallel/distributed.
    DPRows``), and the routed experts run over the whole batch's tokens,
    gathered in the batch's row order, so that capacity and drops are the
    single device's, and the rank keeps its own rows.  The experts' weights
    are then the rank's ``ModelBlock`` s, and :func:`_routed_blocks` runs
    only the rank's share of the expert slots: its experts over "model",
    split again over the dp ranks on the gathered route (ROADMAP C22,
    closed).  The shared expert and the dense residual run on the rank's
    own rows, split over "model" by ``layers.mlp``."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    kw = dict(n_experts=n_experts, k=k, capacity_factor=capacity_factor,
              act=act, groups=groups, engine=engine)
    if isinstance(p["w_gate"], ModelBlock):
        rows = engine.get("dp_rows") if isinstance(engine, Mapping) else None
        y = _routed_blocks(xf, p, rows=rows, **kw)
    else:
        y = _routed(xf, p, **kw)
    y = y.to(x.dtype)

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
