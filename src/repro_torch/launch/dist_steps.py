"""The train step on a rank mesh: ``launch/steps.make_train_step`` over
the ranks of ``launch/mesh.make_rank_mesh``, with the values of one rank.

The reference has no module for this: it runs the single-device
``make_train_step`` under ``jax.jit`` on trees placed by
``jax.device_put(tree, NamedSharding)``, and GSPMD keeps the values
(``tests/test_multidevice.py:108-147``).  Here the params and the
optimizer state are trees of DTensors (``parallel/distributed.shard_tree``
of ``param_shardings`` / ``opt_state_shardings``), the compute runs on
plain tensors, and the collectives are explicit.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import tree as T
from repro_torch.launch import steps
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.parallel import distributed as D
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.distributed import Replicate, Shard


def _dp_groups(mesh: Any) -> List[Any]:
    return [mesh.group(a) for a in shd.dp_axes(mesh) if mesh.shape[a] > 1]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _state_roles(name: str, opt_state: Any) -> List[Tuple[Optional[int],
                                                           str]]:
    """(param leaf index, role) of each optimizer-state leaf in tree
    order: "same" lines up with its parameter, "vr" / "vc" are
    Adafactor's factored rows / columns, "scalar" stands alone."""
    if name == "adamw":                  # dict(count, mu, nu), keys sorted
        n = len(T.leaves(opt_state["mu"]))
        return [(None, "scalar")] + [(i, "same") for i in range(n)] * 2
    if name == "adafactor":              # dict(count, v=[...])
        roles = [(None, "scalar")]
        for i, s in enumerate(opt_state["v"]):
            roles += [(i, {"v": "same"}.get(k, k)) for k in sorted(s)]
        return roles
    raise ValueError(f"no sharded update for optimizer {name!r}")


def _aligned(places: Sequence[Any], ndim: int, role: str
             ) -> Tuple[Any, ...]:
    """Placements of a state leaf whose blocks line up with its
    parameter's blocks (``places``, a ``ndim``-d parameter's)."""
    def one(p):
        if not isinstance(p, Shard) or role == "same":
            return p
        if role == "vr":                 # p.shape[:-1]
            return p if p.dim < ndim - 1 else Replicate()
        if p.dim < ndim - 2:             # vc: p.shape[:-2] + p.shape[-1:]
            return p
        return Shard(ndim - 2) if p.dim == ndim - 1 else Replicate()
    if role == "scalar":
        return tuple(Replicate() for _ in places)
    return tuple(one(p) for p in places)


def whole_mean(dmesh, places: Sequence[Any], shape: Sequence[int]
               ) -> Callable:
    """Adafactor's ``mean`` hook for one leaf of ``shape`` placed by
    ``places``: ``mean(x, dims=None, keepdim=False)`` of ``x``, a block
    over the leaf's leading ``x.ndim`` dims, is the mean over ``dims`` of
    the whole tensor, the local sum all-reduced over each mesh dim that
    shards one of them."""
    def mean(x: torch.Tensor, dims=None, keepdim: bool = False):
        dims = (tuple(range(x.ndim)) if dims is None
                else tuple(d % x.ndim for d in dims))
        s = torch.sum(x, dim=dims, keepdim=keepdim)
        for i, p in enumerate(places):
            if isinstance(p, Shard) and p.dim in dims:
                D.all_reduce(s, group=dmesh.get_group(i))
        n = math.prod(shape[d] for d in dims)
        return s / torch.tensor(float(n), dtype=s.dtype, device=s.device)
    return mean


def check_moe_groups(cfg: ModelConfig, mesh: Any) -> None:
    """A MoE layer routes and caps over its group's tokens, so rows split
    over the dp axes keep the single-rank values only when each rank holds
    whole groups: ``moe_groups`` a multiple of the dp size."""
    dp = shd.dp_size(mesh)
    if cfg.n_experts and dp > 1 and (cfg.moe_groups < dp
                                     or cfg.moe_groups % dp):
        raise ValueError(
            f"{cfg.name}: moe_groups={cfg.moe_groups} is not a multiple of "
            f"the dp size {dp}; a rank's rows would route and drop over "
            "other tokens than one rank's run (ROADMAP A11 (b): gather the "
            "router's tokens over the dp group)")


def make_distributed_train_step(cfg: ModelConfig, optimizer: Optimizer,
                                mesh: Any, lr: float = 3e-4,
                                engine: Optional[Any] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on a rank mesh, the contract of ``make_train_step``:
    ``params`` and ``opt_state`` are ``shard_tree`` s (of
    ``param_shardings`` / ``opt_state_shardings``), ``batch`` the whole
    batch on every rank.  Each step

    1. gathers the parameter leaves;
    2. runs ``loss_and_grads`` on the rank's rows (``local_rows``),
       the loss being the rows' masked sum over the whole batch's token
       count (all-reduced first), so that the ranks' losses add up to the
       single-rank mean;
    3. all-reduces the gradients over the rank's dp groups;
    4. clips them by the global norm (every rank now holds all of it);
    5. updates the rank's own blocks (Adafactor's whole-leaf means through
       :func:`whole_mean`).

    Ranks along "model" hold the same rows and compute the same gradient
    (ROADMAP C19).  ``metrics`` adds the host seconds and bytes of the
    gathers and the all-reduce (``comm``)."""
    steps._loss_fn(cfg)                 # refuse an unknown family now
    check_moe_groups(cfg, mesh)
    engine = dict(engine or {})
    engine.setdefault("dp_axes", shd.dp_axes(mesh))
    groups = _dp_groups(mesh)
    dev = mesh.devices.flat[0].device

    def train_step(params, opt_state, batch):
        t0 = time.perf_counter()
        full = D.gather_tree(params)
        _sync(dev)
        t_gather = time.perf_counter() - t0
        # what the one all-gather brings a rank: every other rank's blocks
        gather_bytes = (dist.get_world_size() - 1) * sum(
            p.to_local().numel() * p.to_local().element_size()
            for p in T.leaves(params)
            if any(isinstance(x, Shard) for x in p.placements))

        rows = D.local_rows(batch, mesh)
        split = rows is not batch and bool(groups)
        lcfg = cfg
        if split and cfg.n_experts:
            lcfg = cfg.replace(moe_groups=cfg.moe_groups // shd.dp_size(mesh))
        mask = rows.get("loss_mask")
        count = (torch.sum(mask.to(torch.float32)) if mask is not None
                 else torch.tensor(float(rows["labels"].numel()),
                                   device=rows["labels"].device))
        if split:
            for g in groups:
                D.all_reduce(count, group=g)
        loss, grads = steps.loss_and_grads(
            full, rows, lcfg, engine=engine,
            denom=torch.clamp(count, min=1.0))
        del full

        t0 = time.perf_counter()
        flat_g = T.leaves(grads)
        reduce_bytes = 0
        if split:
            buf = torch.cat([g.reshape(-1).to(torch.float32)
                             for g in flat_g] + [loss.reshape(1)])
            for g in groups:
                D.all_reduce(buf, group=g)
            reduce_bytes = buf.numel() * buf.element_size()
            parts = torch.split(buf, [g.numel() for g in flat_g] + [1])
            flat_g = [p.view(g.shape).to(g.dtype)
                      for p, g in zip(parts, flat_g)]
            loss = parts[-1].reshape(())
            del buf
        _sync(dev)
        t_reduce = time.perf_counter() - t0
        grads, gnorm = clip_by_global_norm(T.unflatten(grads, flat_g), 1.0)

        p_flat = T.leaves(params)
        blocks = lambda tree: [D.block_of(g, p.device_mesh, p.placements)
                               for g, p in zip(T.leaves(tree), p_flat)]
        roles = _state_roles(optimizer.name, opt_state)
        s_flat = T.leaves(opt_state)
        if len(roles) != len(s_flat):
            raise ValueError(f"{optimizer.name} state of {len(s_flat)} "
                             f"leaves, {len(roles)} expected")
        s_local, s_aligned = [], []
        for (i, role), s in zip(roles, s_flat):
            ref = p_flat[i] if i is not None else p_flat[0]
            want = _aligned(ref.placements, ref.ndim, role)
            s_aligned.append(want)
            s_local.append(s.to_local() if tuple(s.placements) == want
                           else D.block_of(D.gather(s), s.device_mesh, want))
        kw = {}
        if optimizer.name == "adafactor":
            kw["mean"] = [whole_mean(p.device_mesh, p.placements, p.shape)
                          for p in p_flat]
        new_p, new_s = optimizer.update(
            T.unflatten(grads, blocks(grads)),
            T.unflatten(opt_state, s_local),
            T.unflatten(params, [p.to_local() for p in p_flat]),
            torch.tensor(lr, dtype=torch.float32, device=dev), **kw)
        new_p = [D.placed(x, p.device_mesh, p.placements, p.shape)
                 for x, p in zip(T.leaves(new_p), p_flat)]
        new_s_flat = []
        for x, s, want in zip(T.leaves(new_s), s_flat, s_aligned):
            if tuple(s.placements) != want:
                x = D.block_of(D.whole_of(x, s.device_mesh, want),
                               s.device_mesh, s.placements)
            new_s_flat.append(D.placed(x, s.device_mesh, s.placements,
                                       s.shape))
        return (T.unflatten(params, new_p),
                T.unflatten(opt_state, new_s_flat),
                dict(loss=loss, grad_norm=gnorm,
                     comm=dict(gather_s=t_gather, gather_bytes=gather_bytes,
                               reduce_s=t_reduce,
                               reduce_bytes=reduce_bytes)))

    return train_step
