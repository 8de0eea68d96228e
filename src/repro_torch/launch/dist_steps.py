"""The train step on a rank mesh: ``launch/steps.make_train_step`` over
the ranks of ``launch/mesh.make_rank_mesh``, with the values of one rank.

The reference has no module for this: it runs the single-device
``make_train_step`` under ``jax.jit`` on trees placed by
``jax.device_put(tree, NamedSharding)``, and GSPMD keeps the values
(``tests/test_multidevice.py:108-147``).  Here the params and the
optimizer state are trees of DTensors (``parallel/distributed.shard_tree``
of ``param_shardings`` / ``opt_state_shardings``), the compute runs on
plain tensors, and the collectives are explicit: a layer's leaves are
gathered whole only while the layer runs (``_LayerGather``, read through
``engine["layer_fetch"]``), its gradient reduced as its backward ends,
and a MoE layer routes over the whole batch's tokens (``moe_apply``'s
``engine["dp_rows"]``) where a rank cannot route its own groups.
"""

from __future__ import annotations

import math
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import tree as T
from repro_torch.launch import steps
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer
from repro_torch.optim.optimizers import scale_to_norm
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


STACKS = ("layers", "enc_layers", "dec_layers")


class _Entry:
    """One stacked leaf of a layer tree: its index in the params' leaves,
    the DTensor, a layer's placements and shape (the layer axis, never
    sharded, taken off), whether any mesh dim shards it, and the rank's
    gradient blocks, filled a layer at a time."""

    def __init__(self, j: int, leaf: Any):
        self.j, self.leaf = j, leaf
        self.places = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                            for p in leaf.placements)
        if any(isinstance(p, Shard) and p.dim == 0 for p in leaf.placements):
            raise ValueError("a stacked layer axis is sharded")
        self.shape = tuple(leaf.shape[1:])
        self.sharded = any(isinstance(p, Shard) for p in self.places)
        self.local = leaf.to_local()
        self.grad = torch.empty_like(self.local)
        self.sumsq: List[Optional[torch.Tensor]] = [None] * leaf.shape[0]


class _LayerGather(torch.autograd.Function):
    """Forward: layer ``i`` of the stacked ``params[key]``, whole, through
    one all-gather.  Backward: that layer's gradient through one flat
    all-reduce over the rank's dp groups, the rank's blocks kept.  Its
    input is a scalar token of the layer, so that autograd reaches it."""

    @staticmethod
    def forward(ctx, token, sched, key, i):
        ctx.sched, ctx.key, ctx.i = sched, key, i
        return tuple(sched.gather_layer(key, i))

    @staticmethod
    def backward(ctx, *grads):
        ctx.sched.reduce_layer(ctx.key, ctx.i, grads)
        return torch.zeros((), device=grads[0].device), None, None, None


class _LayerSchedule:
    """The per-layer gathers and reduces of one train step: ``fetch(key,
    i)`` is the forward's ``engine["layer_fetch"]``.  It keeps the bytes
    and host seconds of the collectives (re-gathers under remat included)
    and the largest number of layers whose whole leaves were alive at once,
    counted from the gathered tensors' lifetimes."""

    def __init__(self, params: Any, groups: List[Any], reduce: bool,
                 dev: torch.device):
        self.groups, self.reduce, self.dev = groups, reduce, dev
        self.stacks: Dict[str, List[_Entry]] = {}
        for j, (path, leaf) in enumerate(T.flatten_with_paths(params)):
            if path[0] in STACKS:
                self.stacks.setdefault(path[0], []).append(_Entry(j, leaf))
        self.trees = {key: params[key] for key in self.stacks}
        self.tokens = {key: [torch.zeros((), device=dev, requires_grad=True)
                             for _ in range(es[0].leaf.shape[0])]
                       for key, es in self.stacks.items()}
        self.world = dist.get_world_size()
        self.stats = dict(gather_s=0.0, gather_bytes=0, reduce_s=0.0,
                          reduce_bytes=0, layer_gathers=0)
        self.alive = self.alive_max = 0

    def fetch(self, key: str, i: int) -> Any:
        wholes = _LayerGather.apply(self.tokens[key][i], self, key, i)
        return T.unflatten(self.trees[key], list(wholes))

    def gather_layer(self, key: str, i: int) -> List[torch.Tensor]:
        t0 = time.perf_counter()
        entries = self.stacks[key]
        sharded = [e for e in entries if e.sharded]
        wholes = {}
        if sharded:
            dmesh = sharded[0].leaf.device_mesh
            got = D.gather_blocks([e.local[i] for e in sharded],
                                  [e.shape for e in sharded],
                                  [e.places for e in sharded], dmesh)
            wholes = {e.j: w for e, w in zip(sharded, got)}
            self.stats["gather_bytes"] += (self.world - 1) * sum(
                e.local[i].numel() * e.local.element_size() for e in sharded)
        out = [wholes[e.j] if e.sharded else e.local[i].clone()
               for e in entries]
        _sync(self.dev)
        self.stats["gather_s"] += time.perf_counter() - t0
        self.stats["layer_gathers"] += 1
        self.alive += 1
        self.alive_max = max(self.alive_max, self.alive)
        # the layer counts as alive until the last of its leaves is freed
        left = [len(out)]

        def one_freed():
            left[0] -= 1
            if not left[0]:
                self.alive -= 1
        for t in out:
            weakref.finalize(t, one_freed)
        return out

    def reduce_layer(self, key: str, i: int, grads) -> None:
        t0 = time.perf_counter()
        entries = self.stacks[key]
        flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
        if self.reduce:
            for g in self.groups:
                D.all_reduce(flat, group=g)
            self.stats["reduce_bytes"] += flat.numel() * flat.element_size()
        parts = torch.split(flat, [g.numel() for g in grads])
        for e, part, g in zip(entries, parts, grads):
            whole = part.view(g.shape).to(e.local.dtype)
            e.sumsq[i] = torch.sum(torch.square(whole.to(torch.float32)))
            e.grad[i].copy_(D.block_of(whole, e.leaf.device_mesh, e.places))
        _sync(self.dev)
        self.stats["reduce_s"] += time.perf_counter() - t0


def make_distributed_train_step(cfg: ModelConfig, optimizer: Optimizer,
                                mesh: Any, lr: float = 3e-4,
                                engine: Optional[Any] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on a rank mesh, the contract of ``make_train_step``:
    ``params`` and ``opt_state`` are ``shard_tree`` s (of
    ``param_shardings`` / ``opt_state_shardings``), ``batch`` the whole
    batch on every rank.  Each step

    1. gathers the leaves outside the layers (embeddings, final norm, head,
       meta tokens, ``dec_pos``) once, whole;
    2. runs the family's loss on the rank's rows (``local_rows``), the
       loss being the rows' masked sum over the whole batch's token count
       (all-reduced first), so that the ranks' losses add up to the
       single-rank mean.  The layer loops read each layer's leaves through
       ``engine["layer_fetch"]``: one all-gather of the layer's blocks just
       before its use, freed after its forward (under ``remat`` gathered
       again in the backward);
    3. as each layer's backward ends, all-reduces its gradient in one flat
       f32 buffer over the rank's dp groups, adds its sum of squares to
       the global norm and keeps the rank's blocks; the leaves outside the
       layers are reduced once at the end, with the loss;
    4. clips the blocks by the global norm, which every rank now holds;
    5. updates the rank's own blocks (Adafactor's whole-leaf means through
       :func:`whole_mean`).

    A MoE layer routes and caps over its group's tokens: where
    ``moe_groups`` is a multiple of the dp size each rank routes its own
    ``moe_groups / dp`` groups, else each MoE layer gathers the router's
    rows over the dp groups and routes the whole batch's tokens
    (``moe_apply``'s ``engine["dp_rows"]``).  Ranks along "model" hold the
    same rows and compute the same gradient (ROADMAP C19).  ``metrics``
    adds the host seconds and bytes of the gathers and the reduces
    (``comm``) and the most layers whose whole leaves were alive at once
    (``comm["layers_alive_max"]``)."""
    loss_fn = steps._loss_fn(cfg)       # refuse an unknown family now
    engine = dict(engine or {})
    engine.setdefault("dp_axes", shd.dp_axes(mesh))
    groups = _dp_groups(mesh)
    dp = shd.dp_size(mesh)
    # a rank routes its own moe_groups / dp groups where they divide
    own_groups = cfg.moe_groups >= dp and cfg.moe_groups % dp == 0
    dev = mesh.devices.flat[0].device

    def train_step(params, opt_state, batch):
        rows = D.local_rows(batch, mesh)
        split = rows is not batch and bool(groups)
        sched = _LayerSchedule(params, groups, split, dev)
        eng = dict(engine, layer_fetch=sched.fetch)
        lcfg = cfg
        if split and cfg.n_experts and own_groups:
            lcfg = cfg.replace(moe_groups=cfg.moe_groups // dp)
        elif split and cfg.n_experts:
            eng["dp_rows"] = D.dp_rows(next(iter(batch.values())).shape[0],
                                       mesh)
        mask = rows.get("loss_mask")
        count = (torch.sum(mask.to(torch.float32)) if mask is not None
                 else torch.tensor(float(rows["labels"].numel()),
                                   device=rows["labels"].device))
        if split:
            for g in groups:
                D.all_reduce(count, group=g)

        p_flat = T.leaves(params)
        rest = {k: v for k, v in params.items() if k not in sched.stacks}
        t0 = time.perf_counter()
        whole = T.leaves(D.gather_tree(rest))
        _sync(dev)
        sched.stats["gather_s"] += time.perf_counter() - t0
        sched.stats["gather_bytes"] += (dist.get_world_size() - 1) * sum(
            p.to_local().numel() * p.to_local().element_size()
            for p in T.leaves(rest)
            if any(isinstance(x, Shard) for x in p.placements))
        tokens = [t for ts in sched.tokens.values() for t in ts]
        with torch.enable_grad():
            leaves = [w.detach().requires_grad_() for w in whole]
            loss = loss_fn(T.unflatten(rest, leaves), rows, lcfg, engine=eng,
                           denom=torch.clamp(count, min=1.0))
            grads = torch.autograd.grad(loss, leaves + tokens,
                                        allow_unused=True,
                                        materialize_grads=True)
        loss = loss.detach()
        del whole, leaves
        g_rest = list(grads[:len(T.leaves(rest))])
        del grads

        t0 = time.perf_counter()
        if split:
            buf = torch.cat([g.reshape(-1).to(torch.float32)
                             for g in g_rest] + [loss.reshape(1)])
            for g in groups:
                D.all_reduce(buf, group=g)
            sched.stats["reduce_bytes"] += buf.numel() * buf.element_size()
            parts = torch.split(buf, [g.numel() for g in g_rest] + [1])
            g_rest = [p.view(g.shape).to(g.dtype)
                      for p, g in zip(parts, g_rest)]
            loss = parts[-1].reshape(())
            del buf
        _sync(dev)
        sched.stats["reduce_s"] += time.perf_counter() - t0

        # the global norm from each leaf's dp-summed whole gradient, in tree
        # order (a stacked leaf's layers in order), then the rank's blocks
        stacked = {e.j: e for es in sched.stacks.values() for e in es}
        rest_g = iter(g_rest)
        sumsq, g_blocks = [], []
        for j, p in enumerate(p_flat):
            if j in stacked:
                e = stacked[j]
                sumsq.append(sum(e.sumsq))
                g_blocks.append(e.grad)
            else:
                g = next(rest_g)
                sumsq.append(torch.sum(torch.square(g.to(torch.float32))))
                g_blocks.append(D.block_of(g, p.device_mesh, p.placements))
        gnorm = torch.sqrt(sum(sumsq))
        grads = scale_to_norm(T.unflatten(params, g_blocks), gnorm, 1.0)

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
            grads, T.unflatten(opt_state, s_local),
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
        comm = dict(sched.stats, layers_alive_max=sched.alive_max)
        return (T.unflatten(params, new_p),
                T.unflatten(opt_state, new_s_flat),
                dict(loss=loss, grad_norm=gnorm, comm=comm))

    return train_step
