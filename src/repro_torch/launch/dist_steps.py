"""The train step on a rank mesh: ``launch/steps.make_train_step`` over
the ranks of ``launch/mesh.make_rank_mesh``, with the values of one rank.

The reference has no module for this: it runs the single-device
``make_train_step`` under ``jax.jit`` on trees placed by
``jax.device_put(tree, NamedSharding)``, and GSPMD keeps the values and
splits each matmul over "model" (``tests/test_multidevice.py:108-147``).
Here the params and the optimizer state are trees of DTensors
(``parallel/distributed.shard_tree`` of ``param_shardings`` /
``opt_state_shardings``), the compute runs on plain tensors, and the
collectives are explicit: a layer's leaves are gathered over the dp axes
only while the layer runs (``_LayerGather``, read through
``engine["layer_fetch"]``), each matmul weight that "model" shards kept
as the rank's block (``parallel/distributed.ModelBlock``), so that the
ranks of a "model" row each compute their share of the layer, and its
gradient is reduced over the dp axes as its backward ends.  A MoE layer
routes over the whole batch's tokens (``moe_apply``'s
``engine["dp_rows"]``) where a rank cannot route its own groups, each
rank running its share of the expert slots.
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
# the leaves computed on the rank's "model" block where "model" splits
# them: every layer matmul weight, the embedding and the head.  The other
# leaves "model" shards (conv_w, A_log, the MoE router) are gathered whole
SPLIT = shd.PACKABLE | {"embed", "lm_head"}


class _Entry:
    """One leaf of the params: its index in the params' leaves, its name,
    the DTensor, the placements and shape of a layer (the layer axis of a
    stacked leaf, never sharded, taken off), whether any mesh dim shards
    it, and the rank's gradient blocks, filled a layer at a time.

    ``block`` leaves (a layer matmul weight, or the embedding or head
    where "model" splits them) reach the model code as a ``ModelBlock``;
    ``split`` is the dim "model" splits (None: whole), ``dp_places`` the
    placements with the "model" dim replicated (the gradient block kept of
    the rank's model block)."""

    def __init__(self, j: int, leaf: Any, name: str, stacked: bool,
                 model_dim: Optional[int], model_size: int):
        self.j, self.leaf, self.name = j, leaf, name
        lead = 1 if stacked else 0
        if stacked and any(isinstance(p, Shard) and p.dim == 0
                           for p in leaf.placements):
            raise ValueError("a stacked layer axis is sharded")
        self.places = tuple(Shard(p.dim - lead) if isinstance(p, Shard)
                            else p for p in leaf.placements)
        self.shape = tuple(leaf.shape[lead:])
        self.sharded = any(isinstance(p, Shard) for p in self.places)
        self.local = leaf.to_local()
        self.grad = torch.empty_like(self.local)
        self.sumsq: List[Optional[torch.Tensor]] = (
            [None] * leaf.shape[0] if stacked else [None])
        on_model = (self.places[model_dim] if model_dim is not None
                    else Replicate())
        self.split = (on_model.dim if isinstance(on_model, Shard)
                      and model_size > 1 and name in SPLIT else None)
        # every layer matmul weight is counted, split or whole
        self.block = name in SPLIT and (stacked or self.split is not None)
        self.over_model = isinstance(on_model, Shard) and model_size > 1
        self.dp_places = tuple(Replicate() if i == model_dim else p
                               for i, p in enumerate(self.places))

    def grad_block(self, g: torch.Tensor) -> torch.Tensor:
        """The rank's block of the dp-summed gradient ``g`` (of the
        weight's model block where split, else whole)."""
        return D.block_of(g, self.leaf.device_mesh, self.places
                          if self.split is None else self.dp_places)


class _LayerGather(torch.autograd.Function):
    """Forward: layer ``i`` of the stacked ``params[key]``, gathered.
    Backward: that layer's gradient through one flat all-reduce over the
    rank's dp groups, the rank's blocks kept.  Its input is a scalar token
    of the layer, so that autograd reaches it."""

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
    i)`` is the forward's ``engine["layer_fetch"]``.  A leaf that "model"
    splits (``_Entry.split``) is gathered over the dp axes only and comes
    as the rank's ``ModelBlock``; every other sharded leaf is gathered
    whole over the world, as on a mesh whose "model" axis has size 1.  It
    keeps the bytes and host seconds of the collectives (re-gathers under
    remat included), the names of the leaves gathered whole over "model",
    and the largest number of layers whose gathered leaves were alive at
    once, counted from the gathered tensors' lifetimes."""

    def __init__(self, params: Any, mesh: Any, groups: List[Any],
                 reduce: bool, dev: torch.device):
        self.groups, self.reduce, self.dev = groups, reduce, dev
        self.dmesh = mesh.device_mesh
        names = mesh.axis_names
        model_dim = names.index("model") if "model" in names else None
        model_size = mesh.shape.get("model", 1)
        self.dp_dims = [names.index(a) for a in shd.dp_axes(mesh)]
        self.axis = D.ModelAxis(mesh.group("model") if model_dim is not None
                                else None, dev,
                                shd.dp_size(mesh) if reduce else 1)
        self.stacks: Dict[str, List[_Entry]] = {}
        self.rest: List[_Entry] = []
        for j, (path, leaf) in enumerate(T.flatten_with_paths(params)):
            stacked = path[0] in STACKS
            e = _Entry(j, leaf, path[-1], stacked, model_dim, model_size)
            (self.stacks.setdefault(path[0], []) if stacked
             else self.rest).append(e)
        self.trees = {key: params[key] for key in self.stacks}
        self.tokens = {key: [torch.zeros((), device=dev, requires_grad=True)
                             for _ in range(es[0].leaf.shape[0])]
                       for key, es in self.stacks.items()}
        self.world = dist.get_world_size()
        self.stats = dict(gather_s=0.0, gather_bytes=0, gather_calls=0,
                          reduce_s=0.0, reduce_bytes=0, reduce_calls=0,
                          layer_gathers=0)
        self.over_model: set = set()
        self.alive = self.alive_max = 0

    def entries(self) -> List[_Entry]:
        return self.rest + [e for es in self.stacks.values() for e in es]

    def gather(self, pairs: Sequence[Tuple[_Entry, torch.Tensor]]
               ) -> List[torch.Tensor]:
        """Each (entry, this rank's block) gathered: a split leaf over the
        dp axes (the rank's model block), any other sharded leaf whole
        over the world (``gather_blocks``), the rest copied."""
        t0 = time.perf_counter()
        got: Dict[int, torch.Tensor] = {}
        split = [(e, x) for e, x in pairs if e.split is not None]
        whole = [(e, x) for e, x in pairs if e.split is None and e.sharded]
        if split:
            blocks, nbytes, calls = D.gather_over(
                [x for _, x in split], [e.places for e, _ in split],
                self.dmesh, self.dp_dims)
            got.update({e.j: b for (e, x), b in zip(split, blocks)
                        if b is not x})
            self.stats["gather_bytes"] += nbytes
            self.stats["gather_calls"] += calls
        if whole:
            wholes = D.gather_blocks([x for _, x in whole],
                                     [e.shape for e, _ in whole],
                                     [e.places for e, _ in whole],
                                     self.dmesh)
            got.update({e.j: w for (e, _), w in zip(whole, wholes)})
            self.stats["gather_calls"] += 1
            self.stats["gather_bytes"] += (self.world - 1) * sum(
                x.numel() * x.element_size() for _, x in whole)
            self.over_model.update(e.name for e, _ in whole
                                   if e.over_model)
        out = [got[e.j] if e.j in got else x.clone() for e, x in pairs]
        D.sync(self.dev)
        self.stats["gather_s"] += time.perf_counter() - t0
        return out

    def wrap(self, e: _Entry, t: torch.Tensor) -> Any:
        return D.ModelBlock(t, e.split, self.axis) if e.block else t

    def fetch(self, key: str, i: int) -> Any:
        got = _LayerGather.apply(self.tokens[key][i], self, key, i)
        return T.unflatten(self.trees[key], [
            self.wrap(e, t) for e, t in zip(self.stacks[key], got)])

    def gather_layer(self, key: str, i: int) -> List[torch.Tensor]:
        out = self.gather([(e, e.local[i]) for e in self.stacks[key]])
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

    def dp_sum(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``grads`` summed over the rank's dp groups in one flat f32
        all-reduce (as they are where the rows do not split); each comes
        back f32 in its shape."""
        flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
        if self.reduce:
            for g in self.groups:
                D.all_reduce(flat, group=g)
            self.stats["reduce_bytes"] += flat.numel() * flat.element_size()
            self.stats["reduce_calls"] += len(self.groups)
        return [p.view(g.shape) for p, g in zip(
            torch.split(flat, [g.numel() for g in grads]), grads)]

    def reduce_layer(self, key: str, i: int, grads) -> None:
        t0 = time.perf_counter()
        for e, g in zip(self.stacks[key], self.dp_sum(grads)):
            g = g.to(e.local.dtype)
            e.sumsq[i] = torch.sum(torch.square(g.to(torch.float32)))
            e.grad[i].copy_(e.grad_block(g))
        D.sync(self.dev)
        self.stats["reduce_s"] += time.perf_counter() - t0

    def grad_norm(self, sumsq: Dict[int, torch.Tensor]) -> torch.Tensor:
        """The global gradient norm from each leaf's sum of squares (index
        ``j``, tree order): a split leaf's covers the rank's model block
        only, so those are summed over "model" in one all-reduce; no dp
        replica is counted twice."""
        split = [e.j for e in self.entries() if e.split is not None]
        if split:
            summed = self.axis.all_reduce(torch.stack([sumsq[j]
                                                       for j in split]))
            sumsq = {**sumsq, **dict(zip(split, summed))}
        return torch.sqrt(sum(sumsq[j] for j in sorted(sumsq)))


def make_distributed_train_step(cfg: ModelConfig, optimizer: Optimizer,
                                mesh: Any, lr: float = 3e-4,
                                engine: Optional[Any] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on a rank mesh, the contract of ``make_train_step``:
    ``params`` and ``opt_state`` are ``shard_tree`` s (of
    ``param_shardings`` / ``opt_state_shardings``), ``batch`` the whole
    batch on every rank.  Each step

    1. gathers the leaves outside the layers (embeddings, final norm, head,
       meta tokens, ``dec_pos``) once;
    2. runs the family's loss on the rank's rows (``local_rows``), the
       loss being the rows' masked sum over the whole batch's token count
       (all-reduced first), so that the ranks' losses add up to the
       single-rank mean.  The layer loops read each layer's leaves through
       ``engine["layer_fetch"]``: one all-gather of the layer's blocks just
       before its use, freed after its forward (under ``remat`` gathered
       again in the backward);
    3. as each layer's backward ends, all-reduces its gradient in one flat
       f32 buffer over the rank's dp groups, keeps its sum of squares for
       the global norm and keeps the rank's blocks; the leaves outside the
       layers are reduced once at the end, with the loss;
    4. clips the blocks by the global norm, which every rank now holds;
    5. updates the rank's own blocks (Adafactor's whole-leaf means through
       :func:`whole_mean`).

    The compute splits over "model" as the reference's GSPMD splits it: a
    leaf that "model" shards and that a matmul reads (every layer weight,
    the embedding, the head; ``SPLIT``) is gathered over the dp axes only
    and comes to the model code as the rank's ``ModelBlock``, so each rank
    computes its model share of every such matmul: column blocks of the
    dense weights, heads of the attention where both head counts divide
    (``layers.head_split``), its experts or its F / M of each expert, its
    vocab rows of the embedding, the logits and the loss.  The
    activations cross "model" through ``ModelAxis``'s operators.  The
    other leaves "model" shards (``conv_w``, ``A_log``, the router) are
    gathered whole, and the SSM's conv and scan run whole on the gathered
    activation.  On a mesh whose "model" axis has size 1 nothing splits.

    A MoE layer routes and caps over its group's tokens: where
    ``moe_groups`` is a multiple of the dp size each rank routes its own
    ``moe_groups / dp`` groups, else each MoE layer gathers the router's
    rows over the dp groups and routes the whole batch's tokens
    (``moe_apply``'s ``engine["dp_rows"]``), and the dp ranks of a model
    row then split its experts' slots again.  ``metrics["comm"]`` holds
    the weight gathers (``gather_bytes`` / ``gather_s`` /
    ``gather_calls``, ``layer_gathers``: over the dp axes, and over the
    world for the leaves gathered whole), the dp gradient reduces
    (``reduce_bytes`` / ``reduce_s`` / ``reduce_calls``), the model-axis
    activation collectives and the rank's share of the compute
    (``ModelAxis.stats``: ``act_*``, ``linears_*``, ``layer_macs*``,
    ``expert_slots*``, ``logits``), the leaves gathered whole over "model"
    (``over_model``), and the most layers whose gathered leaves were alive
    at once (``layers_alive_max``)."""
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
        sched = _LayerSchedule(params, mesh, groups, split, dev)
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
        whole = sched.gather([(e, e.local) for e in sched.rest])
        tokens = [t for ts in sched.tokens.values() for t in ts]
        with torch.enable_grad():
            leaves = [w.detach().requires_grad_() for w in whole]
            loss = loss_fn(T.unflatten(rest, [
                sched.wrap(e, x) for e, x in zip(sched.rest, leaves)]),
                rows, lcfg, engine=eng, denom=torch.clamp(count, min=1.0))
            grads = torch.autograd.grad(loss, leaves + tokens,
                                        allow_unused=True,
                                        materialize_grads=True)
        loss = loss.detach()
        del whole, leaves
        g_rest = list(grads[:len(sched.rest)])
        del grads

        t0 = time.perf_counter()
        *g_rest, loss = sched.dp_sum(g_rest + [loss.reshape(1)])
        g_rest = [g.to(e.local.dtype) for g, e in zip(g_rest, sched.rest)]
        loss = loss.reshape(())
        D.sync(dev)
        sched.stats["reduce_s"] += time.perf_counter() - t0

        # each leaf's sum of squares of its dp-summed gradient (a stacked
        # leaf's layers in order), then the rank's blocks
        sumsq, g_blocks = {}, {}
        for e, g in zip(sched.rest, g_rest):
            sumsq[e.j] = torch.sum(torch.square(g.to(torch.float32)))
            g_blocks[e.j] = e.grad_block(g)
        for es in sched.stacks.values():
            for e in es:
                sumsq[e.j] = sum(e.sumsq)
                g_blocks[e.j] = e.grad
        gnorm = sched.grad_norm(sumsq)
        grads = scale_to_norm(T.unflatten(params, [
            g_blocks[j] for j in range(len(p_flat))]), gnorm, 1.0)

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
        comm = dict(sched.stats, **sched.axis.stats,
                    logits=sched.axis.logits,
                    over_model=sorted(sched.over_model),
                    layers_alive_max=sched.alive_max)
        return (T.unflatten(params, new_p),
                T.unflatten(opt_state, new_s_flat),
                dict(loss=loss, grad_norm=gnorm, comm=comm))

    return train_step
