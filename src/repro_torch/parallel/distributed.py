"""Ranks: the processes of one ``torch.distributed`` group, their
collectives, and trees placed on a mesh of them.

The reference has no module for this: it places a tree with
``jax.device_put(tree, NamedSharding)`` and lets GSPMD run the program on
it.  The port's counterpart of a device is a rank, one process of a
``torch.distributed`` process group (``launch/mesh.make_rank_mesh``).

* :func:`run_ranks` starts the processes (``spawn``) and one ``gloo``
  group through a ``file://`` rendezvous in a fresh temporary directory,
  and returns each rank's result.
* :func:`all_reduce`, :func:`all_gather` and :func:`ring_shift` are the
  collectives (under ``gloo`` the ring shift of a CUDA tensor is staged
  through pinned host memory), :func:`barrier` and :func:`is_lead` the
  checkpoint's.
* :func:`placements`, :func:`shard_tree`, :func:`gather_tree` and
  :func:`local_rows` are ``device_put``, its inverse and the batch's
  ``batch_pspec`` rows; :func:`gather_blocks` is the one all-gather of
  many leaves' blocks over the world, :func:`gather_over` its
  counterpart over some mesh dims only (a layer's blocks over the dp
  axes in the train step), and :class:`DPRows` a rank's rows of the
  batch gathered and scattered back (the MoE layer's routed tokens).  A
  placed leaf is a DTensor that holds this rank's block only.  DTensors
  are storage and placement here, never compute: plain model code run on
  DTensors fails inside DTensor's sharding propagation (an embedding
  placed as ``P("model", "data")`` under a batch-sharded token DTensor),
  so the train step on these trees (``launch/dist_steps.py``) computes
  on plain tensors.
* :class:`ModelAxis` and :class:`ModelBlock` split the train step's
  compute over "model", as the reference's GSPMD does: a layer weight
  that "model" shards reaches the model code as the rank's block
  (``models/layers.linear`` dispatches on it), and the activations cross
  the axis through Megatron's operators, each an autograd Function:
  ``gather`` (forward an all-gather, backward the rank's slice),
  ``copy`` (forward the identity, backward an all-reduce), ``sum``
  (forward an all-reduce, backward the identity) and ``split`` (forward
  the rank's slice, backward an all-gather).

Ranks on several cards under NCCL are ROADMAP A11 (b) item 6.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import math
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.core import tree as T
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.parallel import sharding as shd

# ring shifts of CUDA tensors staged through pinned host memory in this
# process (:func:`ring_shift`)
STAGED: collections.Counter = collections.Counter()


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, init: str, device: str,
               timeout_s: float, fn: Callable, args: Tuple,
               results: Any) -> None:
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev)          # the context, before the mesh
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(
            "gloo", init_method=init, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def run_ranks(fn: Callable, world: int, *args: Any, device: DeviceLike = None,
              timeout_s: float = 300.0) -> List[Any]:
    """``fn(*args)`` on ``world`` new processes (``spawn``), each a rank
    of one ``gloo`` process group, each set up on ``device`` (default
    ``cuda``, every rank on the one card; raises without one).  Returns
    the ranks' results in rank order.  Raises ``RuntimeError`` with the
    tracebacks if any rank fails, and ``TimeoutError`` if the ranks
    outlive ``timeout_s``; either way every rank is stopped.  ``fn`` and
    ``args`` are pickled: ``fn`` is a module-level function."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, init, str(dev), timeout_s, fn,
                                   args, results))
                 for r in range(world)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            grace = None        # after a failure, the others' reports
            while len(out) + len(errors) < world:
                now = time.monotonic()
                if grace is not None and now > grace:
                    break
                try:
                    rank, ok, val = results.get(timeout=0.2)
                except queue.Empty:
                    if now > deadline:
                        raise TimeoutError(
                            f"{world} ranks outlived {timeout_s} s; ranks "
                            f"{sorted(set(range(world)) - set(out))} had "
                            "not finished")
                    dead = [r for r, p in enumerate(procs) if r not in out
                            and r not in errors
                            and p.exitcode not in (None, 0)]
                    if dead and grace is None:
                        grace = now + 2.0   # its own report may be queued
                    continue
                (out if ok else errors)[rank] = val
                if not ok and grace is None:
                    grace = time.monotonic() + 2.0
            for r, p in enumerate(procs):
                if r not in out and r not in errors and p.exitcode:
                    errors[r] = f"exited {p.exitcode} with no report"
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("rank(s) failed:\n" + "\n".join(
            f"--- rank {r}:\n{msg}" for r, msg in sorted(errors.items())))
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None
               ) -> torch.Tensor:
    """``t`` reduced in place over ``group``; returns ``t``."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` of ``group`` (all of one shape), in group rank
    order."""
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return parts


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """``ppermute`` over the ring ``i -> i + 1`` of ``group``: this rank's
    ``t`` goes to the next rank, and the previous rank's is returned.

    gloo's send / receive of a CUDA tensor hands the device pointer to a
    socket ("writev ... Bad address" on the card), so under gloo a CUDA
    ``t`` goes through a pinned host buffer, on every call (``STAGED``).
    Its all-reduce and all-gather take CUDA tensors, and go through the
    host inside gloo."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prev = dist.get_global_rank(group, (me - 1) % n)
    src = t.contiguous()
    if src.is_cuda and dist.get_backend(group) == "gloo":
        src = torch.empty(src.shape, dtype=src.dtype,
                          pin_memory=True).copy_(src)
        STAGED["send_recv"] += 1
    got = torch.empty_like(src)
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, nxt, group),
            dist.P2POp(dist.irecv, got, prev, group)]):
        work.wait()
    return got.to(t.device)


def barrier() -> None:
    """Every rank of the default group reaches this point; a no-op on one
    process."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def is_lead() -> bool:
    """Rank 0, or the one process when no group is up."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``): what
    ``checkpoint`` restores onto and what ``Trainer(shardings=)`` takes."""
    mesh: Any
    spec: shd.PartitionSpec


def named_shardings(spec_tree: Any, tree_like: Any, mesh: Any) -> Any:
    """``tree_like``'s structure with each leaf's spec on ``mesh``."""
    return T.unflatten(tree_like, [NamedSharding(mesh, s) for s in
                                   shd.spec_leaves(tree_like, spec_tree)])


def placements(spec: Sequence[Any], mesh: Any) -> Tuple[Any, ...]:
    """One DTensor placement a mesh dim: ``Shard(d)`` for each axis that
    ``spec`` names at tensor dim ``d``, ``Replicate()`` elsewhere.  An
    entry naming a tuple of axes shards that dim over each, the first named
    outermost (JAX's layout; DTensor splits mesh dims in mesh order, so the
    tuple must follow it).  An axis the mesh lacks has size 1."""
    out: List[Any] = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        where = [mesh.axis_names.index(a) for a in names
                 if a in mesh.axis_names]
        if where != sorted(where):
            raise ValueError(f"spec entry {entry} runs against the mesh's "
                             f"axis order {mesh.axis_names}")
        for i in where:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {mesh.axis_names[i]} shards two "
                                 f"dims of spec {spec}")
            out[i] = Shard(d)
    return tuple(out)


def _index(shape: Sequence[int], dmesh, places: Sequence[Any],
           coord: Sequence[int]) -> Tuple[slice, ...]:
    """The slices of the block at mesh coordinate ``coord`` of a whole
    tensor of ``shape`` under ``places`` (mesh dims split in mesh order,
    as DTensor does)."""
    index = [slice(0, n) for n in shape]
    for i, p in enumerate(places):
        if isinstance(p, Shard):
            sl = index[p.dim]
            size = (sl.stop - sl.start) // dmesh.size(i)
            index[p.dim] = slice(sl.start + coord[i] * size,
                                 sl.start + (coord[i] + 1) * size)
    return tuple(index)


def block_of(t: Any, dmesh, places: Sequence[Any]) -> Any:
    """This rank's block of the whole ``t`` (a tensor or a numpy array)
    under ``places``: a view."""
    if not len(t.shape):
        return t
    return t[_index(t.shape, dmesh, places, dmesh.get_coordinate())]


def whole_of(local: torch.Tensor, dmesh, places: Sequence[Any]
           ) -> torch.Tensor:
    """The whole tensor from every rank's block: the innermost mesh dim
    first."""
    for i in reversed(range(len(places))):
        p = places[i]
        if isinstance(p, Shard) and dmesh.size(i) > 1:
            local = torch.cat(all_gather(local, dmesh.get_group(i)),
                              dim=p.dim)
    return local


def placed(local: torch.Tensor, dmesh, places: Sequence[Any],
            shape: Sequence[int]) -> DTensor:
    local = local.contiguous()
    whole = torch.empty(tuple(shape), device="meta")
    return DTensor.from_local(local, dmesh, places, run_check=False,
                              shape=whole.shape, stride=whole.stride())


def shard(t: torch.Tensor, spec: Sequence[Any], mesh: Any) -> DTensor:
    """``t`` (whole on every rank) placed by ``spec``: a DTensor holding
    this rank's block only (a copy, so ``t`` may be freed)."""
    t = t.to(mesh.devices.flat[0].device)
    dt = distribute_tensor(t, mesh.device_mesh, placements(spec, mesh),
                           src_data_rank=None)
    local = dt.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        dt = placed(local.clone(), dt.device_mesh, dt.placements, t.shape)
    return dt


def shard_tree(tree: Any, spec_tree: Any, mesh: Any) -> Any:
    """``jax.device_put(tree, shardings)``: every leaf a DTensor of its
    spec's block."""
    return T.unflatten(tree, [shard(leaf, spec, mesh) for leaf, spec in zip(
        T.leaves(tree), shd.spec_leaves(tree, spec_tree))])


def gather(leaf: Any) -> torch.Tensor:
    """A DTensor's whole value on every rank (its ``full_tensor()``, an
    all-gather a sharding mesh dim); any other leaf as it is."""
    if not isinstance(leaf, DTensor):
        return leaf
    return whole_of(leaf.to_local(), leaf.device_mesh, leaf.placements)


def gather_blocks(local: Sequence[torch.Tensor], shapes: Sequence[Any],
                  places: Sequence[Sequence[Any]], dmesh
                  ) -> List[torch.Tensor]:
    """The whole tensors of ``shapes`` whose blocks under ``places`` this
    rank holds as ``local`` (contiguous, any dtypes), through ONE
    all-gather over the world of every rank's blocks laid end to end as
    bytes: each rank receives what a gather leaf by leaf would, in one
    call.  ``dmesh`` spans the world.  Each distinct block is copied into
    its whole once, from the rank at coordinate 0 of every mesh dim that
    replicates it."""
    raw = [x.contiguous().reshape(-1).view(torch.uint8) for x in local]
    parts = all_gather(torch.cat(raw))
    wholes = [torch.empty(tuple(s), dtype=x.dtype, device=x.device)
              for s, x in zip(shapes, local)]
    coords = {int(r): c for c, r in np.ndenumerate(dmesh.mesh.numpy())}
    for r, part in enumerate(parts):
        coord = coords[r]
        off = 0
        for x, b, p, whole in zip(local, raw, places, wholes):
            if not any(c and not isinstance(q, Shard)
                       for c, q in zip(coord, p)):
                block = part[off:off + b.numel()].view(x.dtype).view(x.shape)
                whole[_index(whole.shape, dmesh, p, coord)] = block
            off += b.numel()
    return wholes


def gather_over(local: Sequence[torch.Tensor],
                places: Sequence[Sequence[Any]], dmesh, dims: Sequence[int]
                ) -> Tuple[List[torch.Tensor], int, int]:
    """This rank's blocks ``local`` (under ``places``) gathered over the
    mesh dims ``dims`` only, the blocks of the other mesh dims kept: one
    all-gather a dim, of every block that dim shards laid end to end as
    bytes, the innermost dim first (:func:`whole_of`'s order).  A block no
    dim of ``dims`` shards comes back as it is.  Returns the blocks, the
    bytes this rank received and the all-gathers it made."""
    out = list(local)
    received = calls = 0
    for i in sorted(dims, reverse=True):
        idx = [j for j, p in enumerate(places) if isinstance(p[i], Shard)]
        if not idx or dmesh.size(i) == 1:
            continue
        raw = [out[j].contiguous().reshape(-1).view(torch.uint8) for j in idx]
        parts = all_gather(torch.cat(raw), dmesh.get_group(i))
        calls += 1
        off = 0
        for j, b in zip(idx, raw):
            x = out[j]
            out[j] = torch.cat([part[off:off + b.numel()].view(x.dtype)
                                .view(x.shape) for part in parts],
                               dim=places[j][i].dim)
            off += b.numel()
        received += (dmesh.size(i) - 1) * sum(b.numel() for b in raw)
    return out, received, calls


def _gather_many(leaves: List[DTensor]) -> List[torch.Tensor]:
    """The whole values of DTensors of one mesh through ONE all-gather of
    every rank's blocks (:func:`gather_blocks`)."""
    dmesh = leaves[0].device_mesh
    if dmesh.size() != dist.get_world_size():
        return [gather(leaf) for leaf in leaves]
    return gather_blocks([leaf.to_local() for leaf in leaves],
                         [leaf.shape for leaf in leaves],
                         [leaf.placements for leaf in leaves], dmesh)


def gather_tree(tree: Any) -> Any:
    """Every DTensor leaf's whole value on every rank (:func:`gather`), the
    sharded leaves of each mesh and dtype in one all-gather."""
    flat = T.leaves(tree)
    out = [gather(leaf) if isinstance(leaf, DTensor) and not any(
        isinstance(p, Shard) for p in leaf.placements) else leaf
        for leaf in flat]
    groups: Dict[Tuple[int, torch.dtype], List[int]] = {}
    for i, leaf in enumerate(flat):
        if isinstance(leaf, DTensor) and any(isinstance(p, Shard)
                                             for p in leaf.placements):
            groups.setdefault((id(leaf.device_mesh), leaf.dtype),
                              []).append(i)
    for idx in groups.values():
        for i, whole in zip(idx, _gather_many([flat[i] for i in idx])):
            out[i] = whole
    return T.unflatten(tree, out)


def held_bytes(tree: Any) -> int:
    """Bytes this rank holds of a tree's DTensor leaves."""
    return sum(leaf.to_local().numel() * leaf.to_local().element_size()
               for leaf in T.leaves(tree) if isinstance(leaf, DTensor))


def spec_bytes(tree: Any, spec_tree: Any, mesh: Any) -> int:
    """What a rank should hold of ``tree`` placed by ``spec_tree``: each
    leaf's bytes over its shard count, rounded up."""
    total = 0
    for leaf, spec in zip(T.leaves(tree), shd.spec_leaves(tree, spec_tree)):
        n = math.prod(mesh.device_mesh.size(i) for i, p in
                      enumerate(placements(spec, mesh))
                      if isinstance(p, Shard))
        total += -(-leaf.numel() * leaf.element_size() // n)
    return total


def _row_block(batch: int, mesh: Any) -> Optional[Tuple[int, int]]:
    """(this rank's row block, the number of blocks) as ``batch_pspec``
    splits ``batch`` rows, or None where the rows are replicated."""
    entry = shd.batch_pspec(batch, mesh)[0]
    if entry is None:
        return None
    coord = mesh.coordinate()
    idx, n = 0, 1
    for a in entry:
        idx, n = idx * mesh.shape[a] + coord[a], n * mesh.shape[a]
    return idx, n


def local_rows(batch: Dict[str, torch.Tensor], mesh: Any
               ) -> Dict[str, torch.Tensor]:
    """This rank's rows of every batch tensor (rows first): over the dp
    axes where they divide the batch, else all of them (the reference's
    ``_maybe``)."""
    b = next(iter(batch.values())).shape[0]
    block = _row_block(b, mesh)
    if block is None:
        return batch
    idx, n = block
    rows = b // n
    return {k: v[idx * rows:(idx + 1) * rows] for k, v in batch.items()}


class _RowGather(torch.autograd.Function):
    """Forward: every dp rank's rows, in the batch's row order.  Backward:
    the gradient of all of them summed over the dp groups, this rank's rows
    kept (reduce-scatter; gloo has none, so an all-reduce)."""

    @staticmethod
    def forward(ctx, x, rows):
        out = x
        for g in reversed(rows.groups):          # the innermost axis first
            out = torch.cat(all_gather(out, g))
        ctx.rows, ctx.n = rows, x.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for grp in ctx.rows.groups:
            all_reduce(g, group=grp)
        i, n = ctx.rows.index, ctx.n
        return g[i * n:(i + 1) * n], None


class _RowSum(torch.autograd.Function):
    """Forward: the partials of the gathered rows summed over the dp
    groups.  Backward: the gradient summed over them too: each dp rank
    keeps only its own rows of the sum, so each holds the gradient of its
    own rows, and every partial feeds all of them."""

    @staticmethod
    def forward(ctx, x, rows, axis):
        ctx.rows, ctx.axis = rows, axis
        return rows._sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.rows._sum(g, ctx.axis), None, None


@dataclasses.dataclass(frozen=True)
class DPRows:
    """A rank's place among the row blocks of the dp axes: ``groups`` the
    process groups of the dp axes that split the rows ("pod" before
    "data"), ``index`` this rank's block (``_row_block``) of ``count``.
    The MoE layer's gathered route (``models/moe.moe_apply`` with
    ``engine["dp_rows"]``) routes the whole batch's tokens through
    :meth:`gather`, sums the ranks' partial outputs through :meth:`sum`
    (each rank runs its share of the experts) and keeps its own rows
    through :meth:`own`."""
    groups: Tuple[Any, ...]
    index: int

    @property
    def count(self) -> int:
        return math.prod(dist.get_world_size(g) for g in self.groups)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _RowGather.apply(x, self)

    def sum(self, x: torch.Tensor, axis: "ModelAxis") -> torch.Tensor:
        return _RowSum.apply(x, self, axis)

    def _sum(self, x: torch.Tensor, axis: "ModelAxis") -> torch.Tensor:
        for g in self.groups:
            x = axis.all_reduce(x, g)
        return x

    def own(self, y: torch.Tensor, n: int) -> torch.Tensor:
        return y[self.index * n:(self.index + 1) * n]


def dp_rows(batch: int, mesh: Any) -> Optional[DPRows]:
    """:class:`DPRows` of this rank where ``batch`` rows split over the dp
    axes (``local_rows``), else None."""
    block = _row_block(batch, mesh)
    if block is None:
        return None
    axes = shd.batch_pspec(batch, mesh)[0]
    return DPRows(tuple(mesh.group(a) for a in axes if mesh.shape[a] > 1),
                  block[0])


# ---------------------------------------------------------------------------
# the "model" axis of the train step: the rank's block of each layer matmul
# ---------------------------------------------------------------------------

def sync(dev: torch.device) -> None:
    """Wait for ``dev``'s queued work (a no-op off the card): the host clock
    around a collective then times the collective."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ModelAxis:
    """This rank's place on the "model" axis of one train step, and the
    activation collectives over it with their cost.

    ``group`` is the process group of the rank's "model" row (None where
    the mesh has no "model" axis), ``size`` its ranks, ``index`` this
    rank's place in it.  ``rows_scale`` is how many times the rank's rows
    one device's batch holds (the dp size where the rows split, else 1).

    ``stats`` counts, for ``metrics["comm"]``: ``act_calls`` /
    ``act_bytes`` / ``act_s``, the activation collectives (an all-reduce
    counts its buffer's bytes, an all-gather the bytes the rank receives;
    host seconds, the card synchronised around each); ``linears_block`` /
    ``linears_whole``, the layer linears computed on a block of their
    weight and on a whole one; ``layer_macs``, the rank's multiply-adds in
    them and in the routed experts, from the shapes, and
    ``layer_macs_one_device``, one device's for the same calls over the
    whole batch; ``expert_slots`` / ``expert_slots_one_device``, the
    routed experts' (expert, capacity row) slots likewise;
    ``attention_split`` / ``attention_whole``, the attention blocks run on
    the rank's heads and whole (``layers.head_split``).  ``logits`` is
    the shape of the last vocab-split logits (the rank's (tokens, V / M))."""

    def __init__(self, group: Any, dev: torch.device, rows_scale: int = 1):
        self.group = group
        self.size = dist.get_world_size(group) if group is not None else 1
        self.index = dist.get_rank(group) if group is not None else 0
        self.dev = dev
        self.rows_scale = rows_scale
        self.stats: collections.Counter = collections.Counter(dict.fromkeys(
            ("act_calls", "act_bytes", "act_s", "linears_block",
             "linears_whole", "layer_macs", "layer_macs_one_device",
             "expert_slots", "expert_slots_one_device", "attention_split",
             "attention_whole"), 0))
        self.logits: Optional[Tuple[int, ...]] = None

    def _timed(self, nbytes: int, fn: Callable) -> Any:
        sync(self.dev)
        t0 = time.perf_counter()
        out = fn()
        sync(self.dev)
        self.stats["act_s"] += time.perf_counter() - t0
        self.stats["act_bytes"] += nbytes
        self.stats["act_calls"] += 1
        return out

    def all_reduce(self, x: torch.Tensor, group: Any = None, op=None
                   ) -> torch.Tensor:
        """A new tensor: ``x`` reduced over ``group`` (default the model
        group), in f32 where ``x`` is narrower, then in ``x``'s dtype."""
        group = self.group if group is None else group
        if group is None or dist.get_world_size(group) == 1:
            return x
        buf = x.to(torch.float32) if x.element_size() < 4 else x.clone()
        buf = buf.contiguous()
        self._timed(buf.numel() * buf.element_size(), lambda: all_reduce(
            buf, op=op or dist.ReduceOp.SUM, group=group))
        return buf.to(x.dtype)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model rank's ``x`` laid end to end along ``dim``."""
        parts = self._timed((self.size - 1) * x.numel() * x.element_size(),
                            lambda: all_gather(x, self.group))
        return torch.cat(parts, dim=dim)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Megatron's g after a column split: forward, every model rank's
        ``x`` laid end to end along ``dim``; backward, this rank's slice."""
        return x if self.size == 1 else _ModelGather.apply(x, self, dim)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f before a split region: forward, ``x`` as it is;
        backward, the gradient summed over "model" (each rank's share of
        the region gives a partial gradient of ``x``)."""
        return x if self.size == 1 else _ModelCopy.apply(x, self)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The partials of a row split (or a share of the experts) added
        over "model"; backward, the gradient as it is."""
        return x if self.size == 1 else _ModelSum.apply(x, self)

    def split(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's slice of ``x`` (whole on every model rank) along
        ``dim``: a bias of a column-split weight.  Backward, every rank's
        slice of the gradient laid end to end."""
        return x if self.size == 1 else _ModelSplit.apply(x, self, dim)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s elementwise maximum over "model", no gradient."""
        return self.all_reduce(x.detach(), op=dist.ReduceOp.MAX)

    def count_linear(self, x: torch.Tensor, w: "ModelBlock") -> None:
        k = x.shape[-1]
        macs = x.numel() // k * w.w.shape[-2] * k
        self.stats["linears_block" if w.split else "linears_whole"] += 1
        self.stats["layer_macs"] += macs
        self.stats["layer_macs_one_device"] += (
            macs * self.rows_scale * (self.size if w.split else 1))

    def count_experts(self, slots: int, slots_one: int, macs_a_slot: int,
                      macs_a_slot_one: int) -> None:
        self.stats["expert_slots"] += slots
        self.stats["expert_slots_one_device"] += slots_one
        self.stats["layer_macs"] += slots * macs_a_slot
        self.stats["layer_macs_one_device"] += slots_one * macs_a_slot_one


class _ModelGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n)
                .contiguous(), None, None)


class _ModelCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        n = x.shape[dim] // axis.size
        ctx.axis, ctx.dim = axis, dim
        return x.narrow(dim, axis.index * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather(g.contiguous(), ctx.dim), None, None


@dataclasses.dataclass(frozen=True)
class ModelBlock:
    """A layer weight of the train step on a rank mesh: ``w`` this rank's
    block of it, split over "model" along ``dim`` (None: the whole weight,
    which "model" does not split), and ``axis`` the rank's
    :class:`ModelAxis`.  ``models/layers.linear`` dispatches on it; the
    attention, the MLP, the MoE experts, the embedding and the head
    compute on the block where it is split."""
    w: torch.Tensor
    dim: Optional[int]
    axis: ModelAxis

    @property
    def split(self) -> bool:
        return self.dim is not None

    @property
    def start(self) -> int:
        """The index along ``dim`` of the block's first row in the whole
        weight."""
        return self.axis.index * self.w.shape[self.dim]


def share(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[lo, hi): part ``index`` of ``n`` items split into ``parts``
    contiguous parts, the first ``n % parts`` one longer."""
    q, r = divmod(n, parts)
    lo = index * q + min(index, r)
    return lo, lo + q + (index < r)
