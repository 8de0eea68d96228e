"""Sharding rules and the freeze for At-MRAM serving (reference:
``repro/parallel/sharding.py``).

Plan (the reference's, per mesh ("data", "model") or ("pod", "data",
"model")):

  * batch dims            -> ("pod", "data")      (pure DP across pods)
  * weight out-features   -> "model"              (tensor parallel)
  * weight in-features    -> "data"               (FSDP / ZeRO-3)
  * MoE expert dim        -> "model" when divisible (EP), else the expert
                             hidden dim F -> "model" (TP-in-expert)
  * KV cache sequence     -> "model"              (sequence-parallel decode)
  * SSM channel dims      -> "model" (+"data" when divisible by both)
  * anything indivisible  -> replicated on that axis (rule checks divide)

The rules (``:36-228``: ``dp_axes``, ``dp_size``, ``_param_pspec``,
``param_shardings``, ``opt_state_shardings``, ``shard_axis``,
``batch_pspec``, ``cache_shardings``) read only a mesh's ``axis_names``
and ``shape`` (``launch/mesh.Mesh``).  The port has no ``NamedSharding``:
the tree functions return trees of :class:`PartitionSpec`, entry for
entry the reference's ``NamedSharding.spec``.  Its counterpart of a
``ShapeDtypeStruct`` with a sharding (``:231-243``: ``sds``,
``with_shardings``) is a :class:`ShapeSpec`, a ``meta`` tensor with its
spec; :func:`shard_shape` and :func:`rank_bytes` give what one rank holds
of it.  ``serve_spec_like`` (``:273-297``) gives the packed store of a
parameter tree as ``meta`` tensors (``launch/steps.serve_param_specs``).

``PACKABLE`` and ``freeze_for_serving`` (with its per-leaf rule,
``freeze_leaf``; ``:32-33``, ``:246-270``) freeze a tree for serving.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import packing, quantize
from repro_torch.core import tree as T
from repro_torch.core.device import DeviceLike, resolve_device

# parameter leaves that get packed for At-MRAM serving.  Routers stay at
# full precision: they are tiny and routing decisions are quantization-
# sensitive (same reasoning as norm/bias params living in SRAM on-chip).
PACKABLE = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
            "in_proj", "out_proj", "x_proj", "dt_proj"}


class PartitionSpec(tuple):
    """One leaf's spec: per dim an axis name, a tuple of axis names or
    None (replicated), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """``jax.ShapeDtypeStruct`` with a sharding: ``value``, a ``meta``
    tensor of the leaf's shape and dtype, placed by ``spec`` (a tree walk
    takes the pair as one leaf)."""
    value: torch.Tensor
    spec: PartitionSpec

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype


def _axis_size(mesh: Any, axis: str) -> int:
    return mesh.shape[axis] if axis in mesh.axis_names else 1


def dp_axes(mesh: Any) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh: Any) -> int:
    return math.prod(_axis_size(mesh, a) for a in dp_axes(mesh))


def _div(n: int, mesh: Any, axis) -> bool:
    if isinstance(axis, tuple):
        size = math.prod(_axis_size(mesh, a) for a in axis)
    else:
        size = _axis_size(mesh, axis)
    return n % size == 0 and n >= size


def _maybe(n: int, mesh: Any, axis):
    return axis if _div(n, mesh, axis) else None


def _param_pspec(path: Tuple[str, ...], shape: Tuple[int, ...],
                 mesh: Any) -> PartitionSpec:
    last = path[-1]
    in_layers = any(k in ("layers", "enc_layers", "dec_layers")
                    for k in path)
    # packed-serving leaves: (..., 'w_x', 'packed'|'scale')
    if last in ("packed", "scale") and len(path) >= 2:
        base = _param_pspec(path[:-1], shape if last == "packed"
                            else shape + (1,), mesh)
        if last == "scale":
            return P(*base[:-1])
        return base

    if last in ("embed", "lm_head"):
        return P(_maybe(shape[0], mesh, "model"),
                 _maybe(shape[1], mesh, "data"))
    if last in ("meta_tokens", "dec_pos"):
        return P()

    dims = shape[1:] if in_layers else shape       # strip stacked L dim
    lead: Tuple = (None,) if in_layers else ()

    if len(dims) <= 1:
        return P(*(lead + (None,) * len(dims)))

    if last == "conv_w":                           # (di, K)
        return P(*(lead + (_maybe(dims[0], mesh, "model"), None)))
    if last == "A_log":                            # (di, N)
        return P(*(lead + (_maybe(dims[0], mesh, "model"), None)))

    if len(dims) == 3:                             # MoE experts (E, F, D)
        e, a, b = dims
        if _div(e, mesh, "model"):
            return P(*(lead + ("model", None, _maybe(b, mesh, "data"))))
        if last == "w_down":                       # (E, D, F): F -> model
            return P(*(lead + (None, _maybe(a, mesh, "data"),
                               _maybe(b, mesh, "model"))))
        return P(*(lead + (None, _maybe(a, mesh, "model"),
                           _maybe(b, mesh, "data"))))

    if len(dims) == 2:                             # (out, in)
        return P(*(lead + (_maybe(dims[0], mesh, "model"),
                           _maybe(dims[1], mesh, "data"))))

    return P(*(lead + (None,) * len(dims)))


def param_shardings(params_tree: Any, mesh: Any) -> Any:
    """Tree of PartitionSpecs matching ``params_tree`` (tensors, ``meta``
    tensors included)."""
    return T.unflatten(params_tree, [
        _param_pspec(path, tuple(leaf.shape), mesh)
        for path, leaf in T.flatten_with_paths(params_tree)])


def opt_state_shardings(opt_state: Any, mesh: Any, params_tree: Any) -> Any:
    """Optimizer-state specs: moments mirror their parameter; factored
    Adafactor vectors and scalars fall back to shape rules.

    Moments are matched by tree path first (the state's path ends with the
    parameter's; two same-shape params can carry different specs), then,
    for a leaf no path matches, by shape when every param of that shape
    agrees."""
    by_path: Dict[Tuple[str, ...], Tuple[Tuple[int, ...],
                                         PartitionSpec]] = {}
    by_shape: Dict[Tuple[int, ...], List[PartitionSpec]] = {}
    for keys, leaf in T.flatten_with_paths(params_tree):
        shape = tuple(leaf.shape)
        spec = _param_pspec(keys, shape, mesh)
        by_path[keys] = (shape, spec)
        by_shape.setdefault(shape, []).append(spec)

    def resolve(keys: Tuple[str, ...], shape: Tuple[int, ...]
                ) -> PartitionSpec:
        # longest matching path suffix wins
        for start in range(len(keys)):
            hit = by_path.get(keys[start:])
            if hit is not None and hit[0] == shape:
                return hit[1]
        specs = by_shape.get(shape)
        if specs is not None and all(s == specs[0] for s in specs):
            return specs[0]                        # unambiguous shape
        if len(shape) == 0:
            return P()
        # factored vectors: shard the largest shardable dim on model
        spec: List[Optional[str]] = [None] * len(shape)
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if _div(shape[i], mesh, "model"):
                spec[i] = "model"
                break
        return P(*spec)

    return T.unflatten(opt_state, [
        resolve(keys, tuple(leaf.shape))
        for keys, leaf in T.flatten_with_paths(opt_state)])


def shard_axis(path_keys: Sequence[str], shape: Tuple[int, ...],
               mesh: Any) -> Optional[Tuple[int, int]]:
    """(axis, n_shards) the plan tensor-shards this param on, or None: the
    first NON-LAST dim :func:`_param_pspec` pins to the "model" axis,
    where it divides evenly.  The last (in-features / packed) dim never
    shards: the page wire codec's scales span whole rows, so only leading
    slices keep shard-then-encode equal to encode-then-shard."""
    n = _axis_size(mesh, "model")
    if n <= 1:
        return None
    spec = _param_pspec(tuple(path_keys), tuple(shape), mesh)
    for ax, entry in enumerate(spec):
        if ax >= len(shape) - 1:
            break
        if entry == "model" and shape[ax] % n == 0 and shape[ax] >= n:
            return (ax, n)
    return None


def batch_pspec(batch: int, mesh: Any, extra_dims: int = 1
                ) -> PartitionSpec:
    axes = dp_axes(mesh)
    if not axes or batch % dp_size(mesh) != 0:
        return P(*((None,) * (1 + extra_dims)))
    return P(axes, *((None,) * extra_dims))


def cache_shardings(cache_tree: Any, mesh: Any, batch: int) -> Any:
    """KV cache (L, B, H, S, hd): B -> dp, S -> model.  SSM state h
    (L, B, di, N): di -> model; conv (L, B, K-1, di): di -> model."""
    bspec = (dp_axes(mesh) if batch % dp_size(mesh) == 0
             and dp_size(mesh) > 1 else None)

    def per_leaf(keys: Tuple[str, ...], leaf: Any) -> PartitionSpec:
        nd = len(leaf.shape)
        if keys[-1] in ("k", "v") and nd == 5:        # (L,B,H,S,hd)
            return P(None, bspec, None,
                     _maybe(leaf.shape[3], mesh, "model"), None)
        if keys[-1] in ("xk", "xv") and nd == 5:      # cross-attn KV
            return P(None, bspec, None, None, None)
        if keys[-1] == "h" and nd == 4:               # (L,B,di,N)
            return P(None, bspec, _maybe(leaf.shape[2], mesh, "model"),
                     None)
        if keys[-1] == "conv" and nd == 4:            # (L,B,K-1,di)
            return P(None, bspec, None,
                     _maybe(leaf.shape[3], mesh, "model"))
        return P(*((None,) * nd))

    return T.unflatten(cache_tree, [
        per_leaf(keys, leaf)
        for keys, leaf in T.flatten_with_paths(cache_tree)])


def spec_leaves(tree_like: Any, spec_tree: Any) -> List[PartitionSpec]:
    """The specs of ``spec_tree`` in ``tree_like``'s leaf order (a spec is
    a tuple, which ``core/tree`` would walk into)."""
    if tree_like is None:
        return []
    if isinstance(tree_like, dict):
        return [s for k in sorted(tree_like)
                for s in spec_leaves(tree_like[k], spec_tree[k])]
    if isinstance(tree_like, (list, tuple)):
        return [s for v, sv in zip(tree_like, spec_tree)
                for s in spec_leaves(v, sv)]
    return [spec_tree]


def sds(shape: Sequence[int], dtype: torch.dtype, spec: PartitionSpec
        ) -> ShapeSpec:
    return ShapeSpec(torch.empty(tuple(shape), dtype=dtype, device="meta"),
                     spec)


def with_shardings(spec_tree: Any, shard_tree: Any) -> Any:
    """Attach the specs of ``shard_tree`` to the ``meta`` leaves of
    ``spec_tree``: a tree of :class:`ShapeSpec`."""
    return T.unflatten(spec_tree, [
        ShapeSpec(leaf, spec) for leaf, spec in
        zip(T.leaves(spec_tree), spec_leaves(spec_tree, shard_tree))])


def shard_shape(shape: Sequence[int], spec: PartitionSpec, mesh: Any
                ) -> Tuple[int, ...]:
    """One rank's block of a ``shape`` leaf placed by ``spec`` (the
    reference's ``NamedSharding.shard_shape``): each dim over the sizes of
    the mesh axes its entry names."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            names = entry if isinstance(entry, tuple) else (entry,)
            out[d] = -(-out[d] // math.prod(_axis_size(mesh, a)
                                            for a in names))
    return tuple(out)


def rank_bytes(tree: Any, mesh: Any) -> int:
    """The bytes one rank holds of a tree of :class:`ShapeSpec` (other
    leaves, such as a Python int, hold none)."""
    return sum(math.prod(shard_shape(leaf.shape, leaf.spec, mesh))
               * leaf.dtype.itemsize for leaf in T.leaves(tree)
               if isinstance(leaf, ShapeSpec))


# rows quantized at once: the f32 temporaries of one block stay near 256 MB
# whatever the leaf (falcon-mamba's stacked in_proj is 17.2 GB of f32)
FREEZE_BLOCK_ELEMS = 1 << 26


def _pack_rows(flat: torch.Tensor, bits: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, K) float -> (packed (R, ceil(K/f)) uint8, scale (R,) f32),
    quantized in blocks of rows.  Exact: each row is one output channel
    with its own scale, so a block gives the rows the whole leaf would."""
    r, k = flat.shape
    packed = torch.empty((r, packing.packed_last_dim(k, bits)),
                         dtype=torch.uint8, device=flat.device)
    scale = torch.empty((r,), dtype=torch.float32, device=flat.device)
    step = max(1, FREEZE_BLOCK_ELEMS // max(k, 1))
    for r0 in range(0, r, step):
        qt = quantize.quantize_weights(flat[r0:r0 + step], bits,
                                       channel_axis=0)
        packed[r0:r0 + step] = packing.pack(qt.values, bits)
        scale[r0:r0 + step] = qt.scale
    return packed, scale


def packable(name: str, leaf: torch.Tensor) -> bool:
    """Whether a leaf called ``name`` is packed for serving: a PACKABLE
    matmul weight with at least two dims (stacked ones included)."""
    return name in PACKABLE and leaf.ndim >= 2


def freeze_leaf(name: str, leaf: torch.Tensor, bits: int,
                device: DeviceLike = None) -> Any:
    """One leaf frozen as :func:`freeze_for_serving` freezes it: detached
    and on ``device``, and when :func:`packable` packed at ``bits`` by its
    rows into {"packed", "scale"} (scales of its leading shape).  The draw
    of ``models/transformer.init_params(bits=)`` freezes each weight through
    it as it is drawn."""
    # detached: a serving tree must not carry a trained tree's autograd
    # state into every tick (nor into the forward-only kernels)
    leaf = leaf.detach().to(resolve_device(device))
    if not packable(name, leaf):
        return leaf
    packed, scale = _pack_rows(leaf.reshape(-1, leaf.shape[-1]), bits)
    return dict(packed=packed.reshape(*leaf.shape[:-1], -1),
                scale=scale.reshape(leaf.shape[:-1]))


def freeze_for_serving(params: Any, bits: int = 8, plan: Any = None,
                       device: DeviceLike = None) -> Any:
    """Quantize+pack every PACKABLE matmul leaf into {"packed", "scale"}.

    ``plan`` (a :class:`repro_torch.core.placement.PlacementPlan`) overrides
    ``bits`` per parameter path.  Every leaf of the result lies on
    ``device`` (default ``cuda``), where the packing also runs, a block of
    output rows at a time.  Carriers and scales are byte-identical to the
    reference's; a leaf with leading axes (stacked layers, the MoE experts'
    (L, E, F, D)) is packed as its rows, with scales of its leading shape.
    No leaf of the result requires grad.
    """
    dev = resolve_device(device)

    def walk(tree: Any, keys: Tuple[str, ...]) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in tree.items()}
        name = keys[-1] if keys else ""
        b = (plan.bits_for("/".join(keys))
             if plan is not None and packable(name, tree) else bits)
        return freeze_leaf(name, tree, b, dev)

    return walk(params, ())


def serve_spec_like(params_spec: Any, bits: int = 8, plan: Any = None) -> Any:
    """The packed store of a parameter tree as ``meta`` tensors, as
    :func:`freeze_for_serving` would give it: each :func:`packable` leaf a
    {"packed" uint8, "scale" f32} dict; ``plan`` (PlacementPlan) sets the
    bits per parameter path."""
    def walk(tree: Any, keys: Tuple[str, ...]) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in tree.items()}
        if not packable(keys[-1], tree):
            return tree
        b = plan.bits_for("/".join(keys)) if plan is not None else bits
        lead, k = tuple(tree.shape[:-1]), int(tree.shape[-1])
        return dict(
            packed=torch.empty(lead + (packing.packed_last_dim(k, b),),
                               dtype=torch.uint8, device="meta"),
            scale=torch.empty(lead, dtype=torch.float32, device="meta"))

    return walk(params_spec, ())
