"""Packed read-only weight store — the MRAM analogue.

Ports ``repro/core/weight_store.py:40-162``: ``PackedParam`` (one packed
weight matrix, a uint8 carrier of 2/4/8-bit fields, with its per-channel
f32 scales), ``pack_param``, the store-level ``WeightStore`` (with
``packed_bytes``; the reference's other accounting helpers have no caller
in the port), ``freeze`` and the ``default_policy`` / ``uniform_policy``
freeze policies.

The reference's trees are JAX pytrees; the port's are nested dicts of
tensors.  :func:`flatten_tree` walks them the way
``jax.tree_util.tree_flatten_with_path`` walks a dict, keys in sorted
order, so a store's parameter order (and with it the page order of
``core/paging.build_pages``) is the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import packing, quantize

# Siracusa's weight MRAM (paper §II-B; ``repro/core/weight_store.py:34``):
# the default resident budget of paging decisions
SIRACUSA_MRAM_BYTES = 4 * 1024 * 1024


@dataclasses.dataclass
class PackedParam:
    """One packed weight matrix + its dequant metadata."""

    packed: torch.Tensor              # (..., K_packed) uint8 carrier
    scale: torch.Tensor               # (out_channels,) float32
    bits: int
    orig_shape: Tuple[int, ...]

    @property
    def nbytes_packed(self) -> int:
        return int(np.prod(self.packed.shape))

    def unpack_levels(self) -> torch.Tensor:
        """Materialize int8 levels (reference / non-fused paths)."""
        return packing.unpack(self.packed, self.bits, self.orig_shape[-1])

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        lv = self.unpack_levels().to(dtype)
        # one scale a row: (N,) for (N, K) or a conv's (N, 3, 3, K), (E, N)
        # for a stack of experts' (E, N, K)
        scale = self.scale.to(dtype).reshape(
            tuple(self.scale.shape)
            + (1,) * (len(self.orig_shape) - self.scale.ndim))
        return lv * scale


def pack_param(w: torch.Tensor, bits: int,
               channel_axis: int = 0) -> PackedParam:
    qt = quantize.quantize_weights(w, bits, channel_axis=channel_axis)
    return PackedParam(packed=packing.pack(qt.values, bits), scale=qt.scale,
                       bits=bits, orig_shape=tuple(qt.values.shape))


@dataclasses.dataclass
class WeightStore:
    """Packed store over a parameter tree: ``params`` maps flat path ->
    PackedParam for the quantized ("MRAM") leaves, ``passthrough`` holds the
    leaves kept at full precision (norms, biases, embeddings)."""

    params: Dict[str, PackedParam]
    passthrough: Dict[str, Any]

    @property
    def packed_bytes(self) -> int:
        return sum(p.nbytes_packed for p in self.params.values())


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/c": leaf} over a nested dict, keys sorted at every level (the
    order ``jax.tree_util`` flattens a dict in)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        out.update(flatten_tree(tree[k], f"{prefix}/{k}" if prefix
                                else str(k)))
    return out


def _as_tensor(leaf: Any) -> torch.Tensor:
    return (leaf if isinstance(leaf, torch.Tensor)
            else torch.from_numpy(np.array(leaf)))


# Heuristic used when no explicit policy is given: quantize every >=2-D
# matmul-like weight; keep vectors (norm scales, biases) at full precision.
def default_policy(path: str, leaf: torch.Tensor) -> Optional[int]:
    if leaf.ndim >= 2 and leaf.numel() >= 1024:
        return 8
    return None


def freeze(params: Any,
           policy: Callable[[str, torch.Tensor], Optional[int]]
           = default_policy, channel_axis: int = 0) -> WeightStore:
    """Offline "MRAM programming": quantize+pack a parameter tree (nested
    dicts of tensors or numpy arrays).  ``policy(path, leaf)`` returns the
    weight bit-width (2/4/8) or None to keep the leaf at full precision."""
    packed: Dict[str, PackedParam] = {}
    passthrough: Dict[str, Any] = {}
    for path, leaf in flatten_tree(params).items():
        leaf = _as_tensor(leaf)
        bits = policy(path, leaf)
        if bits is None:
            passthrough[path] = leaf
        else:
            packed[path] = pack_param(leaf, bits, channel_axis=channel_axis)
    return WeightStore(params=packed, passthrough=passthrough)


def uniform_policy(bits: int, min_size: int = 1024):
    def _policy(path: str, leaf: torch.Tensor) -> Optional[int]:
        if leaf.ndim >= 2 and leaf.numel() >= min_size:
            return bits
        return None
    return _policy
