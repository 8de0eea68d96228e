"""Freezing a parameter tree for At-MRAM serving (reference:
``repro/parallel/sharding.py:32-33`` and ``:246-270``).

Only ``PACKABLE`` and ``freeze_for_serving`` (with its per-leaf rule,
``freeze_leaf``) are ported; the sharding rules arrive with the
multi-device slice (ROADMAP A11).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core import packing, quantize
from repro_torch.core.device import DeviceLike, resolve_device

# parameter leaves that get packed for At-MRAM serving.  Routers stay at
# full precision: they are tiny and routing decisions are quantization-
# sensitive (same reasoning as norm/bias params living in SRAM on-chip).
PACKABLE = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
            "in_proj", "out_proj", "x_proj", "dt_proj"}


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
