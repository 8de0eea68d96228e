"""Freezing a parameter tree for At-MRAM serving (reference:
``repro/parallel/sharding.py:32-33`` and ``:246-270``).

Only ``PACKABLE`` and ``freeze_for_serving`` are ported; the sharding rules
arrive with the multi-device slice (ROADMAP A11).
"""

from __future__ import annotations

from typing import Any, Tuple

from repro_torch.core import packing, quantize
from repro_torch.core.device import DeviceLike, resolve_device

# parameter leaves that get packed for At-MRAM serving.  Routers stay at
# full precision: they are tiny and routing decisions are quantization-
# sensitive (same reasoning as norm/bias params living in SRAM on-chip).
PACKABLE = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
            "in_proj", "out_proj", "x_proj", "dt_proj"}


def freeze_for_serving(params: Any, bits: int = 8, plan: Any = None,
                       device: DeviceLike = None) -> Any:
    """Quantize+pack every PACKABLE matmul leaf into {"packed", "scale"}.

    ``plan`` (a :class:`repro_torch.core.placement.PlacementPlan`) overrides
    ``bits`` per parameter path.  Every leaf of the result lies on
    ``device`` (default ``cuda``), where the packing also runs.  Carriers and
    scales are byte-identical to the reference's.
    """
    dev = resolve_device(device)

    def walk(tree: Any, keys: Tuple[str, ...]) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in tree.items()}
        leaf = tree.to(dev)
        if keys and keys[-1] in PACKABLE and leaf.ndim >= 2:
            b = plan.bits_for("/".join(keys)) if plan is not None else bits
            flat = leaf.reshape(-1, leaf.shape[-1])
            qt = quantize.quantize_weights(flat, b, channel_axis=0)
            packed = packing.pack(qt.values, b).reshape(*leaf.shape[:-1], -1)
            return dict(packed=packed, scale=qt.scale.reshape(leaf.shape[:-1]))
        return leaf

    return walk(params, ())
