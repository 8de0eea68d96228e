"""Executable NVM-integration scenarios (paper §IV Fig 9) for the LM stack.

Ports ``repro/core/scenarios.py:39-81`` (``linear_apply``, ``plan_apply``,
``weight_path_bytes``):

  l1mram  — At-Memory: packed weights go straight into the fused dequant
            matmul kernel; no full-width copy.
  l2mram  — weights are dequantized by a separate op into a full-width
            buffer that feeds a plain matmul.
  l3mram  — like l2mram, with the dequantized copy materialised first (the
            store-and-forward staging hop); the reference's
            ``optimization_barrier`` becomes an explicit materialised
            copy (``clone``; eager PyTorch has no fusion to prevent).
  l3flash — weights are not resident: the serving loop re-stages each
            page from host memory every inference through
            ``core/paging.HostPagedStore``; a linear given its pages is
            served like l3mram.

All four give the same numbers; they differ in bytes moved.  The full-width
product of l2mram / l3mram goes to ``torch.matmul``, as the reference leaves
it to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.placement import SCENARIOS, PlacementPlan
from repro_torch.core.weight_store import PackedParam
from repro_torch.kernels import ops as kops

__all__ = ["SCENARIOS", "linear_apply", "plan_apply", "weight_path_bytes"]


def linear_apply(x: torch.Tensor, p: PackedParam, *,
                 scenario: str = "l1mram",
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x @ W^T with W stored packed; x (..., K), p.orig_shape (N, K);
    or grouped, x (E, C, K) and p.orig_shape (E, N, K) -> (E, C, N); the
    result in ``out_dtype`` (default x's)."""
    if scenario == "l1mram":
        out = kops.quant_matmul(x, p.packed, p.scale, bits=p.bits,
                                k_orig=p.orig_shape[-1])
    elif scenario in ("l2mram", "l3mram", "l3flash"):
        w = p.dequantize(torch.float32)            # full-width buffer
        if scenario in ("l3mram", "l3flash"):
            w = w.clone()                           # the staging hop's copy
        out = torch.matmul(x.to(torch.float32), w.transpose(-1, -2))
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    return out.to(out_dtype or x.dtype)


def plan_apply(x: torch.Tensor, p: PackedParam, plan: PlacementPlan,
               path: Optional[str] = None, *,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`linear_apply` with the scenario resolved per parameter path
    from a :class:`~repro_torch.core.placement.PlacementPlan`."""
    return linear_apply(x, p, scenario=plan.scenario_for(path),
                        out_dtype=out_dtype)


def weight_path_bytes(p: PackedParam, scenario: str) -> int:
    """Device-memory bytes the weight crosses per use under each scenario
    (the analytical comparison), a Python int."""
    packed = p.nbytes_packed
    full = math.prod(p.orig_shape) * 4
    if scenario == "l1mram":
        return packed                      # read packed once
    if scenario == "l2mram":
        return packed + full               # read packed + write full
    if scenario in ("l3mram", "l3flash"):
        return packed + 2 * full           # + read the full copy back
    raise ValueError(scenario)
