"""Gradient compression for the data-parallel sync: int8 quantized
all-reduce with error feedback (reference: ``repro/parallel/compress.py``).

The int8 levels are what would cross the interconnect; their int32 sum is
exact given the shared scale (the max over the ranks, synced first with
an all-reduce MAX, the reference's ``pmax``).  The f32 arithmetic is the
reference's, in its order: ``absmax / 127``, round half to even, ``total
* scale / n``.  The reference's collectives run inside ``shard_map`` over
an axis name; here over a process group of ranks
(``launch/mesh.Mesh.group``), through ``parallel/distributed``'s
collectives.  As in the reference, nothing in the train step calls it.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import tree as T
from repro_torch.parallel.distributed import all_reduce

F32 = torch.float32


def _div(x: torch.Tensor, value: float) -> torch.Tensor:
    # a tensor divisor: CUDA's division by a Python number multiplies by
    # its rounded reciprocal, which is not the reference's f32 division
    return x / torch.tensor(value, dtype=F32, device=x.device)


def _levels(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization -> (q, scale)."""
    absmax = torch.max(torch.abs(x))
    scale = torch.clamp(_div(absmax, 127.0), min=1e-12)
    return _levels(x, scale).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def _shared_scale(g: torch.Tensor, group) -> torch.Tensor:
    absmax = all_reduce(torch.max(torch.abs(g)).to(F32).reshape(1),
                        dist.ReduceOp.MAX, group)[0]
    return torch.clamp(_div(absmax, 127.0), min=1e-12)


def int8_allreduce(g: torch.Tensor, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the int32 sum over ``group`` of every rank's int8 levels of ``g``
    against the shared scale, that scale): what crosses the wire."""
    scale = _shared_scale(g, group)
    q = _levels(g, scale).to(torch.int8)
    return all_reduce(q.to(torch.int32), group=group), scale


def compressed_allreduce_mean(g: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of every rank's ``g`` over ``group``: int8-compressed
    against the shared scale, summed as int32, dequantized."""
    total, scale = int8_allreduce(g, group)
    n = dist.get_world_size(group)
    return _div(total.to(F32) * scale, float(n))


def with_error_feedback(grads: Any, residual: Any, group=None
                        ) -> Tuple[Any, Any]:
    """g' = compress(g + residual); residual' = (g + residual) - g'."""
    def one(g, r):
        x = g.to(F32) + r
        out = compressed_allreduce_mean(x, group)
        # the residual tracks the *local* quantization error
        scale = _shared_scale(x, group)
        return out.to(g.dtype), x - _levels(x, scale) * scale

    outs = [one(g, r) for g, r in zip(T.leaves(grads), T.leaves(residual))]
    return (T.unflatten(grads, [o[0] for o in outs]),
            T.unflatten(grads, [o[1] for o in outs]))


def init_residual(grads_like: Any) -> Any:
    return T.tree_map(lambda g: torch.zeros(g.shape, dtype=F32,
                                            device=g.device), grads_like)
