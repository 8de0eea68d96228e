"""GPipe pipeline parallelism over a rank axis (reference:
``repro/parallel/pipeline.py``).

Layers split into S contiguous stages, one a rank along ``stage_axis``;
microbatches flow stage to stage, and the GPipe schedule of S + M - 1
ticks for M microbatches overlaps the stages.  As in the reference, each
stage holds every microbatch's buffer, computes when its tick holds a
valid microbatch, and passes the whole buffer on around the ring (the
reference's ``ppermute``, here ``parallel/distributed.ring_shift``); the
last stage deposits finished microbatches, and a SUM all-reduce hands
them to every stage (the reference's ``psum``).  Forward only, as the
reference.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import tree as T
from repro_torch.parallel.distributed import all_reduce, ring_shift


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble: (S-1) / (S-1+M)."""
    return (n_stages - 1) / (n_stages - 1 + n_microbatches)


def _stage_block(leaf: Any, idx: int) -> torch.Tensor:
    if isinstance(leaf, DTensor):
        return leaf.to_local()
    return leaf[idx:idx + 1]


def pipelined_apply(layer_fn: Callable[[torch.Tensor, Any], torch.Tensor],
                    mesh: Any, stage_axis: str, n_microbatches: int
                    ) -> Callable:
    """``fn(x, stage_params)`` running the GPipe schedule over the ranks
    of ``stage_axis`` (every rank calls it).  ``layer_fn(x_mb, params)``
    applies one stage to one microbatch; ``x`` (B, ...) is the whole batch
    on every rank, B a multiple of ``n_microbatches``; ``stage_params``'
    leaves carry a leading stage dim, as DTensors sharded over
    ``stage_axis`` or whole, and a stage's ``params`` is its block (the
    leading dim 1, as the reference's ``shard_map`` block).  Returns the
    output on every rank."""
    group = mesh.group(stage_axis)
    n_stages = mesh.shape[stage_axis]
    m = n_microbatches

    def fn(x: torch.Tensor, stage_params: Any) -> torch.Tensor:
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} is not a multiple of {m} "
                             "microbatches")
        idx = mesh.coordinate()[stage_axis]
        params = T.tree_map(lambda leaf: _stage_block(leaf, idx),
                            stage_params)
        buf = x.reshape(m, b // m, *x.shape[1:]).clone()
        out = torch.zeros_like(buf)
        for tick in range(n_stages + m - 1):
            mb = tick - idx              # the microbatch at this stage now
            if 0 <= mb < m:
                y = layer_fn(buf[mb], params).reshape(buf[mb].shape)
                buf[mb] = y
                if idx == n_stages - 1:
                    out[mb] = y
            buf = ring_shift(buf, group)
        return all_reduce(out, group=group).reshape(x.shape)

    return fn
