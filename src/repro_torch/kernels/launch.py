"""What several kernel wrappers share: the card's SM count, which the
launch plans read; the zeroed counters of the kernels whose last block of a
tile adds the split slices (the f32 decode loop, ``qmatmul_int8`` and
``flash_attention``); ``forward_only``, the check every wrapper makes
before it launches; and the ``meta`` route of the serve kernels (B1, B2,
B7): ``on_meta`` tells a wrapper that its inputs hold shapes only, and
``count_meta`` hands the kernel's work to the active cost counters
(``launch/hlo_analysis.CostCounter``).  Nothing here touches a card when
the module is imported.
"""

from __future__ import annotations

import functools
from typing import Any, List

import torch

# the cost counters a kernel's meta route reports to, innermost last
# (``launch/hlo_analysis.CostCounter`` adds itself while it counts)
META_COUNTERS: List[Any] = []


def on_meta(name: str, *tensors: torch.Tensor) -> bool:
    """Whether ``name``'s inputs lie on ``meta``: every one of them (the
    wrapper then gives ``meta`` outputs of the kernel's shapes and dtypes
    and reports its work through :func:`count_meta`), or none.  A ``meta``
    tensor beside one on another device raises: it holds no data, so no
    card or CPU input may take this route."""
    devices = [t.device for t in tensors if t is not None]
    types = {d.type for d in devices}
    if "meta" not in types:
        return False
    if types != {"meta"}:
        raise ValueError(f"{name} needs its inputs on one CUDA device, all "
                         f"on the CPU or all on meta, got "
                         f"{[str(d) for d in devices]}")
    return True


def count_meta(name: str, flops: float, nbytes: float) -> None:
    """One call of kernel ``name`` on ``meta`` inputs: its ``flops`` and
    the bytes it moves (each input read once, each output written once)
    to every active cost counter."""
    for counter in META_COUNTERS:
        counter.kernel(name, flops, nbytes)


def forward_only(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through ``name``'s launch.

    The Hopper kernels have no backward: a launch's output has no
    ``grad_fn``, so ``backward()`` would silently give no gradient to
    whatever fed it.  Refuse instead, when grad mode is on and a float
    input requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.is_floating_point() and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the Hopper kernels are "
            "forward-only (ROADMAP A10); train through launch/steps."
            "make_train_step (lm_loss, seq2seq_loss), or call it under "
            "torch.no_grad()")


def count_dtype(wrapper, x: torch.Tensor) -> None:
    """One more launch of ``wrapper`` at x's dtype, in its
    ``launches_by_dtype`` ({"float32": n, "bfloat16": n})."""
    by = wrapper.launches_by_dtype
    dtype = str(x.dtype).removeprefix("torch.")
    by[dtype] = by.get(dtype, 0) + 1


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# one zeroed int an output tile for the last-block count of a split launch,
# a buffer for each (device, stream): a kernel leaves it zeroed, and kernels
# of one stream never overlap
_counters = {}


def tile_counters(device: torch.device, tiles: int) -> torch.Tensor:
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf
