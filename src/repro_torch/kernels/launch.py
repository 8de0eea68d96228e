"""Per-card launch state that several kernel wrappers share: the card's SM
count, which the launch plans read, and the zeroed counters of the kernels
whose last block of a tile adds the split slices (the f32 decode loop,
``qmatmul_int8`` and ``flash_attention``).  Nothing here touches a card
when the module is imported.
"""

from __future__ import annotations

import functools

import torch


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
