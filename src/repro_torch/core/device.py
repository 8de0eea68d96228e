"""Device resolution for the port's entry points (no reference module: JAX
places arrays on its default backend implicitly).

Entry points take ``device=None`` and run on the card by default.  With no
card present they raise instead of moving to the CPU; the CPU is used only
when the caller asks for it, as the tests do with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def device_of(tree) -> Optional[torch.device]:
    """Device of the first tensor found in a nested dict of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        for v in tree.values():
            d = device_of(v)
            if d is not None:
                return d
    return None
