"""Blocked online-softmax (flash) attention, as a Hopper kernel.

Ports ``repro/kernels/flash_attention.py::flash_attention``
(``_flash_kernel``) and generalises it to what model prefill needs, which
the reference models reach through the jnp ``chunked_attention``: the GQA
fold (Hq % Hkv == 0) and a per-batch-row query offset.  The reference
kernel's folded ``(B*H, S, D)`` interface is the case Hq == Hkv with
``q_offset=None``.

The wrapper launches ``csrc/flash_attention.cu`` for CUDA tensors and raises
on anything it does not take.  For CPU tensors it computes the plain PyTorch
version (``kernels/ref.py``).  ``flash_attention.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref

# head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.library("flash_attention").flash_attention_launch
    fn.argtypes = [_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
                   _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
                   ctypes.c_float, _c_int, _c_int, _c_ptr]
    fn.restype = _c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    window: Optional[int] = None,
                    q_offset: ref.QOffset = None) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) f32 -> (B, Hq, Sq, D) f32.

    Also takes the folded (B*H, S, D) form.  ``q_offset`` (scalar or (B,))
    is the first query's position in the kv sequence; ``None`` means
    ``Sk - Sq``.  ``window`` keeps keys with ``qpos - window < kpos``.
    """
    if q.ndim == 3:
        return flash_attention(q[:, None], k[:, None], v[:, None],
                               causal=causal, scale=scale, window=window,
                               q_offset=q_offset)[:, 0]
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                   window=window, q_offset=q_offset)
    if devices != {"cuda"} or len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention needs q, k and v on one CUDA "
                         f"device (or all on the CPU), got {q.device}, "
                         f"{k.device}, {v.device}")
    if {q.dtype, k.dtype, v.dtype} != {torch.float32}:
        raise TypeError("flash_attention takes float32 q, k and v")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B,Hq,Sq,D) and k, v (B,Hkv,Sk,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    if (k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("flash_attention loads k and v as float4: their "
                         "storage must be 16-byte aligned")
    off = ref.query_offsets(q_offset, b, sq, sk, q.device)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     off.data_ptr(), out.data_ptr(),
                     b, hq, hkv, sq, sk, d, float(scale), int(causal),
                     -1 if window is None else int(window),
                     torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
