"""Plain PyTorch versions of the port's kernels (reference:
``repro/kernels/ref.py:21-25`` and ``:106-123``).

Each computes the same function as its Hopper kernel.  The kernel wrappers
take them for CPU tensors, and ``chip_smoke.py`` holds each kernel against
them on the card.  Nothing on the serving path calls them when its tensors
lie on a card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core import packing

# The reference kernels' finite mask value: a fully masked row averages its
# values instead of turning into NaN, exactly as the online-softmax kernel.
NEG_INF = -1e30

QOffset = Union[None, int, torch.Tensor]


def qmatmul_f32(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                *, bits: int, k_orig: int) -> torch.Tensor:
    """x (M, K) float @ unpack(packed (N, ceil(K/f)))^T * scale (N,) -> f32."""
    w = packing.unpack(packed, bits, k_orig).to(torch.float32)
    w = w * scale[:, None].to(torch.float32)
    return torch.matmul(x.to(torch.float32), w.T)


def query_offsets(q_offset: QOffset, batch: int, sq: int, sk: int,
                  device) -> torch.Tensor:
    """(B,) int32 absolute position of each batch row's first query.

    ``None`` puts the queries at the end of the kv sequence (``sk - sq``),
    as the reference kernel does (``flash_attention.py:41``)."""
    if q_offset is None:
        q_offset = sk - sq
    if isinstance(q_offset, torch.Tensor):
        off = q_offset.to(device=device, dtype=torch.int32).reshape(-1)
        if off.numel() == 1:
            off = off.expand(batch)
        if off.shape != (batch,):
            raise ValueError(f"q_offset must be a scalar or ({batch},), got "
                             f"{tuple(q_offset.shape)}")
        return off.contiguous()
    return torch.full((batch,), int(q_offset), dtype=torch.int32,
                      device=device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    window: Optional[int] = None,
                    q_offset: QOffset = None) -> torch.Tensor:
    """Masked softmax attention with the GQA fold.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) with Hq % Hkv == 0, or the
    reference kernel's folded (B*H, S, D) form.  ``q_offset`` is a scalar or
    a (B,) vector of the first query's position per batch row.
    """
    if q.ndim == 3:
        return flash_attention(q[:, None], k[:, None], v[:, None],
                               causal=causal, scale=scale, window=window,
                               q_offset=q_offset)[:, 0]
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = q.to(torch.float32).reshape(b, hkv, hq // hkv, sq, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg,
                          k.to(torch.float32)) * scale
    off = query_offsets(q_offset, b, sq, sk, q.device)
    qpos = off[:, None] + torch.arange(sq, device=q.device)[None]   # (B, Sq)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((b, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, None] <= qpos[..., None]
    if window is not None:
        mask &= kpos[None, None] > qpos[..., None] - window
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return out.reshape(b, hq, sq, d).to(q.dtype)
