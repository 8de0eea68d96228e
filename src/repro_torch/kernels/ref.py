"""Plain PyTorch versions of the port's kernels (reference:
``repro/kernels/ref.py``).

Each computes the same function as its Hopper kernel.  The kernel wrappers
take them for CPU tensors, and ``chip_smoke.py`` holds each kernel against
them on the card.  Nothing on the serving or N-EUREKA path calls them when
its tensors lie on a card.

The integer versions (``qmatmul_int8``, ``conv3x3_dense``) accumulate their
products in float64 and cast the sum to int32: PyTorch has no int32 matmul
on CUDA, and float64 is exact here (|acc| <= 255 * 128 * K, about 4.2e7 at
K = 1280, far below 2^53).  One code path serves both devices.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

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


def qmatmul_f32_grouped(x: torch.Tensor, packed: torch.Tensor,
                        scale: torch.Tensor, *, bits: int, k_orig: int
                        ) -> torch.Tensor:
    """Per-expert :func:`qmatmul_f32`: x (E, C, K) @ unpack(packed (E, N,
    ceil(K/f)))^T * scale (E, N) -> (E, C, N) f32, one batched matmul."""
    w = packing.unpack(packed, bits, k_orig).to(torch.float32)
    w = w * scale[..., None].to(torch.float32)
    return torch.bmm(x.to(torch.float32), w.transpose(1, 2))


def qmatmul_f32_blockscale(x: torch.Tensor, packed: torch.Tensor,
                           scales: torch.Tensor, *, bits: int, k_orig: int,
                           block: int = 32) -> torch.Tensor:
    """Wire-form matmul: x (M, K) @ (unpack(packed (N, ceil(K/f))) x per-
    (row, ``block``) scales (N, ceil(K/block)))^T -> f32, the levels
    expanded with their block scales before the reduction
    (``repro/kernels/ref.py:28-44``)."""
    levels = packing.unpack(packed, bits, k_orig).to(torch.float32)
    n, k = levels.shape
    nblk = scales.shape[1]
    lp = torch.nn.functional.pad(levels, (0, nblk * block - k))
    w = (lp.reshape(n, nblk, block)
         * scales[:, :, None].to(torch.float32)).reshape(n, nblk * block)
    return torch.matmul(x.to(torch.float32), w[:, :k].T)


def requant_f32(acc: torch.Tensor, mult: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """NORMQUANT projection, float-rescale form (``ref.py:16-18``): int32 acc
    -> ``clip(round(acc * mult) + bias, 0, 255)`` uint8, rounding half to
    even as ``jnp.round`` does."""
    y = torch.round(acc.to(torch.float32) * mult.to(torch.float32))
    y = y + bias.to(torch.float32)
    return torch.clamp(y, 0.0, 255.0).to(torch.uint8)


def qmatmul_int8(x_q: torch.Tensor, packed: torch.Tensor, mult: torch.Tensor,
                 bias: torch.Tensor, *, bits: int, k_orig: int
                 ) -> torch.Tensor:
    """uint8 x (M, K) @ unpack(packed (N, ceil(K/f)))^T -> requant uint8."""
    w = packing.unpack(packed, bits, k_orig).to(torch.float64)
    acc = torch.matmul(x_q.to(torch.float64), w.T).to(torch.int32)
    return requant_f32(acc, mult[None, :], bias[None, :])


def _halo(h: int, w: int, stride: int):
    """Output size and the bottom/right zero padding of the reference
    (``neureka_conv.py:97-99``): one row and column above and left, enough
    below and right for ceil(H/s) x ceil(W/s) outputs (at least one)."""
    ho, wo = -(-h // stride), -(-w // stride)
    hpad = max((ho - 1) * stride + 3 - h - 1, 1)
    wpad = max((wo - 1) * stride + 3 - w - 1, 1)
    return ho, wo, hpad, wpad


def _taps(xp: torch.Tensor, ho: int, wo: int, stride: int):
    """The nine strided (ho, wo, C) views of a padded map, tap t = 3i + j."""
    for i in range(3):
        for j in range(3):
            yield i, j, xp[i:i + (ho - 1) * stride + 1:stride,
                           j:j + (wo - 1) * stride + 1:stride]


def conv3x3_dense(x: torch.Tensor, packed: torch.Tensor, mult: torch.Tensor,
                  bias: torch.Tensor, *, bits: int, cin: int,
                  stride: int = 1) -> torch.Tensor:
    """x (H, W, Cin) uint8, packed (Cout, 3, 3, ceil(Cin/f)) -> (Ho, Wo,
    Cout) uint8; weights are packed per tap along Cin."""
    w = packing.unpack(packed, bits, cin).to(torch.float64)  # (Cout,3,3,Cin)
    h, w_, _ = x.shape
    ho, wo, hpad, wpad = _halo(h, w_, stride)
    xp = torch.nn.functional.pad(x.to(torch.float64),
                                 (0, 0, 1, wpad, 1, hpad))
    acc = torch.zeros((ho, wo, packed.shape[0]), dtype=torch.float64,
                      device=x.device)
    for i, j, patch in _taps(xp, ho, wo, stride):
        acc = acc + torch.einsum("hwc,oc->hwo", patch, w[:, i, j, :])
    return requant_f32(acc.to(torch.int32), mult[None, None, :],
                       bias[None, None, :])


def conv3x3_dw(x: torch.Tensor, packed: torch.Tensor, mult: torch.Tensor,
               bias: torch.Tensor, *, bits: int, stride: int = 1
               ) -> torch.Tensor:
    """Depthwise 3x3: x (H, W, C) uint8, packed (C, ceil(9/f)) along the
    nine taps -> (Ho, Wo, C) uint8.  Elementwise, so int32 throughout."""
    w = packing.unpack(packed, bits, 9).to(torch.int32)      # (C, 9)
    h, w_, c = x.shape
    ho, wo, hpad, wpad = _halo(h, w_, stride)
    xp = torch.nn.functional.pad(x.to(torch.int32), (0, 0, 1, wpad, 1, hpad))
    acc = torch.zeros((ho, wo, c), dtype=torch.int32, device=x.device)
    for i, j, patch in _taps(xp, ho, wo, stride):
        acc = acc + patch * w[:, i * 3 + j][None, None, :]
    return requant_f32(acc, mult[None, None, :], bias[None, None, :])


def conv1x1(x: torch.Tensor, packed: torch.Tensor, mult: torch.Tensor,
            bias: torch.Tensor, *, bits: int, cin: int,
            stride: int = 1) -> torch.Tensor:
    """Pointwise conv: the strided slice, then ``qmatmul_int8``."""
    if stride != 1:
        x = x[::stride, ::stride, :]
    h, w_, c = x.shape
    out = qmatmul_int8(x.reshape(h * w_, c), packed, mult, bias, bits=bits,
                       k_orig=cin)
    return out.reshape(h, w_, -1)


def ssm_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                    h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence (``repro/models/ssm.py::ssm_decode_step``).
    x, dt: (Bz, Di); A: (Di, N); B, C: (Bz, N); D: (Di,); h: (Bz, Di, N).
    Returns (y (Bz, Di) f32, h f32)."""
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    dA = torch.exp(dtf[..., None] * A.to(torch.float32)[None])  # (Bz, Di, N)
    dBx = dtf[..., None] * B[:, None, :].to(torch.float32) * xf[..., None]
    h = dA * h + dBx
    y = torch.einsum("bdn,bn->bd", h, C.to(torch.float32))
    return y + xf * D.to(torch.float32)[None], h


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None):
    """Mamba-1 selective scan, one :func:`ssm_decode_step` after another (the
    semantics of ``repro/models/ssm.py::selective_scan``), so the serving
    decode (S = 1) is exactly one decode step.

    x, dt: (Bz, S, Di); A: (Di, N); B, C: (Bz, S, N); D: (Di,); h0: (Bz, Di,
    N) or None for a zero state.  Returns (y (Bz, S, Di) f32, h_last (Bz,
    Di, N) f32).  A step with dt = 0 multiplies h by exp(0) = 1 and adds 0,
    so it leaves h unchanged.
    """
    bsz, s, di = x.shape
    n = A.shape[1]
    h = (torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=x.device)
    for t in range(s):
        y[:, t], h = ssm_decode_step(x[:, t], dt[:, t], A, B[:, t], C[:, t],
                                     D, h)
    return y, h


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
