"""Attention: GQA, blocked online-softmax attention and KV caches
(reference: ``repro/models/attention.py:25-202``).

  * ``chunked_attention`` — the reference's blocked online-softmax GQA
    attention in plain PyTorch ops.  The model reaches the Hopper flash
    kernel through ``kernels.ops.attention`` instead; this function stays as
    the plain counterpart of the reference's jnp path, and the tests hold
    both against it.
  * ``windowed_attention`` — the reference's q-blocked causal sliding-window
    attention (hymba's ``segmented_window_scan`` layers) in plain PyTorch
    ops.  The model runs it on the CPU; on the card the same layers go to
    the flash kernel with the window, whose tile walk skips the keys the
    window hides.
  * ``decode_attention`` — one-token attention over a preallocated cache
    with a per-batch length.  The reference has no Pallas kernel for it, so
    it stays in PyTorch ops.
  * ``init_cache`` / ``update_cache`` — ``update_cache`` writes into the
    cache tensors in place (the reference returns new arrays); it saves a
    full cache copy per layer and step.

The three attention functions take the reference's ``compute_dtype`` (the
config's ``attn_dtype``) and round where it rounds: q is scaled in f32 and
then rounded to it, k and v are rounded to it, and so is P before PV; the
products are summed in f32 and the output is cast to q's dtype.  The
reference's bf16 einsums with ``preferred_element_type=float32`` multiply
bf16 operands into f32 sums, so here the rounded operands are widened back
to f32 and multiplied in f32 (a product of two bf16 values is exact in f32);
a bf16 ``torch.matmul`` would round its output instead.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

NEG_INF = -1e30

Pos = Union[int, torch.Tensor]


def _fold_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, Hq, S, D) -> (B, Hkv, G, S, D)."""
    b, hq, s, d = q.shape
    return q.reshape(b, n_kv, hq // n_kv, s, d)


def _operand(t: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``compute_dtype``, as f32 for an f32-accumulated
    product (a no-op at f32)."""
    return t.to(compute_dtype).to(torch.float32)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: Pos = 0, block: int = 1024,
                      scale: Optional[float] = None,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """Blocked online-softmax GQA attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); Hq % Hkv == 0.  ``q_offset``
    is the absolute position of q[0] in the kv sequence: an int, a 0-d
    tensor, or a (B,) vector for per-row chunk offsets.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = _operand(_fold_gqa(q, hkv).to(torch.float32) * scale,
                  compute_dtype)                           # (B,Hkv,G,Sq,D)
    dev = q.device
    off = torch.as_tensor(q_offset, device=dev)
    ar = torch.arange(sq, device=dev)
    if off.ndim == 1:                                      # (B,) per-batch
        qpos = (off[:, None] + ar)[:, None, None, :, None]  # (B,1,1,Sq,1)
    else:
        qpos = (off + ar)[:, None]                         # (Sq, 1)
    g = hq // hkv
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    block = min(block, sk)
    for start in range(0, sk, block):
        kblk = _operand(k[:, :, start:start + block], compute_dtype)
        vblk = _operand(v[:, :, start:start + block], compute_dtype)
        kpos = start + torch.arange(kblk.shape[2], device=dev)
        s_blk = torch.einsum("bhgqd,bhkd->bhgqk", qg, kblk)
        mask = torch.ones_like(kpos, dtype=torch.bool)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s_blk = torch.where(mask, s_blk, torch.full_like(s_blk, NEG_INF))
        m_new = torch.maximum(m, s_blk.amax(dim=-1))
        p = torch.exp(s_blk - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", _operand(p, compute_dtype), vblk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)


def windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       window: int, q_offset: int = 0, bq: int = 512,
                       scale: Optional[float] = None,
                       compute_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Causal sliding-window attention with q-blocking: each block of ``bq``
    queries attends only to its visible key span (``window + bq`` keys), so
    the work is O(S * (window + bq)), not O(S^2).  q: (B, Hq, Sq, D); k, v:
    (B, Hkv, Sk, D).  The scale goes on q before the scores, and pads go on
    q only, as in the reference."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    bq = min(bq, sq)
    pad = (-sq) % bq
    qg = _operand(q.to(torch.float32) * scale, compute_dtype)
    if pad:
        qg = torch.nn.functional.pad(qg, (0, 0, 0, pad))
    span = min(window + bq, sk)
    dev = q.device
    blocks = []
    for i in range((sq + pad) // bq):
        qstart = i * bq + q_offset
        kstart = min(max(qstart + bq - span, 0), max(sk - span, 0))
        ks = _operand(k[:, :, kstart:kstart + span], compute_dtype)
        vs = _operand(v[:, :, kstart:kstart + span], compute_dtype)
        qblk = _fold_gqa(qg[:, :, i * bq:(i + 1) * bq], hkv)
        s_ = torch.einsum("bhgqd,bhkd->bhgqk", qblk, ks)
        qpos = qstart + torch.arange(bq, device=dev)[:, None]
        kpos = kstart + torch.arange(span, device=dev)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - window)
        s_ = torch.where(mask, s_, torch.full_like(s_, NEG_INF))
        p = torch.softmax(s_, dim=-1)
        o = torch.einsum("bhgqk,bhkd->bhgqd", _operand(p, compute_dtype), vs)
        blocks.append(o.reshape(b, hq, bq, d))
    out = torch.cat(blocks, dim=2)[:, :, :sq]
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: Pos, *,
                     window: Optional[int] = None,
                     scale: Optional[float] = None,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """One-token attention over a preallocated cache.

    q: (B, Hq, 1, D); caches: (B, Hkv, Smax, D); cache_len: scalar or (B,)
    count of valid positions (the new token is at cache_len - 1).
    """
    b, hq, _, d = q.shape
    hkv, smax = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = _operand(_fold_gqa(q, hkv).to(torch.float32) * scale, compute_dtype)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg,
                     _operand(k_cache, compute_dtype))
    kpos = torch.arange(smax, device=q.device)
    cl = torch.as_tensor(cache_len, device=q.device)
    if cl.ndim == 1:                                   # per-batch lengths
        cl = cl[:, None, None, None, None]
    mask = kpos < cl                                   # broadcasts onto s
    if window is not None:
        mask = mask & (kpos > cl - 1 - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", _operand(p, compute_dtype),
                       _operand(v_cache, compute_dtype))
    return out.reshape(b, hq, 1, d).to(q.dtype)


def init_cache(batch: int, n_kv: int, max_len: int, head_dim: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    return dict(
        k=torch.zeros((batch, n_kv, max_len, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, n_kv, max_len, head_dim), dtype=dtype,
                      device=device),
    )


def update_cache(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                 v_new: torch.Tensor, pos: Pos) -> Dict[str, torch.Tensor]:
    """Write (B, Hkv, S_new, D) into the cache at ``pos`` (scalar, or (B,)
    per batch row), in place.  Starts are clamped so the write fits, as
    ``jax.lax.dynamic_update_slice`` clamps them in the reference."""
    smax = cache["k"].shape[2]
    s = k_new.shape[2]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        start = torch.clamp(pos.to(torch.long), 0, smax - s)
        rows = start[:, None] + torch.arange(s, device=start.device)  # (B,S)
        bidx = torch.arange(pos.shape[0], device=start.device)[:, None]
        for name, new in (("k", k_new), ("v", v_new)):
            c = cache[name]
            c[bidx, :, rows] = new.permute(0, 2, 1, 3).to(c.dtype)
        return cache
    start = min(max(int(pos), 0), smax - s)
    cache["k"][:, :, start:start + s] = k_new.to(cache["k"].dtype)
    cache["v"][:, :, start:start + s] = v_new.to(cache["v"].dtype)
    return cache
