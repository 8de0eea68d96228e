"""Mamba-1 selective SSM: falcon-mamba-7b, and hymba's SSM heads (reference:
``repro/models/ssm.py:20-200``).

The reference scans the sequence with a chunked associative scan in jnp;
the port's serving routes every scan through ``kernels.ops.selective_scan``:
the Hopper kernel on the card (prefill, ``forward`` and decode at S = 1),
its plain version on the CPU, a loop of ``ref.ssm_decode_step`` that is one
step at decode.  Decode carries (h, conv window) per row.

Training takes the reference's chunked associative scan instead
(:func:`selective_scan`, ``ssm.py:40-101``), in differentiable torch ops:
the Hopper kernel is forward-only (ROADMAP C9), as the reference's training
path runs none of its Pallas kernels.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over the sequence.  x: (B, S, C), w: (C, K).

    Returns (y, new_state) with state = the last K-1 inputs (B, K-1, C).
    """
    bsz, s, c = x.shape
    k = w.shape[1]
    if state is None:
        state = torch.zeros((bsz, k - 1, c), dtype=x.dtype, device=x.device)
    xe = torch.cat([state, x], dim=1)                   # (B, S+K-1, C)
    y = torch.zeros((bsz, s, c), dtype=torch.float32, device=x.device)
    for i in range(k):
        y = y + xe[:, i:i + s, :].to(torch.float32) * w[:, i].to(torch.float32)
    if b is not None:
        y = y + b.to(torch.float32)
    new_state = xe[:, s:, :] if k > 1 else state
    return y.to(x.dtype), new_state


def _combine(a: Tuple[torch.Tensor, torch.Tensor],
             b: Tuple[torch.Tensor, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) then (a', b'): (a * a', a' * b + b'), the reference's ``comb``."""
    return a[0] * b[0], b[0] * a[1] + b[1]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 1 (even may be one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    if even.shape[1] > n:
        return torch.cat([pairs, even[:, n:]], dim=1)
    return pairs


def _associative_scan(a: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of :func:`_combine` along axis 1 by
    ``jax.lax.associative_scan``'s odd / even recursion (log depth): pairs
    are combined, the half-length sequence is scanned, and the even
    elements are the odd results combined with the next input.  The same
    tree of products as the reference, so the same rounding."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = _associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                      (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        odd_prev = (odd[0][:, :-1], odd[1][:, :-1])
    else:
        odd_prev = odd
    even = _combine(odd_prev, (a[:, 2::2], b[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], dim=1),
            torch.cat([b[:, :1], even[1]], dim=1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def _ssm_chunk_scan(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = dA_t * h_{t-1} + dBx_t within one chunk (``ssm.py:40-53``).

    dA, dBx: (B, T, Di, N); h0: (B, Di, N).  Returns (h_all, h_last)."""
    aa, bb = _associative_scan(dA, dBx)
    h_all = aa * h0[:, None] + bb
    return h_all, h_all[:, -1]


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, chunk: int = 256,
                   compute_dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's training scan (``ssm.py:56-101``) in differentiable
    torch ops: the sequence in chunks of ``chunk`` (the last zero-padded),
    an associative scan within a chunk, the state carried across chunks in
    f32, ``y = einsum(h_all, C) + x * D``.

    x, dt: (Bz, S, Di); A: (Di, N); B, C: (Bz, S, N); D: (Di,).  Returns
    (y (Bz, S, Di) f32, h_last (Bz, Di, N) f32).  ``compute_dtype`` (the
    config's ``scan_dtype``) is the reference's: x, dt, B and C are read in
    it, dA is rounded to it, dBx and the chunk's scan are computed in it,
    y sums h_all times C in f32 and the carried state stays f32."""
    bsz, s, di = x.shape
    n = A.shape[1]
    h = (torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (x, dt, B, C))
    ys = []
    for start in range(0, s + pad, chunk):
        xk, dtk, bk, ck = (t[:, start:start + chunk].to(compute_dtype)
                           for t in (x, dt, B, C))
        dA = torch.exp(dtk.to(torch.float32)[..., None]
                       * A[None, None]).to(compute_dtype)    # (B,T,Di,N)
        dBx = dtk[..., None] * bk[:, :, None, :] * xk[..., None]
        h_all, h = _ssm_chunk_scan(dA, dBx, h.to(compute_dtype))
        ys.append(torch.einsum("btdn,btn->btd", h_all.to(torch.float32),
                               ck.to(torch.float32)))
        h = h.to(torch.float32)
    y = torch.cat(ys, dim=1)[:, :s]
    return y + x[:, :s].to(torch.float32) * D[None, None], h


def mamba_mixer(x: torch.Tensor, p: Dict[str, Any], *, d_inner: int,
                ssm_state: int, dt_rank: int, conv_k: int = 4,
                shard_inner: bool = False,
                state: Optional[Dict[str, torch.Tensor]] = None,
                lengths: Optional[torch.Tensor] = None,
                engine: Optional[Any] = None, in_place: bool = False,
                scan: Optional[Callable] = None,
                scan_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full Mamba-1 mixer.  x: (B, S, D) -> (B, S, D).

    ``state`` (serving): {"h": (B, Di, N), "conv": (B, K-1, Di)}.  With a
    state and S == 1 the mixer takes the decode branch, as the reference
    does (``ssm.py:136``): a 1-token prefill chunk is a decode step.

    ``lengths`` (B,) marks right-padded rows (pow2-bucketed chunked
    prefill): positions >= lengths[b] are state no-ops -- their dt is set
    to zero, so exp(0*A) = 1 and dt*B*x = 0 leave h unchanged, and the
    carried conv window is gathered from the last K-1 real inputs.  y at
    pad positions is garbage the caller ignores.

    ``in_place`` writes the new state into ``state``'s own tensors (the
    serve cache's layer slice; the scan writes h_last over h0) and returns
    ``state``; otherwise the new state is a fresh dict.

    ``scan`` replaces ``kops.selective_scan`` with the same arguments
    (x, dt, A, B, C, D, h0): the training path, which carries no state,
    passes :func:`selective_scan` with the reference's ``chunk``.

    ``shard_inner`` is the reference's multi-device constraint of d_inner
    onto the model axis (ROADMAP A11); it is accepted and ignored here.

    ``scan_dtype`` is the reference's scan compute dtype (``ssm.py:85-96``),
    used where the reference uses it, off the decode branch.  The training
    ``scan`` carries it itself.  The serving scan reads x, dt, B and C in a
    bf16 ``scan_dtype``: that feeds the kernel's bf16 route (its plain
    version on the CPU), the Pallas kernel's bf16 contract, bf16 inputs
    widened to f32 inside, so it is more exact than the reference's bf16
    jnp scan (which also rounds dA, dBx and h to bf16); the two agree
    within the reference's own bf16 scan tolerance (0.05,
    ``tests/test_ssm_kernel.py:46``).  y comes back in the activations'
    dtype, and x * D is taken at their precision, as the reference adds
    it.  At a bf16 ``dtype`` x, dt, B and C are bf16 already and take the
    bf16 route whatever ``scan_dtype`` says.  Decode computes in f32 from
    its inputs, as the reference's ``ssm_decode_step`` does.
    """
    del shard_inner, d_inner
    decode = state is not None and x.shape[1] == 1

    xz = layers.linear(x, p["in_proj"], engine=engine,
                       path="layers/ssm/in_proj")                  # (B,S,2Di)
    xs, z = torch.chunk(xz, 2, dim=-1)

    conv_state = state["conv"] if state is not None else None
    xc, new_conv = causal_conv1d(xs, p["conv_w"], p.get("conv_b"), conv_state)
    if (not decode) and lengths is not None and state is not None:
        # the carried window holds the last K-1 *real* inputs, not the pads:
        # token t sits at index K-1+t of [state ; x], so after n real tokens
        # the window is ext[:, n : n+K-1)
        kk = p["conv_w"].shape[1]
        if kk > 1:
            cs = (conv_state if conv_state is not None
                  else torch.zeros((xs.shape[0], kk - 1, xs.shape[2]),
                                   dtype=xs.dtype, device=xs.device))
            ext = torch.cat([cs, xs], dim=1)                # (B, S+K-1, Di)
            idx = (lengths.to(device=xs.device, dtype=torch.long)[:, None]
                   + torch.arange(kk - 1, device=xs.device)[None])
            new_conv = torch.gather(
                ext, 1, idx[..., None].expand(-1, -1, ext.shape[2]))
    xc = layers.silu(xc)

    dbc = layers.linear(xc, p["x_proj"], engine=engine,
                        path="layers/ssm/x_proj")                  # (B,S,R+2N)
    dt_in = dbc[..., :dt_rank]
    B = dbc[..., dt_rank:dt_rank + ssm_state]
    C = dbc[..., dt_rank + ssm_state:]
    dt = layers.softplus(layers.linear(dt_in, p["dt_proj"], engine=engine,
                                       path="layers/ssm/dt_proj")
                         + p["dt_bias"])
    if (not decode) and lengths is not None:
        # dt = 0 at pads: the scan's exact identity step
        smask = (torch.arange(dt.shape[1], device=dt.device)[None, :]
                 < lengths.to(dt.device)[:, None])
        dt = torch.where(smask[..., None], dt, torch.zeros((), dtype=dt.dtype,
                                                           device=dt.device))
    A = -torch.exp(p["A_log"].to(torch.float32))                # (Di, N)

    h0 = state["h"] if state is not None else None
    if scan is not None:
        y, h_last = scan(xc, dt, A, B, C, p["D"], h0)
    else:
        xs_, dt_, B_, C_ = xc, dt, B, C
        if not decode and scan_dtype != torch.float32:
            xs_, dt_, B_, C_ = (t.to(scan_dtype) for t in (xc, dt, B, C))
        y, h_last = kops.selective_scan(xs_.contiguous(), dt_.contiguous(), A,
                                        B_, C_, p["D"], h0,
                                        h_out=h0 if in_place else None,
                                        y_dtype=xc.dtype)
        if xs_.dtype != xc.dtype:
            # the reference adds x * D with x at the activations' precision
            # (ssm.py:100), the kernel with the x it scanned
            y = y + (xc.to(torch.float32) - xs_.to(torch.float32)) * p["D"]
    new_state = None
    if state is not None and in_place:
        state["conv"].copy_(new_conv)
        new_state = state
    elif state is not None:
        new_state = dict(h=h_last, conv=new_conv)

    y = y.to(x.dtype) * layers.silu(z)
    out = layers.linear(y, p["out_proj"], engine=engine,
                        path="layers/ssm/out_proj")
    return out, new_state


def init_ssm_state(batch: int, d_inner: int, ssm_state: int, conv_k: int = 4,
                   dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zero (h, conv) state on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return dict(h=torch.zeros((batch, d_inner, ssm_state),
                              dtype=torch.float32, device=dev),
                conv=torch.zeros((batch, conv_k - 1, d_inner), dtype=dtype,
                                 device=dev))
