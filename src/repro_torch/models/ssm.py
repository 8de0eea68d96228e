"""Mamba-1 selective SSM: falcon-mamba-7b, and hymba's SSM heads (reference:
``repro/models/ssm.py:20-200``).

The reference scans the sequence with a chunked associative scan in jnp;
the port routes every scan through ``kernels.ops.selective_scan``: the
Hopper kernel on the card (prefill, ``forward`` and decode at S = 1), its
plain version on the CPU, a loop of ``ref.ssm_decode_step`` that is one
step at decode.  Decode carries (h, conv window) per row.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_mixer(x: torch.Tensor, p: Dict[str, Any], *, d_inner: int,
                ssm_state: int, dt_rank: int, conv_k: int = 4,
                shard_inner: bool = False,
                state: Optional[Dict[str, torch.Tensor]] = None,
                lengths: Optional[torch.Tensor] = None,
                engine: Optional[Any] = None, in_place: bool = False
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

    ``shard_inner`` is the reference's multi-device constraint of d_inner
    onto the model axis (ROADMAP A11); it is accepted and ignored here.
    The reference's ``chunk`` picks the jnp scan's chunk, which the kernel
    does not need; its ``scan_dtype`` picks the scan's compute type, and the
    port scans in f32 only: ``transformer.check_family`` refuses a config
    with another ``scan_dtype`` (ROADMAP C7).
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
    xc = F.silu(xc)

    dbc = layers.linear(xc, p["x_proj"], engine=engine,
                        path="layers/ssm/x_proj")                  # (B,S,R+2N)
    dt_in = dbc[..., :dt_rank]
    B = dbc[..., dt_rank:dt_rank + ssm_state]
    C = dbc[..., dt_rank + ssm_state:]
    dt = softplus(layers.linear(dt_in, p["dt_proj"], engine=engine,
                                path="layers/ssm/dt_proj") + p["dt_bias"])
    if (not decode) and lengths is not None:
        # dt = 0 at pads: the scan's exact identity step
        smask = (torch.arange(dt.shape[1], device=dt.device)[None, :]
                 < lengths.to(dt.device)[:, None])
        dt = torch.where(smask[..., None], dt, torch.zeros((), dtype=dt.dtype,
                                                           device=dt.device))
    A = -torch.exp(p["A_log"].to(torch.float32))                # (Di, N)

    h0 = state["h"] if state is not None else None
    y, h_last = kops.selective_scan(xc.contiguous(), dt.contiguous(), A, B, C,
                                    p["D"], h0,
                                    h_out=h0 if in_place else None)
    new_state = None
    if state is not None and in_place:
        state["conv"].copy_(new_conv)
        new_state = state
    elif state is not None:
        new_state = dict(h=h_last, conv=new_conv)

    y = y.to(x.dtype) * F.silu(z)
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
