"""Fused selective scan (Mamba-1), as a Hopper kernel.

Ports ``repro/kernels/ssm_scan.py::selective_scan_fused`` (``_scan_kernel``)
and extends it to what serving needs: an optional initial state ``h0`` in
and the final state ``h_last`` out, since the serving engine carries the
state across prefill chunks and into decode.  The TPU kernel starts from
zero and returns y only; the reference models never call it and run the
jnp chunked scan of ``repro/models/ssm.py`` instead.  The port wires the
kernel into the SSM mixer's prefill, ``forward`` and decode (at S = 1).

The wrapper launches ``csrc/ssm_scan.cu`` for CUDA tensors and raises on
anything it does not take.  x, dt, B and C are float32, or all four
bfloat16 (the TPU kernel's bf16 contract: the kernel reads them as bf16,
computes in f32 and writes y in x's dtype); A, D, h0 and h_out are float32.
For CPU tensors it computes the plain PyTorch version
(``kernels/ref.py::selective_scan``), for ``meta`` ones (all of them) ``meta``
outputs, reporting the kernel's work, :func:`scan_work`, to the cost
counters (``kernels/launch.on_meta``).  ``selective_scan.launches`` counts
kernel launches, ``selective_scan.launches_by_route`` the same launches by
route and ``selective_scan.launches_by_dtype`` by x's dtype.

The kernel has two routes, chosen by S (``scan_plan``, pure Python so that
the CPU tests hold it): ``step`` for decode (S <= ``STEP_MAX_S``), one pass
with every load straight to registers, and ``chunked`` for prefill, chunks
of time steps through a cp.async ring.  Both take ``exp2(dt * A log2 e)``,
one MUFU op a state step.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.launch import (count_dtype, count_meta,
                                        forward_only, on_meta)

# state sizes the kernel is instantiated for
N_STATES = (4, 8, 16, 32)
# the route rule: S up to this takes the step route, longer S the ring
STEP_MAX_S = 1
# a block holds at most this many threads (the kernel's launch bounds), a
# thread at most this many states
MAX_THREADS = 256
MAX_STATES = 16


class ScanPlan(NamedTuple):
    """One launch: ``route`` "step" or "chunked"; ``lanes`` threads share a
    channel's N states (N / lanes each); ``block`` is threads a block
    (step) or channels a block (chunked); ``chunk`` time steps a ring stage
    (chunked only, else 0)."""
    route: str
    lanes: int
    block: int
    chunk: int


def scan_plan(s: int, n: int, *, lanes: Optional[int] = None,
              block: Optional[int] = None, chunk: Optional[int] = None
              ) -> ScanPlan:
    """The launch plan for a scan of S steps with N states: the step route
    for S <= STEP_MAX_S, else the chunked one.  The defaults are the
    fastest of ``tools/attn_scan_ab.py --sweep`` at falcon-mamba-7b's and
    hymba-1.5b's shapes (N = 16) or within its spread: the step route 4
    states a lane, MAX_THREADS threads a block; the chunked route 8 states
    a lane (fewer lanes leave the SFUs idle between steps, more spend the
    issue slots on shuffles), 64 channels a block and 16 steps a ring
    stage, 32 from 256 steps on.  ``lanes``, ``block`` and ``chunk``
    override them (for sweeps)."""
    step = s <= STEP_MAX_S
    if lanes is None:
        lanes = max(1, n // (4 if step else 8))
    if lanes not in (1, 2, 4, 8) or not 1 <= n // lanes <= MAX_STATES:
        raise ValueError(f"lanes must be 1, 2, 4 or 8 with 1 to "
                         f"{MAX_STATES} of the {n} states each, got {lanes}")
    if step:
        return ScanPlan("step", lanes, block or MAX_THREADS, 0)
    return ScanPlan("chunked", lanes, block or min(64, MAX_THREADS // lanes),
                    chunk or (32 if s >= 256 else 16))


def scan_work(bsz: int, s: int, di: int, n: int, *, in_bytes: int,
              y_bytes: int, h0: bool) -> Tuple[int, int]:
    """(operations, bytes) of one scan: a state step's exponential,
    ``dt * A``, ``dt x * B`` and the two multiply-adds of ``h`` and
    ``h * C`` (7), and ``dt * x`` and ``y + D x`` a channel step (3);
    x, dt, B, C, A, D and h0 read once, y and h_last written once
    (PERF.md section 6's bound counts the exponentials, one a state
    step)."""
    ops = 7 * bsz * s * di * n + 3 * bsz * s * di
    nbytes = (in_bytes * (2 * bsz * s * di + 2 * bsz * s * n)
              + y_bytes * bsz * s * di
              + 4 * (di * n + di + (2 if h0 else 1) * bsz * di * n))
    return ops, nbytes


_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.library("ssm_scan").ssm_scan_launch
    fn.argtypes = [_c_ptr] * 9 + [_c_int] * 11 + [_c_ptr]
    fn.restype = _c_int
    return fn


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *,
                   h_out: Optional[torch.Tensor] = None,
                   plan: Optional[ScanPlan] = None,
                   y_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt (Bz, S, Di); A (Di, N); B, C (Bz, S, N); D (Di,); h0 (Bz, Di, N)
    or None -> (y (Bz, S, Di) in x's dtype, h_last (Bz, Di, N) f32).  x,
    dt, B and C are all float32 or all bfloat16; A, D, h0 and h_out float32.
    ``y_dtype=torch.float32`` writes bf16 inputs' y in f32 (a model whose
    activations are f32 but whose scan reads bf16).

    B and C may be strided views (slices of the ``x_proj`` output); they are
    made contiguous here.  The other inputs must be contiguous.  ``h_out``
    (contiguous f32 (Bz, Di, N), and may be ``h0`` itself) receives h_last
    and is returned as it; without it h_last is a new tensor.  ``plan``
    overrides ``scan_plan``'s (for sweeps).
    """
    y_dtype = y_dtype or x.dtype
    if y_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"selective_scan writes y in x's dtype or float32, "
                        f"not {y_dtype}")
    tensors = [x, dt, A, B, C, D] + [t for t in (h0, h_out) if t is not None]
    if {t.device.type for t in tensors} == {"cpu"}:
        y, h_last = ref.selective_scan(x, dt, A, B, C, D, h0,
                                       y_dtype=y_dtype)
        return y, (h_last if h_out is None else h_out.copy_(h_last))
    forward_only("selective_scan", *tensors)
    meta = on_meta("selective_scan", *tensors)
    if not meta and ({t.device.type for t in tensors} != {"cuda"}
                     or len({t.device for t in tensors}) != 1):
        raise ValueError("selective_scan needs every input on one CUDA "
                         "device (or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    streamed = (x, dt, B, C)
    if ({t.dtype for t in streamed} not in ({torch.float32}, {torch.bfloat16})
            or any(t.dtype != torch.float32 for t in [A, D] + tensors[6:])):
        raise TypeError("selective_scan takes x, dt, B and C all float32 or "
                        "all bfloat16, and float32 A, D, h0 and h_out, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if x.ndim != 3 or dt.shape != x.shape or A.ndim != 2:
        raise ValueError(f"need x and dt (Bz, S, Di) and A (Di, N), got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}")
    bsz, s, di = x.shape
    n = A.shape[1]
    if (A.shape[0] != di or B.shape != (bsz, s, n) or C.shape != (bsz, s, n)
            or D.shape != (di,)
            or any(h is not None and h.shape != (bsz, di, n)
                   for h in (h0, h_out))):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, D {tuple(D.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if n not in N_STATES:
        raise ValueError(f"state size {n} not in {N_STATES}")
    if not all(t.is_contiguous() for t in [x, dt, A, D] + tensors[6:]):
        raise ValueError("selective_scan needs contiguous x, dt, A, D, h0 "
                         "and h_out")
    if meta:
        count_meta("selective_scan", *scan_work(
            bsz, s, di, n, in_bytes=x.element_size(),
            y_bytes=y_dtype.itemsize, h0=h0 is not None))
        return (torch.empty((bsz, s, di), dtype=y_dtype, device="meta"),
                torch.empty((bsz, di, n), dtype=torch.float32, device="meta")
                if h_out is None else h_out)
    if h_out is not None and h_out.data_ptr() % 16:
        raise ValueError("selective_scan stores h_out in 16 B pieces: its "
                         "storage must be 16-byte aligned")
    # A, B, C and h0 are read in 16 B pieces: an unaligned one is copied
    B, C = B.contiguous(), C.contiguous()
    A, B, C, h0 = (t if t is None or t.data_ptr() % 16 == 0 else t.clone()
                   for t in (A, B, C, h0))
    y = torch.empty((bsz, s, di), dtype=y_dtype, device=x.device)
    h_last = (torch.empty((bsz, di, n), dtype=torch.float32, device=x.device)
              if h_out is None else h_out)
    if bsz == 0 or di == 0:
        return y, h_last
    plan = plan or scan_plan(s, n)
    bf16 = x.dtype == torch.bfloat16
    vec = (di * x.element_size() % 16 == 0
           and (x.data_ptr() | dt.data_ptr()) % 16 == 0)
    rc = _launcher()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                     C.data_ptr(), D.data_ptr(),
                     None if h0 is None else h0.data_ptr(),
                     y.data_ptr(), h_last.data_ptr(), bsz, s, di, n,
                     int(bf16), int(y_dtype == torch.float32),
                     0 if plan.route == "step" else 1, plan.lanes,
                     plan.block, plan.chunk, int(vec),
                     torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan launch failed: CUDA error {rc} "
                           f"({plan})")
    selective_scan.launches += 1
    by_route = selective_scan.launches_by_route
    by_route[plan.route] = by_route.get(plan.route, 0) + 1
    count_dtype(selective_scan, x)
    return y, h_last


selective_scan.launches = 0
selective_scan.launches_by_route = {}
selective_scan.launches_by_dtype = {}


def hbm_bytes_per_token(di: int, n: int, itemsize: int = 2) -> Tuple[int, int]:
    """(fused, unfused) device-memory bytes per token per layer, the
    reference's estimate (``repro/kernels/ssm_scan.py:109-119``).

    Unfused (the chunked scan of plain ops): the (di, N) expansion crosses
    device memory ~2x per associative-scan pass (log2(chunk) = 8 passes)
    plus x/dt/B/C/y.  Fused: x, dt, y (3·di) + B, C (2·N) only.
    """
    fused = (3 * di + 2 * n) * itemsize
    passes = 8
    unfused = (3 * di + 2 * n) * itemsize + 2 * passes * di * n * 4
    return fused, unfused
