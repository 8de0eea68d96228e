"""Blocked online-softmax (flash) attention, as a Hopper kernel.

Ports ``repro/kernels/flash_attention.py::flash_attention``
(``_flash_kernel``) and generalises it to what model prefill needs, which
the reference models reach through the jnp ``chunked_attention``: the GQA
fold (Hq % Hkv == 0) and a per-batch-row query offset.  The reference
kernel's folded ``(B*H, S, D)`` interface is the case Hq == Hkv with
``q_offset=None``.

The wrapper launches ``csrc/flash_attention.cu`` for CUDA tensors and raises
on anything it does not take.  It takes float32 or bfloat16 q, k and v (one
dtype for all three) and writes the output in q's dtype, as the Pallas
kernel does: bf16 inputs launch the kernel's bf16 route (``flash_fwd_bf16``,
bf16 MMAs with f32 accumulation), never the f32 one.  That route rounds P
to bf16 before PV where the caller asks (``p_dtype=torch.bfloat16``, the
reference's bf16 ``attn_dtype``), and else keeps it to f32 accuracy as a
bf16 hi and lo part, as the Pallas kernel keeps p in f32.
For CPU tensors it computes the plain PyTorch version (``kernels/ref.py``).
For ``meta`` ones (all three) it gives a ``meta`` output and reports the
kernel's work, :func:`flash_work`, to the cost counters
(``kernels/launch.on_meta``).
``flash_attention.launches`` counts kernel launches,
``flash_attention.launches_by_shape`` the same launches by (Sq, Sk) and
``flash_attention.launches_by_dtype`` by q's dtype.

The launch plan is pure Python, here, so that the CPU tests hold it: a block
owns ``16 * WARPS`` (query, head) rows of one (batch row, kv head), query-
major over the GQA group, and walks the kv tiles of ``BLOCK_KEYS[d]`` keys
that its rows can see (``visible_tiles``, the kernel's own rule); each row
tile's kv tiles are split into slices of ``split_tiles`` tiles, one block a
slice (``flash_plan``), and the slices of a row tile are added in slice
order by its last block.  The plan depends on the shapes and the card's SM
count, never on the per-row offsets, which stay on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.launch import (count_dtype, count_meta,
                                        forward_only, on_meta, sm_count,
                                        tile_counters)

# head dims the kernel is instantiated for, each with its keys a kv tile
# (csrc/flash_attention.cu instantiates the same pairs); 4 warps a block of
# 16 (query, head) rows each.  Of the tiles swept at qwen3-0.6b's D = 128
# (32 or 64 keys, 4 or 8 warps) and hymba-1.5b's D = 64, 32 keys and 4 warps
# gave the least flash time over each serve's calls (PERF.md section 6).
# gemma-7b's D = 256 keeps 32 keys (205 KB of shared memory, one block an
# SM; csrc/flash_attention.cu says how it fits its registers)
BLOCK_KEYS = {16: 64, 32: 32, 64: 32, 128: 32, 256: 32}
HEAD_DIMS = tuple(BLOCK_KEYS)
WARPS = 4
ROWS_PER_WARP = 16            # one m16 MMA tile of (query, head) rows
# the kv split of a short span (at most SHORT_TILES kv tiles): about one
# block an SM over the row tiles.  Of a longer one: slices of at least
# SLICE_WORK keys x head dim (the same work a row at every head dim up to
# 128), and as many as give BLOCKS_PER_SM blocks an SM with the row tiles
# (slices wholly masked for a row tile exit at once).  Above D = 128 a block
# has an SM alone and its q tile and slice write-out cost twice as much:
# slices of WIDE_SLICE_WORK (4 tiles at D = 256) took 0.0584 ms at gemma-7b's
# chunk, of SLICE_WORK (1 tile) 0.1128 (PERF.md section 6)
SHORT_TILES = 8
SLICE_WORK = 8192
WIDE_SLICE_WORK = 4 * SLICE_WORK
BLOCKS_PER_SM = 16

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int


class FlashPlan(NamedTuple):
    """One launch: kv tiles of ``block_keys`` keys, ``row_tiles`` row tiles
    of ``rows`` (query, head) rows a (batch row, kv head), each row tile's
    ``kv_tiles`` kv tiles cut into ``splits`` slices of ``split_tiles``."""
    block_keys: int
    row_tiles: int
    kv_tiles: int
    split_tiles: int
    splits: int

    @property
    def rows(self) -> int:
        return ROWS_PER_WARP * WARPS


def flash_plan(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
               sms: int, *, split_tiles: Optional[int] = None) -> FlashPlan:
    """The launch plan for q (b, hq, sq, d) over k, v (b, hkv, sk, d) on a
    card with ``sms`` SMs.  ``split_tiles`` overrides the default: a span of
    at most SHORT_TILES kv tiles (256 keys at D >= 32) in as many slices as
    give about one block an SM (qwen3-0.6b's serving chunks: 32 or 64 row
    tiles, 2-4 slices), a longer one in slices of at least SLICE_WORK / d
    keys (64 at D = 128, 128 at hymba-1.5b's D = 64; WIDE_SLICE_WORK / d,
    128, at gemma-7b's D = 256), longer where the row tiles alone give
    BLOCKS_PER_SM blocks an SM (hymba-1.5b's long prompt: 1,820 row tiles,
    two slices).  Of the splits ``tools/attn_scan_ab.py --sweep`` times at
    both models' serving call shapes and gemma-7b's chunk, this rule takes
    the fastest or one within 4 % of it at each (PERF.md section 6)."""
    if d not in BLOCK_KEYS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    bk = BLOCK_KEYS[d]
    row_tiles = -(-sq * (hq // hkv) // (ROWS_PER_WARP * WARPS))
    kv_tiles = max(1, -(-sk // bk))
    if split_tiles is None:
        tiles = max(1, b * hkv * row_tiles)
        if kv_tiles <= SHORT_TILES:
            split_tiles = -(-kv_tiles // min(kv_tiles, max(1, sms // tiles)))
        else:
            want = -(-BLOCKS_PER_SM * sms // tiles)
            work = SLICE_WORK if d <= 128 else WIDE_SLICE_WORK
            split_tiles = max(work // (d * bk),
                              -(-kv_tiles // min(kv_tiles, want)))
    if split_tiles < 1:
        raise ValueError(f"split_tiles must be >= 1, got {split_tiles}")
    return FlashPlan(bk, row_tiles, kv_tiles, split_tiles,
                     -(-kv_tiles // split_tiles))


def visible_tiles(plan: FlashPlan, group: int, sq: int, sk: int,
                  causal: bool, window: Optional[int], offset: int,
                  row_tile: int) -> Tuple[int, int]:
    """The kv tiles [lo, hi) that any row of ``row_tile`` can see (its first
    query at ``offset`` + r0 / group), as the kernel computes them; (0, 0)
    when no row sees a key."""
    r0 = row_tile * plan.rows
    last = min(r0 + plan.rows, sq * group) - 1
    qfirst, qlast = offset + r0 // group, offset + last // group
    khi = min(sk, qlast + 1) if causal else sk
    klo = max(0, qfirst - window + 1) if window else 0
    if khi <= klo:
        return 0, 0
    return klo // plan.block_keys, -(-khi // plan.block_keys)


def live_slices(plan: FlashPlan, lo: int, hi: int) -> range:
    """The slices that own a visible tile of [lo, hi), in the order the
    last block adds them; slice 0 alone when there is none."""
    if hi <= lo:
        return range(1)
    return range(lo // plan.split_tiles, (hi - 1) // plan.split_tiles + 1)


def slice_tiles(plan: FlashPlan, lo: int, hi: int, split: int) -> range:
    """The kv tiles that slice ``split`` walks, in order."""
    return range(max(lo, split * plan.split_tiles),
                 min(hi, (split + 1) * plan.split_tiles))


def flash_work(b: int, hq: int, hkv: int, sq: int, sk: int, d: int, *,
               causal: bool, window: Optional[int], offsets: Sequence[int],
               q_bytes: int, out_bytes: int) -> Tuple[int, int]:
    """(FLOPs, bytes) that one call needs with these query offsets (one a
    batch row): 4 D FLOPs a visible (query, key) pair; q read and the
    output written once, the offsets, and each kv head's keys and values
    that its batch row's queries can see read once (PERF.md section 6's
    bound)."""
    i = np.arange(sq, dtype=np.int64)
    pairs = 0
    nbytes = b * hq * sq * d * (q_bytes + out_bytes) + b * 4
    for o in offsets:
        hi = (np.minimum(sk, o + i + 1) if causal
              else np.full(sq, sk, np.int64))
        lo = (np.maximum(0, o + i - window + 1) if window
              else np.zeros(sq, np.int64))
        seen = hi > lo
        if seen.any():
            pairs += hq * int((hi - lo)[seen].sum())
            nbytes += 2 * hkv * int(hi[seen].max() - lo[seen].min()) * d \
                * q_bytes
    return 4 * d * pairs, nbytes


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.library("flash_attention").flash_attention_launch
    fn.argtypes = ([_c_ptr] * 7 + [_c_int] * 9 + [ctypes.c_float]
                   + [_c_int] * 6 + [_c_ptr])
    fn.restype = _c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    window: Optional[int] = None,
                    q_offset: ref.QOffset = None,
                    plan: Optional[FlashPlan] = None,
                    out_dtype: Optional[torch.dtype] = None,
                    p_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in q's dtype;
    all three float32, or all three bfloat16 (the bf16 route).  The bf16
    route also writes f32 (``out_dtype=torch.float32``: a model whose
    activations are f32 but whose attention computes in bf16), and rounds
    the probabilities to bf16 before PV at ``p_dtype=torch.bfloat16`` (the
    reference's bf16 ``attn_dtype``); at f32 they stay f32-accurate.

    Also takes the folded (B*H, S, D) form.  ``q_offset`` (scalar or (B,))
    is the first query's position in the kv sequence; ``None`` means
    ``Sk - Sq``.  ``window`` keeps keys with ``qpos - window < kpos``.  A
    query row that sees no key gets the mean of v over all Sk keys, as the
    plain version's softmax over equal scores gives it.  ``plan`` overrides
    ``flash_plan``'s (for sweeps).
    """
    if q.ndim == 3:
        return flash_attention(q[:, None], k[:, None], v[:, None],
                               causal=causal, scale=scale, window=window,
                               q_offset=q_offset, plan=plan,
                               out_dtype=out_dtype, p_dtype=p_dtype)[:, 0]
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"flash_attention writes q's dtype or float32, not "
                        f"{out_dtype}")
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                   window=window, q_offset=q_offset,
                                   out_dtype=out_dtype, p_dtype=p_dtype)
    forward_only("flash_attention", q, k, v)
    meta = on_meta("flash_attention", q, k, v)
    if not meta and (devices != {"cuda"}
                     or len({q.device, k.device, v.device}) != 1):
        raise ValueError("flash_attention needs q, k and v on one CUDA "
                         f"device (or all on the CPU), got {q.device}, "
                         f"{k.device}, {v.device}")
    dtypes = {q.dtype, k.dtype, v.dtype}
    if dtypes not in ({torch.float32}, {torch.bfloat16}):
        raise TypeError("flash_attention takes float32 or bfloat16 q, k and "
                        f"v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if p_dtype not in (torch.float32, torch.bfloat16) or (
            p_dtype == torch.bfloat16 and q.dtype != torch.bfloat16):
        raise TypeError(f"flash_attention rounds P to bf16 on its bf16 route "
                        f"only, got p_dtype {p_dtype} for {q.dtype} q")
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
    if meta:
        if isinstance(q_offset, torch.Tensor):
            raise ValueError("flash_attention on meta counts the keys each "
                             "query sees: q_offset must be an int or None")
        off = sk - sq if q_offset is None else int(q_offset)
        count_meta("flash_attention", *flash_work(
            b, hq, hkv, sq, sk, d, causal=causal, window=window,
            offsets=[off] * b, q_bytes=q.element_size(),
            out_bytes=out_dtype.itemsize))
        return torch.empty_like(q, dtype=out_dtype)
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("flash_attention copies q, k and v in 16 B chunks: "
                         "their storage must be 16-byte aligned")
    off = ref.query_offsets(q_offset, b, sq, sk, q.device)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q, dtype=out_dtype)
    if out.numel() == 0:
        return out
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    if plan is None:
        index = q.device.index
        plan = flash_plan(b, hq, hkv, sq, sk, d, sm_count(
            torch.cuda.current_device() if index is None else index))
    tiles = b * hkv * plan.row_tiles
    part = counters = None
    if plan.splits > 1:
        part = torch.empty(tiles * plan.splits * plan.rows * (d + 2),
                           dtype=torch.float32, device=q.device)
        counters = tile_counters(q.device, tiles)
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     off.data_ptr(), out.data_ptr(),
                     None if part is None else part.data_ptr(),
                     None if counters is None else counters.data_ptr(),
                     b, hq, hkv, sq, sk, d, int(q.dtype == torch.bfloat16),
                     int(out_dtype == torch.float32),
                     int(p_dtype == torch.bfloat16), float(scale),
                     int(causal),
                     -1 if window is None else int(window),
                     plan.block_keys, plan.row_tiles, plan.split_tiles,
                     plan.splits,
                     torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc} "
                           f"({plan})")
    flash_attention.launches += 1
    shape = f"Sq={sq} Sk={sk}"
    by_shape = flash_attention.launches_by_shape
    by_shape[shape] = by_shape.get(shape, 0) + 1
    count_dtype(flash_attention, q)
    return out


flash_attention.launches = 0
flash_attention.launches_by_shape = {}
flash_attention.launches_by_dtype = {}
