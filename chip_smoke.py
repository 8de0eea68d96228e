#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

It drives the port's paths once, each at full width -- serving qwen3-0.6b,
falcon-mamba-7b and hymba-1.5b, int8 MobileNet-V2 1.0-224 on the N-EUREKA
operators, qwen3-0.6b again from a paged 4-bit store whose cold half is
wire-served, both qwen3-0.6b stores once more behind the deadline-aware
``Scheduler`` under XR traffic, qwen3-0.6b with its KV cache paged,
alone and beside falcon-mamba-7b as two tenants of one page pool, and the
MoE qwen2-moe-a2.7b on the grouped expert kernel -- and fails (non-zero
exit, no result line) if any phase fails:

1. set-up: requires a CUDA device, turns TF32 off, prints the card's name
   and power limit, builds every ``csrc/*.cu`` with nvcc for sm_90a (one
   nvcc each, in parallel), prints what ptxas reports for each kernel and
   fails if the tensor-core kernels of the f32 matmuls (``qmm_dec``,
   ``bs_dec`` for M <= 16, ``qmm_tc``, ``bs_tc`` above), the flash kernel
   (``flash_fwd_tc``), the scan's two routes (``scan_step``,
   ``scan_chunked``), the int8 MMA kernels (``qmm_int8_direct``,
   ``qmm_int8_staged``, ``dense3x3_mma``) or the depthwise kernel
   (``dw3x3_vec``, every instantiation) spill, or if ``cuobjdump
   --dump-sass`` finds no ``IMMA`` in an int8 MMA kernel or no TF32
   ``HMMA`` in the flash kernel;
2. each Hopper kernel against its plain PyTorch version on the card, at the
   shapes its path gives it: ``qmatmul_f32``, ``flash_attention`` and
   ``selective_scan`` within the stated tolerances (flash at each tile the
   kernel holds, with GQA 2 and 5, windows, hymba's long prompt and rows
   that see no key, and two calls bit-equal; the scan also at a ragged S,
   with and without h0, at N 4 / 8 / 32 on a ragged Di, on each side of
   its route threshold, and its dt = 0 pads bit-exact no-ops on both
   routes);
   ``qmatmul_int8``, ``conv3x3_dense`` and ``conv3x3_dw`` bit for bit
   (``torch.equal``) at every distinct MobileNet-V2 job shape at 224, at 8,
   4 and 2 bits, at the ragged shapes of the reference's kernel tests (and
   dense 3x3 at Cin 40 and 64, depthwise 3x3 at C 24, 17 and 1, and
   ``qmatmul_int8`` on each side of its plan's K-split thresholds) and at
   requant ties; ``qmatmul_f32`` and
   ``qmatmul_f32_blockscale`` must
   also give the same bits on two calls.  Then each is timed with CUDA
   events (L2-cold: inputs rotate over more than the 50 MB L2) beside its
   plain version, one PyTorch library call for the same function where
   there is one, and its bound: bytes over 3.35 TB/s, or operations over
   67 TFLOP/s (f32), 1,979 TOP/s (int8 tensor cores) or the SFUs'
   exponential rate, whichever is larger; the f32 matmuls and flash
   attention at their own route, two (matmuls) or three (flash) TF32
   passes at 495 TFLOP/s, with the f32 CUDA-core bound beside it.  Besides
   qwen3-0.6b's layer, falcon-mamba-7b's four linears of a layer are timed
   at M = 4 and 256; flash at qwen3-0.6b's prefill chunk and hymba-1.5b's
   longest prompt; the scan at falcon-mamba-7b's and hymba-1.5b's prefill
   and decode; the N-EUREKA kernels at MobileNet-V2 jobs (``NEUREKA_TIMED``:
   ``conv3x3_dw`` at b0.dw, b1.dw and b14.dw, its largest stride-1 and
   stride-2 maps and its smallest one).
   Device times replay a CUDA graph of the calls, so the host's
   launch gaps drop out; the same calls enqueued eagerly from Python are
   printed beside them;
3. serving, three times: full-width qwen3-0.6b (28 layers, d_model 1024),
   falcon-mamba-7b (64 layers, d_model 4096, d_inner 8192) and hymba-1.5b
   (32 layers, d_model 1600, 128 meta tokens, window 1024 with 3 global
   layers), each with random weights from a seeded CUDA ``torch.Generator``,
   frozen at 8 bits, ``ServingEngine(batch_slots=4)`` on the card answering
   8 greedy requests (prompts of 16-256 tokens, and one of 1,000-1,200 for
   hymba so that its window binds; 16 new tokens each); the launch counters
   of the family's kernels are set to 0 before and must have grown after;
4. after each serve: the same requests again on a fresh engine under
   ``torch.profiler``, with every call the model code makes to
   ``qmatmul_f32``, ``flash_attention`` and ``selective_scan`` noted (and
   counted: flash launches by shape, scan launches by route); each
   kernel is then held against its plain version at every distinct call
   shape (and window, offsets, h0 use) of that serve, on random inputs.
   Then card vs CPU: ``forward`` logits of one 64-token sequence with the
   same packed weights on the card (kernels) and on the CPU (plain
   versions); all layers of qwen3-0.6b, the first 2 of falcon-mamba-7b and
   the first 4 of hymba-1.5b, and for hymba also its longest served prompt,
   where the window binds;
5. frames: MobileNet-V2 1.0-224 with random weights from a seeded
   ``torch.Generator``, frozen at 8 bits on the card, runs 16 random uint8
   frames through ``apply``; the N-EUREKA launch counters must grow by
   exactly 1 / 17 / 35 a frame; the tree frozen on the card must equal
   the CPU's; two frames must equal the plain path on the CPU bit for
   bit, and one frame each frozen at 4 and 2 bits too.  It prints the
   eager and CUDA-graph frame times, peak memory, and from
   ``torch.profiler`` the device time by kernel and by job (each
   ``qmatmul_int8`` job with its launch plan) and the device's idle share
   of the eager frames; the k-th N-EUREKA kernel of the profile must be
   job k's operator, and the per-job times summed by operator must equal
   the per-kernel sums;
6. paged serving (§II-B2 virtual paging with wire-serve): full-width
   qwen3-0.6b with random weights from a seeded CUDA ``torch.Generator``,
   frozen at 4 bits; ``plan_for_budget`` pins half the store's bytes on the
   card and int8-pages the rest; ``attach_paging(wire_serve=True)`` keeps
   the cold groups on the host, pinned, and every tick streams them to the
   card as int8 pages with per-32 scales, CRC-checked, which
   ``qmatmul_f32_blockscale`` multiplies from that wire form; once the
   caller's own cold leaves go to the host too, the card's memory must
   have fallen by the cold groups' bytes.  First
   ``qmatmul_f32_blockscale`` is held against its plain version (the
   reference test's shapes, bits 2, ragged K, the cold linears) and timed
   like the others, at decode M = 4 and prefill M = 256.  Then the 8
   requests of phase 3 are served: the launch counters of
   ``qmatmul_f32``, ``qmatmul_f32_blockscale`` and ``flash_attention`` are
   set to 0 before and must have grown after; swaps and misses must equal
   the ticks times ``pass_counters``, nothing may be decoded on the host,
   and each tick is split into its page wait (the worker's CRC and copy)
   and compute.  The tokens must equal, per uid and bit for bit, those of
   a resident engine holding the same wire-form bytes on the card, and
   those of the same serve under ``FaultPlan(seed=3, fail_rate=0.2,
   bitflip_rate=0.2)`` (with faults injected, and every checksum failure
   refetched); one pass begun before a forward and fenced after must give
   the pages of a sync pass; the kernels are checked at every call of a
   profiled serve; and the wire tree's logits (4 layers) on the card must
   match the CPU's;
7. the scheduled XR serve: the XR traffic of
   ``benchmarks/serving_load.py`` (copied: the bench imports JAX) -- a
   t = 0 backlog of best-effort assistant requests (16-48 prompt tokens,
   24 new) and a hand-tracking (priority 2, 15 ms deadline) and a gaze
   request (priority 1, 10 ms; 2-8 prompt tokens, 2 new) every 6 ms --
   served by ``serving.Scheduler`` on the bench's virtual clock (1 ms a
   tick) with its defaults (4 slots, max_len 128, prefill chunk 16, token
   budget 96, ``est_tick_s`` pinned).  (a) Phase 3's 8-bit qwen3-0.6b tree,
   60 requests, under both legs of the bench: run-to-completion, and
   continuous (token budget, preemption, reject-mode admission; traced).
   It fails unless every uid's tokens are equal across the legs, the
   continuous leg preempted, the trackers' miss rate is <= 0.05 and the
   assistant's tokens per virtual second are >= 0.90 of the baseline's
   (the bench's gate), both metrics documents pass ``metrics.validate``
   and the trace ``trace.validate``, and ``qmatmul_f32`` and
   ``flash_attention`` launched in each leg.  (b) The same traffic on a
   2-layer smoke config of qwen3-0.6b on the CPU: each leg's decisions
   (per uid: arrival, admission, first-token and finish times on the
   virtual clock, preemptions, rejection, degradation, ``max_new_tokens``;
   the scheduler's counters) must equal the card's, since on this clock
   they depend only on the traffic.  (c) Phase 6's paged store, 24
   requests, continuous leg with ``async_io=True``: swaps and misses must
   equal the ticks times ``pass_counters`` under preemption, the tokens
   must equal per uid those of a resident engine on the same wire-form
   bytes under the same leg (a reference run, whose launches are not
   counted), and ``qmatmul_f32_blockscale`` must have launched.  The
   kernels are checked against their plain versions at every distinct call
   of the continuous legs of (a) and (c) (the short-prompt prefill buckets
   and the decode tiles that the scheduler's budget gives them).  (d) The
   same paged leg on the real clock
   (``time.perf_counter``), printed as a smoke reading: TTFT p50 / p99 by
   stream, tok/s, miss rate, exposed and hidden page wait and
   ``overlap_frac``, the predicted-vs-measured stall ratio; nothing is
   asserted on these times;
8. KV paging and tenancy, the two-tenant leg of
   ``benchmarks/serving_load.py`` (``_tenant_reqs`` copied: prompts of
   2-47 tokens, 8 new tokens each, a third of them on each XR stream) at
   its defaults (4 slots, max_len 128, prefill chunk 16, ``budget_frac``
   0.5, ``shared_budget_frac`` 0.6, KV blocks of 16 rows, ``async_io``).
   (a) Phase 3's 8-bit qwen3-0.6b tree with its cold half
   (``attach_paging``) and its KV cache (``attach_kv_paging(16)``) joined
   to one ``SharedPagePool`` (0.6 of the cold bytes), 24 requests through
   ``Scheduler``: the tokens must equal per uid those of a resident
   unpaged engine (a reference run, not counted); every pool member's
   swaps, misses, pool hits, evictions, drops and wire / raw bytes must
   equal the ``kv_pass_counters`` replay of the pool's event log; the KV
   table's swaps times its page bytes must equal its streamed bytes, and
   ``memsys.kv_stream_bytes`` over the spans its fetch batches listed its
   swaps plus pool hits.  (b) That tree and phase 3's falcon-mamba-7b
   tree, each half-paged, as two tenants of one ``MultiScheduler`` and
   one pool (0.6 of both cold halves), qwen3-0.6b KV-paged, 8 requests a
   tenant: each tenant's tokens must equal its solo run on a private
   pager (reference runs, not counted), the counters the replay, and the
   metrics v9 multi document must pass ``metrics.validate``.  Both legs'
   kernel calls are recorded and each distinct call of ``qmatmul_f32``,
   ``flash_attention`` and ``selective_scan`` is held against its plain
   version; each leg must have launched them.  The pool summaries, the KV
   exposed / hidden seconds and the host wall a tick are printed as smoke
   readings;
9. the MoE family: ``qmatmul_f32_grouped`` (B1 over a stack of experts
   in one launch) against its plain version at qwen2-moe-a2.7b's expert
   shapes (E 60; C 8, 16 and 24; (K, N) (2048, 1408) and (1408, 2048)),
   a ragged C on each route, E = 1 on each, bits 4 and 2, with experts
   that got no rows giving zeros and two calls bit-equal; timed like the
   others (one layer's three expert linears at C 8 and 24) beside the
   plain version and ``torch.bmm`` on pre-dequantised f32 weights.  Then
   qwen2-moe-a2.7b at full width (24 layers, d_model 2048, 60 experts
   top-4 of d_ff 1408, a shared expert of 5632, vocab 151,936) with
   random weights from a seeded CUDA ``torch.Generator``, drawn and frozen
   at 8 bits one layer at a time, served as in phases 3-4 (8 requests;
   the grouped and plain ``qmatmul_f32`` and ``flash_attention`` counters
   set to 0 before and grown after; every distinct call of the profiled
   serve, grouped ones included, against its plain version; the first 2
   layers' logits card vs CPU within ``LOGITS_TOL``);
10. the ``{"serve": ...}`` and ``{"kernels": [...]}`` lines, the card
   line, and as the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core rate
TF32_FLOPS_PER_S = 495e12        # H100 SXM dense TF32 tensor-core rate

QMM_TOL = dict(rtol=1e-4, atol=1e-4)      # f32 accumulate, reordered sums
FLASH_TOL = dict(rtol=3e-5, atol=3e-5)    # the reference kernel test's
SCAN_TOL = dict(rtol=5e-4, atol=5e-4)     # the reference kernel test's
LOGITS_TOL = dict(rtol=1e-3, atol=1e-3)   # 28 f32 layers, card vs CPU order
# falcon-mamba (2 layers) and hymba (4 layers) cut copies: f32 sums in
# another order and the N-state recurrence over 64 (192 with hymba's meta
# tokens) steps, through full-width layers
CUT_LOGITS_TOL = dict(rtol=2e-3, atol=2e-3)
MUFU_PER_S = 16 * 132 * 1.98e9   # H100 SXM exponentials: 16 a clock per SM

MNV2_IMG = 224
MNV2_FRAMES = 16
NEUREKA_KERNELS = ("conv3x3_dense", "conv3x3_dw", "qmatmul_int8")
NEUREKA_PER_FRAME = {"conv3x3_dense": 1, "conv3x3_dw": 17, "qmatmul_int8": 35}
# the jobs timed alone: B4 at its largest map, at a 7 x 7 projection with a
# long K, at conv_last and at fc; B5 at conv0; B6 at its largest stride-2
# map (b1.dw), its largest stride-1 map (b0.dw) and its smallest (b14.dw)
NEUREKA_TIMED = ("b1.pw_exp", "b14.pw_proj", "conv_last", "fc", "conv0",
                 "b1.dw", "b0.dw", "b14.dw")
L2_COLD_BYTES = 64e6             # rotate timing inputs over more than L2

# the serving paths: (arch, max_len, one prompt of 1,000-1,200 tokens so that
# hymba's window of 1,024 binds, depth of the card-vs-CPU copy: None = all)
SERVE_PATHS = (("qwen3-0.6b", 512, False, None),
               ("falcon-mamba-7b", 512, False, 2),
               ("hymba-1.5b", 2048, True, 4))
SERVE_KERNELS = {"dense": ("qmatmul_f32", "flash_attention"),
                 "moe": ("qmatmul_f32", "qmatmul_f32_grouped",
                         "flash_attention"),
                 "ssm": ("qmatmul_f32", "selective_scan"),
                 "hybrid": ("qmatmul_f32", "flash_attention",
                            "selective_scan")}

# (K, N) of each packed linear of a qwen3-0.6b layer
LAYER_LINEARS = {"wq": (1024, 2048), "wk": (1024, 1024), "wv": (1024, 1024),
                 "wo": (2048, 1024), "w_gate": (1024, 3072),
                 "w_up": (1024, 3072), "w_down": (3072, 1024)}
# (K, N) of each packed linear of a falcon-mamba-7b layer: d_model 4,096,
# d_inner 8,192, dt_rank 256, N 16 (x_proj gives dt_rank + 2N)
FALCON_LINEARS = {"in_proj": (4096, 16384), "x_proj": (8192, 288),
                  "dt_proj": (256, 8192), "out_proj": (8192, 4096)}
# the tensor-core kernels of the f32 matmuls: decode, M <= 16
# (csrc/qmm_decode.cuh), and M > 16 (csrc/qmm_tc.cuh); the flash kernel; the
# scan's two routes (csrc/ssm_scan.cu)
TC_KERNELS = ("qmm_dec", "bs_dec", "qmm_tc", "bs_tc", "flash_fwd_tc")
SCAN_KERNELS = ("scan_step", "scan_chunked")
# the depthwise kernel's instantiations (csrc/neureka_conv.cu)
DW_KERNELS = ("dw3x3_vec",)
# the kernels whose SASS must hold their tensor-core op: {function name
# fragment: (library, the op's tokens)}; the int8 MMA kernels
# (csrc/int8_mma.cuh) IMMA, the flash kernel a TF32 HMMA
MMA_OPS = {"qmm_int8_direct": ("qmatmul_int8", ("IMMA",)),
           "qmm_int8_staged": ("qmatmul_int8", ("IMMA",)),
           "dense3x3_mma": ("neureka_conv", ("IMMA",)),
           "flash_fwd_tc": ("flash_attention", ("HMMA", "TF32"))}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls, CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@functools.lru_cache(maxsize=None)
def capture_stream(torch):
    """One side stream for every graph capture: cuBLAS keeps a workspace for
    each stream it has run on, and those would stay allocated while serving."""
    return torch.cuda.Stream()


def graph_ms(torch, fn, n_sets: int, replays: int = 10) -> float:
    """Device time of one ``fn(i)``: the calls for i in range(n_sets) are
    captured once into a CUDA graph and replayed, so the host's launch gaps
    drop out of the measurement."""
    side = capture_stream(torch)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up before capture
        for i in range(n_sets):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_sets):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * n_sets)


def time_versions(torch, kernel, plain, library, n_sets: int,
                  eager_iters: int):
    """Kernel, plain, library, kernel, in turns.  ``ms`` and the other
    device times come from graph replay; ``eager_*`` are the same calls
    enqueued one by one from Python, launch gaps included."""
    fns = (kernel, plain, library, kernel)
    dev = [None if f is None else graph_ms(torch, f, n_sets) for f in fns]
    eager = [None if f is None else cuda_ms(torch, f, eager_iters)
             for f in fns]
    torch.cuda.empty_cache()
    return dict(ms=min(dev[0], dev[3]), ms_runs=[dev[0], dev[3]],
                plain_ms=dev[1], library_ms=dev[2],
                eager_ms=min(eager[0], eager[3]), eager_plain_ms=eager[1],
                eager_library_ms=eager[2])


def bound_ms(nbytes: float, ops: float, rate: float = F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build(build):
    """Build every kernel, print what ptxas reports, and fail if a
    tensor-core, scan or depthwise kernel spills or an MMA kernel's SASS
    lacks its tensor-core op."""
    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] nvcc sm_90a, {time.perf_counter() - t0:.2f} s")
    checked = TC_KERNELS + SCAN_KERNELS + DW_KERNELS + tuple(MMA_OPS)
    spills = []
    for name, report in build.ptxas_reports().items():
        func = None
        for line in report.splitlines():
            if "Compiling entry function" in line:
                func = line.split("'")[1] if "'" in line else line
            if "Compiling entry function" in line or "Used" in line \
                    or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
            spilled = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            if (func is not None and any(k in func for k in checked)
                    and any(int(b) for b in spilled)):
                spills.append(f"{func}: {line.strip()}")
    if spills:
        raise AssertionError("the tensor-core, scan or depthwise kernels "
                             "spill:\n"
                             + "\n".join(spills))
    ops = sass_mma(build)
    print(f"[build] cuobjdump: tensor-core ops in each MMA kernel "
          f"{json.dumps(ops)}")
    for frag, (_, tokens) in MMA_OPS.items():
        mine = {f: c for f, c in ops.items() if frag in f}
        if not mine or not all(mine.values()):
            raise AssertionError(f"{frag}: no {' '.join(tokens)} in its "
                                 f"SASS: {mine}")


def sass_mma(build) -> dict:
    """{MMA kernel function: its count of instructions with all of its
    op's tokens (``MMA_OPS``)} from ``cuobjdump --dump-sass`` of the built
    libraries."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    counts = {}
    for lib in sorted({lib for lib, _ in MMA_OPS.values()}):
        sass = subprocess.run([str(tool), "--dump-sass",
                               str(build.BUILD_DIR / f"{lib}.so")],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        func = tokens = None
        for line in sass.splitlines():
            hit = re.search(r"Function : (\S+)", line)
            if hit:
                func = hit.group(1)
                tokens = next((t for frag, (lb, t) in MMA_OPS.items()
                               if lb == lib and frag in func), None)
                if tokens is None:
                    func = None
                else:
                    counts[func] = 0
            elif func is not None and all(t in line for t in tokens):
                counts[func] += 1
    return counts


def check_qmatmul(torch, ops, ref, qmm, dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    cases = [(bits, m, k, n) for bits in (8, 4, 2) for m in (1, 4, 16, 256)
             for k, n in sorted(set(LAYER_LINEARS.values()))]
    cases += [(bits, m, 1001, 515) for bits in (8, 4, 2) for m in (7, 37)]
    for bits, m, k, n in cases:
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
        packed, scale = ops.prep_linear(w, bits)
        got = qmm.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k)
        expect = ref.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k)
        again = qmm.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k)
        torch.cuda.synchronize()
        err = (got - expect).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(got, expect, **QMM_TOL):
            raise AssertionError(f"qmatmul_f32 bits={bits} M={m} K={k} N={n}:"
                                 f" max abs err {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"qmatmul_f32 bits={bits} M={m} K={k} N={n}:"
                                 " two calls on one input differ")
    print(f"[check] qmatmul_f32: {len(cases)} cases (bits 8/4/2, M "
          f"1/4/16/256 at the layer shapes, ragged K=1001), max abs err "
          f"{worst:.3e}, "
          f"tolerance {QMM_TOL}; each case called twice, bit-equal")
    return worst


FLASH_CASES = [
    # b, hq, hkv, sq, sk, d, window, per-row q_offset (None: sk - sq), causal
    (4, 16, 8, 64, 512, 128, None, (0, 64, 192, 448), True),   # qwen3, timed
    (4, 16, 8, 16, 256, 128, None, (3, 40, 77, 240), True),
    (4, 16, 8, 64, 64, 128, None, None, True),
    (4, 16, 8, 64, 512, 128, 96, (0, 100, 300, 448), True),
    # hymba-1.5b's longest prompt (1,035 tokens + 128 meta tokens, all four
    # rows alike, as the engine pads a group), window 1,024; timed
    (4, 25, 5, 1163, 2048, 64, 1024, (0, 0, 0, 0), True),
    # rows that see no key (the mean of v): Sq > Sk at the default offset
    # (whole blocks and a mixed one), a window past the keys' end, and one
    # row of a block whose kv range spans two slices
    (2, 4, 2, 100, 24, 64, None, None, True),
    (2, 8, 8, 32, 64, 32, 16, (0, 70), True),
    (1, 2, 2, 64, 280, 16, 40, (256,), False),
]
FLASH_TIMED = {"qwen3": 0, "hymba": 4}     # FLASH_CASES rows timed


def flash_inputs(torch, gen, dev, case):
    b, hq, hkv, sq, sk, d, window, offs, causal = case
    q = torch.randn((b, hq, sq, d), generator=gen, device=dev)
    k = torch.randn((b, hkv, sk, d), generator=gen, device=dev)
    v = torch.randn((b, hkv, sk, d), generator=gen, device=dev)
    off = None if offs is None else torch.tensor(offs, dtype=torch.int32,
                                                 device=dev)
    return q, k, v, dict(causal=causal, window=window, q_offset=off)


def check_flash(torch, ref, fa, dev) -> float:
    """Each FLASH_CASES row at its plan against the plain version; the call
    twice, bit-equal."""
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for case in FLASH_CASES:
        q, k, v, kw = flash_inputs(torch, gen, dev, case)
        expect = ref.flash_attention(q, k, v, **kw)
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got - expect).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(got, expect, **FLASH_TOL):
            raise AssertionError(f"flash_attention case {case}: max abs err "
                                 f"{err}")
        if not torch.equal(got, fa.flash_attention(q, k, v, **kw)):
            raise AssertionError(f"flash_attention case {case}: two calls "
                                 "differ")
        del q, k, v, expect, got
    print(f"[check] flash_attention: {len(FLASH_CASES)} cases (GQA 16/8 and "
          f"25/5, per-row q_offset, causal and not, windows, hymba's long "
          f"prompt, rows that see no key), max abs err {worst:.3e}, "
          f"tolerance {FLASH_TOL}; each call twice, bit-equal")
    return worst


def route_bound(res, nbytes: float, flops: float, passes: int):
    """The f32 matmuls and flash attention run on the tensor cores,
    ``passes`` TF32 MMAs for each f32 multiply-add: ``bound_ms`` is that
    route's bound (the bytes bind at decode, the operations at prefill),
    with both figures beside it (``bytes_ms``, ``tf32_ops_ms``) and the f32
    CUDA-core bound in ``bound_f32_ms``."""
    res["tf32_passes"] = passes
    res["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    res["tf32_ops_ms"] = passes * flops / TF32_FLOPS_PER_S * 1e3
    res["bound_f32_ms"], res["bound_f32_by"] = bound_ms(nbytes, flops)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, passes * flops,
                                                TF32_FLOPS_PER_S)


def time_qmatmul(torch, packing, ops, ref, qmm, dev, m: int,
                 bits: int = 8, copies: int = 8, linears=LAYER_LINEARS,
                 what: str = "qmatmul_f32 layer x7"):
    """One layer's packed linears (qwen3-0.6b's seven by default) at M rows,
    over ``copies`` layer copies (8 x 15.7 MB of 8-bit qwen3 weights, or
    2 x 105 MB of falcon-mamba's, > the 50 MB L2)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    layers = []
    for _ in range(copies):
        layer = []
        for k, n in linears.values():
            w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
            packed, scale = ops.prep_linear(w, bits)
            x = torch.randn((m, k), generator=gen, device=dev)
            deq = packing.unpack(packed, bits, k).float() * scale[:, None]
            layer.append((x, packed, scale, k, deq))
        layers.append(layer)

    def kernel(i):
        for x, p, s, k, _ in layers[i % copies]:
            qmm.qmatmul_f32(x, p, s, bits=bits, k_orig=k)

    def plain(i):
        for x, p, s, k, _ in layers[i % copies]:
            ref.qmatmul_f32(x, p, s, bits=bits, k_orig=k)

    def library(i):
        for x, _, _, _, deq in layers[i % copies]:
            torch.matmul(x, deq.T)

    res = time_versions(torch, kernel, plain, library, copies, 40)
    nbytes = sum(m * k * 4 + p.numel() + s.numel() * 4 + m * n * 4
                 for (x, p, s, k, _), (_, n) in zip(layers[0],
                                                    linears.values()))
    flops = sum(2 * m * n * k for k, n in linears.values())
    route_bound(res, nbytes, flops, 2)
    res["work"] = f"{what} {list(linears)}, M={m}, {bits}-bit"
    print_times(f"{what} M={m} bits={bits}",
                "torch.matmul on pre-dequantised f32", res, nbytes, flops)
    return res


def check_blockscale(torch, ref, qmm, dev, linears) -> float:
    """qmatmul_f32_blockscale against its plain version: the reference
    kernel test's shapes (bits 8 at K = 70, bits 4 at K = 69), bits 2, a
    ragged K = 1,001, and the paged serve's cold linears at decode and
    prefill M."""
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = [(8, 4, 70, 9), (4, 4, 69, 9), (2, 4, 70, 9), (2, 4, 69, 9)]
    cases += [(bits, m, 1001, 515) for bits in (8, 4, 2) for m in (7, 37)]
    cases += [(8, m, k, n) for m in (1, 4, 16, 256) for k, n in linears]
    worst = 0.0
    for bits, m, k, n in cases:
        packed, scales = wire_weight(torch, gen, dev, n, k, bits)
        x = torch.randn((m, k), generator=gen, device=dev)
        got = qmm.qmatmul_f32_blockscale(x, packed, scales, bits=bits,
                                         k_orig=k)
        expect = ref.qmatmul_f32_blockscale(x, packed, scales, bits=bits,
                                            k_orig=k)
        again = qmm.qmatmul_f32_blockscale(x, packed, scales, bits=bits,
                                           k_orig=k)
        torch.cuda.synchronize()
        err = (got - expect).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(got, expect, **QMM_TOL):
            raise AssertionError(f"qmatmul_f32_blockscale bits={bits} M={m} "
                                 f"K={k} N={n}: max abs err {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"qmatmul_f32_blockscale bits={bits} M={m} "
                                 f"K={k} N={n}: two calls on one input differ")
    print(f"[check] qmatmul_f32_blockscale: {len(cases)} cases (the "
          f"reference test's bits 8 / K 70 and bits 4 / K 69, bits 2, ragged "
          f"K=1001 at bits 8/4/2, the cold linears {linears} at M "
          f"1/4/16/256), "
          f"max abs err {worst:.3e}, tolerance {QMM_TOL}; each case called "
          "twice, bit-equal")
    return worst


def time_blockscale(torch, packing, ref, qmm, dev, m: int, linears,
                    copies: int = 8):
    """One layer's cold linears in wire form (int8 levels, per-32 scales) at
    M rows, over ``copies`` layer copies (8 x 9.4 MB > the 50 MB L2)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    layers = []
    for _ in range(copies):
        layer = []
        for k, n in linears:
            packed, scales = wire_weight(torch, gen, dev, n, k, 8)
            x = torch.randn((m, k), generator=gen, device=dev)
            deq = (packing.unpack(packed, 8, k).float().reshape(n, -1, 32)
                   * scales[:, :, None]).reshape(n, k)
            layer.append((x, packed, scales, k, deq))
        layers.append(layer)

    def kernel(i):
        for x, p, s, k, _ in layers[i % copies]:
            qmm.qmatmul_f32_blockscale(x, p, s, bits=8, k_orig=k)

    def plain(i):
        for x, p, s, k, _ in layers[i % copies]:
            ref.qmatmul_f32_blockscale(x, p, s, bits=8, k_orig=k)

    def library(i):
        for x, _, _, _, deq in layers[i % copies]:
            torch.matmul(x, deq.T)

    res = time_versions(torch, kernel, plain, library, copies, 40)
    nbytes = sum(m * k * 4 + p.numel() + s.numel() * 4 + m * n * 4
                 for (x, p, s, k, _), (_, n) in zip(layers[0], linears))
    flops = sum(2 * m * n * k for k, n in linears)
    route_bound(res, nbytes, flops, 2)
    res["work"] = (f"one layer's {len(linears)} cold linears {linears}, "
                   f"M={m}, int8 wire form")
    print_times(f"qmatmul_f32_blockscale {res['work']}",
                "torch.matmul on pre-dequantised f32", res, nbytes, flops)
    return res


def flash_work(case):
    """(bytes, flops) that one call needs with this case's data: q read and
    the output written once, each kv head's keys that its batch row's
    queries can see read once, 4 D flops a visible (query, key) pair."""
    b, hq, hkv, sq, sk, d, window, offs, causal = case
    offs = offs if offs is not None else (sk - sq,) * b
    nbytes, pairs = 2 * b * hq * sq * d * 4 + b * 4, 0
    for o in offs:
        lo_all, hi_all = sk, 0
        for i in range(sq):
            hi = min(sk, o + i + 1) if causal else sk
            lo = max(0, o + i - window + 1) if window else 0
            if hi > lo:
                pairs += hq * (hi - lo)
                lo_all, hi_all = min(lo_all, lo), max(hi_all, hi)
        nbytes += 2 * hkv * max(0, hi_all - lo_all) * d * 4
    return nbytes, 4 * d * pairs


def time_flash(torch, F, ref, fa, dev, which: str = "qwen3",
               copies: int = 4):
    """A timed FLASH_CASES row (qwen3-0.6b's prefill chunk: 4 rows x 16/8
    heads, 64 queries over a 512-row kv span at per-row offsets; hymba-
    1.5b's longest prompt: 4 rows x 25/5 heads, 1,163 queries, window
    1,024) on ``copies`` input sets in turn (more than the 50 MB L2).  The
    library call is ``F.scaled_dot_product_attention`` with the same
    boolean mask, on k and v expanded to Hq heads outside the timing."""
    case = FLASH_CASES[FLASH_TIMED[which]]
    b, hq, hkv, sq, sk, d, window, offs, causal = case
    gen = torch.Generator(device=dev).manual_seed(4)
    sets = []
    for _ in range(copies):
        q, k, v, kw = flash_inputs(torch, gen, dev, case)
        # the library call takes equal head counts: expand outside timing
        ke = k.repeat_interleave(hq // hkv, dim=1)
        ve = v.repeat_interleave(hq // hkv, dim=1)
        sets.append((q, k, v, ke, ve))
    off = kw["q_offset"]
    qpos = off[:, None] + torch.arange(sq, device=dev)
    kpos = torch.arange(sk, device=dev)[None, None]
    mask = torch.ones((b, sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos[..., None]
    if window:
        mask &= kpos > qpos[..., None] - window

    def kernel(i):
        q, k, v, _, _ = sets[i % copies]
        fa.flash_attention(q, k, v, **kw)

    def plain(i):
        q, k, v, _, _ = sets[i % copies]
        ref.flash_attention(q, k, v, **kw)

    def library(i):
        q, _, _, ke, ve = sets[i % copies]
        F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask[:, None])

    res = time_versions(torch, kernel, plain, library, copies, 20)
    nbytes, flops = flash_work(case)
    route_bound(res, nbytes, flops, 3)
    res["work"] = (f"{which}: B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} D={d} "
                   f"window={window} offsets={offs}")
    print_times(f"flash_attention {res['work']}",
                "F.scaled_dot_product_attention, same mask", res, nbytes,
                flops)
    return res


def print_times(what: str, library: str, res, nbytes: int, flops: int,
                ops: str = "flop"):
    def ms(key):
        return "none" if res[key] is None else f"{res[key]:.4f}"
    passes = res.get("tf32_passes")
    f32 = (f" (bytes {res['bytes_ms']:.4f}, {passes} x TF32 operations "
           f"{res['tf32_ops_ms']:.4f}); f32 CUDA-core bound "
           f"{res['bound_f32_ms']:.4f} ({res['bound_f32_by']})"
           if "bound_f32_ms" in res else "")
    route = f" at the {passes} x TF32 route" if f32 else ""
    print(f"[time] {what}: device (graph replay) kernel_ms "
          f"{res['ms_runs'][0]:.4f}/{res['ms_runs'][1]:.4f} plain_ms "
          f"{res['plain_ms']:.4f} library_ms ({library}) "
          f"{ms('library_ms')}; eager kernel_ms {res['eager_ms']:.4f} "
          f"plain_ms {res['eager_plain_ms']:.4f} library_ms "
          f"{ms('eager_library_ms')}; bound_ms{route} "
          f"{res['bound_ms']:.4f} ({res['bound_by']}; {nbytes} B, {flops} "
          f"{ops}){f32}")


# bsz, S, Di, N, with h0: the falcon-mamba prefill chunk and decode step at
# 4 slots, a ragged S, a hymba prefill and decode, and N = 4, 8 and 32 at a
# ragged Di; check_scan adds S on each side of the route threshold
SCAN_CASES = [(4, 64, 8192, 16, True), (4, 64, 8192, 16, False),
              (4, 1, 8192, 16, True), (4, 1, 8192, 16, False),
              (4, 37, 8192, 16, True), (4, 157, 3200, 16, True),
              (4, 1, 3200, 16, True), (3, 37, 1001, 4, True),
              (3, 37, 1001, 8, False), (3, 37, 1001, 32, True),
              (2, 1, 1001, 4, True), (2, 1, 1001, 32, False)]
# the scan shapes timed: falcon-mamba-7b's prefill chunk and decode step,
# hymba-1.5b's longest prompt and decode step, 4 slots each
SCAN_TIMED = {"falcon_prefill": (4, 64, 8192), "falcon_decode": (4, 1, 8192),
              "hymba_prefill": (4, 1163, 3200), "hymba_decode": (4, 1, 3200)}


def scan_inputs(torch, gen, dev, bsz, s, di, n, h0):
    """The reference kernel test's distributions (test_ssm_kernel.py)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
    return (randn(bsz, s, di), uniform(0.001, 0.1, bsz, s, di),
            -uniform(0.5, 2.0, di, n), randn(bsz, s, n), randn(bsz, s, n),
            randn(di), randn(bsz, di, n) if h0 else None)


def check_scan(torch, ref, ssm, dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(8)
    worst = 0.0
    edge = ssm.STEP_MAX_S
    cases = SCAN_CASES + [(4, s, 8192, 16, True) for s in (edge, edge + 1)]
    for case in cases:
        args = scan_inputs(torch, gen, dev, *case)
        (y, h), (y_ref, h_ref) = ssm.selective_scan(*args), \
            ref.selective_scan(*args)
        torch.cuda.synchronize()
        err = max((y - y_ref).abs().max().item(),
                  (h - h_ref).abs().max().item())
        worst = max(worst, err)
        if not (torch.allclose(y, y_ref, **SCAN_TOL)
                and torch.allclose(h, h_ref, **SCAN_TOL)):
            raise AssertionError(f"selective_scan {case} "
                                 f"{ssm.scan_plan(case[1], case[3])}: max "
                                 f"abs err {err}")
    # pads (dt = 0) are exact no-ops at each route: h_last after [real,
    # pads] equals h_last after the real tokens alone (h0 after none)
    routes = set()
    for s_all, real in ((64, 37), (edge + 1, edge), (edge, 0)):
        x, dt, A, B, C, D, h0 = scan_inputs(torch, gen, dev, 4, s_all, 8192,
                                            16, True)
        dt_pad = dt.clone()
        dt_pad[:, real:] = 0
        _, h_pad = ssm.selective_scan(x, dt_pad, A, B, C, D, h0)
        h_real = h0 if real == 0 else ssm.selective_scan(
            x[:, :real].contiguous(), dt[:, :real].contiguous(), A,
            B[:, :real], C[:, :real], D, h0)[1]
        torch.cuda.synchronize()
        if not torch.equal(h_pad, h_real):
            raise AssertionError(f"selective_scan: dt = 0 pads changed "
                                 f"h_last (S={s_all}, {real} real steps)")
        routes.add(ssm.scan_plan(s_all, 16).route)
    if routes != {"step", "chunked"}:
        raise AssertionError(f"pads checked on routes {routes} only")
    print(f"[check] selective_scan: {len(cases)} cases (falcon-mamba "
          f"prefill 4x64x8192 and decode 4x1x8192 with and without h0, "
          f"ragged S=37, hymba 4x157x3200 and 4x1x3200, N 4/8/32 at Di "
          f"1001, S {edge} and {edge + 1} on each side of the route "
          f"threshold), max abs err {worst:.3e}, tolerance {SCAN_TOL}; dt=0 "
          f"pads leave h_last equal (torch.equal) on both routes")
    return worst


def time_scan(torch, ref, ssm, dev, which: str, n: int = 16):
    """One layer's scan at a SCAN_TIMED shape, from h0, inputs rotated over
    more than 50 MB.  No PyTorch call computes a selective scan, so there
    is no library time."""
    bsz, s, di = SCAN_TIMED[which]
    gen = torch.Generator(device=dev).manual_seed(9)
    nbytes = 4 * (3 * bsz * s * di + 2 * bsz * s * n + di * n + di
                  + 2 * bsz * di * n)
    copies = int(max(2, -(-L2_COLD_BYTES // nbytes)))
    sets = [scan_inputs(torch, gen, dev, bsz, s, di, n, True)
            for _ in range(copies)]
    res = time_versions(torch, lambda i: ssm.selective_scan(*sets[i % copies]),
                        lambda i: ref.selective_scan(*sets[i % copies]),
                        None, copies, 20)
    exps = bsz * s * di * n
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, exps, MUFU_PER_S)
    res["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    res["exp_ms"] = exps / MUFU_PER_S * 1e3
    res["route"] = ssm.scan_plan(s, n).route
    res["work"] = f"{which}: Bz={bsz} S={s} Di={di} N={n}, from h0"
    print_times(f"selective_scan {res['work']} ({res['route']} route)",
                "none: no single PyTorch call computes a selective scan",
                res, nbytes, exps, "exp")
    return res


class _Recorder:
    """Stands in for one kernel module as ``kernels/ops.py`` sees it: each
    wrapper named in ``fns`` is the recording function given for it, every
    other attribute the module's own."""

    def __init__(self, module, fns):
        self._module, self._fns = module, fns

    def __getattr__(self, attr):
        return self._fns.get(attr) or getattr(self._module, attr)


@contextlib.contextmanager
def recording(torch, ops):
    """Notes each call that the model code makes to the LM kernel wrappers
    while the block runs.  The model code reaches every kernel through
    ``kernels/ops.py``, which calls each wrapper through its kernel module;
    those module references are put behind recorders that call the wrapper
    unchanged (so its launch count moves as usual) and are restored after.
    Yields {kernel name: [call key, ...]}; per-row query offsets are kept as
    device tensors until the block ends, so nothing syncs."""
    calls = {"qmatmul_f32": [], "qmatmul_f32_grouped": [],
             "qmatmul_f32_blockscale": [], "flash_attention": [],
             "selective_scan": []}
    qmm, fa, ssm = ops._qmm, ops._fa, ops._ssm

    def rec_qmm(x, packed, scale, *, bits, k_orig):
        calls["qmatmul_f32"].append((x.shape[0], k_orig, packed.shape[0],
                                     bits, x.dtype))
        return qmm.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k_orig)

    def rec_grouped(x, packed, scale, *, bits, k_orig):
        calls["qmatmul_f32_grouped"].append((x.shape[0], x.shape[1], k_orig,
                                             packed.shape[1], bits, x.dtype))
        return qmm.qmatmul_f32_grouped(x, packed, scale, bits=bits,
                                       k_orig=k_orig)

    def rec_bs(x, packed, scales, *, bits, k_orig, block=32):
        calls["qmatmul_f32_blockscale"].append((x.shape[0], k_orig,
                                                packed.shape[0], bits))
        return qmm.qmatmul_f32_blockscale(x, packed, scales, bits=bits,
                                          k_orig=k_orig, block=block)

    def rec_fa(q, k, v, **kw):
        off = kw.get("q_offset")
        calls["flash_attention"].append((
            tuple(q.shape), tuple(k.shape), kw.get("causal", True),
            kw.get("scale"), kw.get("window"),
            off.clone() if isinstance(off, torch.Tensor) else off))
        return fa.flash_attention(q, k, v, **kw)

    def rec_scan(x, dt, A, B, C, D, h0=None, *, h_out=None):
        calls["selective_scan"].append((
            tuple(x.shape), A.shape[1], h0 is not None,
            h_out is not None and h_out is h0))
        return ssm.selective_scan(x, dt, A, B, C, D, h0, h_out=h_out)

    ops._qmm = _Recorder(qmm, {"qmatmul_f32": rec_qmm,
                               "qmatmul_f32_grouped": rec_grouped,
                               "qmatmul_f32_blockscale": rec_bs})
    ops._fa = _Recorder(fa, {"flash_attention": rec_fa})
    ops._ssm = _Recorder(ssm, {"selective_scan": rec_scan})
    try:
        yield calls
    finally:
        ops._qmm, ops._fa, ops._ssm = qmm, fa, ssm
    calls["flash_attention"] = [
        key[:5] + (tuple(key[5].reshape(-1).tolist())
                   if isinstance(key[5], torch.Tensor) else key[5],)
        for key in calls["flash_attention"]]
    for name in calls:
        calls[name] = list(dict.fromkeys(calls[name]))


def wire_weight(torch, gen, dev, n: int, k: int, bits: int):
    """(packed, scales) of a random (n, k) weight at the model's init scale
    in the page codec's wire form: levels packed at ``bits`` and one f32
    scale per 32 weights of a row (the codec runs on the host)."""
    from repro_torch.core import packing, quantize

    w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
    levels, scales = quantize.quantize_blockwise(w.cpu().numpy(), bits)
    packed = packing.pack(torch.from_numpy(levels), bits)
    return packed.to(dev), torch.from_numpy(scales).to(dev)


def expert_weights(torch, ops, gen, dev, e: int, k: int, n: int, bits: int):
    """(packed (E, N, Kp), scale (E, N)) of E random (n, k) expert weights
    at the model's init scale, frozen as ``freeze_for_serving`` does."""
    w = torch.randn((e * n, k), generator=gen, device=dev) * k ** -0.5
    packed, scale = ops.prep_linear(w, bits)
    return packed.reshape(e, n, -1), scale.reshape(e, n)


def check_path(torch, ops, ref, qmm, fa, ssm, dev, arch: str, calls):
    """Each LM kernel against its plain version at every distinct call of
    one serve (``recording``), on random inputs with the distributions the
    other checks use; the tolerances are theirs.  A scan call that wrote
    h_last over h0 is also repeated so, and must equal the fresh output."""
    gen = torch.Generator(device=dev).manual_seed(10)
    worst = dict.fromkeys(calls, 0.0)

    def hold(name, got, expect, tol, what):
        torch.cuda.synchronize()
        err = (got - expect).abs().max().item() if got.numel() else 0.0
        worst[name] = max(worst[name], err)
        if not torch.allclose(got, expect, **tol):
            raise AssertionError(f"{arch} {name} {what}: max abs err {err}")

    weights = {}
    for m, k, n, bits, dtype in calls["qmatmul_f32"]:
        if (k, n, bits) not in weights:
            w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
            weights[k, n, bits] = ops.prep_linear(w, bits)
            del w
        packed, scale = weights[k, n, bits]
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        hold("qmatmul_f32",
             qmm.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k),
             ref.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k),
             QMM_TOL, f"M={m} K={k} N={n} bits={bits}")
    del weights
    for e, c, k, n, bits, dtype in calls.get("qmatmul_f32_grouped", ()):
        packed, scale = expert_weights(torch, ops, gen, dev, e, k, n, bits)
        x = torch.randn((e, c, k), generator=gen, device=dev).to(dtype)
        got = qmm.qmatmul_f32_grouped(x, packed, scale, bits=bits, k_orig=k)
        hold("qmatmul_f32_grouped", got,
             ref.qmatmul_f32_grouped(x, packed, scale, bits=bits, k_orig=k),
             QMM_TOL, f"E={e} C={c} K={k} N={n} bits={bits}")
        del packed, scale, x, got
    wires = {}
    for m, k, n, bits in calls["qmatmul_f32_blockscale"]:
        if (k, n, bits) not in wires:
            wires[k, n, bits] = wire_weight(torch, gen, dev, n, k, bits)
        packed, scales = wires[k, n, bits]
        x = torch.randn((m, k), generator=gen, device=dev)
        hold("qmatmul_f32_blockscale",
             qmm.qmatmul_f32_blockscale(x, packed, scales, bits=bits,
                                        k_orig=k),
             ref.qmatmul_f32_blockscale(x, packed, scales, bits=bits,
                                        k_orig=k),
             QMM_TOL, f"M={m} K={k} N={n} bits={bits}")
    del wires
    for qs, ks, causal, scale, window, offs in calls["flash_attention"]:
        q = torch.randn(qs, generator=gen, device=dev)
        k = torch.randn(ks, generator=gen, device=dev)
        v = torch.randn(ks, generator=gen, device=dev)
        off = (torch.tensor(offs, dtype=torch.int32, device=dev)
               if isinstance(offs, tuple) else offs)
        kw = dict(causal=causal, scale=scale, window=window, q_offset=off)
        hold("flash_attention", fa.flash_attention(q, k, v, **kw),
             ref.flash_attention(q, k, v, **kw), FLASH_TOL,
             f"q {qs} k {ks} window {window} q_offset {offs}")
    for (bsz, s, di), n, has_h0, in_place in calls["selective_scan"]:
        args = scan_inputs(torch, gen, dev, bsz, s, di, n, has_h0)
        y, h = ssm.selective_scan(*args)
        y_ref, h_ref = ref.selective_scan(*args)
        what = f"({bsz}, {s}, {di}) N={n} h0={has_h0}"
        hold("selective_scan", y, y_ref, SCAN_TOL, what + " y")
        hold("selective_scan", h, h_ref, SCAN_TOL, what + " h_last")
        if in_place:
            cache = args[-1].clone()
            y_ip, h_ip = ssm.selective_scan(*args[:-1], cache, h_out=cache)
            torch.cuda.synchronize()
            if not (torch.equal(y_ip, y) and torch.equal(h_ip, h)):
                raise AssertionError(f"{arch} selective_scan {what}: h_last "
                                     "written over h0 differs")
    torch.cuda.empty_cache()

    def span(vals):
        return f"{min(vals)}-{max(vals)}" if vals else "-"
    qc, gc_, bc, fc, sc = (calls.get(k, []) for k in (
        "qmatmul_f32", "qmatmul_f32_grouped", "qmatmul_f32_blockscale",
        "flash_attention", "selective_scan"))
    print(f"[check] {arch} path, kernels vs plain at each distinct call of "
          f"the serve: qmatmul_f32 {len(qc)} (M {span([c[0] for c in qc])}, "
          f"(K, N) {sorted({c[1:3] for c in qc})}), qmatmul_f32_grouped "
          f"{len(gc_)} ((E, C) {sorted({c[:2] for c in gc_})}, (K, N) "
          f"{sorted({c[2:4] for c in gc_})}), qmatmul_f32_blockscale "
          f"{len(bc)} (M {span([c[0] for c in bc])}, (K, N) "
          f"{sorted({c[1:3] for c in bc})}), flash_attention "
          f"{len(fc)} (q {sorted({c[0] for c in fc})}, k "
          f"{sorted({c[1] for c in fc})}, windows "
          f"{sorted({c[4] for c in fc if c[4] is not None})}), "
          f"selective_scan {len(sc)} ((Bz, S, Di) "
          f"{sorted({c[0] for c in sc})}, {sum(c[3] for c in sc)} written "
          f"over h0); max abs err {json.dumps(worst)}")
    return dict(cases={k: len(v) for k, v in calls.items()},
                max_abs_err=worst)


# the wrappers that also split their launches, with the attribute that
# holds the split: flash attention by (Sq, Sk), the scan by route
SPLIT_LAUNCHES = {"flash_attention": "launches_by_shape",
                  "selective_scan": "launches_by_route"}


def zero_launches(counters):
    """Sets each wrapper's launch count, and its split of them, to 0."""
    for name, fn in counters.items():
        fn.launches = 0
        if name in SPLIT_LAUNCHES:
            getattr(fn, SPLIT_LAUNCHES[name]).clear()


def read_launches(counters):
    """({wrapper: launches}, {wrapper: its split of them}); fails if a
    split does not add up to its wrapper's count."""
    launches = {name: fn.launches for name, fn in counters.items()}
    split = {name: dict(getattr(counters[name], attr))
             for name, attr in SPLIT_LAUNCHES.items() if name in counters}
    for name, by in split.items():
        if sum(by.values()) != launches[name]:
            raise AssertionError(f"{name}: launches split as {by} add up to "
                                 f"{sum(by.values())}, not {launches[name]}")
    return launches, split


def serve_lm(torch, m, cfg, max_len: int, long_prompt: bool, counters,
             depth, dev, make_tree=None, logits_tol=None):
    """Serve 8 greedy requests (prompts of 16-256 tokens, one of 1,000-1,200
    with ``long_prompt``; 16 new tokens each) on full-width ``cfg`` with
    random weights from a CUDA generator seeded 0, frozen at 8 bits (or the
    packed tree ``make_tree()`` builds); the family's kernels must launch.
    Then ``forward`` logits of 64 tokens on the card against the CPU's plain
    path, on the first ``depth`` layers (all with None), within
    ``logits_tol`` (default: LOGITS_TOL for all layers, CUT_LOGITS_TOL for
    a cut copy).  Returns the serve's readings and the packed tree."""
    np, tfm = m["np"], m["tfm"]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    if make_tree is not None:
        packed = make_tree()
    else:
        params = tfm.init_params(cfg, generator=torch.Generator(
            device=dev).manual_seed(0))
        packed = m["freeze"](params, bits=8)
        del params
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    n_packed = sum(t.numel() * t.element_size() for t in leaves(packed))
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model},"
          f" vocab {cfg.vocab_size}; init + freeze (8-bit) "
          f"{time.perf_counter() - t0:.2f} s, {n_packed / 2**30:.3f} GiB "
          f"frozen, peak {init_peak / 2**30:.3f} GiB")
    eng = m["ServingEngine"](cfg, packed, batch_slots=4, max_len=max_len)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 257, 8)
    if long_prompt:
        lens[-1] = rng.integers(1000, 1201)
    if cfg.family == "ssm" and lens.max() <= eng.prefill_chunk:
        raise AssertionError("no prompt spans two prefill chunks")
    reqs = [m["Request"](uid=i, prompt=rng.integers(0, cfg.vocab_size, int(n))
                         .astype(np.int32), max_new_tokens=16)
            for i, n in enumerate(lens)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_launches(counters)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done, ticks = [], 0
    while eng.pending:
        done += eng.step()
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_class = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    ttft = [r.first_token_s - r.arrival_s for r in done]
    if len(done) != 8 or any(len(r.generated) != 16 for r in done):
        raise AssertionError("not every request got its 16 tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("token id out of the vocabulary")
    for name in SERVE_KERNELS[cfg.family]:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched while serving "
                                 f"{cfg.name}")
    print(f"[serve] {cfg.name}: {len(done)} requests, prompts "
          f"{lens.tolist()} ({int(lens.sum())} prompt tokens), "
          f"{sum(len(r.generated) for r in done)} new tokens, wall "
          f"{wall:.3f} s after synchronize ({ticks} ticks, "
          f"{wall / ticks * 1e3:.1f} ms a tick, "
          f"{sum(len(r.generated) for r in done) / wall:.2f} new tok/s), "
          f"TTFT mean {np.mean(ttft):.3f} s "
          f"max {np.max(ttft):.3f} s, peak memory {peak / 2**30:.3f} GiB "
          f"({base / 2**30:.3f} GiB allocated at the start), "
          f"launches {launches}, by flash shape and scan route "
          f"{json.dumps(by_class)}")
    del eng
    # the same requests again on a fresh engine, under the profiler, with
    # the kernel calls noted; then each kernel at each of those calls
    with recording(torch, m["ops"]) as calls:
        profile = profile_serve(torch, cfg, lambda: m["ServingEngine"](
            cfg, packed, batch_slots=4, max_len=max_len), [
                m["Request"](uid=r.uid, prompt=r.prompt, max_new_tokens=16)
                for r in reqs])
    path_check = check_path(torch, m["ops"], m["ref"], m["qmm"], m["fa"],
                            m["ssm"], dev, cfg.name, calls)

    # card vs CPU logits with the same packed weights: 64 tokens, and with
    # a long prompt that prompt too (hymba's window binds there)
    fcfg, tree = cfg, packed
    if depth is not None:
        fcfg = cfg.replace(n_layers=depth)
        tree = dict(packed, layers=first_layers(packed["layers"], depth))
    tree_cpu = to_device(torch, tree, "cpu")
    seqs = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64)))]
    if long_prompt:
        seqs.append(torch.from_numpy(reqs[-1].prompt[None].astype(np.int64)))
    tol = logits_tol or (LOGITS_TOL if depth is None else CUT_LOGITS_TOL)
    errs = []
    for toks in seqs:
        gpu_logits = tfm.forward(tree, toks.to(dev), fcfg).cpu()
        cpu_logits = tfm.forward(tree_cpu, toks, fcfg)
        err = (gpu_logits - cpu_logits).abs().max().item()
        top1 = (gpu_logits.argmax(-1) == cpu_logits.argmax(-1)).float().mean()
        positions = cfg.n_meta_tokens + toks.shape[1]
        if not (torch.isfinite(gpu_logits).all() and gpu_logits.shape
                == (1, positions, cfg.vocab_size)):
            raise AssertionError(f"{cfg.name}: card logits are not finite or "
                                 "misshapen")
        if not torch.allclose(gpu_logits, cpu_logits, **tol):
            raise AssertionError(f"{cfg.name} card vs CPU logits, "
                                 f"{toks.shape[1]} tokens: max abs err {err}")
        windows = tfm.layer_windows(fcfg)
        print(f"[forward] {cfg.name} ({fcfg.n_layers} of {cfg.n_layers} "
              f"layers, windows {windows}) {toks.shape[1]} tokens "
              f"({positions} positions) card vs CPU: max abs err {err:.3e} "
              f"(tolerance {tol}), top-1 agreement {top1.item():.4f}, max "
              f"|logit| {cpu_logits.abs().max().item():.3f}")
        errs.append(err)
        del gpu_logits, cpu_logits
    return dict(launches=launches, launches_by_class=by_class,
        wall_s=wall, ticks=ticks, ttft_mean_s=float(np.mean(ttft)), ttft_max_s=float(np.max(ttft)), peak_gib=peak / 2**30,
        prompt_tokens=int(lens.sum()), logits_max_abs_err=max(errs),
        path_check=path_check, profile=profile), packed


# the paged path: qwen3-0.6b frozen at 4 bits, half the store's bytes pinned
# on the card, the cold half int8-paged and served from its wire form
# (benchmarks/serving_load.py --wire-serve at budget_frac 0.5)
PAGED_ARCH = "qwen3-0.6b"
PAGED_KERNELS = ("qmatmul_f32", "qmatmul_f32_blockscale", "flash_attention")
PAGED_FAULTS = dict(seed=3, fail_rate=0.2, bitflip_rate=0.2)


def serve_paged(torch, m, cfg, dev):
    """Serve the 8 greedy requests of ``serve_lm`` from a paged 4-bit store
    with wire-serve on; check the counters, the tokens against a resident
    engine on the same wire-form bytes, the same serve under faults, an
    overlapped pass against a sync one, and card vs CPU logits of the wire
    tree; time B3 and split the paged tick into CRC, copy and compute.
    Returns the readings, B3's error and times, and the paged store (the
    tree with its cold leaves on the host, the plan) with the resident
    wire-form tree and plan, for phase 7."""
    np, tfm, pl, pg = m["np"], m["tfm"], m["placement"], m["paging"]
    qmm, fa = m["qmm"], m["fa"]
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0))
    packed = m["freeze"](params, bits=4)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sizes = pl.packed_sizes(packed)
    plan = pl.plan_for_budget(
        sizes, sum(sizes.values()) // 2, sizes_bits=4,
        hot=pl.Placement("l1mram", 4, "resident"),
        cold=pl.Placement("l1mram", 4, "paged", 8))
    hot, cold = plan.split_names(sorted(sizes))
    linears = [LAYER_LINEARS[n.split("/")[-1]] for n in cold]
    print(f"[paged] {cfg.name}: init + freeze (4-bit) "
          f"{time.perf_counter() - t0:.2f} s; store {sum(sizes.values())} B, "
          f"budget {sum(sizes.values()) // 2} B; pinned {hot} "
          f"({plan.resident_bytes(sizes)} B), cold int8-paged {cold} "
          f"({plan.paged_bytes(sizes)} B at 4 bits)")
    bs_err = check_blockscale(torch, m["ref"], qmm, dev, linears)
    t_bs = {"decode": time_blockscale(torch, m["packing"], m["ref"], qmm,
                                      dev, 4, linears),
            "prefill": time_blockscale(torch, m["packing"], m["ref"], qmm,
                                       dev, 256, linears)}
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)          # serve_lm's requests
    lens = rng.integers(16, 257, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]

    def requests():
        return [m["Request"](uid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]

    def engine(faults=None):
        eng = m["ServingEngine"](cfg, packed, batch_slots=4, max_len=512,
                                 plan=plan)
        eng.attach_paging(wire_serve=True, faults=faults)
        return eng

    def serve(eng):
        for r in requests():
            eng.submit(r)
        ticks = []
        while eng.pending:
            t = time.perf_counter()
            eng.step()
            ticks.append((time.perf_counter() - t, eng.last_stall_s))
        torch.cuda.synchronize()
        done = eng.finished
        if len(done) != 8 or any(len(r.generated) != 16 for r in done):
            raise AssertionError("not every request got its 16 tokens")
        if any(not 0 <= t < cfg.vocab_size for r in done
               for t in r.generated):
            raise AssertionError("token id out of the vocabulary")
        return {r.uid: r.generated for r in done}, ticks, done

    t0 = time.perf_counter()
    eng = m["ServingEngine"](cfg, packed, batch_slots=4, max_len=512,
                             plan=plan)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng.attach_paging(wire_serve=True)
    attach_s = time.perf_counter() - t0
    pager = eng.pager
    # the caller's cold leaves go to the host too: from here on the card
    # holds the pinned half of the store and nothing of the cold half, so
    # the device memory falls by the cold groups' bytes
    on_card = pg.packed_tree_store(packed, plan).params
    cold_tensors = [t for n in cold
                    for t in (on_card[n].packed, on_card[n].scale)]
    want = sum(t.numel() * t.element_size() for t in cold_tensors)
    packed = pg.thread_packed(packed, {
        n: m["PackedParam"](packed=on_card[n].packed.cpu(),
                            scale=on_card[n].scale.cpu(), bits=4,
                            orig_shape=on_card[n].orig_shape)
        for n in cold})
    del on_card, cold_tensors
    gc.collect()
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated()
    # the allocator rounds a block up by less than 1 MiB + 512 B
    if not want <= freed <= want + len(cold) * 2 * (2**20 + 512):
        raise AssertionError(f"attach_paging and the release of the cold "
                             f"leaves freed {freed} B of device memory, "
                             f"want {want} B (the cold groups' packed "
                             f"and scale bytes)")
    print(f"[paged] device memory fell by {freed} B after attach_paging and "
          f"the release of the caller's cold leaves (cold packed + scale "
          f"{want} B; plan.paged_bytes {plan.paged_bytes(sizes)} B)")
    n_pages = len(pager.pages)
    wire_pass = sum(p.wire_nbytes for p in pager.pages)
    print(f"[paged] attach_paging(wire_serve=True) {attach_s:.2f} s (host "
          f"encode, pin, CRC); {n_pages} pages "
          f"{[list(p.param_names) for p in pager.pages]}, {wire_pass} wire B "
          f"a pass ({sum(p.nbytes for p in pager.pages)} B on the card at "
          f"4 bits), wire-served {sorted(pager.wire_served)}")
    counters = {"qmatmul_f32": qmm.qmatmul_f32,
                "qmatmul_f32_blockscale": qmm.qmatmul_f32_blockscale,
                "flash_attention": fa.flash_attention}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_launches(counters)
    t0 = time.perf_counter()
    tokens, ticks, done = serve(eng)
    wall = time.perf_counter() - t0
    launches, by_class = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    ttft = [r.first_token_s - r.arrival_s for r in done]
    summary, fsum = eng.paging_summary(), eng.faults_summary()
    for name in PAGED_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched in the paged serve")
    per_pass = pg.pass_counters(n_pages, 2)
    if (summary["swap_count"], summary["miss_count"]) != (
            len(ticks) * per_pass["swaps"], len(ticks) * per_pass["misses"]):
        raise AssertionError(f"swap / miss {summary['swap_count']} / "
                             f"{summary['miss_count']} over {len(ticks)} "
                             f"ticks, want {per_pass} a tick")
    if summary["decode_s"] != 0.0 or summary["decode_skipped_bytes"] <= 0:
        raise AssertionError(f"wire-serve decoded on the host: {summary}")
    if any(fsum.values()):
        raise AssertionError(f"fault counters moved without faults: {fsum}")
    nt = len(ticks)
    tick_mean = sum(t for t, _ in ticks) / nt
    exposed = sum(s for _, s in ticks) / nt
    split = dict(ticks=nt, tick_ms=tick_mean * 1e3,
                 exposed_ms=exposed * 1e3,
                 crc_ms=summary["crc_s"] / nt * 1e3,
                 copy_ms=summary["copy_s"] / nt * 1e3,
                 compute_ms=(tick_mean - exposed) * 1e3)
    print(f"[paged] {cfg.name} paged serve: {len(done)} requests, prompts "
          f"{lens.tolist()}, wall {wall:.3f} s after synchronize, TTFT mean "
          f"{np.mean(ttft):.3f} s max {np.max(ttft):.3f} s, peak memory "
          f"{peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB at the start), "
          f"launches {launches}, by flash shape "
          f"{json.dumps(by_class)}; {nt} ticks x {per_pass} = swaps "
          f"{summary['swap_count']} misses {summary['miss_count']}, "
          f"{summary['bytes_streamed_wire']} wire B streamed, decode_s "
          f"{summary['decode_s']}, decode_skipped_bytes "
          f"{summary['decode_skipped_bytes']}")
    print(f"[paged] tick split (host clock, mean of {nt}): tick "
          f"{split['tick_ms']:.2f} ms = exposed page wait "
          f"{split['exposed_ms']:.2f} ms (worker: CRC {split['crc_ms']:.2f} "
          f"ms, copy {split['copy_ms']:.2f} ms) + compute "
          f"{split['compute_ms']:.2f} ms")

    # a resident engine on the same bytes: the cold groups already in wire
    # form on the card, the same plan, no pager
    wire_plan = plan.replace(wire_serve=True)
    view = {n: m["PackedParam"](packed=p.packed.to(dev),
                                scale=p.scale.to(dev), bits=p.bits,
                                orig_shape=p.orig_shape)
            for n, p in pager.template_view().items()}
    wire_tree = pg.thread_packed(packed, {**pager.resident, **view})
    resident = m["ServingEngine"](cfg, wire_tree, batch_slots=4,
                                  max_len=512, plan=wire_plan)
    r_tokens, _, _ = serve(resident)
    del resident
    if r_tokens != tokens:
        bad = [u for u in tokens if tokens[u] != r_tokens[u]]
        raise AssertionError(f"paged tokens differ from the resident "
                             f"wire-form engine's for uids {bad}")
    print("[paged] tokens equal per uid, bit for bit, to a resident engine "
          "holding the same wire-form bytes on the card (no pager)")

    # one pass overlapped with a forward, against a sync pass
    toks64 = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64))).to(
        dev)
    ps = pager.begin_pass()
    tfm.forward(wire_tree, toks64, cfg, engine=wire_plan)
    torch.cuda.synchronize()
    fenced = ps.fence()
    synced = {}
    for _page, got in pager.stream():
        synced.update(got)
    if set(fenced) != set(cold) or any(
            not (torch.equal(fenced[n].packed, synced[n].packed)
                 and torch.equal(fenced[n].scale, synced[n].scale)
                 and torch.equal(fenced[n].packed, view[n].packed))
            for n in cold):
        raise AssertionError("an overlapped pass's pages differ from a "
                             "sync pass's")
    overlap = dict(swap_s=ps.swap_s, window_s=ps.window_s,
                   hidden_s=ps.hidden_s, exposed_s=ps.exposed_s)
    print(f"[paged] begin_pass() overlapped with a 64-token forward, then "
          f"fence(): pages torch.equal to a sync stream() pass; swap_s "
          f"{ps.swap_s:.4f} hidden_s {ps.hidden_s:.4f} exposed_s "
          f"{ps.exposed_s:.4f} (window_s {ps.window_s:.4f})")
    del fenced, synced
    pager.close()
    del eng, pager

    # the same requests again under the profiler, the kernel calls noted
    engines = []

    def profiled_engine():
        engines.append(engine())
        return engines[-1]

    with recording(torch, m["ops"]) as calls:
        profile = profile_serve(torch, cfg, profiled_engine, requests())
    engines.pop().pager.close()
    path_check = check_path(torch, m["ops"], m["ref"], qmm, fa, m["ssm"],
                            dev, f"{cfg.name} paged", calls)

    # the same serve under faults
    chaos = engine(m["FaultPlan"](**PAGED_FAULTS))
    f_tokens, _, _ = serve(chaos)
    fsum = chaos.faults_summary()
    chaos.pager.close()
    del chaos
    if f_tokens != tokens:
        raise AssertionError("tokens changed under faults")
    if fsum["injected"] <= 0 or fsum["checksum_failures"] != \
            fsum["refetches"]:
        raise AssertionError(f"fault counters {fsum}")
    print(f"[paged] under FaultPlan({PAGED_FAULTS}): tokens equal per uid; "
          f"faults {fsum}")

    # card vs CPU logits of the wire tree, first 4 layers
    depth = min(4, cfg.n_layers)
    fcfg = cfg.replace(n_layers=depth)
    tree = dict(wire_tree, layers=first_layers(wire_tree["layers"], depth))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64)))
    gpu_logits = tfm.forward(tree, toks.to(dev), fcfg,
                             engine=wire_plan).cpu()
    cpu_logits = tfm.forward(to_device(torch, tree, "cpu"), toks, fcfg,
                             engine=wire_plan)
    err = (gpu_logits - cpu_logits).abs().max().item()
    if not (torch.isfinite(gpu_logits).all()
            and gpu_logits.shape == (1, 64, cfg.vocab_size)):
        raise AssertionError("paged wire tree: card logits are not finite "
                             "or misshapen")
    if not torch.allclose(gpu_logits, cpu_logits, **CUT_LOGITS_TOL):
        raise AssertionError(f"wire tree card vs CPU logits: max abs err "
                             f"{err}")
    print(f"[forward] {cfg.name} wire tree ({depth} of {cfg.n_layers} "
          f"layers, cold groups in wire form) 64 tokens card vs CPU: max "
          f"abs err {err:.3e} (tolerance {CUT_LOGITS_TOL})")
    bs_err = max(bs_err, path_check["max_abs_err"]["qmatmul_f32_blockscale"])
    return dict(
        launches=launches, launches_by_class=by_class, wall_s=wall,
        ttft_mean_s=float(np.mean(ttft)),
        ttft_max_s=float(np.max(ttft)), peak_gib=peak / 2**30,
        prompt_tokens=int(lens.sum()), attach_s=attach_s,
        cold_freed_bytes=freed,
        plan=dict(pinned=hot, cold=cold,
                  resident_bytes=plan.resident_bytes(sizes),
                  paged_bytes=plan.paged_bytes(sizes)),
        n_pages=n_pages, wire_bytes_per_pass=wire_pass,
        paging={k: v for k, v in summary.items()}, tick_split=split,
        overlap=overlap, faults=fsum, logits_max_abs_err=err,
        path_check=path_check, profile=profile), bs_err, t_bs, dict(
            packed=packed, plan=plan, wire_tree=wire_tree,
            wire_plan=wire_plan)


# the scheduled XR serve: the XR traffic and the two scheduling legs of
# benchmarks/serving_load.py (STREAMS :95-99, _VirtualClock :288-303,
# _xr_traffic :306-330, _run_xr :333-382, the gate :385-417), copied since
# the bench imports JAX; its defaults --xr-requests 60, --slots 4,
# --max-len 128, --prefill-chunk 16, --token-budget 96, --tick-ms 1
XR_STREAMS = (("hand_tracking", dict(priority=2, deadline_ms=15.0)),
              ("gaze", dict(priority=1, deadline_ms=10.0)),
              ("assistant", dict(priority=0, deadline_ms=None)))
XR_TRACKERS = ("hand_tracking", "gaze")
XR = dict(requests=60, slots=4, max_len=128, prefill_chunk=16,
          token_budget=96, tick_s=1e-3, period_ms=6.0, assist_new=24, seed=0)
XR_ARCH = "qwen3-0.6b"
XR_PAGED_REQUESTS = 24           # parts (c)-(d): ~0.2 s a paged tick
XR_GATE = dict(miss_rate=0.05, assistant_tok_ratio=0.90)


class VirtualClock:
    """Deterministic time: the loop advances one tick's ``tick_s`` per
    scheduler tick, and every read adds 1 us so that timestamps within a
    tick stay ordered."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        self.now += 1e-6
        return self.now

    def advance(self, seconds):
        self.now += seconds


def xr_traffic(make_request, vocab: int, n_requests: int = XR["requests"],
               seed: int = XR["seed"]):
    """A t = 0 backlog of best-effort assistant requests (16-48 prompt
    tokens, 24 new) and a hand-tracking and a gaze request (4-8 and 2-6
    prompt tokens, 2 new) every 6 ms: [(arrival s, stream, request)] in
    arrival order."""
    import numpy as np

    rng = np.random.default_rng(seed + 7)
    events, uid = [], 0
    n_per_stream = max(n_requests // 3, 2)
    for _ in range(n_per_stream):
        n = int(rng.integers(16, 48))
        events.append((0.0, "assistant", make_request(
            uid=uid,
            prompt=rng.integers(0, vocab, n).astype(np.int32),
            max_new_tokens=XR["assist_new"])))
        uid += 1
    period = XR["period_ms"] / 1e3
    for k in range(n_per_stream):
        for off, stream, lo, hi in ((0.004, "hand_tracking", 4, 9),
                                    (0.006, "gaze", 2, 7)):
            n = int(rng.integers(lo, hi))
            events.append((off + k * period, stream, make_request(
                uid=uid,
                prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=2)))
            uid += 1
    return sorted(events, key=lambda e: (e[0], e[2].uid))


def xr_scheduler(scheduler_cls, eng, clock, continuous: bool, **kw):
    """The bench's two legs: run-to-completion, or continuous (the token
    budget, preemption, reject-mode admission with the cost model pinned
    to one tick); ``kw`` adds to or overrides the leg's arguments."""
    args = dict(prefill_chunk=XR["prefill_chunk"], clock=clock,
                token_budget=XR["token_budget"] if continuous else None,
                preemptive=continuous,
                admission="reject" if continuous else None,
                est_tick_s=XR["tick_s"] if continuous else None)
    sched = scheduler_cls(eng, **{**args, **kw})
    for name, spec in XR_STREAMS:
        sched.add_stream(name, **spec)
    return sched


def serve_xr(sched, clock, events, tick_s=XR["tick_s"]):
    """Submit each request at its arrival and tick until all are served;
    on a :class:`VirtualClock` (``tick_s`` set) each tick advances it
    ``tick_s``, on the real clock (``tick_s`` None) arrivals wait for the
    wall.  Returns (finished requests, {uid: time of the tick that
    admitted it}), both clocks measured from the first arrival."""
    from collections import deque

    t0 = 0.0 if tick_s is not None else clock()

    def now():
        return clock.now if tick_s is not None else clock() - t0

    arrivals = deque(events)
    done, admitted = [], {}
    while arrivals or sched.pending:
        if not sched.pending and arrivals and arrivals[0][0] > now():
            if tick_s is not None:
                clock.advance(arrivals[0][0] - clock.now)
            else:
                time.sleep(arrivals[0][0] - now())
        while arrivals and arrivals[0][0] <= now():
            _t, stream, req = arrivals.popleft()
            sched.submit(req, stream=stream)
        queued, t_tick = list(sched.queue), now()
        done += sched.tick()
        waiting = {id(r) for r in sched.queue}
        for r in queued:
            if id(r) not in waiting and not r.rejected:
                admitted.setdefault(r.uid, t_tick)
        if tick_s is not None:
            clock.advance(tick_s)
    return done, admitted


def xr_record(sched, done, admitted):
    """What the scheduler decided, per uid and in its counters: the part of
    a run that depends on the traffic and not on the model or the device."""
    per_uid = {r.uid: dict(arrival_s=r.arrival_s, admitted_s=admitted.get(
        r.uid), first_token_s=r.first_token_s, finish_s=r.finish_s,
        preemptions=r.preemptions, rejected=r.rejected, degraded=r.degraded,
        max_new_tokens=r.max_new_tokens, n_generated=len(r.generated))
        for r in done + sched.rejected}
    mt = sched.metrics
    counters = dict(ticks=sched.ticks, deferred_ticks=sched.deferred_ticks,
                    preemptions=mt.preemptions, restores=mt.restores,
                    rejected=mt.rejected, degraded=mt.degraded,
                    budget_used=list(mt.tick_budget_used))
    return dict(per_uid=dict(sorted(per_uid.items())), counters=counters)


def xr_gate(base, cont):
    """The bench's gate over the two legs' runs: the trackers' worst miss
    rate in the continuous leg, and its assistant tok/s (virtual seconds)
    over the baseline's."""
    def assist_tok_s(run):
        recs = run["sched"].metrics.records
        return (sum(r.n_generated for r in recs if r.stream == "assistant")
                / max(run["doc"]["throughput"]["wall_s"], 1e-9))
    miss = max(cont["doc"]["streams"][s]["miss_rate"] for s in XR_TRACKERS
               if s in cont["doc"]["streams"])
    return miss, assist_tok_s(cont) / max(assist_tok_s(base), 1e-9)


def serve_xr_phase(torch, m, cfg, resident_tree, paged, dev):
    """Phase 7, the scheduled XR serve (see the module doc): (a) the
    resident 8-bit qwen3-0.6b under both legs, (b) the decisions against a
    2-layer smoke config on the CPU, (c) the paged 4-bit store under the
    continuous leg, (d) that leg again on the real clock."""
    np, sv, tr_mod, qmm, fa = m["np"], m["serving"], m["trace"], m["qmm"], \
        m["fa"]
    counters = {"qmatmul_f32": qmm.qmatmul_f32,
                "qmatmul_f32_blockscale": qmm.qmatmul_f32_blockscale,
                "flash_attention": fa.flash_attention}
    total = {name: 0 for name in counters}
    total_split = {}

    def count(launches, split):
        for name, n in launches.items():
            total[name] += n
        for name, by in split.items():
            for k, n in by.items():
                total_split.setdefault(name, {})
                total_split[name][k] = total_split[name].get(k, 0) + n

    calls = {}

    def leg(eng, continuous, events, traced=False, clock=None,
            counted=True, recorded=False, **kw):
        """One leg on ``eng``; a card leg's launches go into the phase's
        count unless ``counted`` is False (a leg that is only a reference),
        and with ``recorded`` its kernel calls go into ``calls``."""
        clock = clock if clock is not None else VirtualClock()
        tracer = tr_mod.Tracer() if traced else None
        sched = xr_scheduler(sv.Scheduler, eng, clock, continuous,
                             tracer=tracer, trace_track="xr", **kw)
        zero_launches(counters)
        t0 = time.perf_counter()
        with (recording(torch, m["ops"]) if recorded
              else contextlib.nullcontext({})) as seen:
            done, admitted = serve_xr(sched, clock, events,
                                      XR["tick_s"] if isinstance(
                                          clock, VirtualClock) else None)
            if eng.device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches, split = read_launches(counters)
        if eng.device.type == "cuda" and counted:
            count(launches, split)
        for name, keys in seen.items():
            calls[name] = list(dict.fromkeys(calls.get(name, []) + keys))
        doc = sv.validate(sched.metrics.summary(
            paging=eng.paging_summary(), trace=sched.trace_summary(),
            faults=sched.faults_summary()))
        if tracer is not None:
            tr_mod.validate(tracer.to_dict())
        if any(not 0 <= t < eng.cfg.vocab_size for r in done
               for t in r.generated):
            raise AssertionError("token id out of the vocabulary")
        return dict(sched=sched, done=done, doc=doc, wall_s=wall,
                    launches=launches, split=split, tracer=tracer,
                    tokens={r.uid: r.generated for r in done},
                    record=xr_record(sched, done, admitted))

    def fresh(events, mod=None):
        return [(t, s, sv.Request(uid=r.uid, prompt=r.prompt if mod is None
                                  else r.prompt % mod,
                                  max_new_tokens=r.max_new_tokens))
                for t, s, r in events]

    # (a) resident 8-bit, both legs
    events = xr_traffic(sv.Request, cfg.vocab_size)
    res = {}
    for name, continuous in (("baseline", False), ("continuous", True)):
        eng = sv.ServingEngine(cfg, resident_tree, batch_slots=XR["slots"],
                               max_len=XR["max_len"], seed=XR["seed"])
        res[name] = leg(eng, continuous, fresh(events), traced=continuous,
                        recorded=continuous)
        for kname in ("qmatmul_f32", "flash_attention"):
            if res[name]["launches"][kname] <= 0:
                raise AssertionError(f"{kname} never launched in the XR "
                                     f"{name} leg")
        del eng
    base, cont = res["baseline"], res["continuous"]
    if base["tokens"] != cont["tokens"]:
        bad = [u for u in base["tokens"]
               if base["tokens"][u] != cont["tokens"].get(u)]
        raise AssertionError(f"XR tokens differ between the legs for uids "
                             f"{bad}")
    miss, ratio = xr_gate(base, cont)
    preempted = cont["doc"]["scheduler"]["preemptions"]
    gate = dict(deadline_miss_rate=miss, assistant_tok_ratio=ratio,
                preemptions=preempted,
                restores=cont["doc"]["scheduler"]["restores"],
                rejected=cont["doc"]["scheduler"]["rejected"],
                bit_exact=True, ticks=dict(
                    baseline=base["sched"].ticks,
                    continuous=cont["sched"].ticks))
    print(f"[xr] {cfg.name} resident (8-bit), {len(events)} requests: "
          f"gate {json.dumps(gate)}; host wall baseline "
          f"{base['wall_s']:.2f} s, continuous {cont['wall_s']:.2f} s; "
          f"trace {cont['tracer'].event_count} events on tracks "
          f"{cont['tracer'].track_names}; launches baseline "
          f"{base['launches']}, continuous {cont['launches']}")
    if not (preempted >= 1 and miss <= XR_GATE["miss_rate"]
            and ratio >= XR_GATE["assistant_tok_ratio"]):
        raise AssertionError(f"XR gate failed: {gate}")

    # (b) the decisions of a 2-layer smoke config of the family on the CPU
    scfg = cfg.smoke()
    sparams = m["tfm"].init_params(scfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    stree = m["freeze"](sparams, bits=8, device="cpu")
    for name, continuous in (("baseline", False), ("continuous", True)):
        eng = sv.ServingEngine(scfg, stree, batch_slots=XR["slots"],
                               max_len=XR["max_len"], seed=XR["seed"],
                               device="cpu")
        cpu = leg(eng, continuous, fresh(events, scfg.vocab_size))
        if cpu["record"] != res[name]["record"]:
            card_rec, cpu_rec = res[name]["record"], cpu["record"]
            bad = [u for u in card_rec["per_uid"]
                   if card_rec["per_uid"][u] != cpu_rec["per_uid"].get(u)]
            raise AssertionError(
                f"XR {name} leg: the card's decisions differ from the CPU's "
                f"on {scfg.n_layers} layers: uids {bad}, counters "
                f"{card_rec['counters']} vs {cpu_rec['counters']}")
    print(f"[xr] decisions (admission, first-token and finish times on the "
          f"virtual clock, preemptions, rejections, degradations, the "
          f"scheduler's counters) equal per uid to the CPU's on a "
          f"{scfg.n_layers}-layer smoke config of {cfg.name}, both legs")

    # (c) the paged 4-bit store (cold half int8 wire pages), continuous
    events24 = xr_traffic(sv.Request, cfg.vocab_size, XR_PAGED_REQUESTS)
    eng = sv.ServingEngine(cfg, paged["packed"], batch_slots=XR["slots"],
                           max_len=XR["max_len"], seed=XR["seed"],
                           plan=paged["plan"])
    eng.attach_paging(wire_serve=True)
    pg = leg(eng, True, fresh(events24), recorded=True, async_io=True)
    per_pass = m["paging"].pass_counters(len(eng.pager.pages),
                                         eng.page_resident_slots)
    ticks = pg["sched"].ticks
    summary = pg["doc"]["paging"]
    if (summary["swap_count"], summary["miss_count"]) != (
            ticks * per_pass["swaps"], ticks * per_pass["misses"]):
        raise AssertionError(f"paged XR: swap / miss "
                             f"{summary['swap_count']} / "
                             f"{summary['miss_count']} over {ticks} ticks, "
                             f"want {per_pass} a tick")
    if pg["launches"]["qmatmul_f32_blockscale"] <= 0:
        raise AssertionError("qmatmul_f32_blockscale never launched in the "
                             "paged XR leg")
    eng.pager.close()
    del eng
    wire = sv.ServingEngine(cfg, paged["wire_tree"], batch_slots=XR["slots"],
                            max_len=XR["max_len"], seed=XR["seed"],
                            plan=paged["wire_plan"])
    ref = leg(wire, True, fresh(events24), counted=False)
    del wire
    if ref["tokens"] != pg["tokens"]:
        bad = [u for u in pg["tokens"]
               if pg["tokens"][u] != ref["tokens"].get(u)]
        raise AssertionError(f"paged XR tokens differ from the resident "
                             f"wire-form engine's for uids {bad}")
    print(f"[xr] {cfg.name} paged (4-bit, cold half int8 wire pages), "
          f"continuous leg, {len(events24)} requests: {ticks} ticks x "
          f"{per_pass} = swaps {summary['swap_count']} misses "
          f"{summary['miss_count']}, preemptions "
          f"{pg['doc']['scheduler']['preemptions']}; tokens equal per uid to "
          f"a resident engine on the same wire-form bytes; host wall "
          f"{pg['wall_s']:.2f} s; launches {pg['launches']}")

    # each kernel against its plain version at every distinct call of the
    # continuous legs of (a) and (c)
    path_check = check_path(torch, m["ops"], m["ref"], qmm, fa, m["ssm"],
                            dev, f"{cfg.name} xr", calls)

    # (d) the same paged continuous leg on the real clock
    eng = sv.ServingEngine(cfg, paged["packed"], batch_slots=XR["slots"],
                           max_len=XR["max_len"], seed=XR["seed"],
                           plan=paged["plan"])
    eng.attach_paging(wire_serve=True)
    real = leg(eng, True, fresh(events24), clock=time.perf_counter,
               async_io=True)
    eng.pager.close()
    del eng
    doc = real["doc"]
    ttft = {}
    for s in sorted({r.stream for r in real["sched"].metrics.records}):
        xs = [r.ttft_s * 1e3 for r in real["sched"].metrics.records
              if r.stream == s and r.ttft_s is not None]
        ttft[s] = dict(p50=float(np.percentile(xs, 50)),
                       p99=float(np.percentile(xs, 99)), n=len(xs))
    pgs = doc["paging"]
    reading = dict(
        ttft_ms=ttft, tok_per_s=doc["throughput"]["tok_per_s"],
        wall_s=doc["throughput"]["wall_s"], ticks=doc["ticks"]["count"],
        tick_ms=doc["ticks"]["latency_ms"],
        miss_rate=doc["deadlines"]["miss_rate"],
        rejected=doc["scheduler"]["rejected"],
        preemptions=doc["scheduler"]["preemptions"],
        exposed_s=pgs["exposed_s"], hidden_s=pgs["hidden_s"],
        overlap_frac=pgs["overlap_frac"],
        predicted_vs_measured_stall_ratio=doc["trace"][
            "predicted_vs_measured_stall_ratio"])
    print(f"[xr] {cfg.name} paged continuous leg on the real clock "
          f"(smoke reading, nothing asserted): {json.dumps(reading)}")
    return dict(
        launches=total, launches_by_class=total_split, gate=gate,
        path_check=path_check,
        resident=dict(baseline=base["doc"], continuous=cont["doc"]),
        paged=dict(doc=pg["doc"], per_pass=per_pass, ticks=ticks),
        real_clock=reading)

# phase 8: KV paging and tenancy, the two-tenant leg of
# benchmarks/serving_load.py (_tenant_reqs :121-131, _bench_multi :134-210)
# at its defaults --arch qwen3-0.6b --arch2 falcon-mamba-7b --slots 4
# --max-new 8 --max-len 128 --prefill-chunk 16 --budget-frac 0.5
# --shared-budget-frac 0.6 --kv-block 16 --async-io, with --kv-paged for
# the tenant that has a KV cache; copied since the bench imports JAX.  The
# bench's 24 requests a tenant are cut to KV_REQUESTS / TENANT_REQUESTS
TENANCY = dict(slots=4, max_new=8, max_len=128, prefill_chunk=16,
               budget_frac=0.5, shared_budget_frac=0.6, kv_block=16, seed=0)
TENANTS = ("qwen3-0.6b", "falcon-mamba-7b")
KV_REQUESTS = 24                 # part (a): ~0.1-0.2 s a paged qwen3 tick
TENANT_REQUESTS = 8              # part (b): ~1.6 s of CRC a falcon pass
KV_KERNELS = ("qmatmul_f32", "flash_attention", "selective_scan")


def tenant_reqs(make_request, vocab: int, n_requests: int, salt: int):
    """``_tenant_reqs``: prompts of 2-47 tokens, ``max_new`` new tokens
    each, from ``default_rng(seed + salt)``."""
    import numpy as np

    rng = np.random.default_rng(TENANCY["seed"] + salt)
    hi = max(3, min(48, TENANCY["max_len"] - TENANCY["max_new"] - 2))
    out = []
    for uid in range(n_requests):
        n = int(rng.integers(2, hi))
        out.append(make_request(
            uid=uid, prompt=rng.integers(0, vocab, n).astype(np.int32),
            max_new_tokens=TENANCY["max_new"]))
    return out


def half_paged_plan(placement, tree):
    """The bench's plan: ``plan_for_budget`` at ``budget_frac`` of the
    store's bytes (8-bit, cold pages streamed verbatim)."""
    sizes = placement.packed_sizes(tree)
    return placement.plan_for_budget(
        sizes, int(sum(sizes.values()) * TENANCY["budget_frac"]))


def pool_replay_check(paging, pool, weights, tables, what):
    """Every pool member's counters and streamed bytes against the
    ``kv_pass_counters`` replay of the pool's event log; the KV tables'
    drops too.  Returns the replay."""
    pred = paging.kv_pass_counters(
        {name: paging.page_sizes(store.pages)
         for name, store in weights.items()},
        pool.budget_bytes, pool.events)
    summ = pool.summary()
    for name, c in summ["models"].items():
        got = dict(swaps=c["swaps"], misses=c["misses"],
                   pool_hits=c["pool_hits"], evicted=c["evicted"],
                   bytes_wire=c["bytes_streamed_wire"],
                   bytes_raw=c["bytes_streamed_raw"])
        want = {k: pred.get(name, {}).get(k, 0) for k in got}
        if name in tables:
            got["dropped"] = tables[name].dropped
            want["dropped"] = pred.get(name, {}).get("dropped", 0)
        if got != want:
            raise AssertionError(f"{what}: pool member {name} counters "
                                 f"{got}, the replay of the event log "
                                 f"{want}")
    return pred


def kv_span_bytes(memsys, table, events):
    """The bytes of the KV spans each fetch batch of ``table`` listed, by
    ``memsys.kv_stream_bytes`` over each slot's block range."""
    total = 0
    for ev in events:
        if ev[0] != "kv" or ev[1] != table.name:
            continue
        per_slot = {}
        for page, _nb in ev[2]:
            slot = page // table.n_blocks
            per_slot[slot] = per_slot.get(slot, 0) + 1
        total += sum(memsys.kv_stream_bytes(n * table.block_rows,
                                            table.block_rows,
                                            table.row_nbytes)
                     for n in per_slot.values())
    return total


def serve_kv_tenancy_phase(torch, m, cfgs, trees, dev):
    """Phase 8 (see the module doc): (a) qwen3-0.6b with its cold half and
    its KV cache paged through one pool, against a resident unpaged engine;
    (b) qwen3-0.6b (KV-paged) and falcon-mamba-7b as two tenants of one
    ``MultiScheduler`` and one pool, each against its solo run on a
    private pager.  ``cfgs`` / ``trees`` map each tenant to its config and
    its frozen 8-bit tree on ``dev``."""
    sv, paging, placement, memsys = (m["serving"], m["paging"],
                                     m["placement"], m["memsys"])
    qwen, falcon = TENANTS
    counters = {"qmatmul_f32": m["qmm"].qmatmul_f32,
                "flash_attention": m["fa"].flash_attention,
                "selective_scan": m["ssm"].selective_scan}
    names = [s for s, _kw in XR_STREAMS]
    card = dev.type == "cuda"

    def sync():
        if card:
            torch.cuda.synchronize()

    def engine(name, plan=None):
        return sv.ServingEngine(cfgs[name], trees[name],
                                batch_slots=TENANCY["slots"],
                                max_len=TENANCY["max_len"], plan=plan,
                                seed=TENANCY["seed"])

    def scheduler(eng):
        sched = sv.Scheduler(eng, prefill_chunk=TENANCY["prefill_chunk"],
                             async_io=True)
        for sname, spec in XR_STREAMS:
            sched.add_stream(sname, **spec)
        return sched

    def serve(sched, reqs):
        for r in reqs:
            sched.submit(r, stream=names[r.uid % len(names)])
        t0 = time.perf_counter()
        done = sched.run_until_done()
        sync()
        return {r.uid: r.generated for r in done}, time.perf_counter() - t0

    def close(eng):
        for part in (eng.pager, eng.kv_table):
            if part is not None:
                part.close()

    def tokens_equal(got, want, name, what):
        if got != want:
            bad = [u for u in want if got.get(u) != want[u]]
            raise AssertionError(f"{what}: tokens differ for uids {bad}")
        if any(not 0 <= t < cfgs[name].vocab_size for ts in got.values()
               for t in ts):
            raise AssertionError(f"{what}: token id out of the vocabulary")

    def kv_reading(eng, sched):
        pg = eng.paging_summary()
        return dict(ticks=sched.ticks, kv_swaps=pg["kv_swaps"],
                    kv_pool_hits=pg["kv_pool_hits"],
                    kv_writebacks=pg["kv_writebacks"],
                    kv_dropped=pg["kv_dropped"],
                    kv_exposed_s=pg["kv_exposed_s"],
                    kv_hidden_s=pg["kv_hidden_s"],
                    exposed_s=pg["exposed_s"], hidden_s=pg["hidden_s"],
                    crc_s=pg["crc_s"], copy_s=pg["copy_s"])

    calls = {}
    out = {}

    # (a) one tenant: weights and KV blocks through one pool
    plan = half_paged_plan(placement, trees[qwen])
    cold = plan.paged_bytes(placement.packed_sizes(trees[qwen]))
    pool = paging.SharedPagePool(int(cold * TENANCY["shared_budget_frac"]))
    eng = engine(qwen, plan)
    eng.attach_paging(pool=pool, name=qwen)
    eng.attach_kv_paging(TENANCY["kv_block"], pool=pool)
    sched = scheduler(eng)
    reqs = tenant_reqs(sv.Request, cfgs[qwen].vocab_size, KV_REQUESTS, 0)
    zero_launches(counters)
    with recording(torch, m["ops"]) as seen:
        got, wall = serve(sched, reqs)
    launches_a, split_a = read_launches(counters)
    for name, keys in seen.items():
        calls[name] = list(dict.fromkeys(calls.get(name, []) + keys))
    table = eng.kv_table
    pred = pool_replay_check(paging, pool, {qwen: eng.pager},
                             {table.name: table}, "kv-paged qwen3")
    span = kv_span_bytes(memsys, table, pool.events)
    if not (table.swap_count * table.page_nbytes == table.bytes_streamed_wire
            == pred[table.name]["bytes_wire"]
            and span == (table.swap_count + table.pool_hits)
            * table.page_nbytes and table.swap_count > 0
            and table.writebacks > 0):
        raise AssertionError(
            f"kv-paged qwen3: kv_swaps {table.swap_count} x page "
            f"{table.page_nbytes} B, streamed {table.bytes_streamed_wire} "
            f"B, spans listed {span} B with {table.pool_hits} pool hits, "
            f"{table.writebacks} writebacks")
    for kname in ("qmatmul_f32", "flash_attention"):
        if launches_a[kname] <= 0:
            raise AssertionError(f"{kname} never launched in the kv-paged "
                                 "leg")
    doc = sv.validate(sched.metrics.summary(paging=eng.paging_summary()))
    reading = kv_reading(eng, sched)
    summary_a = pool.summary()
    pool.close()
    del eng, sched
    ref = engine(qwen)
    want, ref_wall = serve(scheduler(ref), tenant_reqs(
        sv.Request, cfgs[qwen].vocab_size, KV_REQUESTS, 0))
    del ref
    tokens_equal(got, want, qwen,
                 "kv-paged qwen3 against the resident engine")
    reading.update(wall_s=wall, tick_ms=wall / reading["ticks"] * 1e3,
                   resident_wall_s=ref_wall, requests=len(reqs),
                   tok_per_s=doc["throughput"]["tok_per_s"],
                   page_nbytes=table.page_nbytes,
                   kv_stream_bytes=span)
    members = {name: {k: c[k] for k in ("swaps", "misses", "pool_hits",
                                        "evicted")}
               for name, c in summary_a["models"].items()}
    print(f"[kv] {qwen} (8-bit, cold half paged, KV in blocks of "
          f"{TENANCY['kv_block']} rows, one pool of "
          f"{summary_a['budget_bytes']} B), {len(reqs)} requests: tokens "
          f"equal per uid to a resident unpaged engine's; pool members on "
          f"the kv_pass_counters replay ({json.dumps(members)}); "
          f"kv_swaps x page = {table.swap_count} x {table.page_nbytes} B, "
          f"kv_stream_bytes of the listed spans {span} B; host clock "
          f"(smoke reading): {json.dumps(reading)}; launches {launches_a}")
    out["kv"] = dict(launches=launches_a, launches_by_class=split_a,
                     reading=reading, pool=summary_a, doc=doc)

    # (b) two tenants, one MultiScheduler, one pool
    plans = {name: half_paged_plan(placement, trees[name])
             for name in TENANTS}
    cold = sum(plans[n].paged_bytes(placement.packed_sizes(trees[n]))
               for n in TENANTS)
    budget = max(int(cold * TENANCY["shared_budget_frac"]), 1)
    ms = sv.MultiScheduler(pool=paging.SharedPagePool(budget),
                           async_io=True)
    for salt, name in enumerate(TENANTS):
        eng = engine(name, plans[name])
        ms.add_model(name, eng, prefill_chunk=TENANCY["prefill_chunk"],
                     kv_paged="kv" in eng.cache,
                     kv_block_rows=TENANCY["kv_block"])
        for sname, spec in XR_STREAMS:
            ms.add_stream(name, sname, **spec)
        for r in tenant_reqs(sv.Request, cfgs[name].vocab_size,
                             TENANT_REQUESTS, salt):
            ms.submit(name, r, stream=names[r.uid % len(names)])
    zero_launches(counters)
    t0 = time.perf_counter()
    with recording(torch, m["ops"]) as seen:
        done = ms.run_until_done()
        sync()
    wall = time.perf_counter() - t0
    launches_b, split_b = read_launches(counters)
    for name, keys in seen.items():
        calls[name] = list(dict.fromkeys(calls.get(name, []) + keys))
    doc = sv.validate(ms.summary())
    engines = {n: ms.model(n).engine for n in TENANTS}
    pool_replay_check(paging, ms.pool,
                      {n: e.pager for n, e in engines.items()},
                      {e.kv_table.name: e.kv_table for e in engines.values()
                       if e.kv_table is not None}, "tenancy")
    for kname in KV_KERNELS:
        if launches_b[kname] <= 0:
            raise AssertionError(f"{kname} never launched in the tenancy "
                                 "leg")
    readings = {n: kv_reading(e, ms.model(n)) for n, e in engines.items()}
    summary_b = ms.pool.summary()
    ms.close()
    del engines, ms
    gc.collect()
    for salt, name in enumerate(TENANTS):
        eng = engine(name, plans[name])
        eng.attach_paging()
        if "kv" in eng.cache:
            eng.attach_kv_paging(TENANCY["kv_block"])
        want, solo_wall = serve(scheduler(eng), tenant_reqs(
            sv.Request, cfgs[name].vocab_size, TENANT_REQUESTS, salt))
        close(eng)
        del eng
        gc.collect()
        tokens_equal({r.uid: r.generated for r in done.get(name, [])}, want,
                     name, f"tenant {name} against its solo run")
        readings[name]["solo_wall_s"] = solo_wall
    ticks = doc["ticks"]["count"]
    reading = dict(wall_s=wall, ticks=ticks, tick_ms=wall / ticks * 1e3,
                   tok_per_s=doc["totals"]["tok_per_s"],
                   requests=doc["totals"]["requests"], tenants=readings)
    print(f"[tenancy] {' + '.join(TENANTS)} (8-bit, cold halves paged, "
          f"{qwen} KV-paged), {TENANT_REQUESTS} requests a tenant, one pool "
          f"of {budget} B ({TENANCY['shared_budget_frac']} of {cold} B "
          f"cold): tokens equal per uid to each tenant's solo run on a "
          f"private pager; pool members on the kv_pass_counters replay; "
          f"metrics v9 multi document valid; pool {json.dumps(summary_b)}; "
          f"host clock (smoke reading): {json.dumps(reading)}; launches "
          f"{launches_b}")
    out["tenancy"] = dict(launches=launches_b, launches_by_class=split_b,
                          reading=reading, pool=summary_b)
    out["path_check"] = check_path(torch, m["ops"], m["ref"], m["qmm"],
                                   m["fa"], m["ssm"], dev,
                                   "kv-paged + tenancy", calls)
    return out


# kernel-name fragments of the LM paths' device time, as the profiler names
# them; cuBLAS / CUTLASS GEMMs are the unembedding's f32 matmul
PROFILE_LM_KERNELS = (("qmm_tc", "qmatmul_f32 tensor cores (prefill)"),
                      ("qmm_dec", "qmatmul_f32 tensor cores (decode)"),
                      ("bs_tc", "qmatmul_f32_blockscale tensor cores "
                       "(prefill)"),
                      ("bs_dec", "qmatmul_f32_blockscale tensor cores "
                       "(decode)"),
                      ("memcpy", "memcpy (host <-> device)"),
                      ("flash_fwd", "flash_attention"),
                      ("scan_step", "selective_scan (step route)"),
                      ("scan_chunked", "selective_scan (chunked route)"),
                      ("gemm", "torch.matmul (unembed)"))


def profile_serve(torch, cfg, make_engine, reqs):
    """Device time by kernel and the device's idle share of one serve, from
    ``torch.profiler`` (device activity only, to keep its cost low)."""
    from torch.profiler import ProfilerActivity, profile

    eng = make_engine()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    if not kernels:
        print(f"[serve] {cfg.name} profiler: no device events recorded; "
              "device time by kernel not measured")
        return None
    def busy_us(events):
        busy, end = 0.0, -1.0
        for e in events:
            t0_, t1_ = e.time_range.start, e.time_range.end
            busy += max(0.0, t1_ - max(t0_, end))
            end = max(end, t1_)
        return busy

    by_kernel = {}
    for e in kernels:
        label = next((lab for frag, lab in PROFILE_LM_KERNELS
                      if frag in e.name.lower()), "other torch ops")
        by_kernel[label] = (by_kernel.get(label, 0.0)
                            + (e.time_range.end - e.time_range.start) / 1e3)
    busy = busy_us(kernels)
    # the copy engine's memcpys left out: how idle the compute engine is
    compute = busy_us([e for e in kernels if "memcpy" not in e.name.lower()])
    res = dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
               idle_share=1.0 - busy / wall_us,
               compute_busy_ms=compute / 1e3,
               compute_idle_share=1.0 - compute / wall_us,
               n_kernels=len(kernels),
               by_kernel_ms={k: round(v, 3) for k, v in by_kernel.items()})
    print(f"[serve] {cfg.name} profiler over the same requests: device busy "
          f"{busy / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms on the host clock "
          f"(idle share {res['idle_share']:.3f}; without memcpy "
          f"{compute / 1e3:.1f} ms, idle share "
          f"{res['compute_idle_share']:.3f}), {len(kernels)} kernels; "
          f"by kernel (ms) {json.dumps(res['by_kernel_ms'])}")
    return res


def first_layers(tree, depth: int):
    if isinstance(tree, dict):
        return {k: first_layers(v, depth) for k, v in tree.items()}
    return tree[:depth]


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def job_key(j):
    """(op, shape) of one N-EUREKA job: pw1x1 (M, K, N), dense3x3 (H, W,
    Cin, Cout, stride), dw3x3 (H, W, C, stride).  Every pw1x1 job of the
    network has stride 1."""
    if j.op_kind == "pw1x1":
        return "pw1x1", (j.h * j.w, j.cin, j.cout)
    if j.op_kind == "dense3x3":
        return "dense3x3", (j.h, j.w, j.cin, j.cout, j.stride)
    return "dw3x3", (j.h, j.w, j.cin, j.stride)


def neureka_case(torch, packing, ops, gen, dev, op, shape, bits,
                 tie=False):
    """(x, packed, mult, bias) of one N-EUREKA job.  ``mult`` spreads the
    int32 sums over ~40 LSB as ``freeze_packed`` does and the bias sits
    near 128; with ``tie`` the activations are small and ``mult`` is 0.5 or
    0.25, so many outputs land on an exact .5 before rounding."""
    hi = 4 if tie else 256
    if op == "pw1x1":
        m, k, n = shape
        x = torch.randint(0, hi, (m, k), generator=gen, device=dev,
                          dtype=torch.uint8)
        packed = ops.prep_linear(torch.randn((n, k), generator=gen,
                                             device=dev), bits)[0]
        levels, k_red = packing.unpack(packed, bits, k), k
    elif op == "dense3x3":
        h, w, cin, n, _ = shape
        x = torch.randint(0, hi, (h, w, cin), generator=gen, device=dev,
                          dtype=torch.uint8)
        packed = ops.prep_conv3x3(torch.randn((n, 3, 3, cin), generator=gen,
                                              device=dev), bits)[0]
        levels, k_red = packing.unpack(packed, bits, cin), 9 * cin
    else:
        h, w, n, _ = shape
        x = torch.randint(0, hi, (h, w, n), generator=gen, device=dev,
                          dtype=torch.uint8)
        packed = ops.prep_dw3x3(torch.randn((n, 3, 3), generator=gen,
                                            device=dev), bits)[0]
        levels, k_red = packing.unpack(packed, bits, 9), 9
    if tie:
        mult = torch.where(torch.arange(n, device=dev) % 2 == 0, 0.5, 0.25)
        bias = torch.full((n,), 100, dtype=torch.int32, device=dev)
    else:
        rms = levels.reshape(n, -1).float().pow(2).mean(1).sqrt()
        mult = 40.0 / (128.0 * rms.clamp(min=1e-3) * k_red ** 0.5)
        bias = torch.randint(96, 160, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
    return x, packed, mult.float().contiguous(), bias


def neureka_pair(nkc, qmm, ref, op, shape, bits):
    """(kernel name, kernel call, plain call) for one job shape."""
    if op == "pw1x1":
        k = shape[1]
        return ("qmatmul_int8",
                lambda *a: qmm.qmatmul_int8(*a, bits=bits, k_orig=k),
                lambda *a: ref.qmatmul_int8(*a, bits=bits, k_orig=k))
    if op == "dense3x3":
        cin, st = shape[2], shape[4]
        return ("conv3x3_dense",
                lambda *a: nkc.conv3x3_dense(*a, bits=bits, cin=cin,
                                             stride=st),
                lambda *a: ref.conv3x3_dense(*a, bits=bits, cin=cin,
                                             stride=st))
    st = shape[3]
    return ("conv3x3_dw",
            lambda *a: nkc.conv3x3_dw(*a, bits=bits, stride=st),
            lambda *a: ref.conv3x3_dw(*a, bits=bits, stride=st))


# the ragged shapes of the reference's kernel tests (test_kernels.py:45-100),
# dense 3x3 at Cin 40 and 64 (odd maps; K runs over several 32-wide steps
# across taps), and depthwise 3x3 at C 24, 17 and 1 (8, 1 and 1 channels a
# thread)
RAGGED_CASES = (
    [("pw1x1", (40, 130, 50)), ("pw1x1", (1, 33, 7)), ("pw1x1", (63, 130, 17))]
    + [("dense3x3", (12, 10, 24, 16, s)) for s in (1, 2)]
    + [("dense3x3", (7, 7, 3, 32, s)) for s in (1, 2)]
    + [("dense3x3", (9, 11, 40, 8, s)) for s in (1, 2)]
    + [("dense3x3", (13, 7, 64, 40, s)) for s in (1, 2)]
    + [("dw3x3", shape + (s,)) for s in (1, 2)
       for shape in ((9, 11, 40), (12, 10, 24), (9, 11, 17), (7, 5, 1))])
TIE_CASES = [("pw1x1", (37, 4, 9)), ("pw1x1", (50, 24, 40)),
             ("dense3x3", (7, 7, 3, 32, 1)), ("dw3x3", (9, 11, 40, 2))]


def split_edges(plan, m: int, n: int, most: int = 4):
    """(m, k, n) on each side of the first ``most`` K values (multiples of
    32 up to 2,048) where ``plan(m, k, n)`` changes its number of K splits."""
    out, prev = [], plan(m, 32, n).splits
    for k in range(64, 2049, 32):
        splits = plan(m, k, n).splits
        if splits != prev and len(out) < 2 * most:
            out += [(m, k - 32, n), (m, k, n)]
        prev = splits
    return out


def check_neureka(torch, packing, ops, ref, nkc, qmm, dev, jobs):
    """Every N-EUREKA kernel equals its plain version bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(5)
    shapes = list(dict.fromkeys(job_key(j) for j in jobs))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    edges = [("pw1x1", shape) for mn in ((49, 160), (1, 1000), (196, 96))
             for shape in split_edges(lambda m, k, n: qmm.int8_plan(
                 m, k, n, sms), *mn)]
    cases = [(op, shape, bits, False) for op, shape in shapes
             for bits in (8, 4, 2)]
    cases += [(op, shape, bits, False) for op, shape in RAGGED_CASES + edges
              for bits in (8, 4, 2)]
    cases += [(op, shape, bits, True) for op, shape in TIE_CASES
              for bits in (4, 2)]
    counts = dict.fromkeys(NEUREKA_KERNELS, 0)
    worst = dict.fromkeys(NEUREKA_KERNELS, 0)
    for op, shape, bits, tie in cases:
        args = neureka_case(torch, packing, ops, gen, dev, op, shape, bits,
                            tie)
        name, kernel, plain = neureka_pair(nkc, qmm, ref, op, shape, bits)
        got, expect = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        diff = (got.int() - expect.int()).abs()
        worst[name] = max(worst[name], int(diff.max().item()))
        if got.shape != expect.shape or not torch.equal(got, expect):
            raise AssertionError(
                f"{name} {op} {shape} bits={bits} tie={tie}: "
                f"{int((diff > 0).sum().item())} of {got.numel()} outputs "
                f"differ from the plain version (max {worst[name]})")
        counts[name] += 1
    print(f"[check] N-EUREKA kernels bit-equal to their plain versions: "
          f"{counts} cases ({len(shapes)} distinct MobileNet-V2 job shapes "
          f"at {MNV2_IMG} x bits 8/4/2, {len(RAGGED_CASES)} ragged shapes "
          f"and {len(edges)} qmatmul_int8 shapes at its K-split thresholds "
          f"x bits 8/4/2, {len(TIE_CASES)} requant-tie shapes x bits 4/2)")
    return worst


def cold_sets(torch, packing, ops, gen, dev, op, shape, bits):
    """Input sets of one job, as many as rotate over more than L2 (2-64)."""
    probe = neureka_case(torch, packing, ops, gen, dev, op, shape, bits)
    if op == "pw1x1":
        out_numel = shape[0] * shape[2]
    else:   # (H, W, ..., C out, stride)
        s = shape[-1]
        out_numel = -(-shape[0] // s) * -(-shape[1] // s) * shape[-2]
    set_bytes = probe[0].numel() + probe[1].numel() + out_numel
    copies = int(min(64, max(2, -(-L2_COLD_BYTES // set_bytes))))
    return [probe] + [neureka_case(torch, packing, ops, gen, dev, op, shape,
                                   bits) for _ in range(copies - 1)]


def time_neureka(torch, F, packing, ops, ref, nkc, qmm, dev, op, shape,
                 job, note=""):
    """One N-EUREKA job at 8 bits, inputs rotated over > 50 MB.  The
    library call is the same accumulation in f32 on pre-unpacked levels,
    without the requant: ``torch.matmul`` for pw1x1, ``F.conv2d`` (NCHW,
    ``groups=C`` for dw3x3) for the 3x3 operators.  ``note`` (the launch
    plan; a dw3x3 job prints the plan its timed launches took) is added
    to the printed work."""
    bits = 8
    gen = torch.Generator(device=dev).manual_seed(7)
    name, kernel, plain = neureka_pair(nkc, qmm, ref, op, shape, bits)
    sets = []
    for x, packed, mult, bias in cold_sets(torch, packing, ops, gen, dev, op,
                                           shape, bits):
        if op == "pw1x1":
            lib_args = (x.float(), packing.unpack(packed, bits,
                                                  shape[1]).float().T)
        elif op == "dense3x3":
            lib_args = (x.permute(2, 0, 1)[None].float(),
                        packing.unpack(packed, bits, shape[2]).float()
                        .permute(0, 3, 1, 2).contiguous())
        else:
            lib_args = (x.permute(2, 0, 1)[None].float(),
                        packing.unpack(packed, bits, 9).float()
                        .reshape(-1, 1, 3, 3))
        sets.append(((x, packed, mult, bias), lib_args))
    copies = len(sets)

    def library(i):
        a, w = sets[i % copies][1]
        if op == "pw1x1":
            torch.matmul(a, w)
        elif op == "dense3x3":
            F.conv2d(a, w, stride=shape[4], padding=1)
        else:
            F.conv2d(a, w, stride=shape[3], padding=1, groups=shape[2])

    res = time_versions(torch, lambda i: kernel(*sets[i % copies][0]),
                        lambda i: plain(*sets[i % copies][0]), library,
                        copies, 50)
    # the plan of the dw3x3 launches just timed (tools/neureka_ab.py also
    # times checkouts whose wrapper kept no plans)
    if op == "dw3x3" and getattr(nkc.conv3x3_dw, "plans", None):
        res["plan"] = nkc.conv3x3_dw.plans[-1]
        note = plan_text(res["plan"])
    x, packed, mult, _ = sets[0][0]
    out_numel = plain(*sets[0][0]).numel()
    if op == "pw1x1":
        macs = shape[0] * shape[1] * shape[2]
    elif op == "dense3x3":
        macs = out_numel * 9 * shape[2]
    else:
        macs = out_numel * 9
    nbytes = x.numel() + packed.numel() + 8 * mult.numel() + out_numel
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 2 * macs,
                                                INT8_OPS_PER_S)
    res["work"] = f"{job} {op} {shape} bits={bits}" + (
        f", {note}" if note else "")
    library_name = ("torch.matmul f32 on unpacked levels" if op == "pw1x1"
                    else "F.conv2d f32 on unpacked levels")
    print_times(f"{name} {res['work']}",
                f"{library_name}, no requant", res, nbytes, 2 * macs)
    return res


def plan_text(plan) -> str:
    """An ``Int8Plan`` as 'route, splits x kchunk K, blocks', a ``DwPlan``
    as 'vec B a thread, cg ch x tc x rows a block, route, blocks'."""
    if hasattr(plan, "route"):
        return (f"{plan.route}, {plan.splits} x {plan.kchunk} K, "
                f"{plan.blocks} blocks")
    return (f"{plan.vec} B a thread, {plan.cg} ch x "
            f"{plan.tc} x {plan.rows} rows a block, "
            f"{'staged' if plan.staged else 'direct'}, {plan.blocks} blocks")


# kernel-name fragments of the N-EUREKA kernels, as the profiler names them,
# and the kernel of each job's operator
PROFILE_KERNELS = (("qmm_int8", "qmatmul_int8"), ("dense3x3", "conv3x3_dense"),
                   ("dw3x3", "conv3x3_dw"))
OP_KERNEL = {"pw1x1": "qmatmul_int8", "dense3x3": "conv3x3_dense",
             "dw3x3": "conv3x3_dw"}


def profile_frames(torch, mnv2, qmm, frozen, frames, jobs, n: int = 4):
    """Device time of ``n`` eager frames by kernel and by job, and the
    device's idle share of the host window, from ``torch.profiler``.  One
    frame before them is traced and dropped (the schedule's warm-up step,
    one cycle), so that the tracer runs before the first kernel it counts.
    The k-th N-EUREKA kernel is job k mod len(jobs); the phase fails if its
    name is not that job's operator, or if the per-job times summed by
    operator differ from the per-kernel sums."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels.neureka_conv import conv3x3_dw

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n,
                                   repeat=1)) as prof:
        for i in range(n + 1):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            mnv2.apply(frozen, frames[i], weight_bits=8, img=MNV2_IMG)
            if i == n:
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
    # device events, without the schedule's own step annotations
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.name.startswith("ProfilerStep")),
                     key=lambda e: e.time_range.start)
    if not kernels:
        raise AssertionError("profile: no device events recorded over the "
                             f"{n} frames")
    by_kernel, by_job, others = {}, {}, {}
    busy, end = 0.0, -1.0
    nk = 0
    for e in kernels:
        t0_, t1_ = e.time_range.start, e.time_range.end
        busy += max(0.0, t1_ - max(t0_, end))
        end = max(end, t1_)
        label = next((lab for frag, lab in PROFILE_KERNELS if frag in e.name),
                     "other torch ops")
        by_kernel[label] = by_kernel.get(label, 0.0) + (t1_ - t0_) / n
        if label == "other torch ops":
            name = re.sub(r"void |at::native::|\(anonymous namespace\)::|"
                          r"std::array<[^>]*>", "", e.name)[:64]
            others[name] = others.get(name, 0.0) + (t1_ - t0_) / n
        else:
            job = jobs[nk % len(jobs)]
            if OP_KERNEL[job.op_kind] != label:
                raise AssertionError(
                    f"profile: N-EUREKA kernel {nk} is {e.name} ({label}), "
                    f"but job {job.name} runs {OP_KERNEL[job.op_kind]}")
            by_job[job.name] = by_job.get(job.name, 0.0) + (t1_ - t0_) / n
            nk += 1
    if nk != n * len(jobs):
        raise AssertionError(f"profile: {nk} N-EUREKA kernels in {n} frames, "
                             f"want {len(jobs)} a frame")
    by_op = {}
    for job in jobs:
        lab = OP_KERNEL[job.op_kind]
        by_op[lab] = by_op.get(lab, 0.0) + by_job[job.name]
    for lab, t in by_op.items():
        if abs(t - by_kernel[lab]) > 1e-6 * max(1.0, by_kernel[lab]):
            raise AssertionError(f"profile: {lab}'s jobs add up to {t:.3f} "
                                 f"us a frame, its kernels to "
                                 f"{by_kernel[lab]:.3f}")
    span = kernels[-1].time_range.end - kernels[0].time_range.start
    top = dict(sorted(((k, round(v, 2)) for k, v in others.items()),
                      key=lambda kv: -kv[1])[:4])
    res = dict(busy_us_per_frame=busy / n, wall_us_per_frame=wall_us / n,
               idle_share=1.0 - busy / wall_us, kernel_span_us=span / n,
               by_kernel_us=by_kernel, n_kernel_launches=nk,
               other_ops_us=top)
    index = frames.device.index
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device() if index is None else index
    ).multi_processor_count
    # the plans the last frame's depthwise launches took, in job order
    n_dw = sum(job.op_kind == "dw3x3" for job in jobs)
    dw_plans = iter(list(conv3x3_dw.plans)[-n_dw:])
    per_job = {}
    for job in jobs:
        entry = {"op": OP_KERNEL[job.op_kind],
                 "us": round(by_job[job.name], 3)}
        if job.op_kind == "pw1x1":
            entry["plan"] = plan_text(qmm.int8_plan(
                job.h * job.w, job.cin, job.cout, sms))
        elif job.op_kind == "dw3x3":
            entry["plan"] = plan_text(next(dw_plans))
        per_job[job.name] = entry
    res["by_job"] = per_job
    print(f"[frames] profiler over {n} eager frames (after one warm-up frame):"
          f" device busy {busy / n:.1f} us a frame of {wall_us / n:.1f} us on "
          f"the host clock (idle share {res['idle_share']:.3f}); by kernel "
          f"(us a frame) "
          f"{json.dumps({k: round(v, 2) for k, v in by_kernel.items()})}; "
          f"the largest other ops (us a frame) {json.dumps(top)}")
    print(f"[frames] device time by job at 8 bits (us a frame, job order; "
          f"summed by operator equal to the per-kernel sums): "
          f"{json.dumps(per_job)}")
    return res


def run_frames(torch, mnv2, nkc, qmm, dev):
    """Full-width MobileNet-V2 1.0-224 on the card: 16 frames at 8 bits
    with the launch counts checked, card vs CPU at 8, 4 and 2 bits."""
    t0 = time.perf_counter()
    params = mnv2.init_params(torch.Generator().manual_seed(0),
                              weight_bits=8, img=MNV2_IMG)
    frozen = mnv2.freeze_packed(params, weight_bits=8, img=MNV2_IMG)
    torch.cuda.synchronize()
    n_bytes = sum(leaf["packed"].numel() for leaf in frozen.values())
    print(f"[frames] MobileNet-V2 1.0-{MNV2_IMG}: {len(frozen)} N-EUREKA jobs,"
          f" init + freeze (8-bit, {n_bytes} packed weight bytes) "
          f"{time.perf_counter() - t0:.2f} s")
    # freezing on the card gives the CPU's packed bytes and biases; mult
    # is an f32 rms, summed in another order
    on_cpu = mnv2.freeze_packed(to_device(torch, params, "cpu"),
                                weight_bits=8, img=MNV2_IMG)
    mult_rel = 0.0
    for name, leaf in frozen.items():
        want = on_cpu[name]
        if not (torch.equal(leaf["packed"].cpu(), want["packed"])
                and torch.equal(leaf["bias"].cpu(), want["bias"])):
            raise AssertionError(f"{name}: packed weights frozen on the card"
                                 " differ from the CPU's")
        rel = ((leaf["mult"].cpu() - want["mult"]).abs()
               / want["mult"].abs()).max().item()
        mult_rel = max(mult_rel, rel)
    if mult_rel > 1e-6:
        raise AssertionError(f"mult frozen on the card: rel diff {mult_rel}")
    print(f"[frames] frozen on the card vs on the CPU: packed and bias equal, "
          f"mult max rel diff {mult_rel:.3e} (tolerance 1e-6)")
    gen = torch.Generator(device=dev).manual_seed(6)
    frames = torch.randint(0, 256, (MNV2_FRAMES, MNV2_IMG, MNV2_IMG, 3),
                           generator=gen, device=dev, dtype=torch.uint8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counters = {"conv3x3_dense": nkc.conv3x3_dense,
                "conv3x3_dw": nkc.conv3x3_dw, "qmatmul_int8": qmm.qmatmul_int8}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits = [mnv2.apply(frozen, frames[i], weight_bits=8, img=MNV2_IMG)
              for i in range(MNV2_FRAMES)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        if n != NEUREKA_PER_FRAME[name] * MNV2_FRAMES:
            raise AssertionError(f"{name} launched {n} times in "
                                 f"{MNV2_FRAMES} frames, want "
                                 f"{NEUREKA_PER_FRAME[name]} a frame")
    out = torch.stack(logits)
    if out.shape != (MNV2_FRAMES, 1000) or out.dtype != torch.uint8:
        raise AssertionError(f"logits {tuple(out.shape)} {out.dtype}")
    if not bool((out.max(1).values > out.min(1).values).all()):
        raise AssertionError("a frame's logits collapsed to one value")
    graph = graph_ms(torch, lambda i: mnv2.apply(
        frozen, frames[i], weight_bits=8, img=MNV2_IMG), 4)
    profile_frames(torch, mnv2, qmm, frozen, frames,
                   mnv2.job_list(8, MNV2_IMG))
    print(f"[frames] {MNV2_FRAMES} frames at 8 bits: eager wall {wall:.4f} s "
          f"after synchronize ({wall / MNV2_FRAMES * 1e3:.3f} ms a frame), "
          f"CUDA-graph replay {graph:.4f} ms a frame, peak memory "
          f"{peak / 2**20:.1f} MiB ({base / 2**20:.1f} MiB allocated at the "
          f"start), launches {launches}")

    # card vs CPU, same frozen weights: two frames at 8 bits, one each at
    # 4 and 2 bits
    checked = []
    for bits, idx in ((8, 0), (8, MNV2_FRAMES - 1), (4, 1), (2, 2)):
        tree = frozen if bits == 8 else mnv2.freeze_packed(
            params, weight_bits=bits, img=MNV2_IMG)
        card = (logits[idx] if bits == 8 else mnv2.apply(
            tree, frames[idx], weight_bits=bits, img=MNV2_IMG)).cpu()
        cpu = mnv2.apply(to_device(torch, tree, "cpu"), frames[idx].cpu(),
                         weight_bits=bits, img=MNV2_IMG)
        if not torch.equal(card, cpu):
            raise AssertionError(
                f"frame {idx} at {bits} bits: card and CPU logits differ in "
                f"{int((card != cpu).sum())} of 1000")
        checked.append(f"frame {idx} @ {bits} bits")
    print(f"[frames] card vs CPU plain path bit-equal: {', '.join(checked)}")
    return launches


# phase 9: the MoE family, qwen2-moe-a2.7b at full width (24 layers,
# d_model 2048, 60 experts top-4 of d_ff 1408, a shared expert of 5632,
# vocab 151,936, an untied head)
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_KERNELS = ("qmatmul_f32", "qmatmul_f32_grouped", "flash_attention")
# (K, N) of a layer's three expert linears
EXPERT_LINEARS = {"w_gate": (2048, 1408), "w_up": (2048, 1408),
                  "w_down": (1408, 2048)}
# (E, C, K, N, bits) of the grouped kernel's checks: the expert linears at
# decode (C 8: 4 slots, top-4 of 60, factor 1.25) and at the prefill
# capacities of 16-256 token prompts (C 16, 24), a ragged C on each route,
# one expert on each route, and bits 4 and 2
GROUPED_CASES = ([(60, c, k, n, 8) for c in (8, 16, 24)
                  for k, n in ((2048, 1408), (1408, 2048))]
                 + [(60, 13, 2048, 1408, 8), (60, 40, 1408, 2048, 8),
                    (1, 8, 2048, 1408, 8), (1, 24, 1408, 2048, 8),
                    (60, 8, 2048, 1408, 4), (60, 24, 1408, 2048, 4),
                    (60, 8, 1408, 2048, 2), (60, 24, 2048, 1408, 2)])


def moe_tree(torch, m, cfg, dev):
    """``cfg``'s packed tree with random weights from a CUDA generator
    seeded 0, drawn and frozen at 8 bits one layer at a time into stacked
    leaves allocated once: the f32 tree (~57 GB for qwen2-moe-a2.7b) never
    exists whole."""
    tfm, freeze = m["tfm"], m["freeze"]
    gen = torch.Generator(device=dev).manual_seed(0)
    # the embedding, head and final norm, and no layer
    tree = tfm.init_params(cfg.replace(n_layers=0), generator=gen)
    one = cfg.replace(n_layers=1, vocab_size=8)

    def stack(t):
        if isinstance(t, dict):
            return {k: stack(v) for k, v in t.items()}
        return t.new_empty((cfg.n_layers,) + tuple(t.shape[1:]))

    def put(dst, src, i):
        if isinstance(src, dict):
            for k, v in src.items():
                put(dst[k], v, i)
        else:
            dst[i].copy_(src[0])

    layers = None
    for i in range(cfg.n_layers):
        layer = freeze(tfm.init_params(one, generator=gen), bits=8)["layers"]
        if layers is None:
            layers = stack(layer)
        put(layers, layer, i)
        del layer
    tree["layers"] = layers
    return tree


def check_grouped(torch, ops, ref, qmm, dev) -> float:
    """The grouped ``qmatmul_f32`` against its plain version at
    ``GROUPED_CASES``, within QMM_TOL; every seventh expert gets no rows
    (zero x, as dispatch leaves an unrouted expert) and must give zeros, and
    two calls must give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0
    for e, c, k, n, bits in GROUPED_CASES:
        packed, scale = expert_weights(torch, ops, gen, dev, e, k, n, bits)
        x = torch.randn((e, c, k), generator=gen, device=dev)
        x[1::7] = 0.0
        got = qmm.qmatmul_f32_grouped(x, packed, scale, bits=bits, k_orig=k)
        again = qmm.qmatmul_f32_grouped(x, packed, scale, bits=bits,
                                        k_orig=k)
        expect = ref.qmatmul_f32_grouped(x, packed, scale, bits=bits,
                                         k_orig=k)
        torch.cuda.synchronize()
        err = (got - expect).abs().max().item()
        worst = max(worst, err)
        what = f"E={e} C={c} K={k} N={n} bits={bits}"
        if not torch.allclose(got, expect, **QMM_TOL):
            raise AssertionError(f"qmatmul_f32_grouped {what}: max abs err "
                                 f"{err}")
        if not torch.equal(again, got):
            raise AssertionError(f"qmatmul_f32_grouped {what}: two calls "
                                 "give different bits")
        if got[1::7].any():
            raise AssertionError(f"qmatmul_f32_grouped {what}: an expert "
                                 "with no rows gave non-zeros")
        del packed, scale, x, got, again, expect
    torch.cuda.empty_cache()
    print(f"[check] qmatmul_f32_grouped vs plain at {len(GROUPED_CASES)} "
          f"(E, C, K, N, bits) cases {GROUPED_CASES}: max abs err "
          f"{worst:.3e} (tolerance {QMM_TOL}), two calls bit-equal, "
          "experts with no rows give zeros")
    return worst


def time_grouped(torch, packing, ops, ref, qmm, dev, c: int, bits: int = 8,
                 copies: int = 2):
    """One qwen2-moe-a2.7b layer's three expert linears grouped over its 60
    experts at capacity ``c``, over ``copies`` layer copies (519 MB of 8-bit
    levels each, > the 50 MB L2), beside the plain version and torch.bmm on
    pre-dequantised f32 weights."""
    gen = torch.Generator(device=dev).manual_seed(12)
    layers = []
    for _ in range(copies):
        layer = []
        for k, n in EXPERT_LINEARS.values():
            packed, scale = expert_weights(torch, ops, gen, dev, 60, k, n,
                                           bits)
            x = torch.randn((60, c, k), generator=gen, device=dev)
            deq = packing.unpack(packed, bits, k).float() * scale[..., None]
            layer.append((x, packed, scale, k, deq))
        layers.append(layer)

    def kernel(i):
        for x, p, s, k, _ in layers[i % copies]:
            qmm.qmatmul_f32_grouped(x, p, s, bits=bits, k_orig=k)

    def plain(i):
        for x, p, s, k, _ in layers[i % copies]:
            ref.qmatmul_f32_grouped(x, p, s, bits=bits, k_orig=k)

    def library(i):
        for x, _, _, _, deq in layers[i % copies]:
            torch.bmm(x, deq.transpose(1, 2))

    res = time_versions(torch, kernel, plain, library, copies, 20)
    nbytes = sum(x.numel() * 4 + p.numel() + s.numel() * 4
                 + x.shape[0] * c * p.shape[1] * 4
                 for x, p, s, _, _ in layers[0])
    flops = sum(2 * 60 * c * n * k for k, n in EXPERT_LINEARS.values())
    route_bound(res, nbytes, flops, 2)
    res["work"] = (f"qmatmul_f32_grouped, one layer's 3 expert linears "
                   f"{list(EXPERT_LINEARS)}, E=60, C={c}, {bits}-bit")
    print_times(f"qmatmul_f32_grouped {MOE_ARCH} layer x3 E=60 C={c} "
                f"bits={bits}", "torch.bmm on pre-dequantised f32", res,
                nbytes, flops)
    del layers
    torch.cuda.empty_cache()
    return res


def serve_moe_phase(torch, m, cfg, dev):
    """Phase 9: the grouped kernel checked and timed, then qwen2-moe-a2.7b
    served at full width (``serve_lm``: 8 requests, the grouped and plain
    B1 and B2 counters zeroed before and grown after, every distinct call
    of the profiled serve held against its plain version, and the first 2
    layers' logits card vs CPU within LOGITS_TOL)."""
    err = check_grouped(torch, m["ops"], m["ref"], m["qmm"], dev)
    times = {c: time_grouped(torch, m["packing"], m["ops"], m["ref"],
                             m["qmm"], dev, c) for c in (8, 24)}
    gc.collect()
    torch.cuda.empty_cache()
    counters = {"qmatmul_f32": m["qmm"].qmatmul_f32,
                "qmatmul_f32_grouped": m["qmm"].qmatmul_f32_grouped,
                "flash_attention": m["fa"].flash_attention}
    served, tree = serve_lm(torch, m, cfg, 512, False, counters, 2, dev,
                            make_tree=lambda: moe_tree(torch, m, cfg, dev),
                            logits_tol=LOGITS_TOL)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    return served, err, times


def to_device(torch, tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(torch, v, dev) for k, v in tree.items()}
    return tree.to(dev)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import memsys, packing, paging, placement
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.weight_store import PackedParam
    from repro_torch.core.perf_model import mobilenet_v2_jobs
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import neureka_conv as nkc
    from repro_torch.kernels import qmatmul as qmm
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.models import mobilenet_v2 as mnv2
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import freeze_for_serving
    from repro_torch import serving
    from repro_torch.serving import trace
    from repro_torch.serving.engine import Request, ServingEngine

    # 1. set-up
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"[card] {card}  torch {torch.__version__} cuda {torch.version.cuda}"
          f"  devices {torch.cuda.device_count()}")
    phase_build(build)

    # 2. kernels against their plain versions, then timed
    qmm_err = check_qmatmul(torch, ops, ref, qmm, dev)
    fa_err = check_flash(torch, ref, fa, dev)
    t_dec = time_qmatmul(torch, packing, ops, ref, qmm, dev, m=4)
    t_pre = time_qmatmul(torch, packing, ops, ref, qmm, dev, m=256)
    t_falcon_dec, t_falcon = (
        time_qmatmul(torch, packing, ops, ref, qmm, dev, m=m, copies=2,
                     linears=FALCON_LINEARS,
                     what="qmatmul_f32 falcon-mamba-7b layer x4")
        for m in (4, 256))
    t_fa = {which: time_flash(torch, F, ref, fa, dev, which)
            for which in FLASH_TIMED}
    jobs = {j.name: j for j in mobilenet_v2_jobs(8, MNV2_IMG)}
    nk_err = check_neureka(torch, packing, ops, ref, nkc, qmm, dev,
                           list(jobs.values()))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {name: qmm.int8_plan(*job_key(jobs[name])[1], sms)
             for name in NEUREKA_TIMED if jobs[name].op_kind == "pw1x1"}
    t_nk = {name: time_neureka(torch, F, packing, ops, ref, nkc, qmm, dev,
                               *job_key(jobs[name]), name,
                               plan_text(plans[name]) if name in plans
                               else "")
            for name in NEUREKA_TIMED}
    for name, plan in plans.items():
        t_nk[name].update(plan=plan._asdict(), launch_route=plan.route)
    for t in t_nk.values():
        if "plan" in t and not isinstance(t["plan"], dict):
            t["plan"] = t["plan"]._asdict()
    scan_err = check_scan(torch, ref, ssm, dev)
    t_scan = {which: time_scan(torch, ref, ssm, dev, which)
              for which in SCAN_TIMED}
    gc.collect()                  # drop the timing graphs and their pools
    torch.cuda.empty_cache()

    # 3-4. serve full-width qwen3-0.6b, falcon-mamba-7b and hymba-1.5b,
    # each with its card-vs-CPU logits check
    mods = dict(np=np, tfm=tfm, freeze=freeze_for_serving, Request=Request,
                ServingEngine=ServingEngine, ops=ops, ref=ref, qmm=qmm, fa=fa,
                ssm=ssm)
    counters = {"qmatmul_f32": qmm.qmatmul_f32,
                "flash_attention": fa.flash_attention,
                "selective_scan": ssm.selective_scan}
    served = {}
    for arch, max_len, long_prompt, depth in SERVE_PATHS:
        served[arch], tree = serve_lm(torch, mods, get_config(arch), max_len,
                                      long_prompt, counters, depth, dev)
        if arch == XR_ARCH:
            xr_tree = tree               # phases 7 and 8 serve it again
        if arch == TENANTS[1]:
            falcon_tree = tree           # phase 8's second tenant
        del tree
        gc.collect()
        torch.cuda.empty_cache()
    launches = {name: sum(s["launches"][name] for s in served.values())
                for name in counters}
    qmm_err, fa_err, scan_err = (
        max([err] + [s["path_check"]["max_abs_err"][name]
                     for s in served.values()])
        for err, name in ((qmm_err, "qmatmul_f32"),
                          (fa_err, "flash_attention"),
                          (scan_err, "selective_scan")))

    # 5. MobileNet-V2 1.0-224 frames on the N-EUREKA kernels
    gc.collect()
    torch.cuda.empty_cache()
    nk_launches = run_frames(torch, mnv2, nkc, qmm, dev)

    # 6. paged serving: qwen3-0.6b at 4 bits, the cold half wire-served
    gc.collect()
    torch.cuda.empty_cache()
    mods.update(placement=placement, paging=paging, packing=packing,
                PackedParam=PackedParam, FaultPlan=FaultPlan)
    paged, bs_err, t_bs, paged_store = serve_paged(
        torch, mods, get_config(PAGED_ARCH), dev)
    served[f"{PAGED_ARCH} paged"] = paged
    for name in ("qmatmul_f32", "flash_attention"):
        launches[name] += paged["launches"][name]
    qmm_err = max(qmm_err, paged["path_check"]["max_abs_err"]["qmatmul_f32"])
    fa_err = max(fa_err,
                 paged["path_check"]["max_abs_err"]["flash_attention"])

    # 7. the scheduled XR serve, resident and paged
    gc.collect()
    torch.cuda.empty_cache()
    mods.update(serving=serving, trace=trace)
    xr = serve_xr_phase(torch, mods, get_config(XR_ARCH), xr_tree,
                        paged_store, dev)
    del paged_store
    served[f"{XR_ARCH} xr"] = xr
    for name in ("qmatmul_f32", "flash_attention"):
        launches[name] += xr["launches"][name]
    qmm_err = max(qmm_err, xr["path_check"]["max_abs_err"]["qmatmul_f32"])
    fa_err = max(fa_err, xr["path_check"]["max_abs_err"]["flash_attention"])
    bs_err = max(bs_err,
                 xr["path_check"]["max_abs_err"]["qmatmul_f32_blockscale"])

    # 8. KV paging and tenancy over one page pool
    gc.collect()
    torch.cuda.empty_cache()
    mods.update(memsys=memsys)
    kvt = serve_kv_tenancy_phase(
        torch, mods, {name: get_config(name) for name in TENANTS},
        {TENANTS[0]: xr_tree, TENANTS[1]: falcon_tree}, dev)
    del xr_tree, falcon_tree
    for path, part in ((f"{TENANTS[0]} kv-paged", "kv"),
                       (f"{'+'.join(TENANTS)} tenancy", "tenancy")):
        served[path] = kvt[part]
        for name in KV_KERNELS:
            launches[name] += kvt[part]["launches"][name]
    qmm_err, fa_err, scan_err = (
        max(err, kvt["path_check"]["max_abs_err"][name])
        for err, name in ((qmm_err, "qmatmul_f32"),
                          (fa_err, "flash_attention"),
                          (scan_err, "selective_scan")))
    b3_by_path = {f"{PAGED_ARCH} paged":
                  paged["launches"]["qmatmul_f32_blockscale"],
                  f"{XR_ARCH} xr": xr["launches"]["qmatmul_f32_blockscale"]}

    # 9. the MoE family: qwen2-moe-a2.7b, its experts on the grouped kernel
    gc.collect()
    torch.cuda.empty_cache()
    moe, grouped_err, t_grouped = serve_moe_phase(
        torch, mods, get_config(MOE_ARCH), dev)
    served[MOE_ARCH] = moe
    for name in ("qmatmul_f32", "flash_attention"):
        launches[name] += moe["launches"][name]
    qmm_err, fa_err = (max(err, moe["path_check"]["max_abs_err"][name])
                       for err, name in ((qmm_err, "qmatmul_f32"),
                                         (fa_err, "flash_attention")))
    grouped_err = max(grouped_err, moe["path_check"]["max_abs_err"][
        "qmatmul_f32_grouped"])

    # 10. result lines
    by_path = {name: {arch: s["launches"][name] for arch, s in served.items()
                      if name in s["launches"]}
               for name in counters}
    by_class = {name: {arch: s["launches_by_class"][name]
                       for arch, s in served.items()
                       if s["launches_by_class"].get(name)}
                for name in SPLIT_LAUNCHES}
    kernels = [
        dict(name="qmatmul_f32", route="cuda",
             source="src/repro_torch/csrc/qmatmul_f32.cu",
             replaces="src/repro/kernels/qmatmul.py:132",
             launches=launches["qmatmul_f32"],
             launches_by_path=by_path["qmatmul_f32"], max_abs_err=qmm_err,
             ms=t_dec["ms"], plain_ms=t_dec["plain_ms"],
             bound_ms=t_dec["bound_ms"], bound_by=t_dec["bound_by"],
             library_ms=t_dec["library_ms"], eager_ms=t_dec["eager_ms"],
             work="one layer's 7 packed linears, decode M=4, 8-bit",
             bytes_ms=t_dec["bytes_ms"], tf32_ops_ms=t_dec["tf32_ops_ms"],
             bound_f32_ms=t_dec["bound_f32_ms"],
             decode_falcon_M4=t_falcon_dec, prefill_M256=t_pre,
             prefill_falcon_M256=t_falcon),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:71",
             launches=launches["flash_attention"],
             launches_by_path=by_path["flash_attention"],
             launches_by_shape=by_class["flash_attention"],
             max_abs_err=fa_err, ms=t_fa["qwen3"]["ms"],
             plain_ms=t_fa["qwen3"]["plain_ms"],
             bound_ms=t_fa["qwen3"]["bound_ms"],
             bound_by=t_fa["qwen3"]["bound_by"],
             library_ms=t_fa["qwen3"]["library_ms"],
             eager_ms=t_fa["qwen3"]["eager_ms"], work=t_fa["qwen3"]["work"],
             bytes_ms=t_fa["qwen3"]["bytes_ms"],
             tf32_ops_ms=t_fa["qwen3"]["tf32_ops_ms"],
             bound_f32_ms=t_fa["qwen3"]["bound_f32_ms"],
             hymba=t_fa["hymba"]),
    ]
    for name, source, replaces, timed in (
            ("qmatmul_int8", "qmatmul_int8.cu", "qmatmul.py:218",
             "b1.pw_exp"),
            ("conv3x3_dense", "neureka_conv.cu", "neureka_conv.py:80",
             "conv0"),
            ("conv3x3_dw", "neureka_conv.cu", "neureka_conv.py:153",
             "b1.dw")):
        t = t_nk[timed]
        entry = dict(name=name, route="cuda",
                     source=f"src/repro_torch/csrc/{source}",
                     replaces=f"src/repro/kernels/{replaces}",
                     launches=nk_launches[name],
                     launches_per_frame=nk_launches[name] / MNV2_FRAMES,
                     max_abs_err=nk_err[name], ms=t["ms"],
                     plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                     bound_by=t["bound_by"], library_ms=t["library_ms"],
                     eager_ms=t["eager_ms"], work=t["work"])
        if name == "qmatmul_int8":
            entry.update(launch_route=t["launch_route"], plan=t["plan"],
                         b14_pw_proj=t_nk["b14.pw_proj"],
                         conv_last=t_nk["conv_last"], fc=t_nk["fc"])
        if name == "conv3x3_dw":
            entry.update(plan=t["plan"], b0_dw=t_nk["b0.dw"],
                         b14_dw=t_nk["b14.dw"])
        kernels.append(entry)
    t = t_scan["falcon_prefill"]
    kernels.append(dict(
        name="selective_scan", route="cuda",
        source="src/repro_torch/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:64",
        launches=launches["selective_scan"],
        launches_by_path=by_path["selective_scan"],
        launches_by_route=by_class["selective_scan"], max_abs_err=scan_err,
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None,
        library_note="no single PyTorch call computes a selective scan",
        eager_ms=t["eager_ms"], work=t["work"],
        **{k: v for k, v in t_scan.items() if k != "falcon_prefill"}))
    t = t_grouped[8]
    kernels.append(dict(
        name="qmatmul_f32_grouped", route="cuda",
        source="src/repro_torch/csrc/qmatmul_f32.cu",
        replaces="src/repro/kernels/qmatmul.py:132",
        replaces_note="qmatmul_f32 vmapped over the experts by "
        "src/repro/models/moe.py:97-106: one Pallas launch whose grid "
        "gains the expert axis",
        launches=moe["launches"]["qmatmul_f32_grouped"],
        launches_by_path={MOE_ARCH: moe["launches"]["qmatmul_f32_grouped"]},
        max_abs_err=grouped_err, ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], eager_ms=t["eager_ms"], work=t["work"],
        bytes_ms=t["bytes_ms"], tf32_ops_ms=t["tf32_ops_ms"],
        bound_f32_ms=t["bound_f32_ms"], prefill_C24=t_grouped[24]))
    t = t_bs["decode"]
    kernels.append(dict(
        name="qmatmul_f32_blockscale", route="cuda",
        source="src/repro_torch/csrc/qmatmul_blockscale.cu",
        replaces="src/repro/kernels/qmatmul.py:170",
        launches=sum(b3_by_path.values()), launches_by_path=b3_by_path,
        max_abs_err=bs_err, ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], eager_ms=t["eager_ms"], work=t["work"],
        bytes_ms=t["bytes_ms"], tf32_ops_ms=t["tf32_ops_ms"],
        bound_f32_ms=t["bound_f32_ms"], prefill_M256=t_bs["prefill"]))
    print(json.dumps({"serve": served}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
