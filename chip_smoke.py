#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

It drives the port's main path once at the full width of qwen3-0.6b and
fails (non-zero exit, no result line) if any phase fails:

1. set-up: requires a CUDA device, turns TF32 off, prints the card's name
   and power limit, builds every ``csrc/*.cu`` with nvcc for sm_90a and
   prints what ptxas reports for each kernel;
2. each Hopper kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, within the stated tolerances; then
   each timed with CUDA events (L2-cold: inputs rotate over more than the
   50 MB L2) beside its plain version, one PyTorch library call for the
   same function, and its bound (bytes over 3.35 TB/s or f32 flops over
   67 TFLOP/s, whichever is larger).  Device times replay a CUDA graph of
   the calls, so the host's launch gaps drop out; the same calls enqueued
   eagerly from Python are printed beside them;
3. serving: full-width qwen3-0.6b (28 layers, d_model 1024, vocab 151936)
   with random weights from a seeded ``torch.Generator``, frozen at 8 bits,
   ``ServingEngine(batch_slots=4, max_len=512)`` on the card answering 8
   greedy requests (prompts of 16-256 tokens, 16 new tokens each); both
   kernels' launch counters must grow during it;
4. card vs CPU: ``forward`` logits of one 64-token sequence with the same
   packed weights on the card (kernels) and on the CPU (plain versions);
5. the ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import functools
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores

QMM_TOL = dict(rtol=1e-4, atol=1e-4)      # f32 accumulate, reordered sums
FLASH_TOL = dict(rtol=3e-5, atol=3e-5)    # the reference kernel test's
LOGITS_TOL = dict(rtol=1e-3, atol=1e-3)   # 28 f32 layers, card vs CPU order

# (K, N) of each packed linear of a qwen3-0.6b layer
LAYER_LINEARS = {"wq": (1024, 2048), "wk": (1024, 1024), "wv": (1024, 1024),
                 "wo": (2048, 1024), "w_gate": (1024, 3072),
                 "w_up": (1024, 3072), "w_down": (3072, 1024)}


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
    dev = [graph_ms(torch, f, n_sets) for f in fns]
    eager = [cuda_ms(torch, f, eager_iters) for f in fns]
    torch.cuda.empty_cache()
    return dict(ms=min(dev[0], dev[3]), ms_runs=[dev[0], dev[3]],
                plain_ms=dev[1], library_ms=dev[2],
                eager_ms=min(eager[0], eager[3]), eager_plain_ms=eager[1],
                eager_library_ms=eager[2])


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build(build):
    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] nvcc sm_90a, {time.perf_counter() - t0:.2f} s")
    for name, report in build.ptxas_reports().items():
        for line in report.splitlines():
            if "Compiling entry function" in line or "Used" in line \
                    or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")


def check_qmatmul(torch, ops, ref, qmm, dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    cases = [(bits, m, k, n) for bits in (8, 4, 2) for m in (4, 256)
             for k, n in sorted(set(LAYER_LINEARS.values()))]
    cases += [(bits, m, 1001, 515) for bits in (8, 4, 2) for m in (7, 37)]
    for bits, m, k, n in cases:
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
        packed, scale = ops.prep_linear(w, bits)
        got = qmm.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k)
        expect = ref.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k)
        torch.cuda.synchronize()
        err = (got - expect).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(got, expect, **QMM_TOL):
            raise AssertionError(f"qmatmul_f32 bits={bits} M={m} K={k} N={n}:"
                                 f" max abs err {err}")
    print(f"[check] qmatmul_f32: {len(cases)} cases (bits 8/4/2, M 4/256 at "
          f"the layer shapes, ragged K=1001), max abs err {worst:.3e}, "
          f"tolerance {QMM_TOL}")
    return worst


FLASH_CASES = [
    # b, hq, hkv, sq, sk, d, window, per-row q_offset (None: sk - sq)
    (4, 16, 8, 64, 512, 128, None, (0, 64, 192, 448)),
    (4, 16, 8, 16, 256, 128, None, (3, 40, 77, 240)),
    (4, 16, 8, 64, 64, 128, None, None),
    (4, 16, 8, 64, 512, 128, 96, (0, 100, 300, 448)),
]


def check_flash(torch, ref, fa, dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for b, hq, hkv, sq, sk, d, window, offs in FLASH_CASES:
        q = torch.randn((b, hq, sq, d), generator=gen, device=dev)
        k = torch.randn((b, hkv, sk, d), generator=gen, device=dev)
        v = torch.randn((b, hkv, sk, d), generator=gen, device=dev)
        off = None if offs is None else torch.tensor(offs, dtype=torch.int32,
                                                     device=dev)
        got = fa.flash_attention(q, k, v, causal=True, window=window,
                                 q_offset=off)
        expect = ref.flash_attention(q, k, v, causal=True, window=window,
                                     q_offset=off)
        torch.cuda.synchronize()
        err = (got - expect).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(got, expect, **FLASH_TOL):
            raise AssertionError(f"flash_attention case {(b, hq, hkv, sq, sk, d, window, offs)}:"
                                 f" max abs err {err}")
    print(f"[check] flash_attention: {len(FLASH_CASES)} cases (GQA 16/8, "
          f"per-row q_offset, causal, one windowed), max abs err "
          f"{worst:.3e}, tolerance {FLASH_TOL}")
    return worst


def time_qmatmul(torch, packing, ops, ref, qmm, dev, m: int,
                 bits: int = 8, copies: int = 8):
    """One layer's seven packed linears at M rows, over ``copies`` layer
    copies (8 x 15.7 MB of 8-bit weights > the 50 MB L2)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    layers = []
    for _ in range(copies):
        layer = []
        for k, n in LAYER_LINEARS.values():
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
                                                    LAYER_LINEARS.values()))
    flops = sum(2 * m * n * k for k, n in LAYER_LINEARS.values())
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops)
    print_times(f"qmatmul_f32 layer x7 M={m} bits={bits}",
                "torch.matmul on pre-dequantised f32", res, nbytes, flops)
    return res


def time_flash(torch, F, ref, fa, dev, copies: int = 4):
    """The main prefill shape: 4 rows x 16/8 heads, a 64-query chunk over a
    512-row kv span at per-row offsets; k/v rotate over 4 x 16.8 MB."""
    b, hq, hkv, sq, sk, d, window, offs = FLASH_CASES[0]
    gen = torch.Generator(device=dev).manual_seed(4)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    qpos = off[:, None] + torch.arange(sq, device=dev)
    mask = (torch.arange(sk, device=dev)[None, None] <= qpos[..., None])
    sets = []
    for _ in range(copies):
        q = torch.randn((b, hq, sq, d), generator=gen, device=dev)
        k = torch.randn((b, hkv, sk, d), generator=gen, device=dev)
        v = torch.randn((b, hkv, sk, d), generator=gen, device=dev)
        # the library call takes equal head counts: expand outside timing
        ke = k.repeat_interleave(hq // hkv, dim=1)
        ve = v.repeat_interleave(hq // hkv, dim=1)
        sets.append((q, k, v, ke, ve))

    def kernel(i):
        q, k, v, _, _ = sets[i % copies]
        fa.flash_attention(q, k, v, causal=True, q_offset=off)

    def plain(i):
        q, k, v, _, _ = sets[i % copies]
        ref.flash_attention(q, k, v, causal=True, q_offset=off)

    def library(i):
        q, _, _, ke, ve = sets[i % copies]
        F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask[:, None])

    res = time_versions(torch, kernel, plain, library, copies, 50)
    # what this run's data needs: keys up to each row's causal frontier
    keys = [min(sk, o + sq) for o in offs]
    pairs = sum(min(sk, o + i + 1) for o in offs for i in range(sq)) * hq
    nbytes = (2 * b * hq * sq * d * 4 + b * 4
              + sum(2 * hkv * kk * d * 4 for kk in keys))
    flops = 4 * d * pairs
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops)
    print_times(f"flash_attention B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} "
                f"D={d} offsets={offs}",
                "F.scaled_dot_product_attention, same mask", res, nbytes,
                flops)
    return res


def print_times(what: str, library: str, res, nbytes: int, flops: int):
    print(f"[time] {what}: device (graph replay) kernel_ms "
          f"{res['ms_runs'][0]:.4f}/{res['ms_runs'][1]:.4f} plain_ms "
          f"{res['plain_ms']:.4f} library_ms ({library}) "
          f"{res['library_ms']:.4f}; eager kernel_ms {res['eager_ms']:.4f} "
          f"plain_ms {res['eager_plain_ms']:.4f} library_ms "
          f"{res['eager_library_ms']:.4f}; bound_ms {res['bound_ms']:.4f} "
          f"({res['bound_by']}; {nbytes} B, {flops} flop)")


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
    from repro_torch.core import packing
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import qmatmul as qmm
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import freeze_for_serving
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
    t_fa = time_flash(torch, F, ref, fa, dev)
    gc.collect()                  # drop the timing graphs and their pools
    torch.cuda.empty_cache()

    # 3. serve full-width qwen3-0.6b
    cfg = get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    packed = freeze_for_serving(params, bits=8)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model},"
          f" vocab {cfg.vocab_size}; init + freeze (8-bit) "
          f"{time.perf_counter() - t0:.2f} s")
    eng = ServingEngine(cfg, packed, batch_slots=4, max_len=512)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 257, 8)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), max_new_tokens=16)
            for i, n in enumerate(lens)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    qmm.qmatmul_f32.launches = 0
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"qmatmul_f32": qmm.qmatmul_f32.launches,
                "flash_attention": fa.flash_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    new_tokens = sum(len(r.generated) for r in done)
    ttft = [r.first_token_s - r.arrival_s for r in done]
    if len(done) != 8 or any(len(r.generated) != 16 for r in done):
        raise AssertionError("not every request got its 16 tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("token id out of the vocabulary")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched while serving")
    print(f"[serve] {len(done)} requests, prompts {lens.tolist()} "
          f"({int(lens.sum())} prompt tokens), {new_tokens} new tokens, wall "
          f"{wall:.3f} s after synchronize, TTFT mean {np.mean(ttft):.3f} s "
          f"max {np.max(ttft):.3f} s, peak memory {peak / 2**30:.3f} GiB "
          f"({base / 2**30:.3f} GiB allocated at the start), "
          f"launches {launches}")

    # 4. card vs CPU logits with the same packed weights
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64)))
    gpu_logits = tfm.forward(packed, toks.to(dev), cfg).cpu()
    cpu_logits = tfm.forward(to_device(torch, packed, "cpu"), toks, cfg)
    logit_err = (gpu_logits - cpu_logits).abs().max().item()
    top1 = (gpu_logits.argmax(-1) == cpu_logits.argmax(-1)).float().mean()
    if not (torch.isfinite(gpu_logits).all()
            and gpu_logits.shape == (1, 64, cfg.vocab_size)):
        raise AssertionError("card logits are not finite or misshapen")
    if not torch.allclose(gpu_logits, cpu_logits, **LOGITS_TOL):
        raise AssertionError(f"card vs CPU logits: max abs err {logit_err}")
    print(f"[forward] 64 tokens card vs CPU: max abs err {logit_err:.3e} "
          f"(tolerance {LOGITS_TOL}), top-1 agreement {top1.item():.4f}, "
          f"max |logit| {cpu_logits.abs().max().item():.3f}")

    # 5. result lines
    kernels = [
        dict(name="qmatmul_f32", route="cuda",
             source="src/repro_torch/csrc/qmatmul_f32.cu",
             replaces="src/repro/kernels/qmatmul.py:132",
             launches=launches["qmatmul_f32"], max_abs_err=qmm_err,
             ms=t_dec["ms"], plain_ms=t_dec["plain_ms"],
             bound_ms=t_dec["bound_ms"], bound_by=t_dec["bound_by"],
             library_ms=t_dec["library_ms"], eager_ms=t_dec["eager_ms"],
             work="one layer's 7 packed linears, decode M=4, 8-bit",
             prefill_M256=t_pre),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:71",
             launches=launches["flash_attention"], max_abs_err=fa_err,
             ms=t_fa["ms"], plain_ms=t_fa["plain_ms"],
             bound_ms=t_fa["bound_ms"], bound_by=t_fa["bound_by"],
             library_ms=t_fa["library_ms"], eager_ms=t_fa["eager_ms"],
             work="prefill chunk B=4 Hq=16 Hkv=8 Sq=64 Sk=512 D=128"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
