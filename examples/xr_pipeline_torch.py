"""The paper's XR workload on the PyTorch port: a heterogeneous frame
pipeline beside two tenant models (the counterpart of
``examples/xr_pipeline.py``).

Per camera frame (the paper's >30 FPS visual loop):
  DSP path (RISC-V cluster analogue):  lens distortion correction ->
  N-EUREKA path:                       int8 MobileNet-V2 from the packed
                                       At-MRAM store (the Hopper N-EUREKA
                                       kernels on the card) ->
  DSP path:                            FFT post-processing on a sensor
                                       channel + k-means gesture clustering

and one tenancy tick a frame: a KV-paged assistant LM (qwen3-0.6b) and an
SSM tracker (falcon-mamba-7b) share ONE ``MultiScheduler`` and ONE
``SharedPagePool`` at 0.6 of their cold bytes, with a global token budget,
preemption, and an urgent wake-word request at tick 2 that must preempt a
busy assistant slot.  Each tenant's tokens must equal its solo run on a
private pager, the pool's counters the ``kv_pass_counters`` replay of its
event log (weights and KV), and the trace must validate.  The frame budget
is checked against the memsys model's L1MRAM walk (>30 FPS).

Run:  PYTHONPATH=src python examples/xr_pipeline_torch.py [--device cpu]
          [--img N] [--full] [--trace-json PATH]

It runs on the CUDA card unless ``--device cpu`` asks for the CPU.
``--img`` defaults to 64 on the CPU (the reference's reduced frame) and
224 on the card; ``--full`` serves the tenants at their configs' full
widths instead of the reduced (smoke) configs.  It prints "xr_pipeline OK"
and ``main`` returns the run's readings.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.paging import (SharedPagePool, kv_pass_counters,
                                     page_sizes)
from repro_torch.core.perf_model import mnv2_scenario_table
from repro_torch.core.placement import packed_sizes, plan_for_budget
from repro_torch.models import mobilenet_v2 as mnv2
from repro_torch.models import transformer as tfm
from repro_torch.parallel.sharding import freeze_for_serving
from repro_torch.serving import (MultiScheduler, Request, Scheduler,
                                 ServingEngine, Tracer, validate)
from repro_torch.serving.trace import validate as validate_trace

IMG_CPU, IMG_CARD = 64, 224
N_FRAMES = 5
# the tenants' traffic (requests, prompt length, new tokens) and seeds
TRAFFIC = {"assistant": (3, 20, 4), "tracker": (4, 6, 2)}
TENANT_ARCHS = {"assistant": ("qwen3-0.6b", 1),
                "tracker": ("falcon-mamba-7b", 2)}
WAKE_AT_TICK = 2
# gestures against another FFT (XLA's, or cuFFT against pocketfft): the
# centres are f32 means over an f32 spectrum whose last bits differ; the
# worst relative drift from XLA's over 200 seeded 1000-bin vectors is
# 3.1e-7
GESTURE_RTOL = 1e-5


def expect(cond, what: str) -> None:
    """An assert that ``python -O`` keeps."""
    if not cond:
        raise AssertionError(what)


def lens_grid(n: int, device) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n)`` as the reference computes it (f32): the
    step ``i / (n - 1)`` is a multiply by the rounded reciprocal (XLA's
    rewrite of a division by a constant inside ``jit``), then
    ``-1 * (1 - step) + 1 * step`` and the exact endpoint.
    ``torch.linspace`` gives other last bits."""
    f32 = dict(dtype=torch.float32, device=device)
    if n == 1:
        return torch.full((1,), -1.0, **f32)
    # tensor / tensor: a true f32 division on either device
    recip = torch.tensor(1.0, **f32) / torch.tensor(float(n - 1), **f32)
    step = torch.arange(n - 1, **f32) * recip
    out = step - (1 - step)
    return torch.cat([out, torch.ones(1, **f32)])


def distortion_map(h: int, w: int, device):
    """(ys, xs) int64 source indices of the barrel-distortion correction:
    ``r2 = x^2 + y^2``, ``f = 1 + 0.08 r2``, each coordinate mapped back to
    ``trunc((c f + 1) / 2 (n - 1))`` clipped to the image, in separate f32
    roundings as the reference's ``distortion_correct``."""
    yy, xx = torch.meshgrid(lens_grid(h, device), lens_grid(w, device),
                            indexing="ij")
    r2 = xx * xx + yy * yy
    f = 1 + r2 * 0.08

    def index(c, n):
        t = ((c * f + 1) * 0.5) * (n - 1)       # * 0.5 is exactly / 2
        return torch.clamp(t.to(torch.int32), 0, n - 1).to(torch.int64)
    return index(yy, h), index(xx, w)


def distortion_correct(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) frame -> the lens-corrected frame, gathered on its device
    (the reference's ``distortion_correct``)."""
    h, w, _ = img.shape
    ys, xs = distortion_map(h, w, img.device)
    return img[ys, xs]


def post_process(features: torch.Tensor) -> torch.Tensor:
    """The reference's ``post_process``: the magnitude spectrum of the
    features, then 3 rounds of 4-means over it (centres seeded with its
    first 4 bins, first-index ``argmin``); returns the 4 centres.  The
    FFT (pocketfft on the CPU, cuFFT on the card) and the f32 sums differ
    from XLA's in the last bits."""
    spec = torch.fft.rfft(features.to(torch.float32)).abs()
    cents = spec[:4, None]
    for _ in range(3):
        d = (spec[None, :] - cents).abs()
        assign = torch.argmin(d, dim=0)
        cents = torch.stack([
            torch.where(assign == i, spec, 0).sum()
            / torch.clamp((assign == i).sum(), min=1)
            for i in range(4)])[:, None]
    return cents[:, 0]


def frame_stage(img: int, dev: torch.device, n_frames: int = N_FRAMES):
    """(frozen int8 MobileNet-V2, frames): weights drawn from a CPU
    generator seeded 0 (so every device gets the same floats) and frozen
    at 8 bits on ``dev``; uint8 frames from ``default_rng(0)``."""
    params = mnv2.init_params(torch.Generator().manual_seed(0),
                              weight_bits=8, img=img, device=dev)
    frozen = mnv2.freeze_packed(params, weight_bits=8, img=img)
    rng = np.random.default_rng(0)
    frames = [torch.from_numpy(rng.integers(0, 255, (img, img, 3))
                               .astype(np.uint8)).to(dev)
              for _ in range(n_frames)]
    return frozen, frames


def _requests(cfg, n, length, max_new, seed):
    r = np.random.default_rng(seed)
    return [Request(uid=uid, prompt=r.integers(0, cfg.vocab_size,
                                               length).astype(np.int32),
                    max_new_tokens=max_new) for uid in range(n)]


def _tenant_requests(name, cfg):
    n, length, max_new = TRAFFIC[name]
    return _requests(cfg, n, length, max_new, seed=sum(name.encode()) % 97)


def _build_tenant(arch: str, seed: int, full: bool, dev):
    """(cfg, packed, plan): random weights from a generator on ``dev``
    seeded ``seed``, frozen at 8 bits; half the packed store resident, the
    rest paged through the pool."""
    cfg = get_config(arch)
    if not full:
        cfg = cfg.smoke()
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    packed = freeze_for_serving(params, bits=8, device=dev)
    del params
    sizes = packed_sizes(packed)
    return cfg, packed, plan_for_budget(sizes, sum(sizes.values()) // 2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--img", type=int, default=None,
                    help=f"frame size (default {IMG_CPU} on the CPU, "
                         f"{IMG_CARD} on the card)")
    ap.add_argument("--full", action="store_true",
                    help="tenants at their configs' full widths")
    ap.add_argument("--trace-json", default="xr_pipeline_trace.json",
                    help="where the tenancy run's Chrome trace goes")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)            # raises without a card
    img = args.img or (IMG_CARD if dev.type == "cuda" else IMG_CPU)
    card = dev.type == "cuda"

    def sync():
        if card:
            torch.cuda.synchronize(dev)

    print(f"programming the MRAM store (int8 MobileNet-V2 1.0-{img}) on "
          f"{dev}...")
    frozen, frames = frame_stage(img, dev)
    wbytes = sum(p["packed"].numel() for p in frozen.values())
    print(f"  packed weights: {wbytes/1e6:.2f} MB "
          f"(224px network: 3.47 MB < 4 MiB MRAM)")

    def apply_fn(x):
        return mnv2.apply(frozen, x, weight_bits=8, img=img)

    # warm-up
    post_process(apply_fn(distortion_correct(frames[0])))
    sync()
    t0 = time.perf_counter()
    for fr in frames:
        corrected = distortion_correct(fr)          # DSP engine
        logits = apply_fn(corrected)                # N-EUREKA engine
        gestures = post_process(logits)             # DSP engine
    sync()
    dt = (time.perf_counter() - t0) / len(frames)
    expect(logits.shape == (1000,) and logits.dtype == torch.uint8,
           f"logits {tuple(logits.shape)} {logits.dtype}")
    expect(bool(torch.isfinite(gestures).all()) and gestures.shape == (4,),
           f"gestures {gestures}")
    print(f"  host pipeline: {dt*1e3:.1f} ms/frame (functional check)")

    tab = mnv2_scenario_table()
    t_l1, e_l1, _ = tab["l1mram"]
    print(f"  Siracusa model @0.8V: {t_l1*1e3:.2f} ms/frame, "
          f"{e_l1*1e3:.2f} mJ/frame -> {1/t_l1:.0f} FPS capable, "
          f"{e_l1*30*1e3:.0f} mW at 30 FPS (paper target: >30 FPS, <60 mW)")
    expect(1 / t_l1 > 30, "the memsys walk misses 30 FPS")

    # the paper's "complex heterogeneous application workloads" (§V): two
    # tenant models share ONE MultiScheduler and ONE SharedPagePool
    # budget, with one tenancy tick interleaved per camera frame.  The
    # tick loop is the ASYNC paging pipeline: each tick fences the page
    # pass begun last tick and begins the next one at once
    t0 = time.perf_counter()
    tenants = {name: _build_tenant(arch, seed, args.full, dev)
               for name, (arch, seed) in TENANT_ARCHS.items()}
    sync()
    build_s = time.perf_counter() - t0
    cold = sum(plan.paged_bytes(packed_sizes(packed))
               for _c, packed, plan in tenants.values())
    pool = SharedPagePool(max(int(cold * 0.6), 1))   # tight: forces churn
    print(f"tenancy: assistant LM ({tenants['assistant'][0].name}) + SSM "
          f"tracker ({tenants['tracker'][0].name}) share a "
          f"{pool.budget_bytes} B page pool ({cold} B cold; built in "
          f"{build_s:.1f} s)")

    # continuous batching: one global token budget re-planned every tick
    # and mid-request preemption, so an urgent wake-word request seizes a
    # slot THIS tick instead of queueing behind a long assistant prefill;
    # the whole tenancy run is recorded as a Chrome trace
    tracer = Tracer()
    ms = MultiScheduler(pool=pool, token_budget=24, preemptive=True,
                        tracer=tracer)
    for name, (cfg, packed, plan) in tenants.items():
        eng = ServingEngine(cfg, packed, batch_slots=2, max_len=64, seed=0,
                            plan=plan, device=dev)
        # the assistant's KV cache pages through the SAME pool budget as
        # everyone's weights; the SSM tracker has recurrent state instead
        ms.add_model(name, eng, prefill_chunk=8,
                     kv_paged="kv" in eng.cache, kv_block_rows=8)
    ms.add_stream("assistant", "assistant", priority=1, deadline_ms=20.0)
    ms.add_stream("tracker", "tracker", priority=2, deadline_ms=15.0)
    ms.add_stream("assistant", "wake", priority=3, deadline_ms=10.0)
    for name, (cfg, _p, _pl) in tenants.items():
        for req in _tenant_requests(name, cfg):
            ms.submit(name, req, stream=name)
    wake_rng = np.random.default_rng(11)
    wake = Request(uid=100,
                   prompt=wake_rng.integers(
                       0, tenants["assistant"][0].vocab_size,
                       4).astype(np.int32),
                   max_new_tokens=2)

    served = {}
    frame_ms, tick_ms = [], []
    t_loop = time.perf_counter()
    while ms.pending:         # frame loop with one tenancy tick per frame
        t0 = time.perf_counter()
        corrected = distortion_correct(frames[0])
        apply_fn(corrected)
        sync()
        t1 = time.perf_counter()
        for name, reqs in ms.tick().items():
            served.setdefault(name, []).extend(reqs)
        sync()
        t2 = time.perf_counter()
        frame_ms.append((t1 - t0) * 1e3)
        tick_ms.append((t2 - t1) * 1e3)
        if ms.ticks == WAKE_AT_TICK:
            # mid-run urgent arrival: both assistant slots are busy with
            # long prompts, so the wake request preempts one mid-service
            ms.submit("assistant", wake, stream="wake")
    loop_s = time.perf_counter() - t_loop

    doc = validate(ms.summary())
    for name in tenants:
        dl = doc["models"][name]["deadlines"]
        pc = doc["shared_pool"]["models"][name]
        pg = doc["models"][name]["paging"]
        print(f"  {name}: {doc['models'][name]['requests']['count']} "
              f"requests over {ms.ticks} interleaved ticks, deadline "
              f"misses {dl['missed']}/{dl['with_deadline']}, paging "
              f"{pc['swaps']} swaps / {pc['pool_hits']} pool hits / "
              f"evicted {pc['evicted']}x (host timing; the SoC budget "
              f"check is the memsys walk above)")
        print(f"    I/O overlap: {pg['exposed_s']*1e3:.1f} ms exposed "
              f"stall vs {pg['hidden_s']*1e3:.1f} ms hidden behind the "
              f"frame loop's compute ({pg['overlap_frac']*100:.0f}% of "
              f"the page stream reclaimed by the async pipeline)")
    tot = doc["totals"]
    sc = doc["models"]["assistant"]["scheduler"]
    print(f"  continuous batching: budget "
          f"{sc['budget_tokens_per_tick']} tok/tick at "
          f"{sc['budget_utilization']*100:.0f}% utilization; "
          f"{tot['preemptions']} preemption(s) / {tot['restores']} "
          f"restore(s) — the wake-word request seized a busy slot and "
          f"its victim resumed bit-exactly")
    expect(tot["preemptions"] >= 1, "the wake request preempted no slot")
    expect(tot["preemptions"] == tot["restores"],
           f"{tot['preemptions']} preemptions, {tot['restores']} restores")

    # the §V claim, checked: concurrency changes WHO pays the swaps, not
    # what anyone computes.  The shared-pool counters (weights AND kv, with
    # their wire / raw bytes) follow the replay of the pool's event log
    pred = kv_pass_counters(
        {name: page_sizes(ms.model(name).engine.pager.pages)
         for name in tenants},
        pool.budget_bytes, events=pool.events)
    expect(set(pred) == set(doc["shared_pool"]["models"]),
           f"pool members {sorted(doc['shared_pool']['models'])} vs the "
           f"replay's {sorted(pred)}")
    for name in pred:                       # weight members AND */kv
        got = doc["shared_pool"]["models"][name]
        expect(all(got[k] == pred[name][k]
                   for k in ("swaps", "misses", "pool_hits", "evicted"))
               and got["bytes_streamed_wire"] == pred[name]["bytes_wire"]
               and got["bytes_streamed_raw"] == pred[name]["bytes_raw"],
               f"{name}: pool counters {got} vs the replay {pred[name]}")
    kv_pg = doc["models"]["assistant"]["paging"]
    print(f"  assistant KV paging: {kv_pg['kv_swaps']} block swaps / "
          f"{kv_pg['kv_pool_hits']} pool hits / "
          f"{kv_pg['kv_writebacks']} writebacks through the shared pool")
    pool_summary = pool.summary()
    ms.close()

    # each tenant alone on a private pager: its tokens must not change
    solo_s = {}
    for name, (cfg, packed, plan) in tenants.items():
        t0 = time.perf_counter()
        eng = ServingEngine(cfg, packed, batch_slots=2, max_len=64, seed=0,
                            plan=plan, device=dev).attach_paging()
        if "kv" in eng.cache:
            eng.attach_kv_paging(8)        # private table: same tokens
        solo = Scheduler(eng, prefill_chunk=8)
        solo.add_stream(name, priority=1, deadline_ms=20.0)
        for req in _tenant_requests(name, cfg):
            solo.submit(req, stream=name)
        if name == "assistant":
            # the wake request rides in the solo reference too: greedy
            # tokens are slot-isolated, so WHEN it was admitted (or whom
            # it preempted) must not change a single token
            solo.submit(Request(uid=100,
                                prompt=np.asarray(wake.prompt, np.int32),
                                max_new_tokens=2), stream=name)
        want = {r.uid: r.generated for r in solo.run_until_done()}
        got = {r.uid: r.generated for r in served[name]}
        expect(got == want, f"{name}: tenant tokens diverge from solo")
        expect(all(0 <= t < cfg.vocab_size for ts in got.values()
                   for t in ts), f"{name}: token id out of the vocabulary")
        eng.pager.close()
        if eng.kv_table is not None:
            eng.kv_table.close()
        solo_s[name] = time.perf_counter() - t0
    print("  tenant tokens bit-exact vs solo private pagers; pool "
          "counters (weights AND kv) match kv_pass_counters")

    tdoc = tracer.to_dict()
    validate_trace(tdoc)
    tracer.write(args.trace_json)
    print(f"  trace: {tracer.event_count} events on "
          f"{len(tracer.track_names)} tracks -> {args.trace_json} "
          f"(open in chrome://tracing or ui.perfetto.dev)")
    print("xr_pipeline OK")
    return dict(img=img, frozen=frozen, frames=frames,
                frame_ms=frame_ms, tick_ms=tick_ms, loop_s=loop_s,
                frames_ms_alone=dt * 1e3, ticks=ms.ticks,
                build_s=build_s, solo_s=solo_s, doc=doc,
                pool=pool_summary, served={n: {r.uid: r.generated
                                               for r in rs}
                                           for n, rs in served.items()},
                tenants={n: t[0].name for n, t in tenants.items()})


if __name__ == "__main__":
    main()
