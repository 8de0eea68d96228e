"""A cell's step and memory on the card, from its program at depth 1 and 2
(reference: ``repro/launch/microbench.py``).

The reference compiles single-layer programs because XLA's cost analysis
counts a loop body once:

    total = full_program + (L - 1) * layer1

``layer_cost`` does the same algebra on the card: it runs the cell as
rank 0 of the production mesh at depth 1 and depth 2 of the cell's
config, full width, at the rank's shapes, takes ``layer1`` as the
difference and extrapolates the step time and the peak device memory to
the config's depth.  A train cell runs ``dist_steps``' step on a fake
process group of 256 or 512 ranks (``launch/mesh.make_production_mesh``
on ``cuda``), whose collectives move nothing: its time is the rank's
compute alone, and the gathered buffers hold no data (the rank's own
leaves are drawn from a seeded ``torch.Generator``).  A serve cell runs
the one-device serve step on the rank's dp rows with whole packed
weights, as the dry-run counts it.  The reference's ``loop_corrections``
and its single-iteration attention and scan programs have no counterpart:
eager dispatch runs, and the dry-run counts, every loop iteration.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.configs.shapes import ShapeCell
from repro_torch.core.device import resolve_device
from repro_torch.launch import steps
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as shd

DEPTHS = (1, 2)
# calls timed at each depth, and calls profiled (each alone), after one
# warm-up
REPEATS = 3


def _depth(cfg: ModelConfig, layers: int) -> ModelConfig:
    """The config cut to ``layers`` decoder (and encoder) layers."""
    if cfg.family == "encdec":
        return cfg.replace(n_layers=layers, n_encoder_layers=layers)
    return cfg.replace(n_layers=layers)


def _train_program(cfg: ModelConfig, full: ModelConfig, cell: ShapeCell,
                   mesh: Any, gen: torch.Generator, dev: torch.device
                   ) -> Tuple[Callable, Tuple]:
    from repro_torch.launch import dist_steps
    from repro_torch.parallel import distributed as D

    cfg = cfg.replace(dtype="bfloat16")
    params = steps._init_fn(cfg)(cfg, generator=gen, device=dev)
    opt = steps.cell_optimizer(steps.param_specs(full), mesh)
    opt_state = opt.init(params)
    sp = D.shard_tree(params, shd.param_shardings(params, mesh), mesh)
    so = D.shard_tree(opt_state, shd.opt_state_shardings(opt_state, mesh,
                                                         params), mesh)
    del params, opt_state
    batch = {}
    for k, v in steps.train_batch_specs(cfg, cell, mesh).items():
        if v.dtype == torch.int32:
            batch[k] = torch.randint(0, cfg.vocab_size, v.shape,
                                     generator=gen, device=dev,
                                     dtype=torch.int32)
        else:
            batch[k] = torch.randn(v.shape, generator=gen, device=dev
                                   ).to(v.dtype)
    fn = dist_steps.make_distributed_train_step(cfg, opt, mesh)
    return fn, (sp, so, batch)


def _serve_program(cfg: ModelConfig, cell: ShapeCell, mesh: Any,
                   serve_bits: int, gen: torch.Generator, dev: torch.device
                   ) -> Tuple[Callable, Tuple]:
    fn, meta_args, _ = steps.build_cell(cfg, cell, mesh,
                                        serve_bits=serve_bits)
    cfg = cfg.replace(dtype="bfloat16")
    if cfg.family == "encdec":
        params = shd.freeze_for_serving(
            encdec.init_params(cfg, generator=gen, device=dev),
            bits=serve_bits, device=dev)
        init_cache = encdec.init_serve_cache
    else:
        params = tfm.init_params(cfg, generator=gen, device=dev,
                                 bits=serve_bits)
        init_cache = tfm.init_serve_cache
    cache = init_cache(cfg, steps.rank_rows(cell.global_batch, mesh),
                       cell.seq_len, device=dev)
    args = [params]
    for a in meta_args[1:]:
        if isinstance(a, dict):
            args.append(cache)
        elif isinstance(a, int):
            args.append(a)
        elif a.dtype == torch.int32:
            args.append(torch.randint(0, cfg.vocab_size, a.shape,
                                      generator=gen, device=dev,
                                      dtype=torch.int32))
        else:
            args.append(torch.randn(a.shape, generator=gen, device=dev
                                    ).to(a.dtype))
    return fn, tuple(args)


def _device_profile(prof) -> Dict[str, Any]:
    """What the card did in a profiled window: ``busy_s``, the union of
    its kernels' and copies' spans; ``events``, how many the profiler
    kept; and ``top``, the seconds of the eight longest-running names."""
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted((e.time_range.start, e.time_range.end)
                         for e in evs):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    by_name: Dict[str, float] = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(busy_s=busy / 1e6, events=len(evs),
                top={k: v / 1e6 for k, v in top})


def _spread(xs: List[float]) -> Dict[str, float]:
    return dict(median=statistics.median(xs), min=min(xs), max=max(xs))


def _time_program(fn: Callable, args: Tuple, base: int) -> Dict[str, Any]:
    """One warm-up call, then ``REPEATS`` calls each timed with CUDA
    events (the peak device memory over them beside it, less ``base``,
    what the process held before the program's arguments were made), then
    ``REPEATS`` calls each under its own ``torch.profiler`` window, timed
    with CUDA events there too, so that a window whose busy time falls
    short of its own call's shows that the profiler lost work.  Gives the
    medians (``step_s``, ``host_s``, ``device_busy_s``) and each reading's
    median, least and most under ``spread``."""
    from torch.profiler import ProfilerActivity, profile

    def timed():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, time.perf_counter() - t0

    fn(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps_s, hosts_s = zip(*(timed() for _ in range(REPEATS)))
    peak = torch.cuda.max_memory_allocated() - base
    profiled = []
    for _ in range(REPEATS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step_s, _ = timed()
        profiled.append(dict(_device_profile(prof), step_s=step_s))
    busy = [p["busy_s"] for p in profiled]
    return dict(step_s=statistics.median(steps_s),
                host_s=statistics.median(hosts_s),
                device_busy_s=statistics.median(busy), peak_bytes=peak,
                spread=dict(step_s=_spread(list(steps_s)),
                            host_s=_spread(list(hosts_s)),
                            device_busy_s=_spread(busy),
                            profiled_step_s=_spread(
                                [p["step_s"] for p in profiled])),
                profiled=profiled)


def layer_cost(cfg: ModelConfig, cell: ShapeCell, *, multi_pod: bool = False,
               serve_bits: int = 8) -> Dict[str, Any]:
    """The cell at depth 1 and 2 of ``cfg`` on the card (raises without
    one), extrapolated to ``cfg.n_layers`` as ``d1 + (L - 1) * (d2 -
    d1)`` from each depth's median (:func:`_time_program`):
    ``measured_step_s`` (CUDA events), ``measured_step_range_s`` (the
    least and most the depths' spreads allow), ``layer_s``,
    ``device_busy_s`` (the profiler's), ``peak_bytes``
    (``max_memory_allocated``, less what the process held before the
    cell's tensors were made) and ``fits`` against the card's memory,
    with each depth's readings under ``depths``.  Each depth draws its
    tensors from a ``torch.Generator`` seeded 0."""
    from repro_torch.launch.mesh import make_production_mesh

    dev = resolve_device("cuda")
    mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
    runs = {}
    for d in DEPTHS:
        base = torch.cuda.memory_allocated()
        gen = torch.Generator(device=dev).manual_seed(0)
        cut = _depth(cfg, d)
        if cell.kind == "train":
            fn, args = _train_program(cut, cfg, cell, mesh, gen, dev)
        else:
            fn, args = _serve_program(cut, cell, mesh, serve_bits, gen, dev)
        runs[d] = _time_program(fn, args, base)
        del fn, args
        torch.cuda.empty_cache()
    n = cfg.n_layers
    one, two = runs[DEPTHS[0]], runs[DEPTHS[1]]

    def extrapolate(key):
        return one[key] + (n - 1) * (two[key] - one[key])

    peak = extrapolate("peak_bytes")
    lo, hi = (r["spread"]["step_s"] for r in (one, two))
    total = torch.cuda.get_device_properties(dev).total_memory
    return dict(
        measured_step_s=extrapolate("step_s"),
        measured_step_range_s=[
            lo["min"] + (n - 1) * max(0.0, hi["min"] - lo["max"]),
            lo["max"] + (n - 1) * (hi["max"] - lo["min"])],
        layer_s=two["step_s"] - one["step_s"],
        device_busy_s=extrapolate("device_busy_s"),
        peak_bytes=int(peak), fits=bool(peak <= total),
        device_memory_bytes=int(total),
        device=torch.cuda.get_device_name(dev),
        depths={str(d): r for d, r in runs.items()},
        layers=n,
        timed="compute only: the fake process group's collectives move "
              "nothing" if cell.kind == "train" else
              "one-device serve step on the rank's dp rows")
