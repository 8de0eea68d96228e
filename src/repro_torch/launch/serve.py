"""Serving launcher of the port: deadline-aware scheduling over the packed
At-MRAM store (reference: ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --smoke --requests 8 --bits 4 --budget-mb 2 --deadline-ms 20 \\
        [--device cpu]

It runs on the CUDA card unless ``--device cpu`` asks for the CPU; without
a card it raises.  Without ``--smoke`` the config is served at full width.

Freezes random params (drawn from a seeded ``torch.Generator`` on the
device) into the packed store and serves through the deadline-aware
``Scheduler``: ``--scenario`` gives a uniform placement, ``--budget-mb``
the greedy hot-set plan (hot params resident, the rest paged l3flash,
§II-B2) with the live ``HostPagedStore`` streaming the cold pages to the
device between ticks, swap / miss counters included.  ``--page-bits``
re-encodes the cold pages on the wire; ``--kv-paged`` pages the KV cache
through the same stream; ``--fault-seed`` puts every fetch under a seeded
``FaultPlan``; ``--token-budget``, ``--preemptive`` and ``--admission``
are the continuous-batching controls of ``Scheduler``.

When anything pages, the run is verified bit-exact against the fully
resident plan and, with ``--async-io`` (the default), against the
synchronous streaming path with the swap / miss counters and ticks
unchanged (``--no-verify`` skips both).  The launcher exits 1 when a verify
fails.  Metrics are the ``repro.serving.metrics/v9`` JSON (stdout, and
``--metrics-json PATH``); ``--trace-json PATH`` writes the Chrome trace.

Multi-model tenancy:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
        --models qwen3-0.6b,falcon-mamba-7b --shared-budget-mb 0.05

serves every listed model through ONE ``MultiScheduler`` and one
``SharedPagePool`` (``--shared-budget-mb``; default 60% of the combined
cold bytes); each tenant is verified bit-exact against serving it alone on
a private pager, and the pool's counters against the ``kv_pass_counters``
replay of its event log.

Mesh-sharded paging: ``--mesh N`` (or ``DxM``) builds a ("data",
"model") mesh (``launch/mesh.make_test_mesh``) whose links all stream to
the one device, and shards the paged store over the model axis: each link
streams ONLY its shard's pages on its own fetch worker and copy stream
(``core/paging.ShardedPagedStore``), the tick's fence joins them, and the
``ShardedPoolLedger`` sums the per-link byte counters into one global
ledger.  The greedy plan charges a sharded param 1/N a link
(``shard_factors``).  A third verify leg serves the same plan on one link
and asserts tokens and ticks BIT-EXACT, global wire / raw bytes equal to
the single link's, and every link strictly below the single link when
anything shards; the ledger must MATCH its static per-link
``kv_pass_counters`` prediction.  With ``--models`` the mesh is ignored,
as the reference ignores it there.

Every decoder-only family serves, the VLM (llava-next-34b) with text
prompts as the reference's engine serves it.  Refused: the encdec family,
as the reference refuses it; its serve steps are
``repro_torch.launch.steps.make_prefill_step`` / ``make_decode_step``.
"""

from __future__ import annotations

import argparse
import sys
import zlib

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.paging import (SharedPagePool, kv_pass_counters,
                                     packed_tree_store, page_roundtrip_param,
                                     page_sizes, store_shard_axes,
                                     thread_packed)
from repro_torch.core.placement import (Placement, PlacementPlan,
                                        packed_sizes, plan_for_budget)
from repro_torch.models import transformer as tfm
from repro_torch.serving import (MultiScheduler, Request, Scheduler,
                                 ServingEngine, Tracer)
from repro_torch.serving.trace import validate as validate_trace


def _requests(cfg, n, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(uid=uid,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        8 + uid % 5).astype(np.int32),
                    max_new_tokens=max_new)
            for uid in range(n)]


def _fault_plan(args):
    """--fault-seed's seeded FaultPlan, or None when chaos is off."""
    if args.fault_seed is None:
        return None
    from repro_torch.core.faults import FaultPlan
    return FaultPlan(seed=args.fault_seed, fail_rate=args.fault_rate,
                     bitflip_rate=args.fault_bitflip)


def _fetch_timeout_s(args):
    return (None if args.fetch_timeout_ms is None
            else args.fetch_timeout_ms / 1e3)


def _build_serve_mesh(spec, device):
    """--mesh's ("data", "model") mesh of links on ``device``: "N" puts
    all N links on the model axis ((1, N)), "DxM" is an explicit (data,
    model) grid.  Never clamped: the links share the one device."""
    if spec is None:
        return None
    from repro_torch.launch.mesh import make_test_mesh
    parts = spec.lower().split("x")
    try:
        dims = [int(p) for p in parts]
    except ValueError:
        raise SystemExit(f"--mesh wants N or DxM, got {spec!r}")
    if len(dims) == 1:
        shape = (1, dims[0])
    elif len(dims) == 2:
        shape = tuple(dims)
    else:
        raise SystemExit(f"--mesh wants N or DxM, got {spec!r}")
    if any(d < 1 for d in shape):
        raise SystemExit(f"--mesh dims must be >= 1, got {spec!r}")
    return make_test_mesh(shape, ("data", "model"), device=device)


def _mesh_shard_factors(packed, mesh):
    """{param name: n_shards} under the mesh's sharding rules: what
    plan_for_budget charges a link (computed before the plan, so over
    every packed group; bits do not move it, the shard axis is never the
    packed last dim)."""
    if mesh is None or "model" not in tuple(mesh.axis_names) \
            or int(mesh.shape["model"]) < 2:
        return None
    store = packed_tree_store(packed, None)
    return {name: n
            for name, (_ax, n) in store_shard_axes(store, None, mesh).items()}


def _serve(cfg, packed, plan, args, paged: bool,
           async_io: bool = None, kv_paged: bool = False, tracer=None,
           faults=None, mesh=None):
    eng = ServingEngine(cfg, packed, batch_slots=args.slots,
                        max_len=args.max_len, plan=plan, seed=args.seed,
                        device=args.device)
    if paged:
        eng.attach_paging(faults=faults, mesh=mesh)
    if kv_paged:
        eng.attach_kv_paging(args.kv_block, faults=faults)
    sched = Scheduler(eng, prefill_chunk=args.prefill_chunk,
                      async_io=args.async_io if async_io is None
                      else async_io,
                      token_budget=args.token_budget,
                      preemptive=args.preemptive,
                      admission=args.admission,
                      fetch_timeout_s=(_fetch_timeout_s(args)
                                       if faults is not None else None),
                      tracer=tracer, trace_track=args.arch)
    sched.add_stream("xr", priority=1, deadline_ms=args.deadline_ms)
    sched.add_stream("background")
    for req in _requests(cfg, args.requests, args.max_new, seed=args.seed):
        sched.submit(req, stream="xr" if req.uid % 2 == 0 else "background")
    done = sched.run_until_done()
    return done, sched, eng


def _verify_mesh(cfg, packed, plan, args, eng, sched, got, mesh_doc):
    """The third verify leg: the mesh changes where pages live and which
    link moves them, never what the step computes.  The single-link paged
    run of the same plan must give the same tokens in as many ticks, and
    the byte ledgers obey the sharding algebra: global wire / raw bytes
    EQUAL to the single link's (each shard's rows cross one link,
    replicated params page once on link 0), and each link STRICTLY below
    it when anything shards.  Fills ``mesh_doc``; returns whether all
    held."""
    uref, usched, ueng = _serve(cfg, packed, plan, args, paged=True,
                                kv_paged=args.kv_paged,
                                faults=_fault_plan(args))
    exact = ({r.uid: r.generated for r in uref} == got
             and usched.ticks == sched.ticks)
    single_wire = ueng.pager.bytes_streamed_wire
    single_raw = ueng.pager.bytes_streamed_raw
    pager = eng.pager
    link_max = max(d["bytes_streamed_wire"]
                   for d in mesh_doc["ledger"]["per_device"])
    ledger_ok = (pager.bytes_streamed_wire == single_wire
                 and pager.bytes_streamed_raw == single_raw
                 and (not pager.shard_axes or link_max < single_wire))
    print("verify: mesh tokens "
          + ("BIT-EXACT vs single-device paged run" if exact
             else "MISMATCH vs single-device paged run")
          + (", byte ledger obeys the sharding algebra" if ledger_ok else
             f", ledger VIOLATION (global {pager.bytes_streamed_wire}"
             f"/{pager.bytes_streamed_raw} B vs single {single_wire}"
             f"/{single_raw} B, link max {link_max} B)"))
    mesh_doc.update(
        bit_exact=exact, ledger_ok=ledger_ok,
        per_link_max_wire=int(link_max),
        single_device=dict(bytes_streamed_wire=int(single_wire),
                           bytes_streamed_raw=int(single_raw),
                           swaps=int(ueng.pager.swap_count),
                           ticks=int(usched.ticks)))
    for part in (ueng.pager, ueng.kv_table):
        if part is not None:
            part.close()
    return exact and ledger_ok


def _servable(cfg):
    """Exit, naming why, for a family this launcher does not serve."""
    if cfg.family == "encdec":
        raise SystemExit(f"{cfg.name}: serve launcher covers decoder-only "
                         "archs; the enc-dec serve steps are "
                         "repro_torch.launch.steps.make_prefill_step and "
                         "make_decode_step")
    tfm.check_family(cfg)


def _config(args):
    """``--arch``'s config as ``main`` serves it: full width, or with
    ``--smoke`` the reduced one."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
        if args.budget_mb is not None:
            # the default smoke net packs < 0.1 MiB: nothing would page.
            # Scale it so that a MiB-order budget splits the store
            cfg = cfg.replace(n_layers=6, d_model=256, n_heads=4,
                              n_kv_heads=2, head_dim=64, d_ff=1024)
    return cfg


def _init_packed(cfg, seed: int, args):
    """Random params from a ``torch.Generator`` seeded ``seed`` on the
    device, frozen at ``--bits`` there as each weight is drawn: the same
    tree as ``freeze_for_serving`` of the whole f32 draw, which never
    exists (137 GB at llava-next-34b's full width)."""
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tfm.init_params(cfg, gen, device=dev, bits=args.bits)


def _build_model(arch: str, args, packed=None):
    """(cfg, packed, plan) for one tenant: smoke-scaled config, packed
    store, and a half-resident greedy plan (or --budget-mb's budget).
    ``packed`` (a frozen tree on the device) replaces the random draw,
    whose seed is the reference's ``crc32(arch) % 2**31``."""
    cfg = get_config(arch)
    if args.smoke:
        cfg = cfg.smoke()
    _servable(cfg)
    if packed is None:
        packed = _init_packed(cfg, zlib.crc32(arch.encode()) % (1 << 31),
                              args)
    sizes = packed_sizes(packed)
    budget = (int(args.budget_mb * 1024 * 1024)
              if args.budget_mb is not None else sum(sizes.values()) // 2)
    plan = plan_for_budget(
        sizes, budget,
        hot=Placement("l1mram", args.bits, "resident"),
        cold=Placement("l3flash", args.bits, "paged", args.page_bits),
        sizes_bits=args.bits)
    return cfg, packed, plan


def _reference_packed(packed, plan, args):
    """Packed tree the resident reference engine serves.

    fp and run-quantized-identity page encodings are lossless, so the
    reference is the original tree.  A lossy ``--page-bits`` (narrower
    than ``--bits``) distorts every cold weight deterministically at
    encode time, so the reference's cold params take the same
    encode->decode round trip and the verify stays bit-exact."""
    if args.page_bits is None or args.page_bits == args.bits:
        return packed
    store = packed_tree_store(packed, plan)
    rt = {}
    for name, p in store.params.items():
        pl = plan.placement_for(name)
        if pl.residency == "paged" and pl.page_bits not in (None,
                                                            pl.weight_bits):
            rt[name] = page_roundtrip_param(p, pl.page_bits)
    return thread_packed(packed, rt) if rt else packed


def _tenant_requests(cfg, args, salt):
    return _requests(cfg, args.requests, args.max_new,
                     seed=args.seed + salt)


def _serve_tenants(models, args, pool, tracer=None):
    """One MultiScheduler pass over every tenant; returns (ms, done)."""
    ms = MultiScheduler(pool=pool, async_io=args.async_io,
                        token_budget=args.token_budget,
                        preemptive=args.preemptive,
                        admission=args.admission,
                        fetch_timeout_s=_fetch_timeout_s(args),
                        faults=_fault_plan(args),
                        tracer=tracer)
    for name, (cfg, packed, plan) in models.items():
        eng = ServingEngine(cfg, packed, batch_slots=args.slots,
                            max_len=args.max_len, plan=plan,
                            seed=args.seed, device=args.device)
        ms.add_model(name, eng, prefill_chunk=args.prefill_chunk,
                     kv_paged=args.kv_paged, kv_block_rows=args.kv_block)
        ms.add_stream(name, "xr", priority=1, deadline_ms=args.deadline_ms)
        ms.add_stream(name, "background")
    for salt, (name, (cfg, _p, _pl)) in enumerate(models.items()):
        for req in _tenant_requests(cfg, args, salt):
            ms.submit(name, req,
                      stream="xr" if req.uid % 2 == 0 else "background")
    done = ms.run_until_done()
    return ms, done


def _serve_solo(name, cfg, packed, plan, args, salt):
    """The tenant served ALONE on a private pager: the bit-exactness
    reference the shared pool must not perturb."""
    eng = ServingEngine(cfg, packed, batch_slots=args.slots,
                        max_len=args.max_len, plan=plan, seed=args.seed,
                        device=args.device)
    sizes = packed_sizes(packed)
    if plan.paged_bytes(sizes) > 0:
        eng.attach_paging()
    if args.kv_paged and "kv" in eng.cache:
        eng.attach_kv_paging(args.kv_block)
    sched = Scheduler(eng, prefill_chunk=args.prefill_chunk,
                      async_io=args.async_io)
    sched.add_stream("xr", priority=1, deadline_ms=args.deadline_ms)
    sched.add_stream("background")
    for req in _tenant_requests(cfg, args, salt):
        sched.submit(req, stream="xr" if req.uid % 2 == 0 else "background")
    done = sched.run_until_done()
    if eng.pager is not None:
        eng.pager.close()
    if eng.kv_table is not None:
        eng.kv_table.close()
    return {r.uid: r.generated for r in done}


def _write_trace(tracer, path):
    validate_trace(tracer.to_dict())
    tracer.write(path)
    print(f"trace written to {path} ({tracer.event_count} events on "
          f"{len(tracer.track_names)} tracks); load it in "
          f"chrome://tracing or https://ui.perfetto.dev")


def _main_multi(args):
    archs = [a.strip() for a in args.models.split(",") if a.strip()]
    if len(archs) < 2:
        raise SystemExit("--models wants >= 2 comma-separated archs")
    models = {}
    for arch in archs:
        name = arch
        i = 2
        while name in models:            # same arch twice = two tenants
            name = f"{arch}#{i}"
            i += 1
        models[name] = _build_model(arch, args)

    cold = {name: plan.paged_bytes(packed_sizes(packed))
            for name, (_c, packed, plan) in models.items()}
    total_cold = sum(cold.values())
    if args.shared_budget_mb is not None:
        budget = int(args.shared_budget_mb * 1024 * 1024)
    else:
        budget = max(int(total_cold * 0.6), 1)
    print(f"tenants: {', '.join(models)}; cold bytes "
          f"{ {n: c for n, c in cold.items()} }, shared pool budget "
          f"{budget} B")

    pool = SharedPagePool(budget) if total_cold > 0 else None
    tracer = Tracer() if args.trace_json else None
    ms, done = _serve_tenants(models, args, pool, tracer=tracer)
    doc = ms.summary()
    for name in models:
        reqs = doc["models"][name]["requests"]
        dl = doc["models"][name]["deadlines"]
        print(f"  {name}: {reqs['count']} requests, {reqs['tokens_out']} "
              f"tokens, deadline misses {dl['missed']}/{dl['with_deadline']}")
    if pool is not None:
        ps = doc["shared_pool"]
        print(f"  shared pool: {ps['cached_pages']} pages cached "
              f"({ps['live_bytes']}/{ps['budget_bytes']} B device, "
              f"{ps['live_wire_bytes']} B wire), "
              f"{ps['evictions']} cross-model evictions; "
              f"{ps['bytes_streamed_wire']} B wire streamed for "
              f"{ps['bytes_streamed_raw']} B raw")
        # the replay of the pool's full event log (weight passes and KV
        # batches / drops) covers every member, byte ledgers included
        pred = kv_pass_counters(
            {name: page_sizes(ms.model(name).engine.pager.pages)
             for name in models
             if ms.model(name).engine.pager is not None},
            pool.budget_bytes, events=pool.events)
        pred_ok = all(
            all(ps["models"][m][k] == pred[m][k]
                for k in ("swaps", "misses", "pool_hits", "evicted"))
            and ps["models"][m]["bytes_streamed_wire"] == pred[m]["bytes_wire"]
            and ps["models"][m]["bytes_streamed_raw"] == pred[m]["bytes_raw"]
            for m in pred)
        print("  pool counters (incl. wire/raw bytes) "
              + ("MATCH" if pred_ok else "DIVERGE FROM")
              + " the static kv_pass_counters prediction")
    else:
        pred_ok = True

    ok = pred_ok
    if not args.no_verify:
        for salt, (name, (cfg, packed, plan)) in enumerate(models.items()):
            want = _serve_solo(name, cfg, packed, plan, args, salt)
            got = {r.uid: r.generated for r in done.get(name, [])}
            exact = got == want
            ok = ok and exact
            print(f"  verify {name}: tokens "
                  + ("BIT-EXACT vs solo private pager" if exact
                     else "MISMATCH vs solo private pager"))

    print(ms.to_json())
    if args.metrics_json:
        ms.write(args.metrics_json)
        print(f"metrics written to {args.metrics_json}")
    if tracer is not None:
        _write_trace(tracer, args.trace_json)
    ms.close()
    if not ok:
        sys.exit(1)
    return done


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--models", default=None,
                    help="comma-separated archs served as tenants of ONE "
                         "MultiScheduler + SharedPagePool (overrides "
                         "--arch/--scenario)")
    ap.add_argument("--shared-budget-mb", type=float, default=None,
                    help="SharedPagePool device budget in MiB for --models "
                         "runs; default 60%% of the combined cold bytes")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized); without it the full "
                         "config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--bits", type=int, default=8, choices=(2, 4, 8))
    ap.add_argument("--page-bits", type=int, default=None,
                    choices=(2, 4, 8),
                    help="wire encoding for COLD pages: stream blockwise-"
                         "quantized intN payload + scales and dequantize "
                         "at fetch (default: stream the packed device "
                         "format verbatim). Equal to --bits is the zero-"
                         "decode identity; narrower is lossy and verified "
                         "against a codec-round-tripped resident "
                         "reference")
    ap.add_argument("--scenario", default="l1mram",
                    choices=("l1mram", "l2mram", "l3mram", "l3flash"))
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="resident MRAM budget in MiB; enables the greedy "
                         "hot-set plan (mixed placement) and live paged-"
                         "weight streaming instead of the uniform "
                         "--scenario")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline for the 'xr' stream (EDF "
                         "admission; misses are reported, not dropped)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="max prompt tokens absorbed per tick per slot")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="continuous batching: per-tick token budget "
                         "re-planned every tick across prefill chunks "
                         "and decode steps (with --models, ONE budget "
                         "shared across all tenants)")
    ap.add_argument("--preemptive", action="store_true",
                    help="allow an urgent stream to evict a strictly-"
                         "lower-priority slot mid-request; the victim "
                         "checkpoints and later resumes bit-exactly")
    ap.add_argument("--admission", default=None,
                    choices=("reject", "degrade"),
                    help="admission control: refuse (or shorten to fit) "
                         "requests whose predicted completion already "
                         "misses their deadline")
    ap.add_argument("--kv-paged", action="store_true",
                    help="page the per-slot KV cache through the same "
                         "budgeted page stream as the weights (with "
                         "--models, KV blocks join the SharedPagePool as "
                         "<model>/kv members)")
    ap.add_argument("--kv-block", type=int, default=16,
                    help="KV page size in cache rows")
    ap.add_argument("--mesh", default=None, metavar="N|DxM",
                    help="shard the paged store over a ('data', 'model') "
                         "mesh: N links on the model axis (or an explicit "
                         "DxM grid), all streaming to the one device, "
                         "each only its shard's pages on its own fetch "
                         "worker and copy stream, joined at the tick "
                         "fence under one global byte ledger.  A third "
                         "verify leg serves the same plan on one link and "
                         "asserts tokens bit-exact plus the ledger "
                         "identities")
    io = ap.add_mutually_exclusive_group()
    io.add_argument("--async-io", dest="async_io", action="store_true",
                    default=True,
                    help="overlap the next tick's page stream with this "
                         "tick's compute, fencing at first use (default)")
    io.add_argument("--sync-io", dest="async_io", action="store_false",
                    help="block the tick on the full page stream (the "
                         "schedule the async path is verified against)")
    ap.add_argument("--metrics-json", default=None,
                    help="also write the metrics JSON to this path")
    ap.add_argument("--trace-json", default=None,
                    help="record the tick pipeline as a Chrome Trace "
                         "Event JSON at this path")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="chaos mode: run every page fetch under a "
                         "seeded FaultPlan (transient failures retried, "
                         "wire bit-flips caught by the page CRC and "
                         "re-fetched)")
    ap.add_argument("--fault-rate", type=float, default=0.15,
                    help="transient fetch-failure probability per "
                         "(page, attempt) under --fault-seed")
    ap.add_argument("--fault-bitflip", type=float, default=0.15,
                    help="wire bit-flip probability per (page, attempt) "
                         "under --fault-seed")
    ap.add_argument("--fetch-timeout-ms", type=float, default=None,
                    help="fence deadline per tick: a page stream that "
                         "exceeds it defers that model's tick")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the bit-exact checks of the paged run")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    resolve_device(args.device)                  # raises without a card

    if args.models is not None:
        return _main_multi(args)

    cfg = _config(args)
    _servable(cfg)

    packed = _init_packed(cfg, 0, args)
    mesh = _build_serve_mesh(args.mesh, args.device)
    shard_factors = _mesh_shard_factors(packed, mesh)
    mesh_active = shard_factors is not None
    if args.mesh is not None and not mesh_active:
        print("--mesh: the model axis has one link; serving unsharded")
    if args.budget_mb is not None:
        # greedy hot-set plan over exactly the packed leaves the serving
        # dispatch reads (embed and norms never page)
        sizes = packed_sizes(packed)
        plan = plan_for_budget(
            sizes, int(args.budget_mb * 1024 * 1024),
            hot=Placement("l1mram", args.bits, "resident"),
            cold=Placement("l3flash", args.bits, "paged", args.page_bits),
            sizes_bits=args.bits, shard_factors=shard_factors)
        print(plan.summary(sizes))
        paged = plan.paged_bytes(sizes) > 0
    else:
        plan = PlacementPlan.uniform(args.scenario, bits=args.bits)
        paged = False
    if mesh_active and not paged:
        print("--mesh: nothing paged under this plan; serving unsharded")
        mesh_active = False
    mesh = mesh if mesh_active else None

    tracer = Tracer() if args.trace_json else None
    done, sched, eng = _serve(cfg, packed, plan, args, paged,
                              kv_paged=args.kv_paged, tracer=tracer,
                              faults=_fault_plan(args), mesh=mesh)
    total_tokens = sum(len(r.generated) for r in done)
    place = ("mixed:" + "+".join(plan.scenarios_used())
             if not plan.is_uniform else plan.default.scenario)
    summary = sched.metrics.summary(paging=eng.paging_summary(),
                                    faults=sched.faults_summary())
    thr = summary["throughput"]
    print(f"served {len(done)} requests, {total_tokens} tokens in "
          f"{thr['wall_s']:.2f}s ({thr['tok_per_s']:.1f} tok/s) "
          f"[W{args.bits}, {place}] over {sched.ticks} ticks")
    if paged:
        pg = summary["paging"]
        enc = "fp" if args.page_bits is None else f"int{args.page_bits}"
        wire, raw = pg["bytes_streamed_wire"], pg["bytes_streamed_raw"]
        print(f"live paging ({'async' if args.async_io else 'sync'}): "
              f"{len(eng.pager.pages)} pages, "
              f"{eng.swap_count} swaps, {eng.miss_count} demand misses, "
              f"{pg['exposed_s'] * 1e3:.1f} ms exposed + "
              f"{pg['hidden_s'] * 1e3:.1f} ms hidden behind compute "
              f"(overlap {pg['overlap_frac'] * 100:.0f}%)")
        if wire:
            print(f"page wire ({enc}): {wire} B streamed for {raw} B raw "
                  f"(x{raw / wire:.2f} compression vs fp32 dense)")
    mesh_doc = None
    if mesh is not None:
        # the ledger's contract: the per-link counters, summed, equal the
        # static per-link kv_pass_counters replay
        pred = eng.pager.predict(eng.page_resident_slots)
        led = eng.pager.ledger.summary()
        pred_ok = (led["swap_count"] == pred["swaps"]
                   and led["miss_count"] == pred["misses"]
                   and led["bytes_streamed_wire"] == pred["bytes_wire"]
                   and led["bytes_streamed_raw"] == pred["bytes_raw"])
        shape_s = "x".join(str(int(mesh.shape[a])) for a in mesh.axis_names)
        link_wire = [d["bytes_streamed_wire"] for d in led["per_device"]]
        print(f"mesh {shape_s}: {eng.pager.n_shards} links on "
              f"{eng.pager.device}, {len(eng.pager.shard_axes)} params "
              f"sharded; per-link wire {link_wire} B; global ledger "
              + ("MATCHES" if pred_ok else "DIVERGES FROM")
              + " the static kv_pass_counters prediction")
        mesh_doc = dict(shape=shape_s, n_devices=eng.pager.n_shards,
                        sharded_params=len(eng.pager.shard_axes),
                        ledger=led, predicted=pred, predicted_ok=pred_ok)
    if args.kv_paged:
        pg = summary["paging"]
        print(f"kv paging: {pg['kv_block_rows']}-row blocks, "
              f"{pg['kv_swaps']} swaps, {pg['kv_pool_hits']} pool hits, "
              f"{pg['kv_writebacks']} writebacks, "
              f"{pg['kv_dropped']} dropped; "
              f"{pg['kv_exposed_s'] * 1e3:.1f} ms exposed + "
              f"{pg['kv_hidden_s'] * 1e3:.1f} ms hidden")
    if args.deadline_ms is not None:
        dl = summary["deadlines"]
        print(f"deadlines: {dl['missed']}/{dl['with_deadline']} missed "
              f"({dl['miss_rate'] * 100:.0f}% at {args.deadline_ms} ms)")
    if args.fault_seed is not None or args.fetch_timeout_ms is not None:
        ft = summary["faults"]
        print(f"faults: {ft['injected']} injected, {ft['retries']} "
              f"retries, {ft['checksum_failures']} checksum failures "
              f"(all re-fetched: {ft['refetches']}), "
              f"{ft['fetch_timeouts']} fetch timeouts, "
              f"{ft['deferred_ticks']} ticks deferred")
    if args.token_budget or args.preemptive or args.admission:
        sc = summary["scheduler"]
        print(f"scheduler: {sc['preemptions']} preemptions / "
              f"{sc['restores']} restores, {sc['rejected']} rejected, "
              f"{sc['degraded']} degraded"
              + (f"; budget use {sc['budget_used_mean']:.1f}"
                 f"/{sc['budget_tokens_per_tick']} tok/tick"
                 if args.token_budget else ""))

    ok = mesh_doc is None or mesh_doc["predicted_ok"]
    if (paged or args.kv_paged) and not args.no_verify:
        # the resident reference serves with fully resident weights AND a
        # fully resident KV cache: the pre-paging engine the paged runs
        # must match token for token
        ref, _sched2, _eng2 = _serve(
            cfg, _reference_packed(packed, plan, args),
            PlacementPlan.uniform("l1mram", bits=args.bits), args,
            paged=False)
        got = {r.uid: r.generated for r in done}
        want = {r.uid: r.generated for r in ref}
        ok = ok and got == want
        lossy = (paged and args.page_bits is not None
                 and args.page_bits != args.bits)
        ref_name = ("resident plan (codec round-tripped cold weights)"
                    if lossy else "resident plan")
        print("verify: paged tokens "
              + (f"BIT-EXACT vs {ref_name}" if got == want
                 else f"MISMATCH vs {ref_name}"))
        if args.async_io:
            # the overlapped pipeline must change WHEN pages move, never
            # what the step computes: re-serve on the blocking sync path
            # (on a mesh, on the same links)
            sref, ssched, seng = _serve(cfg, packed, plan, args,
                                        paged=paged, async_io=False,
                                        kv_paged=args.kv_paged,
                                        faults=_fault_plan(args), mesh=mesh)
            sync_tokens = {r.uid: r.generated for r in sref}
            sync_ok = got == sync_tokens
            ctr_ok = (seng.swap_count == eng.swap_count
                      and seng.miss_count == eng.miss_count
                      and ssched.ticks == sched.ticks)
            ok = ok and sync_ok and ctr_ok
            print("verify: async tokens "
                  + ("BIT-EXACT vs sync streaming" if sync_ok
                     else "MISMATCH vs sync streaming")
                  + (", counters unchanged by overlap" if ctr_ok
                     else f", counters DIVERGED (sync "
                          f"{seng.swap_count}/{seng.miss_count} vs async "
                          f"{eng.swap_count}/{eng.miss_count})"))
            if seng.pager is not None:
                seng.pager.close()
            if seng.kv_table is not None:
                seng.kv_table.close()
        if mesh is not None:
            ok = _verify_mesh(cfg, packed, plan, args, eng, sched, got,
                              mesh_doc) and ok

    print(sched.metrics.to_json(paging=eng.paging_summary(),
                                trace=sched.trace_summary(),
                                faults=sched.faults_summary()))
    if args.metrics_json:
        sched.metrics.write(args.metrics_json,
                            paging=eng.paging_summary(),
                            trace=sched.trace_summary(),
                            faults=sched.faults_summary(),
                            **({"mesh": mesh_doc} if mesh_doc else {}))
        print(f"metrics written to {args.metrics_json}")
    if tracer is not None:
        _write_trace(tracer, args.trace_json)
    for part in (eng.pager, eng.kv_table):
        if part is not None:
            part.close()
    if not ok:
        sys.exit(1)
    return done


if __name__ == "__main__":
    main()
