#!/usr/bin/env python3
"""Device times of the flash attention and selective scan kernels (B2
``flash_attention``, B7 ``selective_scan``) of one or more checkouts of the
port, on one CUDA card, in turns.

    python3 tools/attn_scan_ab.py --tree build/parent --tree . --tree . \\
        --tree build/parent
    python3 tools/attn_scan_ab.py --sweep     # this checkout's launch plans

Each ``--tree`` is the root of a checkout (it holds ``src/repro_torch``);
each runs in its own process, in the order given, which builds that tree's
kernels and times, with ``chip_smoke.py``'s timing helpers of this checkout
(CUDA-graph replay, L2-cold, TF32 off): flash attention at qwen3-0.6b's
prefill chunk and at hymba-1.5b's longest prompt, each beside
``F.scaled_dot_product_attention`` with the same mask, and the scan at
falcon-mamba-7b's prefill chunk and decode step and at hymba-1.5b's longest
prompt and decode step, each beside its bound.  Each process prints one JSON
line; the last two lines are the card's name and power limit and all runs
together.

``--sweep`` runs this checkout alone: it builds the kernels (with
``chip_smoke.py`` phase 1's spill and SASS checks), holds both kernels
against their plain versions at every ``chip_smoke.py`` case, then at each
timed shape checks every candidate launch plan against the plain version
(flash: kv slices of 1 to all tiles; scan: both routes, 1-8 lanes a
channel, block sizes and ring chunks) and times it.  The plans' defaults (``kernels/flash_attention.
flash_plan``, ``kernels/ssm_scan.scan_plan``) come from these times.  The
full table goes to ``--out`` (``build/attn_scan_sweep.json``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLASH_SPLITS = (1, 2, 4, 8, 16, 32, 64)
SCRATCH_MAX = 1 << 30          # bytes of slice scratch a swept flash plan
SCAN_LANES = (1, 2, 4, 8)
STEP_BLOCKS = (64, 128, 256)
CHUNK_CHANNELS = (16, 32, 64)
CHUNK_STEPS = (8, 16, 32)
# S of the route threshold's sweep, at falcon-mamba's decode width
EDGE_S = (1, 2, 4, 8, 16)
# the flash calls of one chip_smoke.py serve, by shape, as the wrapper's
# launches_by_shape counts them (PERF.md section 5): (Sq, Sk): launches;
# queries at the end of the kv span.  qwen3-0.6b: B 4, Hq 16 / Hkv 8, D 128, causal;
# hymba-1.5b's shorter prompts: B 4, Hq 25 / Hkv 5, D 64, window 1,024
SERVE_FLASH = {
    "qwen3": ((4, 16, 8, 128, None),
              {(64, 64): 56, (64, 128): 28, (32, 128): 56, (64, 256): 28,
               (16, 256): 28, (32, 256): 28, (32, 32): 28}),
    "hymba": ((4, 25, 5, 64, 1024),
              {(153, 256): 32, (162, 256): 32, (209, 256): 32,
               (218, 256): 32, (267, 512): 32, (297, 512): 32,
               (349, 512): 32}),
}


def setup(tree: Path):
    """torch and chip_smoke, with ``tree``'s kernels built (and, for this
    checkout, phase 1's ptxas and SASS checks passed)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attn_scan_ab: no CUDA device is available")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if tree.resolve() == ROOT:
        cs.phase_build(build)
    else:
        build.build_all()
    return torch, cs


FIELDS = ("work", "ms", "ms_runs", "plain_ms", "library_ms", "bound_ms",
          "bound_by", "bytes_ms", "tf32_ops_ms", "bound_f32_ms", "exp_ms",
          "route", "eager_ms")


def serve_cases(which: str):
    """[(FLASH_CASES-style case, launches)] of SERVE_FLASH[which]."""
    (b, hq, hkv, d, window), mix = SERVE_FLASH[which]
    return [((b, hq, hkv, sq, sk, d, window, (sk - sq,) * b, True), n)
            for (sq, sk), n in mix.items()]


def time_serve_flash(torch, cs, fa, dev, which: str, plan_of=None) -> dict:
    """Device time (graph replay, two input sets) of each flash call shape
    of one serve, and their sum weighted by the serve's launches: the
    serve's flash device time this kernel would take.  ``plan_of(case)``
    gives a plan (default: the wrapper's own)."""
    gen = torch.Generator(device=dev).manual_seed(14)
    by_shape, total = {}, 0.0
    for case, n in serve_cases(which):
        sets = [cs.flash_inputs(torch, gen, dev, case) for _ in range(2)]
        extra = {} if plan_of is None else {"plan": plan_of(case)}
        ms = cs.graph_ms(torch, lambda i: fa.flash_attention(
            *sets[i][:3], **sets[i][3], **extra), len(sets))
        by_shape[f"Sq={case[3]} Sk={case[4]}"] = ms
        total += n * ms
    print(f"[time] flash {which} serve mix: {total:.3f} ms over "
          f"{sum(n for _, n in serve_cases(which))} launches; by shape (ms) "
          f"{json.dumps({k: round(v, 4) for k, v in by_shape.items()})}",
          flush=True)
    return dict(ms=total, by_shape=by_shape)


def one(tree: Path) -> dict:
    torch, cs = setup(tree)
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssm

    assert Path(fa.__file__).resolve().is_relative_to(tree.resolve())
    if not hasattr(ssm, "scan_plan"):
        # a checkout from before the two routes: one route, no scan_plan
        ssm.scan_plan = lambda s, n: types.SimpleNamespace(route="single")
    dev = torch.device("cuda")
    res = {f"flash_{w}": cs.time_flash(torch, F, ref, fa, dev, w)
           for w in cs.FLASH_TIMED}
    res.update({f"scan_{w}": cs.time_scan(torch, ref, ssm, dev, w)
                for w in cs.SCAN_TIMED})
    res = {k: {f: v.get(f) for f in FIELDS} for k, v in res.items()}
    res.update({f"flash_{w}_serve": time_serve_flash(torch, cs, fa, dev, w)
                for w in SERVE_FLASH})
    return res


def sweep_flash(torch, cs, fa, ref, dev, sms) -> dict:
    gen = torch.Generator(device=dev).manual_seed(12)
    out = {}
    cases = {which: cs.FLASH_CASES[idx]
             for which, idx in cs.FLASH_TIMED.items()}
    for which in SERVE_FLASH:
        cases.update({f"{which}_serve Sq={c[3]} Sk={c[4]}": c
                      for c, _ in serve_cases(which)})
    for which, case in cases.items():
        b, hq, hkv, sq, sk, d = case[:6]
        sets = [cs.flash_inputs(torch, gen, dev, case) for _ in range(2)]
        expect = ref.flash_attention(*sets[0][:3], **sets[0][3])
        default = fa.flash_plan(b, hq, hkv, sq, sk, d, sms)
        plans = {default} | {
            fa.flash_plan(b, hq, hkv, sq, sk, d, sms, split_tiles=st)
            for st in FLASH_SPLITS if st <= default.kv_tiles}
        rows = []
        for plan in sorted(plans):
            scratch = (b * hkv * plan.row_tiles * plan.splits * plan.rows
                       * (d + 2) * 4 if plan.splits > 1 else 0)
            if scratch > SCRATCH_MAX:
                continue
            q, k, v, kw = sets[0]
            got = fa.flash_attention(q, k, v, plan=plan, **kw)
            err = (got - expect).abs().max().item()
            if not torch.allclose(got, expect, **cs.FLASH_TOL):
                raise AssertionError(f"flash {which} {plan}: max abs err "
                                     f"{err}")
            del got
            ms = cs.graph_ms(torch, lambda i: fa.flash_attention(
                *sets[i][:3], plan=plan, **sets[i][3]), len(sets))
            rows.append(dict(plan=plan._asdict(), ms=ms, max_abs_err=err))
            torch.cuda.empty_cache()
        rows.sort(key=lambda r: r["ms"])
        chosen = next(r["ms"] for r in rows if r["plan"] == default._asdict())
        out[which] = dict(case=list(case), chosen=default._asdict(),
                          chosen_ms=chosen, by_plan=rows)
        print(f"[sweep] flash {which}: best {rows[0]['ms']:.4f} ms "
              f"{rows[0]['plan']}, chosen {chosen:.4f} ms {default._asdict()}",
              flush=True)
        del sets, expect
    return out


def scan_candidates(ssm, s: int, n: int, full: bool):
    plans = set()
    for lanes in SCAN_LANES:
        if not 1 <= n // lanes <= ssm.MAX_STATES:
            continue
        for block in STEP_BLOCKS if full else (128, 256):
            plans.add(ssm.ScanPlan("step", lanes, block, 0))
        for ch in CHUNK_CHANNELS:
            if ch * lanes > ssm.MAX_THREADS or (ch * lanes) % 32:
                continue
            for steps in (CHUNK_STEPS if full else (8, 16)):
                if steps <= max(8, s) or steps == CHUNK_STEPS[0]:
                    plans.add(ssm.ScanPlan("chunked", lanes, ch, steps))
    return plans


def sweep_scan(torch, cs, ssm, ref, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(13)
    shapes = dict(cs.SCAN_TIMED)
    shapes.update({f"edge_S{s}": (4, s, 8192) for s in EDGE_S})
    out = {}
    for which, (bsz, s, di) in shapes.items():
        n = 16
        sets = [cs.scan_inputs(torch, gen, dev, bsz, s, di, n, True)
                for _ in range(2)]
        y_ref, h_ref = ref.selective_scan(*sets[0])
        default = ssm.scan_plan(s, n)
        plans = scan_candidates(ssm, s, n, not which.startswith("edge"))
        plans.add(default)
        rows = []
        for plan in sorted(plans):
            y, h = ssm.selective_scan(*sets[0], plan=plan)
            err = max((y - y_ref).abs().max().item(),
                      (h - h_ref).abs().max().item())
            if not (torch.allclose(y, y_ref, **cs.SCAN_TOL)
                    and torch.allclose(h, h_ref, **cs.SCAN_TOL)):
                raise AssertionError(f"scan {which} {plan}: max abs err "
                                     f"{err}")
            ms = cs.graph_ms(torch, lambda i: ssm.selective_scan(
                *sets[i], plan=plan), len(sets))
            rows.append(dict(plan=plan._asdict(), ms=ms, max_abs_err=err))
        rows.sort(key=lambda r: r["ms"])
        chosen = next(r["ms"] for r in rows if r["plan"] == default._asdict())
        best = {route: next((r for r in rows if r["plan"]["route"] == route),
                            None) for route in ("step", "chunked")}
        out[which] = dict(shape=[bsz, s, di, n], chosen=default._asdict(),
                          chosen_ms=chosen, best_by_route=best, by_plan=rows)
        print(f"[sweep] scan {which} {(bsz, s, di, n)}: best "
              f"{rows[0]['ms']:.4f} ms {rows[0]['plan']}, best step "
              f"{best['step']['ms']:.4f}, best chunked "
              f"{best['chunked']['ms']:.4f}, chosen {chosen:.4f} ms "
              f"{default._asdict()}", flush=True)
        del sets
        torch.cuda.empty_cache()
    return out


def sweep() -> dict:
    torch, cs = setup(ROOT)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssm

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cs.check_flash(torch, ref, fa, dev)
    cs.check_scan(torch, ref, ssm, dev)
    return {"flash": sweep_flash(torch, cs, fa, ref, dev, sms),
            "scan": sweep_scan(torch, cs, ssm, ref, dev)}


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", type=Path, default=[])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "attn_scan_sweep.json")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps({"tree": str(args.one), "times": one(args.one)}))
        return 0
    if args.sweep:
        res = sweep()
        card = card_line()
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "sweep": res},
                                       indent=1))
        print(card)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("attn_scan_ab: no CUDA device is available", file=sys.stderr)
        return 1
    runs = []
    for tree in args.tree or [ROOT]:
        out = subprocess.run([sys.executable, __file__, "--one", str(tree)],
                             capture_output=True, text=True, check=False)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    card = card_line()
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
