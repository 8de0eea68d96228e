#!/usr/bin/env python3
"""Device times of the N-EUREKA kernels (B4 ``qmatmul_int8``, B5
``conv3x3_dense``, B6 ``conv3x3_dw``) of one or more checkouts of the port,
on one CUDA card, in turns.

    python3 tools/neureka_ab.py --tree build/parent --tree . --tree . \\
        --tree build/parent
    python3 tools/neureka_ab.py --host --tree build/parent --tree .
    python3 tools/neureka_ab.py --sweep [--op dw3x3]   # this checkout's plans

Each ``--tree`` is the root of a checkout (it holds ``src/repro_torch``);
each runs in its own process, in the order given, which builds that tree's
kernels and times, with ``chip_smoke.py``'s timing helpers of this checkout
(CUDA-graph replay, L2-cold, 8-bit levels): ``qmatmul_int8`` at every
distinct pointwise job shape of MobileNet-V2 1.0-224 (20 shapes for its 35
jobs), ``conv3x3_dense`` at conv0 and ``conv3x3_dw`` at every distinct
depthwise job shape (10 for its 17 jobs), each beside one PyTorch call for
the same accumulation (``torch.matmul``, ``F.conv2d``, ``F.conv2d`` with
``groups=C``) and its byte bound; then, on the host clock, an eager
MobileNet-V2 frame at 8 bits and one eager ``conv3x3_dw`` call at b14.dw
(``host_times``; ``--host`` runs only these, so that many turns fit in
one call).  Each process prints one JSON line; the last two lines are the
card's name and power limit and all runs together.

``--sweep`` runs this checkout alone: at every distinct pointwise shape it
checks each launch plan the kernels hold (the direct route where it takes
K, the staged one with K split 1-16) bit for bit against the plain version
at 8, 4 and 2 bits, then times it at 8 bits, and does the same for conv0's
dense tiles and for every depthwise plan (``kernels/neureka_conv.dw_plans``)
at each depthwise shape; the rules of ``kernels/qmatmul.int8_plan``,
``kernels/neureka_conv.dense_plan`` and ``dw_plan`` come from these times.
The full table goes to ``build/neureka_sweep.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)
OPS = ("pw1x1", "dense3x3", "dw3x3")


def pw_shapes(jobs):
    """{(M, K, N): first job name} over the pointwise jobs, in job order."""
    out = {}
    for j in jobs:
        if j.op_kind == "pw1x1":
            out.setdefault((j.h * j.w, j.cin, j.cout), j.name)
    return out


def dw_shapes(jobs):
    """{(H, W, C, stride): first job name} over the depthwise jobs."""
    out = {}
    for j in jobs:
        if j.op_kind == "dw3x3":
            out.setdefault((j.h, j.w, j.cin, j.stride), j.name)
    return out


def setup(tree: Path):
    """torch and chip_smoke, with ``tree``'s kernels built (and, for this
    checkout, phase 1's ptxas and SASS checks passed)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("neureka_ab: no CUDA device is available")
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


def one(tree: Path, host_only: bool = False) -> dict:
    torch, cs = setup(tree)
    import torch.nn.functional as F
    from repro_torch.core import packing
    from repro_torch.core.perf_model import mobilenet_v2_jobs
    from repro_torch.kernels import neureka_conv as nkc
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import qmatmul as qmm

    assert Path(qmm.__file__).resolve().is_relative_to(tree.resolve())
    dev = torch.device("cuda")
    jobs = mobilenet_v2_jobs(8, cs.MNV2_IMG)
    todo = [("pw1x1", shape, name)
            for shape, name in pw_shapes(jobs).items()]
    todo.append(("dense3x3", cs.job_key(jobs[0])[1], jobs[0].name))
    todo += [("dw3x3", shape, name)
             for shape, name in dw_shapes(jobs).items()]
    res = {}
    for op, shape, name in [] if host_only else todo:
        t = cs.time_neureka(torch, F, packing, ops, ref, nkc, qmm, dev, op,
                            shape, name)
        res[name] = {f: t.get(f) for f in ("work", "ms", "ms_runs",
                                           "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")}
    res["host"] = host_times(torch, cs, packing, ops, nkc, dev, jobs)
    return res


def host_times(torch, cs, packing, ops, nkc, dev, jobs, rounds: int = 7,
               calls: int = 1000) -> dict:
    """Host-clock times: an eager MobileNet-V2 1.0-224 frame at 8 bits
    (``rounds`` rounds of chip_smoke's 16 frames, each ended by a
    synchronize, after two warm-up frames), and one eager ``conv3x3_dw``
    call at b14.dw (``calls`` calls in a row, then a synchronize: its
    kernel takes about 2.3 us, so the wrapper's host time sets the pace)."""
    import time

    from repro_torch.models import mobilenet_v2 as mnv2

    img, n = cs.MNV2_IMG, cs.MNV2_FRAMES
    params = mnv2.init_params(torch.Generator().manual_seed(0),
                              weight_bits=8, img=img)
    frozen = mnv2.freeze_packed(params, weight_bits=8, img=img)
    gen = torch.Generator(device=dev).manual_seed(6)
    frames = torch.randint(0, 256, (n, img, img, 3), generator=gen,
                           device=dev, dtype=torch.uint8)
    for i in range(2):
        mnv2.apply(frozen, frames[i], weight_bits=8, img=img)
    frame_ms = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            mnv2.apply(frozen, frames[i], weight_bits=8, img=img)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) / n * 1e3)
    shape = next(s for s, name in dw_shapes(jobs).items()
                 if name == "b14.dw")
    args = cs.neureka_case(torch, packing, ops, gen, dev, "dw3x3", shape, 8)
    call_us = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            nkc.conv3x3_dw(*args, bits=8, stride=shape[3])
        torch.cuda.synchronize()
        call_us.append((time.perf_counter() - t0) / calls * 1e6)
    return dict(frame_ms=min(frame_ms), frame_ms_runs=frame_ms,
                dw_call_us=min(call_us), dw_call_us_runs=call_us)


def sweep(ops_: tuple) -> dict:
    torch, cs = setup(ROOT)
    from repro_torch.core import packing
    from repro_torch.core.perf_model import mobilenet_v2_jobs
    from repro_torch.kernels import neureka_conv as nkc
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import qmatmul as qmm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    jobs = mobilenet_v2_jobs(8, cs.MNV2_IMG)
    out = {}
    if "dw3x3" in ops_:
        out["dw3x3"] = sweep_dw(torch, cs, packing, ops, ref, nkc, gen, dev,
                                jobs)
    if "pw1x1" in ops_:
        out["pw1x1"] = sweep_pw(torch, cs, packing, ops, ref, qmm, gen, dev,
                                jobs)
    if "dense3x3" in ops_:
        out["dense3x3"] = sweep_dense(torch, cs, packing, ops, ref, nkc, gen,
                                      dev, jobs)
    return out


def sweep_pw(torch, cs, packing, ops, ref, qmm, gen, dev, jobs) -> dict:
    """Every int8 plan at each pointwise shape."""
    out = {}
    for (m, k, n), name in pw_shapes(jobs).items():
        plans = {qmm.int8_tile_plan(m, k, n, s) for s in SPLITS}
        if qmm.int8_direct_ok(k, True):
            plans.add(qmm.int8_tile_plan(m, k, n, direct=True))
        checks = {bits: cs.neureka_case(torch, packing, ops, gen, dev,
                                        "pw1x1", (m, k, n), bits)
                  for bits in (8, 4, 2)}
        sets = cs.cold_sets(torch, packing, ops, gen, dev, "pw1x1",
                            (m, k, n), 8)
        rows = []
        for plan in sorted(plans):
            for bits, args in checks.items():
                got = torch.empty((m, n), dtype=torch.uint8, device=dev)
                qmm._launch_int8(*args, got, bits, plan)
                want = ref.qmatmul_int8(*args, bits=bits, k_orig=k)
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} {plan} bits={bits}: differs "
                                         "from the plain version")
            outs = [torch.empty((m, n), dtype=torch.uint8, device=dev)
                    for _ in sets]
            ms = cs.graph_ms(torch, lambda i: qmm._launch_int8(
                *sets[i], outs[i], 8, plan), len(sets))
            rows.append(dict(plan=plan._asdict(), ms=ms))
        rows.sort(key=lambda r: r["ms"])
        chosen = qmm.int8_plan(m, k, n)._asdict()
        out[name] = dict(shape=[m, k, n], chosen=chosen,
                         chosen_ms=next(r["ms"] for r in rows
                                        if r["plan"] == chosen),
                         by_plan=rows)
        print(f"[sweep] {name} {(m, k, n)}: best {rows[0]['ms']:.4f} ms "
              f"{rows[0]['plan']}, chosen "
              f"{out[name]['chosen_ms']:.4f} ms {chosen}", flush=True)
    return out


def sweep_dense(torch, cs, packing, ops, ref, nkc, gen, dev, jobs) -> dict:
    """Every dense tile at conv0."""
    op, shape = cs.job_key(jobs[0])
    h, w, cin, cout, stride = shape
    checks = {bits: cs.neureka_case(torch, packing, ops, gen, dev, op, shape,
                                    bits) for bits in (8, 4, 2)}
    sets = cs.cold_sets(torch, packing, ops, gen, dev, op, shape, 8)
    ho, wo = -(-h // stride), -(-w // stride)
    rows = []
    for r in (1, 2, 4):
        for tw in (14, 16, 28, 32, 56, 112):
            if r * tw <= 128:
                plan = nkc.dense_tile(h, w, cout, stride, r, tw)
                for bits, args in checks.items():
                    got = torch.empty((ho, wo, cout), dtype=torch.uint8,
                                      device=dev)
                    nkc._launch_dense(*args, got, bits, cin, stride, plan)
                    want = ref.conv3x3_dense(*args, bits=bits, cin=cin,
                                             stride=stride)
                    if not torch.equal(got, want):
                        raise AssertionError(f"conv0 {plan} bits={bits}: "
                                             "differs from the plain version")
                outs = [torch.empty((ho, wo, cout), dtype=torch.uint8,
                                    device=dev) for _ in sets]
                ms = cs.graph_ms(torch, lambda i: nkc._launch_dense(
                    *sets[i], outs[i], 8, cin, stride, plan), len(sets))
                rows.append(dict(plan=plan._asdict(), ms=ms))
    rows.sort(key=lambda r: r["ms"])
    chosen = nkc.dense_plan(h, w, cout, stride)._asdict()
    chosen_ms = next(r["ms"] for r in rows if r["plan"] == chosen)
    print(f"[sweep] conv0 {shape}: best {rows[0]['ms']:.4f} ms "
          f"{rows[0]['plan']}, chosen {chosen_ms:.4f} ms {chosen}",
          flush=True)
    return {jobs[0].name: dict(shape=list(shape), chosen=chosen,
                               chosen_ms=chosen_ms, by_plan=rows)}


def sweep_dw(torch, cs, packing, ops, ref, nkc, gen, dev, jobs) -> dict:
    """Every depthwise plan at each depthwise shape: checked bit for bit at
    8, 4 and 2 bits, then timed at 8 bits."""
    out = {}
    for shape, name in dw_shapes(jobs).items():
        h, w, c, stride = shape
        checks = {}
        for bits in (8, 4, 2):
            args = cs.neureka_case(torch, packing, ops, gen, dev, "dw3x3",
                                   shape, bits)
            checks[bits] = (args, ref.conv3x3_dw(*args, bits=bits,
                                                 stride=stride))
        sets = cs.cold_sets(torch, packing, ops, gen, dev, "dw3x3", shape, 8)
        rows = []
        for plan in nkc.dw_plans(h, w, c, stride):
            for bits, (args, want) in checks.items():
                got = nkc.conv3x3_dw(*args, bits=bits, stride=stride,
                                     plan=plan)
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} {plan} bits={bits}: "
                                         "differs from the plain version")
            ms = cs.graph_ms(torch, lambda i: nkc.conv3x3_dw(
                *sets[i], bits=8, stride=stride, plan=plan), len(sets))
            rows.append(dict(plan=plan._asdict(), ms=ms))
        rows.sort(key=lambda r: r["ms"])
        chosen = nkc.dw_plan(h, w, c, stride)._asdict()
        out[name] = dict(shape=list(shape), chosen=chosen,
                         chosen_ms=next(r["ms"] for r in rows
                                        if r["plan"] == chosen),
                         by_plan=rows)
        print(f"[sweep] {name} {shape}: best {rows[0]['ms']:.4f} ms "
              f"{rows[0]['plan']}, chosen {out[name]['chosen_ms']:.4f} ms "
              f"{chosen}", flush=True)
    return out


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", type=Path, default=[])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--op", action="append", choices=OPS, default=[],
                    help="the operators --sweep covers (default: all)")
    ap.add_argument("--host", action="store_true",
                    help="time only the host clock (host_times) per tree")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps({"tree": str(args.one),
                          "times": one(args.one, args.host)}))
        return 0
    if args.sweep:
        res = sweep(tuple(args.op) or OPS)
        card = card_line()
        dest = ROOT / "build"
        dest.mkdir(exist_ok=True)
        (dest / "neureka_sweep.json").write_text(json.dumps(
            {"card": card, "sweep": res}, indent=1))
        print(card)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("neureka_ab: no CUDA device is available", file=sys.stderr)
        return 1
    runs = []
    for tree in args.tree or [ROOT]:
        out = subprocess.run([sys.executable, __file__, "--one", str(tree)]
                             + ["--host"] * args.host,
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
