"""Render the dry-run's tables from dryrun_results/*.json (reference:
``repro/launch/report.py``; it reads the reference's records too).

    PYTHONPATH=src python -m repro_torch.launch.report [--dir dryrun_results]

The port compiles nothing: its records' ``compile_s`` holds the seconds of
the count, so that column is headed "count".  The roofline tables gain a
"measured step" column, the card's ``measured_step_s`` where a record has
one (``launch/dryrun.py --measure``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    for unit, scale in (("s", 1.0), ("ms", 1e-3), ("us", 1e-6)):
        if x >= scale:
            return f"{x/scale:.2f}{unit}"
    return f"{x*1e6:.3f}us"


def fmt_b(x: float) -> str:
    for unit, scale in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= scale:
            return f"{x/scale:.2f}{unit}"
    return f"{x:.0f}B"


def load(results_dir: Path):
    recs = {}
    for f in sorted(results_dir.glob("*.json")):
        recs[f.stem] = json.loads(f.read_text())
    return recs


def dryrun_table(recs) -> str:
    lines = ["| cell | mesh | status | count | peak mem/chip | args/chip | collectives (per-chip bytes) |",
             "|---|---|---|---|---|---|---|"]
    for name, r in recs.items():
        if r.get("serve_bits", 8) != 8 or "_opt" in name:
            continue
        if r["status"] == "skipped":
            lines.append(f"| {name} | - | SKIP (sub-quadratic-only shape) "
                         f"| - | - | - | - |")
            continue
        mem = r.get("memory", {})
        peak = mem.get("peak_memory_in_bytes", 0)
        args = mem.get("argument_size_in_bytes", 0)
        cc = r.get("collectives", {}).get("counts", {})
        cb = r.get("collectives", {}).get("total_bytes", 0)
        cstr = " ".join(f"{k}:{v}" for k, v in sorted(cc.items()))
        lines.append(
            f"| {name} | {r.get('mesh','')} | {r['status']} "
            f"| {r.get('compile_s', 0):.1f}s | {fmt_b(peak)} | {fmt_b(args)} "
            f"| {cstr} ({fmt_b(cb)}) |")
    return "\n".join(lines)


def roofline_table(recs, multi_pod=False) -> str:
    lines = ["| arch x shape | compute | memory | collective | bound | "
             "MODEL_FLOPS | useful frac | lever | measured step |",
             "|---|---|---|---|---|---|---|---|---|"]
    for name, r in recs.items():
        if r["status"] != "ok" or r.get("serve_bits", 8) != 8 or "_opt" in name:
            continue
        if r.get("multi_pod", False) != multi_pod:
            continue
        rf = r["roofline"]
        tot = r["cost"].get("total_flops", 0)
        uf = r["model_flops"] / tot if tot else 0
        bound = rf["bound"]
        lever = {
            "compute": "more chips / lower precision matmuls",
            "memory": "fuse f32 converts, bf16 softmax/scan, cut activation round-trips",
            "collective": "resharding: drop FSDP gather for small params, EP all-to-all, DP-only batch axes",
        }[bound]
        measured = r.get("measured_step_s")
        lines.append(
            f"| {name.replace('_1pod','').replace('_2pod','')} "
            f"| {fmt_s(rf['compute_s'])} | {fmt_s(rf['memory_s'])} "
            f"| {fmt_s(rf['collective_s'])} | **{bound}** "
            f"| {r['model_flops']:.2e} | {uf:.3f} | {lever} "
            f"| {'-' if measured is None else fmt_s(measured)} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="dryrun_results")
    ap.add_argument("--section", default="all",
                    choices=("all", "dryrun", "roofline"))
    args = ap.parse_args(argv)
    recs = load(Path(args.dir))
    if args.section in ("all", "dryrun"):
        print("## Dry-run table (both meshes)\n")
        print(dryrun_table(recs))
        print()
    if args.section in ("all", "roofline"):
        print("## Roofline (single-pod 16x16, per chip)\n")
        print(roofline_table(recs, multi_pod=False))
        print()
        print("## Roofline (multi-pod 2x16x16, per chip)\n")
        print(roofline_table(recs, multi_pod=True))


if __name__ == "__main__":
    main()
