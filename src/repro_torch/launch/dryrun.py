"""The dry-run: every (arch x shape x mesh) cell counted as one rank of the
production mesh (reference: ``repro/launch/dryrun.py``).

The reference compiles each cell for a 256- or 512-chip mesh on
placeholder host devices.  The port has no compiler to ask: it runs the
rank's own program once on ``meta`` tensors (shapes, no data) as rank 0
of a fake process group of 256 or 512 ranks
(``launch/mesh.make_production_mesh``) and counts what it does
(``launch/hlo_analysis``).  Per cell it records, under the reference's
keys, so that ``launch/report.py`` reads both:

* ``memory``: ``argument_size_in_bytes``, what the rank holds of the
  cell's inputs by the placement rules; ``peak_memory_in_bytes`` only
  under ``--measure``;
* ``cost``: FLOPs and bytes of the rank's program; ``layer_corrections``
  stays zero (eager dispatch counts every loop iteration);
* ``collectives``: the rank's census from the train step's
  ``metrics["comm"]``;
* ``roofline``: the three terms on H100 rates; ``model_flops`` (6ND or
  2ND) and ``useful_flops_frac``;
* ``lower_s``: seconds to build the cell; ``compile_s``: seconds of the
  count (the port compiles nothing); ``hlo_n_lines``: None (no HLO).

A train cell is rank 0 running the port's distributed step
(``launch/dist_steps``).  A serve cell is the port's one-device serve step
on the rank's dp rows with whole weights, since the port has no
model-split serve: its record says ``"split": "dp rows only"``, and it
sends nothing.  ``--measure`` adds the card's timing at depth 1 and 2
(``launch/microbench.layer_cost``): ``measured_step_s``, ``layer_s``,
``peak_bytes`` and ``fits``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --serve-bits 4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape prefill_32k --measure                                  # on a card
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell, cell_specs, rank_rows
from repro_torch.models.transformer import (active_param_count,
                                            total_param_count)

RESULTS_DIR = Path("dryrun_results")


def model_flops(cfg, cell) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (per decode/prefill token)."""
    n_active = active_param_count(cfg)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    if cfg.family == "vlm" and cell.kind != "decode":
        tokens = cell.global_batch * cell.seq_len   # patches count as tokens
    mult = 6 if cell.kind == "train" else 2
    return float(mult * n_active * tokens)


def count_cell(cfg, cell, mesh, serve_bits: int = 8) -> Dict[str, Any]:
    """Build ``cell`` for rank 0 of ``mesh`` (ranks on ``meta``) and count
    its program: the record's measured-free fields."""
    t0 = time.time()
    fn, args, _ = build_cell(cfg, cell, mesh, serve_bits=serve_bits)
    specs = cell_specs(cfg, cell, mesh, serve_bits=serve_bits)
    t_build = time.time() - t0
    with hlo_analysis.CostCounter() as counter:
        out = fn(*args)
    t_count = time.time() - t0 - t_build
    flops, hbm_bytes = hlo_analysis.extract_cost(counter)
    comm = out[2]["comm"] if cell.kind == "train" else None
    coll = hlo_analysis.collective_stats(comm)
    n = mesh.devices.size
    roof = hlo_analysis.Roofline(flops_per_chip=flops,
                                 hbm_bytes_per_chip=hbm_bytes,
                                 collective_bytes_per_chip=coll.total_bytes,
                                 n_chips=n)
    mf = model_flops(cfg, cell)
    zero = dict(flops=0.0, hbm_bytes=0.0, collective_bytes=0.0)
    rec = dict(
        status="ok",
        lower_s=round(t_build, 2), compile_s=round(t_count, 2),
        memory=hlo_analysis.memory_analysis_dict(specs, mesh),
        cost=dict(flops_per_chip_raw=flops, hbm_bytes_per_chip_raw=hbm_bytes,
                  layer_corrections=zero, flops_per_chip=flops,
                  hbm_bytes_per_chip=hbm_bytes, total_flops=flops * n),
        collectives=dict(counts=coll.counts, bytes=coll.bytes_by_kind,
                         total_bytes=coll.total_bytes),
        roofline=roof.as_dict(),
        model_flops=mf,
        useful_flops_frac=mf / (flops * n) if flops else None,
        params_total=total_param_count(cfg),
        params_active=active_param_count(cfg),
        hlo_n_lines=None,
        aten_ops=counter.ops, kernels=counter.kernels)
    if cell.kind != "train":
        rec.update(split="dp rows only",
                   rank_rows=rank_rows(cell.global_batch, mesh))
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool, serve_bits: int = 8,
             tag: str = "", overrides: Optional[dict] = None,
             measure: bool = False) -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    cell = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    rec = dict(arch=arch, shape=shape,
               mesh="x".join(map(str, mesh.devices.shape)),
               multi_pod=multi_pod, n_chips=mesh.devices.size,
               serve_bits=serve_bits, kind=cell.kind, status="start")
    rec.update(count_cell(cfg, cell, mesh, serve_bits))
    if measure:
        from repro_torch.launch.microbench import layer_cost
        lc = layer_cost(cfg, cell, multi_pod=multi_pod,
                        serve_bits=serve_bits)
        rec["measured"] = lc
        rec["measured_step_s"] = lc["measured_step_s"]
        rec["memory"]["peak_memory_in_bytes"] = float(lc["peak_bytes"])
    return rec


def cell_name(arch, shape, multi_pod, serve_bits, tag=""):
    pod = "2pod" if multi_pod else "1pod"
    suffix = f"_w{serve_bits}" if serve_bits != 8 else ""
    tag = f"_{tag}" if tag else ""
    return f"{arch}_{shape}_{pod}{suffix}{tag}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch (default all)")
    ap.add_argument("--shape", default=None, help="single shape (default all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--serve-bits", type=int, default=8)
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override, e.g. attn_dtype=bfloat16")
    ap.add_argument("--measure", action="store_true",
                    help="also time the cell on the card at depth 1 and 2")
    ap.add_argument("--dir", default=str(RESULTS_DIR),
                    help="where the records go")
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            pass
        overrides[k] = v

    results = Path(args.dir)
    results.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                name = cell_name(arch, shape, mp, args.serve_bits, args.tag)
                out = results / f"{name}.json"
                if out.exists() and not args.force:
                    print(f"[cached] {name}")
                    n_ok += 1
                    continue
                if not applicable(arch, shape):
                    rec = dict(arch=arch, shape=shape, multi_pod=mp,
                               status="skipped",
                               reason="long_500k requires sub-quadratic "
                                      "attention")
                    out.write_text(json.dumps(rec, indent=1))
                    print(f"[skip]   {name}")
                    n_skip += 1
                    continue
                try:
                    rec = run_cell(arch, shape, mp, args.serve_bits, args.tag,
                                   overrides=overrides, measure=args.measure)
                    n_ok += 1
                    r = rec["roofline"]
                    meas = (f" measured={rec['measured_step_s']:.3e}s"
                            if args.measure else "")
                    print(f"[ok]     {name}: count {rec['compile_s']:.1f}s "
                          f"bound={r['bound']} compute={r['compute_s']:.2e}s "
                          f"mem={r['memory_s']:.2e}s "
                          f"coll={r['collective_s']:.2e}s{meas}")
                except Exception as e:
                    rec = dict(arch=arch, shape=shape, multi_pod=mp,
                               status="error", error=str(e),
                               traceback=traceback.format_exc())
                    n_fail += 1
                    print(f"[FAIL]   {name}: {e}")
                out.write_text(json.dumps(rec, indent=1))
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
