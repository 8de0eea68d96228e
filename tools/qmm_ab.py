#!/usr/bin/env python3
"""Device times of the f32 packed matmuls (B1 ``qmatmul_f32``, B3
``qmatmul_f32_blockscale``) of one or more checkouts of the port, on one
CUDA card, in turns.

    python3 tools/qmm_ab.py --tree build/parent --tree . --tree . \\
        --tree build/parent

Each ``--tree`` is the root of a checkout (it holds ``src/repro_torch``);
each runs in its own process, in the order given, which builds that tree's
kernels and times, with ``chip_smoke.py``'s timing helpers of this
checkout (CUDA-graph replay, L2-cold, TF32 off): qwen3-0.6b's seven linears
of a layer at decode M = 4 and prefill M = 256, 8-bit; the paged serve's
four cold linears in int8 wire form at M = 4 and 256; falcon-mamba-7b's four
linears of a layer at M = 4 and 256, 8-bit.  Each process prints one JSON line;
the last line gives them all with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(tree: Path) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("qmm_ab: no CUDA device is available")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import chip_smoke as cs
    from repro_torch.core import packing
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import qmatmul as qmm

    assert Path(qmm.__file__).resolve().is_relative_to(tree.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cs.phase_build(build)
    cold = [cs.LAYER_LINEARS[n] for n in ("wq", "wo", "wv", "w_up")]
    res = {
        "b1_decode": cs.time_qmatmul(torch, packing, ops, ref, qmm, dev, 4),
        "b1_prefill": cs.time_qmatmul(torch, packing, ops, ref, qmm, dev,
                                      256),
        "b3_decode": cs.time_blockscale(torch, packing, ref, qmm, dev, 4,
                                        cold),
        "b3_prefill": cs.time_blockscale(torch, packing, ref, qmm, dev, 256,
                                         cold),
        "falcon_decode": cs.time_qmatmul(
            torch, packing, ops, ref, qmm, dev, 4, copies=2,
            linears=cs.FALCON_LINEARS,
            what="qmatmul_f32 falcon-mamba-7b layer x4"),
        "falcon_prefill": cs.time_qmatmul(
            torch, packing, ops, ref, qmm, dev, 256, copies=2,
            linears=cs.FALCON_LINEARS,
            what="qmatmul_f32 falcon-mamba-7b layer x4"),
    }
    return {k: {f: v.get(f) for f in ("ms", "ms_runs", "plain_ms",
                                       "library_ms", "bound_ms", "bytes_ms",
                                       "tf32_ops_ms", "bound_f32_ms",
                                       "eager_ms")}
            for k, v in res.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", type=Path, default=[])
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps({"tree": str(args.one), "times": one(args.one)}))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("qmm_ab: no CUDA device is available", file=sys.stderr)
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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
