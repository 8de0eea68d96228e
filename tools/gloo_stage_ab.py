#!/usr/bin/env python3
"""The two ways ``gloo`` can run a collective of CUDA tensors, in turns on
one card: handed the CUDA tensor (gloo's own CUDA path), or staged by hand
through a pinned host buffer (copy out, the host collective, copy back).

    python3 tools/gloo_stage_ab.py [--reduce-mb 1126] [--gather-mb 844] [--rounds 2]

Four ranks (``parallel/distributed.run_ranks``) on the one card form the
(2, 2) ``("data", "model")`` rank mesh of ``chip_smoke.py`` phase 17.  The
all-reduce runs over each "data" pair on a flat f32 buffer of
``--reduce-mb`` MB, the size of the sharded train step's gradient
all-reduce at 8 of qwen3-0.6b's layers; the all-gather runs over the world
on each rank's ``--gather-mb / 3`` MB of blocks (what the step's one
all-gather brings a rank is ``--gather-mb``).  Each round times both
collectives both ways in the order unstaged, staged, staged, unstaged.
Prints one JSON line with every time (host clock, seconds, rank 0's,
after a barrier and a synchronize) beside the card's name and power
limit, and writes it to ``chiprun_out/gloo_stage_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _timed(torch, dist, fn):
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _rank(reduce_mb: float, gather_mb: float, rounds: int):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_rank_mesh

    dev = torch.device("cuda")
    mesh = make_rank_mesh((2, 2), ("data", "model"), dev)
    pair = mesh.group("data")
    buf = torch.randn(int(reduce_mb * 1e6 / 4), device=dev)
    blocks = torch.randn(int(gather_mb * 1e6 / 3 / 4), device=dev)
    world = dist.get_world_size()

    def pinned(t):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)

    def reduce_cuda():
        dist.all_reduce(buf, group=pair)

    def reduce_staged():
        host = pinned(buf)
        dist.all_reduce(host, group=pair)
        buf.copy_(host)

    def gather_cuda():
        parts = [torch.empty_like(blocks) for _ in range(world)]
        dist.all_gather(parts, blocks)

    def gather_staged():
        src = pinned(blocks)
        parts = [torch.empty_like(src) for _ in range(world)]
        dist.all_gather(parts, src)
        [p.to(dev) for p in parts]

    ways = dict(all_reduce=dict(cuda=reduce_cuda, staged=reduce_staged),
                all_gather=dict(cuda=gather_cuda, staged=gather_staged))
    out = {name: dict(cuda=[], staged=[]) for name in ways}
    for _ in range(rounds):
        for name, fns in ways.items():
            for way in ("cuda", "staged", "staged", "cuda"):
                out[name][way].append(_timed(torch, dist, fns[way]))
    return out


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reduce-mb", type=float, default=1126.0)
    ap.add_argument("--gather-mb", type=float, default=844.0)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gloo_stage_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.parallel.distributed import run_ranks

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    ranks = run_ranks(_rank, 4, args.reduce_mb, args.gather_mb, args.rounds,
                      timeout_s=600)
    res = dict(card=card, reduce_mb=args.reduce_mb, gather_mb=args.gather_mb,
               times_s=ranks[0])
    for name, t in ranks[0].items():
        print(f"[gloo_stage_ab] {name}: gloo's CUDA path "
              f"{[round(x, 3) for x in t['cuda']]} s, staged by hand "
              f"{[round(x, 3) for x in t['staged']]} s; {card}")
    line = json.dumps(res)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gloo_stage_ab.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
