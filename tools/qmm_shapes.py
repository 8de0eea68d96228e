#!/usr/bin/env python3
"""Device time of ``qmatmul_f32`` / ``qmatmul_f32_blockscale`` at single
shapes on one CUDA card, with the K split the wrapper picks and the rate
that the route's operations reach (two TF32 passes for f32 x, one for bf16).

    python3 tools/qmm_shapes.py                      # the serves' shapes
    python3 tools/qmm_shapes.py 256,4096,16384,8,f32 256,100,3200,8,bs

Each shape is M,K,N,bits,kind with kind ``f32`` / ``bf16`` (x of
``qmatmul_f32``) or ``bs`` (``qmatmul_f32_blockscale``).  Times are CUDA-graph
replays over copies of the weights that exceed the 50 MB L2, as in
``chip_smoke.py``.  Prints one line a shape (with the rate at which the
packed weights and their scales stream, which binds at decode) and a JSON
line with all of them and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT = ["256,1024,2048,8,f32", "256,1024,1024,8,f32", "256,2048,1024,8,f32",
           "256,1024,3072,8,f32", "256,3072,1024,8,f32",
           "256,4096,16384,8,f32", "256,4096,16384,4,f32",
           "256,4096,16384,2,f32", "256,4096,16384,8,bf16",
           "256,8192,288,8,f32", "256,256,8192,8,f32", "256,8192,4096,8,f32",
           "256,1024,2048,8,bs", "256,1024,3072,8,bs",
           "4,1024,2048,8,f32", "4,3072,1024,8,f32", "4,4096,16384,8,f32",
           "4,4096,16384,4,f32", "4,4096,16384,2,f32", "4,4096,16384,8,bf16",
           "4,8192,288,8,f32", "4,256,8192,8,f32", "4,8192,4096,8,f32",
           "1,4096,16384,8,f32", "16,4096,16384,8,f32", "4,100,3200,8,f32",
           "4,1024,2048,8,bs", "4,1024,3072,8,bs",
           "4652,1600,6400,8,f32", "4652,100,3200,8,f32"]


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("qmm_shapes: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import qmatmul as qmm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.build_all()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for spec in argv or DEFAULT:
        m, k, n, bits, kind = spec.split(",")
        m, k, n, bits = int(m), int(k), int(n), int(bits)
        copies = max(2, int(cs.L2_COLD_BYTES // (n * k * bits / 8)) + 1)
        sets = []
        for _ in range(copies):
            x = torch.randn((m, k), generator=gen, device=dev)
            if kind == "bs":
                packed, scales = cs.wire_weight(torch, gen, dev, n, k, bits)
                sets.append((x, packed, scales))
            else:
                w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
                packed, scale = ops.prep_linear(w, bits)
                sets.append((x.to(torch.bfloat16) if kind == "bf16" else x,
                             packed, scale))

        def call(i):
            x, p, s = sets[i % copies]
            if kind == "bs":
                qmm.qmatmul_f32_blockscale(x, p, s, bits=bits, k_orig=k)
            else:
                qmm.qmatmul_f32(x, p, s, bits=bits, k_orig=k)

        ms = cs.graph_ms(torch, call, copies)
        passes = 1 if kind == "bf16" else 2
        geo = qmm.tc_geometry("qmatmul_blockscale" if kind == "bs"
                              else "qmatmul_f32")
        splits = qmm.tc_splits(m, n, k, sms, geo, bits)
        wbytes = sum(t.numel() * t.element_size() for t in sets[0][1:])
        row = dict(shape=spec, ms=ms, splits=splits,
                   tflops=passes * 2 * m * n * k / (ms * 1e-3) / 1e12,
                   weight_gbps=wbytes / (ms * 1e-3) / 1e9)
        print(f"[shape] {spec}: {ms:.4f} ms, {row['splits']} splits, "
              f"{row['tflops']:.1f} TFLOP/s at the route's passes, weights "
              f"and scales at {row['weight_gbps']:.0f} GB/s")
        rows.append(row)
        del sets
        torch.cuda.empty_cache()
    card = cs.card_line()
    print(card)
    print(json.dumps({"shapes": rows, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
