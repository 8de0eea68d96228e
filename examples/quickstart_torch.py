"""Quickstart on the PyTorch port: the four steps of
``examples/quickstart.py``.

1. train a tiny LM (the reduced qwen3 config) for 30 AdamW steps,
2. freeze it into the packed At-MRAM store at 8 and 4 bits,
3. serve 6 requests through the deadline-aware ``Scheduler`` over the fused
   dequant path,
4. show that the NVM scenarios compute the same numbers by different weight
   paths (Fig 9 of the paper).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

It runs on the CUDA card (the Hopper kernels) unless ``--device cpu`` asks
for the plain PyTorch path.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import freeze_for_serving
from repro_torch.serving import Request, Scheduler, ServingEngine, validate


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)      # raises without a card

    cfg = get_config("qwen3-0.6b").smoke()
    print(f"config: {cfg.name} (reduced): {cfg.n_layers}L d{cfg.d_model}, "
          f"device {dev}")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tfm.init_params(cfg, gen, device=dev)

    # 1. train
    opt = adamw()
    step = make_train_step(cfg, opt, lr=1e-3)
    opt_state = opt.init(params)
    ds = SyntheticLMDataset(cfg.vocab_size, 64, 8, seed=0)
    for i in range(30):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ds.batch(i).items()}
        params, opt_state, m = step(params, opt_state, batch)
        if i % 10 == 0:
            print(f"  step {i:3d} loss {float(m['loss']):.4f}")
    print(f"  final loss {float(m['loss']):.4f}")

    # 2. freeze into the packed store ("MRAM programming")
    dense_b = _nbytes(params)
    for bits in (8, 4):
        packed_b = _nbytes(freeze_for_serving(params, bits=bits, device=dev))
        print(f"  W{bits}: {dense_b / 1e6:.2f} MB dense -> "
              f"{packed_b / 1e6:.2f} MB packed ({dense_b / packed_b:.1f}x "
              f"density, the MRAM advantage)")

    # 3. serve through the fused At-MRAM path, behind the scheduler
    packed = freeze_for_serving(params, bits=8, device=dev)
    eng = ServingEngine(cfg, packed, batch_slots=4, max_len=128,
                        engine=dict(scenario="l1mram", mode="xla", bits=8),
                        device=dev)
    sched = Scheduler(eng)
    rng = np.random.default_rng(0)
    for uid in range(6):
        sched.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, 8).astype(np.int32), max_new_tokens=8))
    done = sched.run_until_done()
    doc = validate(sched.metrics.summary(paging=eng.paging_summary()))
    if len(done) != 6 or any(len(r.generated) != 8 for r in done):
        raise SystemExit("not every request got its 8 tokens")
    print(f"  served {len(done)} requests "
          f"({sum(len(r.generated) for r in done)} tokens) in "
          f"{doc['ticks']['count']} scheduler ticks")

    # 4. the NVM scenarios: identical numerics, different bytes
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 16))).to(
        dev)
    outs = {sc: tfm.forward(packed, tokens, cfg,
                            engine=dict(scenario=sc, mode="xla", bits=8))
            for sc in ("l1mram", "l2mram", "l3mram")}
    drift = max(float((outs[s] - outs["l1mram"]).abs().max()) for s in outs)
    print(f"  scenario numerics drift: {drift:.2e} (identical math, "
          f"different weight paths: Fig 9 of the paper)")
    print("quickstart OK")


if __name__ == "__main__":
    main()
