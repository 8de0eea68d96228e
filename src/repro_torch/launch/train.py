"""End-to-end training launcher of the port (reference:
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 50 --batch 8 --seq 256 --smoke [--device cpu] \\
        [--inject-failure-at K]

``--smoke`` trains the arch's reduced config; without it the full config.
It runs on the CUDA card unless ``--device cpu`` asks for the CPU.  The
loop is the fault-tolerant ``Trainer``: step-indexed data, async atomic
checkpoints (in a fresh temporary directory unless ``--ckpt-dir`` names
one), the straggler monitor and automatic restart.  Every family trains:
the VLM's batches carry patch embeddings, the encoder-decoder's frame
embeddings (the stub frontends' inputs).
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.steps import _init_fn, make_train_step
from repro_torch.optim import adamw
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                    "one, removed at the end)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)            # raises without a card
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    init_fn = _init_fn(cfg)
    opt = adamw()
    train_step = make_train_step(cfg, opt, lr=args.lr)

    def init_state():
        params = init_fn(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
        return dict(params=params, opt_state=opt.init(params))

    dataset = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch,
                                 family=cfg.family, d_model=cfg.d_model,
                                 n_frames=cfg.n_audio_frames,
                                 n_patches=cfg.n_patches)
    injector = (FailureInjector([args.inject_failure_at])
                if args.inject_failure_at >= 0 else None)
    with tempfile.TemporaryDirectory(prefix="repro_train_") as tmp:
        trainer = Trainer(
            TrainerConfig(total_steps=args.steps,
                          checkpoint_every=args.ckpt_every,
                          checkpoint_dir=args.ckpt_dir or tmp),
            train_step, init_state, dataset, failure_injector=injector,
            device=dev)
        out = trainer.run()
    losses = [m["loss"] for m in out["metrics"]]
    print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f} "
          f"({len(losses)} steps, {out['restarts']} restarts)")
    return out


if __name__ == "__main__":
    main()
