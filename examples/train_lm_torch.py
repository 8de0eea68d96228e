"""End-to-end training on the PyTorch port (``examples/train_lm.py``): a
~100M-param LM for a few hundred steps with the full substrate -- the
fault-tolerant ``Trainer``, async checkpoints, the straggler monitor,
step-indexed data, and a mid-run injected failure that the loop survives.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
      [--tiny] [--device cpu]

It trains on the CUDA card unless ``--device cpu`` asks for the CPU;
``--tiny`` shrinks the model to the smoke size for a quick CPU run.
"""

import argparse
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig


def hundred_m_config() -> ModelConfig:
    """~100M params: 12L x d512, GQA 8/4 heads, swiglu -- qwen3 family."""
    return get_config("qwen3-0.6b").replace(
        n_layers=12, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=1536, vocab_size=32768, remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tiny", action="store_true",
                    help="shrink further for very fast CPU runs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)            # raises without a card

    cfg = hundred_m_config()
    if args.tiny:
        cfg = cfg.smoke()
    print(f"model: {cfg.name}-derived, "
          f"{tfm.total_param_count(cfg) / 1e6:.1f}M params, device {dev}")
    opt = adamw()
    step_fn = make_train_step(cfg, opt, lr=3e-4)

    def init_state():
        params = tfm.init_params(cfg, torch.Generator(device=dev)
                                 .manual_seed(0), device=dev)
        return dict(params=params, opt_state=opt.init(params))

    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch, seed=0)
    with tempfile.TemporaryDirectory(prefix="repro_train_lm_") as ckpt:
        trainer = Trainer(
            TrainerConfig(total_steps=args.steps, checkpoint_every=50,
                          checkpoint_dir=ckpt, log_every=20),
            step_fn, init_state, ds,
            failure_injector=FailureInjector([args.steps // 2]),  # chaos
            device=dev)
        out = trainer.run()
    losses = [m["loss"] for m in out["metrics"]]
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} "
          f"steps; survived {out['restarts']} injected failure(s); "
          f"{len(trainer.monitor.flagged)} straggler steps flagged")
    if not losses[-1] < losses[0]:
        raise SystemExit("training did not improve")
    print("train_lm OK")


if __name__ == "__main__":
    main()
