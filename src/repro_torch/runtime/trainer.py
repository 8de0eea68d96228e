"""Fault-tolerant training loop (reference: ``repro/runtime/trainer.py``).

    restore-or-init -> [step: data(step) -> train_step -> monitor
                        -> periodic async checkpoint] -> on failure:
    re-enter restore-or-init (a fresh process does the same).

The data pipeline is step-indexed and the checkpoint holds (params,
opt_state, step), so a run crashed at any step resumes on the same
numbers; under ``torch.use_deterministic_algorithms(True)`` the final
params equal an uninterrupted run's bit for bit.  ``init_state`` must
re-create the same state on every call (its own seeded
``torch.Generator``).  A step's span on the monitor ends after the loss is
read on the host, so it holds the step's device work, as the reference's
``jax.block_until_ready`` does.

As in the reference, every ``RuntimeError`` out of a step counts as a
failure and is retried up to ``max_restarts`` times; a CUDA error is one.

On a rank mesh (``shardings=``, reference ``:40-68``) every rank runs the
same loop: ``init_state`` gives the rank's sharded state
(``parallel/distributed.shard_tree``), a restart restores onto the
current mesh's shardings, each rank takes ``dataset.batch(step)`` (the
same on every rank, so nothing is broadcast) and the sharded step keeps
its rows (``distributed.local_rows``).  A failure injected on a step
fails every rank on it, so every rank restarts from the same checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.data import SyntheticLMDataset
from repro_torch.runtime.monitor import FailureInjector, StragglerMonitor


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = "repro_ckpt"
    keep_n: int = 3
    log_every: int = 10
    max_restarts: int = 3


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_step: Callable,
                 init_state: Callable[[], Dict[str, Any]],
                 dataset: SyntheticLMDataset,
                 failure_injector: Optional[FailureInjector] = None,
                 device: DeviceLike = None,
                 shardings: Optional[Dict[str, Any]] = None):
        """``init_state() -> {"params": ..., "opt_state": ...}`` on
        ``device`` (default ``cuda``), where the batches go too;
        ``train_step(params, opt_state, batch) -> (params, opt, metrics)``.
        ``shardings``: the state's ``NamedSharding`` tree on the current
        rank mesh, which a restart restores onto.
        """
        self.cfg = cfg
        self.train_step = train_step
        self.init_state = init_state
        self.dataset = dataset
        self.injector = failure_injector
        self.device = resolve_device(device)
        self.shardings = shardings
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, keep_n=cfg.keep_n)
        self.monitor = StragglerMonitor()
        self.metrics_log = []
        self.restarts = 0

    # -- restore-or-init ------------------------------------------------------
    def _bring_up(self):
        self.ckpt.wait()        # an in-flight write lands before the lookup
        state = self.init_state()
        start_step = 0
        if self.ckpt.latest_step() is not None:
            start_step, state = self.ckpt.restore(
                dict(state), shardings=self.shardings, device=self.device)
            start_step += 1
        return start_step, state

    # -- main loop ------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        while True:
            try:
                return self._run_once()
            except RuntimeError as e:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                print(f"[trainer] failure ({e}); restart "
                      f"{self.restarts}/{self.cfg.max_restarts}")

    def _run_once(self) -> Dict[str, Any]:
        step, state = self._bring_up()
        params, opt_state = state["params"], state["opt_state"]
        while step < self.cfg.total_steps:
            if self.injector is not None:
                self.injector.maybe_fail(step)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.dataset.batch(step).items()}
            self.monitor.step_start()
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            loss = float(metrics["loss"])    # waits for the device
            straggler = self.monitor.step_end()
            self.metrics_log.append(dict(step=step, loss=loss,
                                         straggler=straggler))
            if step % self.cfg.log_every == 0:
                print(f"[trainer] step {step} loss {loss:.4f}"
                      + (" [straggler]" if straggler else ""))
            if (step + 1) % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step, dict(params=params,
                                          opt_state=opt_state))
            step += 1
        self.ckpt.save(self.cfg.total_steps - 1,
                       dict(params=params, opt_state=opt_state), block=True)
        self.ckpt.wait()
        return dict(params=params, opt_state=opt_state,
                    metrics=self.metrics_log, restarts=self.restarts)
