"""NeuralEngine: the heterogeneous-cluster dispatch (paper §II-A; reference:
``repro/core/engine.py:32-77``).

Siracusa pairs N-EUREKA (the quantized engine) with 8 RISC-V DSP cores in
one cluster sharing L1.  Every compute site declares an engine:

  "neureka" — the quantized path: packed weights (WeightStore), the fused
              dequant kernels, a selectable weight placement scenario;
  "dsp"     — the float path: plain PyTorch ops.

``EngineConfig.mode`` is carried for compatibility and ignored, as
``PlacementPlan.mode`` is: the device of the tensors picks the path (a CUDA
tensor runs the Hopper kernel, a CPU tensor its plain PyTorch version).
``placement.as_plan`` and ``placement.linear_dispatch`` accept an
``EngineConfig`` wherever they take a plan.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import scenarios
from repro_torch.core.placement import PlacementPlan
from repro_torch.core.weight_store import PackedParam


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    engine: str = "dsp"           # "neureka" | "dsp"
    scenario: str = "l1mram"      # weight placement of the neureka path
    mode: str = "xla"             # carried, not read (see the module doc)
    weight_bits: int = 8          # default packing precision
    # optional per-parameter placement; overrides `scenario` when set, so
    # one model can mix integration points (hot At-MRAM, cold paged)
    plan: Optional[PlacementPlan] = None

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_plan(cls, plan: PlacementPlan, engine: str = "neureka"
                  ) -> "EngineConfig":
        return cls(engine=engine, scenario=plan.default.scenario,
                   mode=plan.mode, weight_bits=plan.default.weight_bits,
                   plan=plan)

    def scenario_for(self, path: Optional[str]) -> str:
        if self.plan is not None:
            return self.plan.scenario_for(path)
        return self.scenario


DSP = EngineConfig(engine="dsp")
NEUREKA = EngineConfig(engine="neureka")


def linear(x: torch.Tensor, w, cfg: EngineConfig, *,
           path: Optional[str] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x @ W^T.  ``w`` is a PackedParam (neureka) or a dense (N, K)
    tensor (dsp); dense weights given to a neureka engine raise, since the
    packed store is the only weight source the accelerator reads.  With
    ``cfg.plan`` the scenario is resolved per parameter ``path``."""
    if isinstance(w, PackedParam):
        return scenarios.linear_apply(x, w, scenario=cfg.scenario_for(path),
                                      out_dtype=out_dtype)
    if cfg.engine == "neureka":
        raise TypeError("neureka engine requires packed weights "
                        "(freeze the params into a WeightStore first)")
    out = torch.matmul(x, w.T)
    return out.to(out_dtype) if out_dtype is not None else out
