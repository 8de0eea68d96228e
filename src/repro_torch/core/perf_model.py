"""Network walks for the scenario study (paper §IV, Figs 10-11).

A copy of ``repro/core/perf_model.py`` (framework-neutral).  It holds the
MobileNet-V2-1.0-224 job list exactly as it maps onto N-EUREKA's three
operators -- the list ``models/mobilenet_v2.apply`` walks -- and the
end-to-end latency/energy walk of the four NVM integration scenarios,
calibrated to the paper's silicon:

    L3FLASH : 12.6 ms / 3.8 mJ   (off-chip share of energy ~ 55 %)
    L3MRAM  : ~0.8x latency of L3FLASH, ~0.5x energy
    L2MRAM  : 1.2x faster than L3MRAM, energy ~ L3MRAM
    L1MRAM  :  7.3 ms / 1.4 mJ   (1.7x / 3x vs L3FLASH)
"""

from __future__ import annotations

from typing import List, Tuple

from repro_torch.core.memsys import (LayerShape, LayerTiming, NOMINAL,
                                     OperatingPoint, network_walk, SCENARIOS)
from repro_torch.core.placement import (HOT, COLD, Placement, PlacementPlan,
                                        plan_for_budget)

# MobileNet-V2 inverted-residual stack: (expansion t, cout, repeats n, stride s)
_MNV2_BLOCKS = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def mobilenet_v2_jobs(weight_bits: int = 8, img: int = 224) -> List[LayerShape]:
    """MobileNet-V2-1.0 as a sequence of N-EUREKA jobs (HWC, 8-bit act)."""
    jobs: List[LayerShape] = []
    h = w = img // 2
    jobs.append(LayerShape("conv0", "dense3x3", img, img, 3, 32, stride=2,
                           weight_bits=weight_bits))
    cin = 32
    bi = 0
    for t, c, n, s in _MNV2_BLOCKS:
        for r in range(n):
            stride = s if r == 0 else 1
            hid = cin * t
            tag = f"b{bi}"
            if t != 1:
                jobs.append(LayerShape(f"{tag}.pw_exp", "pw1x1", h, w, cin,
                                       hid, weight_bits=weight_bits))
            jobs.append(LayerShape(f"{tag}.dw", "dw3x3", h, w, hid, hid,
                                   stride=stride, weight_bits=weight_bits))
            if stride == 2:
                h, w = -(-h // 2), -(-w // 2)
            jobs.append(LayerShape(f"{tag}.pw_proj", "pw1x1", h, w, hid, c,
                                   weight_bits=weight_bits))
            cin = c
            bi += 1
    jobs.append(LayerShape("conv_last", "pw1x1", h, w, cin, 1280,
                           weight_bits=weight_bits))
    jobs.append(LayerShape("fc", "pw1x1", 1, 1, 1280, 1000,
                           weight_bits=weight_bits))
    return jobs


def mnv2_scenario_table(op: OperatingPoint = NOMINAL,
                        weight_bits: int = 8) -> dict:
    """{scenario: (latency_s, energy_j, [LayerTiming])} — reproduces Fig 10."""
    jobs = mobilenet_v2_jobs(weight_bits)
    return {s: network_walk(jobs, s, op) for s in SCENARIOS}


def mnv2_budget_plan(budget_bytes: int = 2 * 1024 * 1024,
                     weight_bits: int = 8,
                     hot: Placement = HOT,
                     cold: Placement = COLD) -> PlacementPlan:
    """A mixed placement for MobileNet-V2: greedily pin the layers with the
    highest weight-bytes-per-inference into the At-MRAM budget; everything
    else pages from the cold scenario (§II-B2 against a tightened budget —
    at the paper's 4 MiB the full 8-bit network is resident, so the mixed
    case is exercised with a smaller budget or fatter weights)."""
    jobs = mobilenet_v2_jobs(weight_bits)
    sizes = {j.name: j.weight_bytes for j in jobs}
    return plan_for_budget(sizes, budget_bytes, hot=hot, cold=cold,
                           sizes_bits=weight_bits)


def mnv2_plan_walk(plan: PlacementPlan, op: OperatingPoint = NOMINAL,
                   weight_bits: int = 8
                   ) -> Tuple[float, float, List[LayerTiming]]:
    """Latency/energy of MobileNet-V2 under a mixed placement plan."""
    return network_walk(mobilenet_v2_jobs(weight_bits), plan, op)


def mnv2_total_macs() -> int:
    return sum(j.macs for j in mobilenet_v2_jobs())


def mnv2_weight_bytes(weight_bits: int = 8) -> int:
    return sum(j.weight_bytes for j in mobilenet_v2_jobs(weight_bits))
