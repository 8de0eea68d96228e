"""Per-layer weight placement — where each weight lives (paper §IV Fig 9
scenarios + §II-B2 virtual paging).

A copy of the part of ``repro/core/placement.py`` that the executable linear
dispatch and the analytical model need: ``SCENARIOS``, ``ScenarioCost``,
``Placement``, ``HOT`` / ``COLD``, ``PlacementPlan``, ``as_plan``,
``linear_dispatch``, ``wire_served_bits`` and ``plan_for_budget`` over a
plain ``{name: nbytes}`` mapping.  It holds no tensor code.  The store
accounting and the ``WeightStore`` branch of ``plan_for_budget`` arrive with
the paging slice.

``PlacementPlan.mode`` and the legacy dict's ``"mode"`` key are accepted and
carried for compatibility, but the port ignores them: the device of the
tensors picks the path (a CUDA tensor runs the Hopper kernel, a CPU tensor
the plain PyTorch version; see ``kernels/ops.py``).
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Any, List, Mapping, Optional, Tuple

from repro_torch.core.weight_store import SIRACUSA_MRAM_BYTES

# The four NVM integration scenarios (paper §IV, Fig 9), loosest->tightest.
SCENARIOS = ("l3flash", "l3mram", "l2mram", "l1mram")

RESIDENCIES = ("resident", "paged")


@dataclasses.dataclass(frozen=True)
class ScenarioCost:
    """Per-byte weight-path costs for one integration scenario (filled in
    by ``memsys.scenario_costs``)."""
    name: str
    # bandwidth of the ingress stage feeding weights toward L2/L1
    weight_bw_Bps: float
    # energy per weight byte end-to-end (all hops)
    weight_energy_per_B: float
    # does the weight path steal L1 bandwidth from activations?
    weights_through_l1: bool
    # how many times each weight byte crosses the shared cluster port
    # (L3 scenarios store+load through L2 = 2; L2MRAM = 1; L1MRAM = 0)
    shared_port_crossings: int


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one parameter lives: integration scenario, packed precision,
    residency, and for paged parameters the wire precision ``page_bits``
    (``None`` streams the device form verbatim)."""

    scenario: str = "l1mram"
    weight_bits: int = 8
    residency: str = "resident"
    page_bits: Optional[int] = None

    def __post_init__(self):
        if self.scenario not in SCENARIOS:
            raise ValueError(f"unknown scenario {self.scenario!r}; "
                             f"expected one of {SCENARIOS}")
        if self.residency not in RESIDENCIES:
            raise ValueError(f"unknown residency {self.residency!r}; "
                             f"expected one of {RESIDENCIES}")
        if self.weight_bits not in (2, 4, 8):
            raise ValueError(f"weight_bits must be 2/4/8, got "
                             f"{self.weight_bits}")
        if self.page_bits is not None and self.page_bits not in (2, 4, 8):
            raise ValueError(f"page_bits must be None or 2/4/8, got "
                             f"{self.page_bits}")

    @property
    def paged(self) -> bool:
        return self.residency == "paged"


# Canonical hot/cold placements for budget planning: hot weights stream
# over the dedicated At-MRAM port; cold weights page in from off-chip
# flash (§II-B2).
HOT = Placement("l1mram", 8, "resident")
COLD = Placement("l3flash", 8, "paged")


def _match(path: str, pattern: str) -> bool:
    """Glob match on the full path or a ``/``-boundary suffix of it."""
    return (fnmatch.fnmatchcase(path, pattern)
            or fnmatch.fnmatchcase(path, "*/" + pattern))


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """Parameter path -> :class:`Placement`, first-matching-rule-wins."""

    default: Placement = Placement()
    rules: Tuple[Tuple[str, Placement], ...] = ()
    mode: str = "xla"
    wire_serve: bool = False

    @classmethod
    def uniform(cls, scenario: str = "l1mram", bits: int = 8,
                mode: str = "xla", residency: str = "resident"
                ) -> "PlacementPlan":
        return cls(default=Placement(scenario, bits, residency), mode=mode)

    def with_rule(self, pattern: str, placement: Placement) -> "PlacementPlan":
        return dataclasses.replace(self, rules=self.rules + ((pattern,
                                                              placement),))

    def placement_for(self, path: Optional[str]) -> Placement:
        if path is not None:
            for pattern, placement in self.rules:
                if _match(path, pattern):
                    return placement
        return self.default

    def scenario_for(self, path: Optional[str]) -> str:
        return self.placement_for(path).scenario

    def bits_for(self, path: Optional[str]) -> int:
        return self.placement_for(path).weight_bits


DEFAULT_PLAN = PlacementPlan()


def as_plan(engine: Any) -> PlacementPlan:
    """Normalize a plan, a legacy {"scenario", "mode", "bits"} dict or None
    into a PlacementPlan."""
    if engine is None:
        return DEFAULT_PLAN
    if isinstance(engine, PlacementPlan):
        return engine
    if isinstance(engine, Mapping):
        return PlacementPlan.uniform(
            scenario=engine.get("scenario", "l1mram"),
            bits=int(engine.get("bits", 8)),
            mode=engine.get("mode", "xla"))
    raise TypeError(f"cannot interpret {type(engine).__name__} as a "
                    "placement plan")


def linear_dispatch(engine: Any, path: Optional[str]
                    ) -> Tuple[str, str, int]:
    """(scenario, mode, bits) for one linear call site."""
    if isinstance(engine, Mapping):
        return (engine.get("scenario", "l1mram"),
                engine.get("mode", "xla"),
                int(engine.get("bits", 8)))
    plan = as_plan(engine)
    p = plan.placement_for(path)
    return p.scenario, plan.mode, p.weight_bits


def wire_served_bits(engine: Any, path: Optional[str]) -> Optional[int]:
    """Wire bits when this param is served straight from its page wire form
    (re-encoded int8 cold pages of a ``wire_serve`` plan), else None."""
    if isinstance(engine, Mapping) or engine is None:
        return None
    plan = as_plan(engine)
    if not plan.wire_serve:
        return None
    p = plan.placement_for(path)
    if (p.paged and p.scenario == "l1mram" and p.page_bits == 8
            and p.page_bits != p.weight_bits):
        return p.page_bits
    return None


def plan_for_budget(sizes: Mapping[str, int],
                    budget_bytes: int = SIRACUSA_MRAM_BYTES, *,
                    hot: Placement = HOT, cold: Placement = COLD,
                    sizes_bits: int = 8) -> PlacementPlan:
    """Pin the parameters with the most weight bytes per inference resident.

    ``sizes`` is a plain {name: nbytes} mapping measured at ``sizes_bits``
    per weight.  The budget is charged each resident parameter's bytes at
    ``hot.weight_bits``; the greedy score is its bytes at the cold page
    encoding (``cold.page_bits``, else ``cold.weight_bits``).  Ties break by
    larger size, then name.  Returns a plan with one exact-path ``hot`` rule
    per pinned parameter and ``cold`` as default.  The reference's ``uses``
    and ``shard_factors`` weightings arrive with the paging slice, which
    has their callers.
    """
    if not isinstance(sizes, Mapping):
        raise TypeError("plan_for_budget takes a {name: nbytes} mapping; "
                        "the WeightStore form arrives with the paging slice")
    sizes = {n: int(v) for n, v in sizes.items()}

    def _at_bits(name: str, bits: int) -> int:
        return max(1, -(-sizes[name] * bits // sizes_bits))

    wire_bits = cold.page_bits or cold.weight_bits
    order = sorted(sizes, key=lambda n: (-_at_bits(n, wire_bits), -sizes[n],
                                         n))
    rules: List[Tuple[str, Placement]] = []
    used = 0
    for name in order:
        resident_nb = _at_bits(name, hot.weight_bits)
        if used + resident_nb <= budget_bytes:
            rules.append((name, hot))
            used += resident_nb
    return PlacementPlan(default=cold, rules=tuple(rules))
