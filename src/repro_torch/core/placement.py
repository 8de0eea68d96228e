"""Per-layer weight placement — where each weight lives (paper §IV Fig 9
scenarios + §II-B2 virtual paging).

A copy of ``repro/core/placement.py`` (``:111-247`` and ``:332-448``) over
the port's trees: ``SCENARIOS``, ``ScenarioCost``, ``Placement``, ``HOT`` /
``COLD``, ``PlacementPlan`` with ``is_uniform``, ``scenarios_used`` and its
store accounting, ``as_plan`` and ``linear_dispatch`` (both also taking a
``core/engine.EngineConfig``), ``wire_served_bits``, ``path_key``, ``packed_sizes``,
``plan_for_budget`` over a ``WeightStore`` or a plain ``{name: nbytes}``
mapping, and ``freeze_policy``.  It holds no tensor code.  Both
``packed_sizes`` and ``plan_for_budget`` take the reference's
``shard_factors`` (``:339-360, 378-420``): a param a mesh shards ``n``
ways charges ``ceil(bytes / n)`` to each device.

``PlacementPlan.mode`` and the legacy dict's ``"mode"`` key are accepted and
carried for compatibility, but the port ignores them: the device of the
tensors picks the path (a CUDA tensor runs the Hopper kernel, a CPU tensor
the plain PyTorch version; see ``kernels/ops.py``).
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

from repro_torch.core.weight_store import (SIRACUSA_MRAM_BYTES, WeightStore,
                                           flatten_tree)

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

    @property
    def page_encoding(self) -> str:
        """Wire encoding: ``"fp"`` (the device form verbatim) or
        ``"int8"`` / ``"int4"`` / ``"int2"``."""
        return "fp" if self.page_bits is None else f"int{self.page_bits}"


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

    def replace(self, **kw) -> "PlacementPlan":
        return dataclasses.replace(self, **kw)

    def with_page_bits(self, page_bits: Optional[int]) -> "PlacementPlan":
        """A copy whose *paged* placements (default and rules) carry
        ``page_bits`` as their wire encoding; resident ones are unchanged."""
        def _enc(p: Placement) -> Placement:
            return dataclasses.replace(p, page_bits=page_bits) if p.paged \
                else p
        return dataclasses.replace(
            self, default=_enc(self.default),
            rules=tuple((pat, _enc(p)) for pat, p in self.rules))

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

    @property
    def is_uniform(self) -> bool:
        return not self.rules

    def scenarios_used(self) -> Tuple[str, ...]:
        """Scenarios the plan can dispatch to, in SCENARIOS order."""
        used = {self.default.scenario} | {p.scenario for _, p in self.rules}
        return tuple(s for s in SCENARIOS if s in used)

    # -- store accounting ---------------------------------------------------
    def split_names(self, names: Sequence[str]
                    ) -> Tuple[List[str], List[str]]:
        """Partition parameter paths into (resident, paged), order kept."""
        resident, paged = [], []
        for n in names:
            (paged if self.placement_for(n).paged else resident).append(n)
        return resident, paged

    def resident_bytes(self, store: "StoreSizes") -> int:
        sizes = _sizes_of(store)
        return sum(sizes[n] for n in self.split_names(list(sizes))[0])

    def paged_bytes(self, store: "StoreSizes") -> int:
        sizes = _sizes_of(store)
        return sum(sizes[n] for n in self.split_names(list(sizes))[1])

    def fits(self, store: "StoreSizes",
             budget_bytes: int = SIRACUSA_MRAM_BYTES) -> bool:
        return self.resident_bytes(store) <= budget_bytes

    def summary(self, store: Optional["StoreSizes"] = None) -> str:
        lines = [f"PlacementPlan(mode={self.mode}, default="
                 f"{self.default.scenario}/{self.default.weight_bits}b/"
                 f"{self.default.residency}, {len(self.rules)} rules)"]
        for pattern, p in self.rules:
            lines.append(f"  {pattern} -> {p.scenario}/{p.weight_bits}b/"
                         f"{p.residency}")
        if store is not None:
            lines.append(f"  resident {self.resident_bytes(store)} B, "
                         f"paged {self.paged_bytes(store)} B")
        return "\n".join(lines)


DEFAULT_PLAN = PlacementPlan()

# Anything that names parameter sizes: a packed WeightStore or a plain
# {path: nbytes} mapping.
StoreSizes = Union[WeightStore, Mapping[str, int]]


def _sizes_of(store: StoreSizes) -> Dict[str, int]:
    if isinstance(store, WeightStore):
        return {n: p.nbytes_packed for n, p in store.params.items()}
    return {n: int(v) for n, v in store.items()}


def as_plan(engine: Any) -> PlacementPlan:
    """Normalize a plan, an ``EngineConfig`` (its plan, else a uniform plan
    of its scenario and bits), a legacy {"scenario", "mode", "bits"} dict
    or None into a PlacementPlan."""
    if engine is None:
        return DEFAULT_PLAN
    if isinstance(engine, PlacementPlan):
        return engine
    if isinstance(engine, Mapping):
        return PlacementPlan.uniform(
            scenario=engine.get("scenario", "l1mram"),
            bits=int(engine.get("bits", 8)),
            mode=engine.get("mode", "xla"))
    plan = getattr(engine, "plan", None)           # EngineConfig
    if isinstance(plan, PlacementPlan):
        return plan
    if hasattr(engine, "scenario"):
        return PlacementPlan.uniform(
            scenario=engine.scenario,
            bits=int(getattr(engine, "weight_bits", 8)),
            mode=getattr(engine, "mode", "xla"))
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


def dp_axes_of(engine: Any) -> Tuple[str, ...]:
    """Data-parallel axes threaded alongside the engine (the training
    path, ``placement.py:324``): plans carry none, legacy dicts may."""
    if isinstance(engine, Mapping):
        return tuple(engine.get("dp_axes") or ())
    return ()


def path_key(path: Sequence[Any]) -> str:
    """Canonical flat path string of a sequence of tree keys: the vocabulary
    PlacementPlan rules match against."""
    return "/".join(str(p) for p in path)


def packed_sizes(tree: Any, shard_factors: Optional[Mapping[str, int]]
                 = None) -> Dict[str, int]:
    """{param path: packed bytes} for every packed leaf group of a serving
    tree (the {"packed", "scale"} dicts of ``freeze_for_serving``), the
    dispatch surface to feed :func:`plan_for_budget`.

    ``shard_factors`` ({name: n_shards}, e.g. from
    :func:`repro_torch.core.paging.store_shard_axes`) divides a sharded
    param's bytes by its shard count, rounding up: the footprint a
    mesh-sharded pager pays on each link."""
    sizes = {key[:-len("/packed")]: leaf.numel()
             for key, leaf in flatten_tree(tree).items()
             if key.endswith("/packed")}
    for name, factor in (shard_factors or {}).items():
        if name in sizes and factor > 1:
            sizes[name] = max(1, -(-sizes[name] // factor))
    return sizes


def plan_for_budget(store: StoreSizes,
                    budget_bytes: int = SIRACUSA_MRAM_BYTES, *,
                    uses: Optional[Mapping[str, float]] = None,
                    hot: Placement = HOT, cold: Placement = COLD,
                    sizes_bits: int = 8,
                    shard_factors: Optional[Mapping[str, int]] = None
                    ) -> PlacementPlan:
    """Pin the parameters with the most weight bytes used per inference
    resident.

    ``store`` is a WeightStore (sizes = packed bytes at each param's own
    bits) or a plain {name: nbytes} mapping measured at ``sizes_bits`` per
    weight.  The budget is charged each resident parameter's bytes at
    ``hot.weight_bits``; the greedy score is its bytes at the cold page
    encoding (``cold.page_bits``, else ``cold.weight_bits``) times
    ``uses`` (default 1).  Ties break by larger size, then name.  Returns a
    plan with one exact-path ``hot`` rule per pinned parameter and ``cold``
    as default.

    ``shard_factors`` ({name: n_shards}) marks the params a mesh shards:
    each device pins only ``1/n`` of such a param, so its resident charge
    against the per-device budget is divided by ``n``, rounding up.
    """
    sizes = _sizes_of(store)
    uses = uses or {}
    shard_factors = shard_factors or {}
    bits_of = ({n: p.bits for n, p in store.params.items()}
               if isinstance(store, WeightStore) else {})

    def _at_bits(name: str, bits: int) -> int:
        have = bits_of.get(name, sizes_bits)
        return max(1, -(-sizes[name] * bits // have))

    wire_bits = cold.page_bits or cold.weight_bits

    def score(name: str) -> float:
        return _at_bits(name, wire_bits) * float(uses.get(name, 1.0))

    def _resident(name: str) -> int:
        """Per-device resident charge: a sharded param pins 1/n a link."""
        factor = int(shard_factors.get(name, 1))
        nb = _at_bits(name, hot.weight_bits)
        return max(1, -(-nb // factor)) if factor > 1 else nb

    order = sorted(sizes, key=lambda n: (-score(n), -sizes[n], n))
    rules: List[Tuple[str, Placement]] = []
    used = 0
    for name in order:
        resident_nb = _resident(name)
        if used + resident_nb <= budget_bytes:
            rules.append((name, hot))
            used += resident_nb
    return PlacementPlan(default=cold, rules=tuple(rules))


def freeze_policy(plan: PlacementPlan, min_size: int = 1024):
    """A ``weight_store.freeze`` policy taking per-param bits from ``plan``
    (>=2-D matmul-like leaves only, like the default policy)."""
    def _policy(path: str, leaf) -> Optional[int]:
        if leaf.ndim >= 2 and leaf.numel() >= min_size:
            return plan.bits_for(path)
        return None
    return _policy
