"""Cost, collective and memory figures of one rank's program, and the
roofline on H100 rates (reference: ``repro/launch/hlo_analysis.py``; the
name is kept so that the modules line up one for one).

The port has no HLO: it runs eager PyTorch, and the dry-run
(``launch/dryrun.py``) runs the rank's program on ``meta`` tensors, which
carry shapes and no data.  What takes the place of each piece:

* ``extract_cost`` reads a :class:`CostCounter`, a ``TorchDispatchMode``
  held around the program.  FLOPs are ``torch.utils.flop_counter``'s
  formulas (a ``FlopCounterMode`` inside it).  Bytes are each aten op's
  tensor inputs plus outputs, the eager program's own device-memory
  traffic; views and ``empty`` move none.  The Hopper kernels add their
  own FLOPs and bytes from their ``meta`` route (``kernels/launch.
  count_meta``: the formulas of PERF.md section 6's bound column), in
  place of the plain version's ops.  Eager dispatch counts every loop
  iteration, so nothing needs the reference's loop-body corrections.
* :class:`CollectiveStats` / ``collective_stats`` fill ``counts`` and
  ``bytes_by_kind`` from the train step's ``metrics["comm"]``
  (``launch/dist_steps``): the weight all-gathers, the gradient
  all-reduces over the dp axes and the activation collectives over
  "model".  The reference parses them out of the HLO text; its parser
  (``_COLLECTIVE_RE``, ``_shape_bytes``) has no counterpart.
* ``memory_analysis_dict`` gives ``argument_size_in_bytes``, what one rank
  holds of the cell's inputs by the placement rules
  (``parallel/sharding.rank_bytes``); the record gains
  ``peak_memory_in_bytes`` only where the card measured it
  (``launch/microbench.layer_cost``).
* :class:`Roofline` keeps the reference's fields, properties and
  ``as_dict()`` keys, on the rates of one NVIDIA H100 SXM below.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import launch as klaunch
from repro_torch.parallel import sharding

# Rates of one NVIDIA H100 SXM (NVIDIA's H100 data sheet: dense bf16
# tensor-core rate, HBM3 bandwidth, at its 700 W power limit; a card set
# below 700 W runs slower).  The collective rate is the data sheet's
# NVLink 4 figure, 900 GB/s a GPU both ways together, taken one way: an
# upper bound inside one NVLink domain, never measured here (the card
# machine has one card).
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per card
HBM_BW = 3.35e12                # B/s per card
NVLINK_BW = 450e9               # B/s per card, one way

# aten ops that move no bytes beside the views (``is_view``): allocations
# that write nothing, and a view its schema does not mark
_NO_TRAFFIC = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
    torch.ops.aten.empty_permuted.default,
    torch.ops.aten._unsafe_view.default,
}


def _tensor_bytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


class CostCounter(TorchDispatchMode):
    """Counts a program's FLOPs and bytes while it is active (``with
    CostCounter() as cc: fn(*args)``): ``flops`` (the aten ops' through
    ``FlopCounterMode``, plus the kernels'), ``hbm_bytes`` (each aten op's
    tensor inputs and outputs, plus the kernels'), ``ops`` (the aten ops
    counted) and ``kernels`` ({name: {"calls", "flops", "bytes"}} of the
    Hopper kernels' ``meta`` routes).  An op on DTensors is the placement
    bookkeeping of ``parallel/distributed`` (the train step computes on
    plain tensors) and is not counted."""

    def __init__(self):
        super().__init__()
        self._flops = FlopCounterMode(display=False)
        self.hbm_bytes = 0
        self.ops = 0
        self.kernels: Dict[str, Dict[str, float]] = {}

    def __enter__(self):
        self._flops.__enter__()
        super().__enter__()
        klaunch.META_COUNTERS.append(self)
        return self

    def __exit__(self, *exc):
        klaunch.META_COUNTERS.remove(self)
        super().__exit__(*exc)
        self._flops.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _NO_TRAFFIC or func.is_view:
            return out
        ins = tree_leaves((args, kwargs))
        outs = tree_leaves(out)
        if any(isinstance(x, DTensor) for x in ins + outs):
            return out
        self.hbm_bytes += _tensor_bytes(ins) + _tensor_bytes(outs)
        self.ops += 1
        return out

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, dict(calls=0, flops=0, bytes=0))
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    @property
    def flops(self) -> float:
        return float(self._flops.get_total_flops()
                     + sum(k["flops"] for k in self.kernels.values()))


def extract_cost(counter: CostCounter) -> Tuple[float, float]:
    """(flops, bytes) of the counted program: one rank's."""
    return counter.flops, float(counter.hbm_bytes
                                + sum(k["bytes"]
                                      for k in counter.kernels.values()))


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


# (kind, calls key, bytes key) of the train step's metrics["comm"]
_COMM_KINDS = (("all-gather", "gather_calls", "gather_bytes"),
               ("all-reduce", "reduce_calls", "reduce_bytes"),
               ("model-axis", "act_calls", "act_bytes"))


def collective_stats(comm: Optional[Dict[str, Any]]) -> CollectiveStats:
    """The census of one rank's collectives from a train step's
    ``metrics["comm"]``: "all-gather" the weight gathers, "all-reduce" the
    gradient reduces over the dp axes, "model-axis" the activation
    collectives over "model" (bytes: an all-reduce its buffer, an
    all-gather what the rank receives).  ``None`` (a serve step, which
    sends nothing) is empty."""
    counts: Dict[str, int] = {}
    bytes_by_kind: Dict[str, int] = {}
    for kind, calls, nbytes in _COMM_KINDS if comm else ():
        if comm[calls]:
            counts[kind] = int(comm[calls])
            bytes_by_kind[kind] = int(comm[nbytes])
    return CollectiveStats(counts, bytes_by_kind)


@dataclasses.dataclass
class Roofline:
    """Roofline terms of one rank's program: each total over the card's
    rate, the step's lower bound the largest (the terms overlap)."""
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    n_chips: int

    @property
    def total_flops(self) -> float:
        return self.flops_per_chip * self.n_chips

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_chip / NVLINK_BW

    @property
    def bound(self) -> str:
        terms = dict(compute=self.compute_s, memory=self.memory_s,
                     collective=self.collective_s)
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower-bound step time: overlapped terms -> max."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> Dict:
        return dict(flops_per_chip=self.flops_per_chip,
                    hbm_bytes_per_chip=self.hbm_bytes_per_chip,
                    collective_bytes_per_chip=self.collective_bytes_per_chip,
                    total_flops=self.total_flops,
                    n_chips=self.n_chips, compute_s=self.compute_s,
                    memory_s=self.memory_s, collective_s=self.collective_s,
                    bound=self.bound, step_time_s=self.step_time_s)


def memory_analysis_dict(specs: Any, mesh: Any) -> Dict[str, float]:
    """``argument_size_in_bytes``: what one rank of ``mesh`` holds of the
    cell's input trees ``specs`` (``ShapeSpec`` leaves) by the placement
    rules.  ``peak_memory_in_bytes`` is added by ``dryrun.run_cell`` only
    where the card measured it (``--measure``)."""
    return dict(argument_size_in_bytes=float(sharding.rank_bytes(specs,
                                                                 mesh)))
