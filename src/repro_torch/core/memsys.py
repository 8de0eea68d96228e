"""Calibrated analytical model of the Siracusa memory system + N-EUREKA.

A copy of ``repro/core/memsys.py``, which is framework-neutral (it holds no
array code): the operating points (paper Table I), the interface
bandwidths, the calibrated energy constants, the N-EUREKA throughput model
(``neureka_gops``), the per-scenario weight-path costs, ``LayerShape``, the
double-buffered ``layer_timing`` and ``network_walk``, and the proactive-
swap ``overlap_stall`` identity the scheduler uses, and the wire bytes of an
encoded weight page (``encoded_wire_bytes``).  ``kv_stream_bytes`` arrives
with KV paging (ROADMAP A7).
The constants are the paper's silicon, not the H100's.

All bandwidths in bytes/s, energies in J, times in s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple, Union

from repro_torch.core.placement import SCENARIOS, PlacementPlan, ScenarioCost

# ---------------------------------------------------------------------------
# Operating points (paper Table I)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    name: str
    voltage: float
    cluster_hz: float
    mram_hz: float
    cluster_power_w: float        # incl. MRAM (Table I)
    mram_power_w: float


NOMINAL = OperatingPoint("nominal", 0.80, 360e6, 180e6, 0.332, 0.069)
LOW_POWER = OperatingPoint("low_power", 0.65, 210e6, 105e6, 0.151, 0.040)

TABLE_I = [
    OperatingPoint("0.65V", 0.65, 210e6, 105e6, 0.151, 0.040),
    OperatingPoint("0.70V", 0.70, 250e6, 125e6, 0.196, 0.047),
    OperatingPoint("0.75V", 0.75, 310e6, 155e6, 0.261, 0.058),
    OperatingPoint("0.80V", 0.80, 360e6, 180e6, 0.332, 0.069),
]

# ---------------------------------------------------------------------------
# Interface bandwidths (paper §II) at an operating point
# ---------------------------------------------------------------------------

def mram_port_Bps(op: OperatingPoint) -> float:
    """Dedicated N-EUREKA<-MRAM port: 256 bit/cluster-cycle (92 Gbit/s @360)."""
    return 256 / 8 * op.cluster_hz


def cluster_dma_Bps(op: OperatingPoint) -> float:
    """64-bit AXI Cluster-DMA (L2<->L1, and AXI access to neural mem):
    23 Gbit/s @ 360 MHz; DMA_EFFICIENCY models 2D strided tile bursts."""
    return 64 / 8 * op.cluster_hz * DMA_EFFICIENCY


def io_dma_Bps(op: OperatingPoint) -> float:
    """32-bit AXI CDC used by the IO-DMA for background weight pages."""
    return IO_DMA_32B_BPS_AT_NOMINAL * (op.cluster_hz / 360e6)


# Off-chip HyperBus flash read bandwidth.  Calibrated (with the energy
# constants below) so the L3FLASH MobileNet-V2 walk reproduces the paper's
# 12.6 ms / 3.8 mJ; a 16-bit DDR HyperBus at ~200 MT/s lands in this range.
HYPERBUS_BPS = 550e6          # bytes/s, voltage-independent (IO domain)

# ---------------------------------------------------------------------------
# Energy constants (J/byte moved, J/op computed).  Sources:
#   * off-chip: calibrated so off-chip share of L3FLASH = 55% of 3.8 mJ
#   * MRAM read: 69 mW at 5.76 GB/s streaming (Table I) ~ 12 pJ/B incl.
#     periphery; background (L3/L2) use adds AXI+DMA hop energy
#   * compute: 698 GOp/s @ (332-69) mW burn ~ 0.35 pJ/Op core datapath at
#     0.8 V; scaled by V^2 at other points
# ---------------------------------------------------------------------------

E_OFFCHIP_PER_B = 560e-12     # HyperBus + IO pads + L2 write
E_MRAM_READ_PER_B = 40e-12    # MRAM array + periphery read
E_AXI_HOP_PER_B = 20e-12      # background-memory access adds interconnect hop
E_DMA_L2L1_PER_B = 9e-12      # Cluster-DMA transfer L2<->L1
E_L1_ACCESS_PER_B = 11e-12    # TCDM/tile access incl. engine-side load
E_OP = 0.350e-12              # N-EUREKA datapath J/Op (1 MAC = 2 Op) @ 0.8 V
P_CLUSTER_BASE_W = 0.110      # non-datapath cluster power (clock tree, cores idle)

# 2D strided HWC tile transfers interrupt AXI bursts at row boundaries;
# sustained DMA efficiency on feature-map tiles (calibration: Fig 10/11).
DMA_EFFICIENCY = 0.65
# IO-DMA 32-bit AXI CDC used for background (L3) page traffic (paper II-B2)
IO_DMA_32B_BPS_AT_NOMINAL = 32 / 8 * 360e6


def _vscale(op: OperatingPoint, ref: OperatingPoint = NOMINAL) -> float:
    """Dynamic energy scales ~ V^2 (same tech, same caps)."""
    return (op.voltage / ref.voltage) ** 2


# ---------------------------------------------------------------------------
# N-EUREKA throughput model (paper Fig. 8 anchors)
#
# Bit-serial execution: a weight-bit plane costs one pass; per-pass overhead
# (prefetch/streamout handshake) o is calibrated from the two published
# dense-3x3 anchors: 698 GOp/s @ 8 b and 1947 GOp/s @ 2 b (360 MHz):
#     T(w) = P / (w + o)   =>  o = 1.353,  P = 6529 GOp/s*bit
# Ideal (datapath-limited) dense-3x3 throughput at 8 b is 738 GOp/s (paper),
# giving utilization 0.946.
# ---------------------------------------------------------------------------

_BITSERIAL_OVERHEAD = 1.3529
_DENSE3X3_P = 698e9 * (8 + _BITSERIAL_OVERHEAD)          # GOp/s * bits @ 360MHz

# Pointwise runs bit-parallel (weights of all precisions fetched at once,
# §II-C3): throughput is bandwidth/datapath-limited, ~flat in bits for
# latency but weight *traffic* still scales with bits.
_PW_GOPS_8B = 580e9
# Depthwise: 1 input channel per column group, datapath mostly idle.
_DW_GOPS_8B = 58e9


def neureka_gops(op_kind: str, weight_bits: int,
                 oppoint: OperatingPoint = NOMINAL) -> float:
    """Sustained GOp/s (1 MAC = 2 Op) for an optimally-shaped job."""
    f = oppoint.cluster_hz / NOMINAL.cluster_hz
    if op_kind == "dense3x3":
        return f * _DENSE3X3_P / (weight_bits + _BITSERIAL_OVERHEAD)
    if op_kind == "pw1x1":
        return f * _PW_GOPS_8B
    if op_kind == "dw3x3":
        return f * _DW_GOPS_8B * (8 + _BITSERIAL_OVERHEAD) / (
            weight_bits + _BITSERIAL_OVERHEAD)
    raise ValueError(op_kind)


# ---------------------------------------------------------------------------
# NVM integration scenarios (paper §IV, Fig 9): where weights live and which
# interfaces they cross per inference.
# ---------------------------------------------------------------------------

def scenario_costs(op: OperatingPoint = NOMINAL) -> Dict[str, ScenarioCost]:
    v = _vscale(op)
    return {
        # 1: off-chip flash -> L2 -> (DMA) -> L1 -> engine
        "l3flash": ScenarioCost(
            "l3flash", HYPERBUS_BPS,
            E_OFFCHIP_PER_B + v * (E_DMA_L2L1_PER_B + E_L1_ACCESS_PER_B),
            weights_through_l1=True, shared_port_crossings=1),
        # 2: on-chip MRAM as background L3 -> (IO-DMA, 32b CDC) -> L2 -> L1
        "l3mram": ScenarioCost(
            "l3mram", io_dma_Bps(op),
            v * (E_MRAM_READ_PER_B + 2 * E_AXI_HOP_PER_B
                 + E_DMA_L2L1_PER_B + E_L1_ACCESS_PER_B),
            weights_through_l1=True, shared_port_crossings=2),
        # 3: MRAM on the shared L2 interconnect; DMA pulls weights to L1
        "l2mram": ScenarioCost(
            "l2mram", cluster_dma_Bps(op),
            v * (E_MRAM_READ_PER_B + E_AXI_HOP_PER_B + E_L1_ACCESS_PER_B),
            weights_through_l1=True, shared_port_crossings=1),
        # 4: Siracusa At-MRAM: dedicated contention-free 256-bit port
        "l1mram": ScenarioCost(
            "l1mram", mram_port_Bps(op),
            v * E_MRAM_READ_PER_B,
            weights_through_l1=False, shared_port_crossings=0),
    }


# ---------------------------------------------------------------------------
# Tiled layer walk: double-buffered latency/energy for one DNN layer.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerShape:
    """One N-EUREKA job in a network walk."""
    name: str
    op_kind: str                 # dense3x3 | dw3x3 | pw1x1
    h: int
    w: int
    cin: int
    cout: int
    stride: int = 1
    weight_bits: int = 8

    @property
    def macs(self) -> int:
        ho, wo = -(-self.h // self.stride), -(-self.w // self.stride)
        if self.op_kind == "dense3x3":
            return ho * wo * self.cin * self.cout * 9
        if self.op_kind == "dw3x3":
            return ho * wo * self.cin * 9
        return ho * wo * self.cin * self.cout

    @property
    def ops(self) -> int:
        return 2 * self.macs

    @property
    def weight_bytes(self) -> int:
        if self.op_kind == "dw3x3":
            n = self.cin * 9
        elif self.op_kind == "dense3x3":
            n = self.cin * self.cout * 9
        else:
            n = self.cin * self.cout
        return -(-n * self.weight_bits // 8)

    @property
    def act_in_bytes(self) -> int:
        return self.h * self.w * self.cin

    @property
    def act_out_bytes(self) -> int:
        ho, wo = -(-self.h // self.stride), -(-self.w // self.stride)
        return ho * wo * self.cout


@dataclasses.dataclass
class LayerTiming:
    name: str
    compute_s: float
    weight_s: float
    act_s: float
    latency_s: float             # max of the three (double-buffered pipeline)
    energy_j: float
    regime: str                  # balanced | compute | weight-memory


def layer_timing(layer: LayerShape, scenario: str,
                 op: OperatingPoint = NOMINAL) -> LayerTiming:
    sc = scenario_costs(op)[scenario]
    v = _vscale(op)

    compute_s = layer.ops / neureka_gops(layer.op_kind, layer.weight_bits, op)
    weight_s = layer.weight_bytes / sc.weight_bw_Bps

    # activation movement: L2 -> L1 in, L1 -> L2 out over the Cluster-DMA;
    # if weights share the DMA (scenarios 1-3) the effective act bandwidth
    # halves while weight transfers are in flight.
    act_bytes = layer.act_in_bytes + layer.act_out_bytes
    act_bw = cluster_dma_Bps(op)
    act_s = act_bytes / act_bw
    if sc.shared_port_crossings:
        # weight bytes cross the shared 64-bit cluster port (round-robin
        # arbitration): model as serialized occupancy of the shared port.
        shared_s = (act_bytes
                    + sc.shared_port_crossings * layer.weight_bytes) / act_bw
        act_s = shared_s
        weight_s = max(weight_s, shared_s)

    latency_s = max(compute_s, weight_s, act_s)

    # energies
    e = (layer.weight_bytes * sc.weight_energy_per_B
         + act_bytes * v * (E_DMA_L2L1_PER_B + E_L1_ACCESS_PER_B)
         + layer.ops * E_OP * v
         + latency_s * P_CLUSTER_BASE_W * v)

    terms = dict(compute=compute_s, weight=weight_s, act=act_s)
    dom = max(terms, key=terms.get)
    second = sorted(terms.values())[-2]
    if terms[dom] < 1.35 * second:
        regime = "balanced"
    elif dom == "compute":
        regime = "compute"
    else:
        regime = "weight-memory" if dom == "weight" else "act-memory"

    return LayerTiming(layer.name, compute_s, weight_s, act_s, latency_s, e,
                       regime)


# ---------------------------------------------------------------------------
# Proactive-swap overlap identity (paper §II-B2).
#
# A swap started while independent compute runs hides min(swap, compute) of
# its latency; only the remainder lands on the critical path:
#     stall += swap - hidden,   hidden = min(swap, compute)
# In the reference this one identity drives the analytical stall walk, the
# static schedule prediction and the measured async-paging counters; in the
# port the pager's stall model, the scheduler's admission cost model and
# its predicted-vs-measured stall overlay read it.
# ---------------------------------------------------------------------------

def overlap_stall(swap_s: float, compute_s: float) -> Dict[str, float]:
    """Exposed/hidden split of a ``swap_s`` transfer overlapped with
    ``compute_s`` of independent compute.

    ``exposed_s`` is the wait actually blocking the critical path,
    ``hidden_s`` the part absorbed behind the MACs — the At-MRAM reading
    of §II-B2, and the check the serving runtime's measured per-tick
    counters are asserted against (predicted-vs-measured agreement)."""
    swap_s = max(float(swap_s), 0.0)
    compute_s = max(float(compute_s), 0.0)
    hidden = min(swap_s, compute_s)
    exposed = swap_s - hidden
    return dict(swap_s=swap_s, compute_s=compute_s, hidden_s=hidden,
                exposed_s=exposed,
                overlap_frac=(hidden / swap_s) if swap_s > 0 else 0.0)


def encoded_wire_bytes(rows: int, k: int, page_bits: int,
                       block: int = 32) -> int:
    """Wire bytes of one (rows, k) weight tensor crossing the host->device
    link under the intN page encoding of :mod:`repro_torch.core.paging`:
    packed levels at ``page_bits`` per weight (byte-aligned per row) plus
    one float32 scale per (row, block) group, which travel inside the page
    payload."""
    if rows < 0 or k < 0:
        raise ValueError("rows and k must be >= 0")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    payload = rows * (-(-k * page_bits // 8))
    scales = rows * (-(-k // block)) * 4
    return payload + scales


Scenarios = Union[str, Sequence[str], PlacementPlan]


def resolve_scenarios(layers: Sequence[LayerShape],
                      scenario: Scenarios) -> List[str]:
    """Per-layer scenario list from a global name, an explicit per-layer
    sequence, or a PlacementPlan keyed by layer name."""
    if isinstance(scenario, str):
        return [scenario] * len(layers)
    if isinstance(scenario, PlacementPlan):
        return [scenario.scenario_for(l.name) for l in layers]
    names = list(scenario)
    if len(names) != len(layers):
        raise ValueError(f"got {len(names)} scenarios for {len(layers)} "
                         "layers")
    return names


def network_walk(layers: Sequence[LayerShape], scenario: Scenarios,
                 op: OperatingPoint = NOMINAL) -> Tuple[float, float, List[LayerTiming]]:
    """End-to-end latency/energy of a network under a weight placement.

    ``scenario`` is a single global scenario name (the paper's Fig 10
    setup), an explicit per-layer sequence, or a
    :class:`~repro_torch.core.placement.PlacementPlan` matched against layer
    names — the mixed-residency case where hot layers stream from At-MRAM
    while cold layers come through the background path.

    Double buffering across layers: per-layer latency is the max of its
    pipeline stages (paper §IV-C: "overall latency is determined by the
    latency of the slowest step").
    """
    per_layer = resolve_scenarios(layers, scenario)
    timings = [layer_timing(l, s, op) for l, s in zip(layers, per_layer)]
    total_s = sum(t.latency_s for t in timings)
    total_j = sum(t.energy_j for t in timings)
    return total_s, total_j, timings
