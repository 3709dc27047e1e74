"""Analytical cost modeling (paper §2 phase 2) + node resource tagging (§3).

The port's copy of ``repro.core.cost_model``: the same names, arithmetic
and iteration order, so that floats agree with the reference exactly;
only the imports differ, and ``H100_SXM`` stands beside ``TPU_V5E``.
Pure Python: no ``torch``.

The paper assigns a node ``v_i`` mapped to device ``D_j`` the compute cost
``c_{v_i}^{D_j}`` = ops(v_i) / throughput(D_j), supporting heterogeneous
devices. We implement that exactly (``mode="paper"``), plus a roofline mode
(``mode="roofline"``) where a node's time is max(compute, memory) — the
refinement the assistants' tags are derived from.

Hardware constants: the TPU v5e targets of the reference (197 TFLOP/s
bf16 per chip, 819 GB/s HBM, ~50 GB/s per ICI link), and the port's target,
the NVIDIA H100 SXM (``H100_SXM``, from NVIDIA's datasheet).  Plans costed
with either are models of the hardware, not measurements of it.
"""

from __future__ import annotations

from dataclasses import dataclass

from .graph import Graph, Node, TAG_COMPUTE, TAG_MEMORY, TAG_NETWORK


@dataclass(frozen=True)
class DeviceSpec:
    """One compute device (or SPMD stage-group treated as a device)."""

    name: str
    flops_per_s: float          # peak bf16 FLOP/s
    hbm_bw: float               # bytes/s
    link_bw: float              # bytes/s per ICI link (device<->device)
    memory_bytes: float         # HBM capacity
    speed_factor: float = 1.0   # heterogeneity multiplier (paper: "potentially
                                # varying computational capabilities")

    @property
    def eff_flops(self) -> float:
        return self.flops_per_s * self.speed_factor

    @property
    def eff_hbm(self) -> float:
        return self.hbm_bw * self.speed_factor


TPU_V5E = DeviceSpec(
    name="tpu-v5e",
    flops_per_s=197e12,
    hbm_bw=819e9,
    link_bw=50e9,
    memory_bytes=16 * 2**30,
)

# NVIDIA H100 SXM5 80GB (the card reported as "NVIDIA H100 80GB HBM3", 700 W),
# from the SXM column of the NVIDIA H100 Tensor Core GPU datasheet:
# 989 TFLOP/s dense BF16 tensor math (the datasheet's 1,979 is with
# sparsity), 3.35 TB/s HBM3, NVLink 4 at 900 GB/s per GPU in both
# directions together (450 GB/s each way), 80 GB of memory.
H100_SXM = DeviceSpec(
    name="h100-sxm",
    flops_per_s=989e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    memory_bytes=80e9,
)


def homogeneous_devices(k: int, base: DeviceSpec = TPU_V5E) -> list[DeviceSpec]:
    return [DeviceSpec(f"{base.name}[{i}]", base.flops_per_s, base.hbm_bw,
                       base.link_bw, base.memory_bytes) for i in range(k)]


def heterogeneous_devices(speed_factors: list[float],
                          base: DeviceSpec = TPU_V5E) -> list[DeviceSpec]:
    return [DeviceSpec(f"{base.name}[{i}]", base.flops_per_s, base.hbm_bw,
                       base.link_bw, base.memory_bytes, speed_factor=s)
            for i, s in enumerate(speed_factors)]


class CostModel:
    """Maps (node, device) -> time and annotates nodes with §3 resource tags.

    Accepts either a :class:`repro_torch.core.topology.Topology` (the plan-centric
    API: devices + pairwise interconnect bandwidth) or a bare device list
    (the legacy surface, wrapped into a uniform-fabric topology).
    """

    def __init__(self, devices, mode: str = "roofline"):
        assert mode in ("paper", "roofline")
        if isinstance(devices, (list, tuple)):
            # legacy surface: wrap the device list in a uniform fabric
            from .topology import Topology
            self.topology = Topology.from_devices(devices)
        else:
            self.topology = devices
        self.devices = list(self.topology.devices)
        self.mode = mode

    @property
    def k(self) -> int:
        return len(self.devices)

    # -- paper: c_{v_i}^{D_j} ----------------------------------------------------
    def node_cost(self, node: Node, device_idx: int) -> float:
        """Seconds to execute ``node`` on device ``device_idx``."""
        dev = self.devices[device_idx]
        t_compute = node.flops / dev.eff_flops
        if self.mode == "paper":
            return t_compute
        t_memory = node.bytes_accessed / dev.eff_hbm
        return max(t_compute, t_memory)

    def edge_cost(self, bytes: float, device_idx: int) -> float:
        """Seconds to move ``bytes`` across one link of ``device_idx``."""
        return bytes / self.devices[device_idx].link_bw

    def link_cost(self, bytes: float, src: int, dst: int) -> float:
        """Seconds to move ``bytes`` over the ``src -> dst`` fabric link.

        Uses the topology's pairwise bandwidth matrix — on the default
        uniform fabric this equals ``edge_cost`` at the slower endpoint.
        A zero-bandwidth off-diagonal entry means *no link*: moving data
        across it costs infinity (so a cut there can never look cheap),
        not zero."""
        if src == dst:
            return 0.0
        bw = self.topology.link_bw(src, dst)
        if bw <= 0:
            return float("inf") if bytes > 0 else 0.0
        return bytes / bw

    # -- §3: compute/memory/network-bound tagging -------------------------------
    def tag_nodes(self, graph: Graph, device_idx: int = 0) -> None:
        """Annotate every node with its bottleneck resource on ``device_idx``.

        A node is network-bound when moving its inputs over a link would take
        longer than recomputing/streaming it locally — i.e. its edge traffic
        dominates; otherwise compute- vs memory-bound by roofline comparison.
        """
        dev = self.devices[device_idx]
        for node in graph:
            t_c = node.flops / dev.eff_flops
            t_m = node.bytes_accessed / dev.eff_hbm
            in_bytes = sum(e.weight for e in graph.in_edges(node.id))
            out_bytes = sum(e.weight for e in graph.out_edges(node.id))
            t_n = (in_bytes + out_bytes) / dev.link_bw
            if t_n > max(t_c, t_m):
                node.tag = TAG_NETWORK
            elif t_m > t_c:
                node.tag = TAG_MEMORY
            else:
                node.tag = TAG_COMPUTE

    # -- phase 1: node selection -------------------------------------------------
    def select_relocatable(self, graph: Graph, quantile: float = 0.5) -> None:
        """Paper phase 1: mark computationally-expensive stateless nodes.

        Nodes below the cost quantile are pinned (``relocatable=False``) — they
        ride along with their consumers. Nodes whose ``param_bytes`` exceed HBM
        of a single device are also pinned (cannot be migrated atomically).
        """
        costs = sorted(n.flops for n in graph)
        if not costs:
            return
        cut = costs[min(len(costs) - 1, int(len(costs) * quantile))]
        dev = self.devices[0]
        for node in graph:
            expensive = node.flops >= cut and node.flops > 0
            fits = node.param_bytes < dev.memory_bytes
            node.relocatable = bool(expensive and fits)

    # -- aggregates ---------------------------------------------------------------
    def assignment_costs(self, graph: Graph, assignment: dict[str, int]) -> list[float]:
        """Per-device total compute cost C_{D_i} under ``assignment``."""
        totals = [0.0] * self.k
        for nid, d in assignment.items():
            totals[d] += self.node_cost(graph.nodes[nid], d)
        return totals

    def ideal_share(self, graph: Graph) -> float:
        """C/k with heterogeneity folded in: share proportional to speed."""
        total = sum(self.node_cost(n, 0) for n in graph)  # on reference device
        return total / self.k
