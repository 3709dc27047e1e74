"""Hardware scheduling assistants (paper §3) — software realization.

The port's copy of ``repro.core.assistants``: the same names, arithmetic
and iteration order, so that floats agree with the reference exactly;
only the imports differ.  Pure Python: no ``torch``.

The paper proposes hardware engines, programmed by the compiler, that migrate
dataflow-graph nodes between devices at runtime using simple rules over
resource-utilization counters:

* node tags: compute-bound / memory-bound / network-bound (set by the compiler
  — here ``CostModel.tag_nodes``),
* when device D_i's utilization of resource R exceeds θ (default 95%), D_i
  places one of its R-bound nodes into its *R out-box*,
* a device whose utilization of R is below γ (default 50%) acquires a node
  from another device's R out-box.

Neither a TPU nor a GPU exposes such a hardware engine, so the assistant
protocol runs in the launcher runtime: telemetry (real step timings on hardware; the
analytical simulator below on CPU) feeds the same θ/γ/out-box rules, and an
accepted migration triggers a re-lowering + state reshard between steps.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from .cost_model import CostModel
from .graph import Graph, TAG_COMPUTE, TAG_MEMORY, TAG_NETWORK, TAGS


@dataclass(frozen=True)
class AssistantConfig:
    theta: float = 0.95          # over-utilization threshold (paper: "say, 95%")
    gamma: float = 0.50          # under-utilization threshold (paper: "say, 50%")
    resources: tuple[str, ...] = TAGS
    max_outbox: int = 1          # paper: "selects one of the ... nodes"
    cooldown: int = 5            # cycles a migrated node is pinned before it
                                 # may be offered again (hysteresis: stops
                                 # ping-pong under sustained interference)


RESOURCE_OF_TAG = {TAG_COMPUTE: "compute", TAG_MEMORY: "memory", TAG_NETWORK: "network"}
TAG_OF_RESOURCE = {v: k for k, v in RESOURCE_OF_TAG.items()}


# =============================================================================
# Telemetry: analytical utilization simulator
# =============================================================================

def simulate_utilization(graph: Graph, assignment: dict[str, int],
                         cost_model: CostModel,
                         interference: Optional[list[dict[str, float]]] = None,
                         ) -> list[dict[str, float]]:
    """Per-device utilization of compute / memory / network in [0, 1].

    Busy time per resource is derived from the cost model; utilization is busy
    time over the step's critical path (slowest device). ``interference``
    models co-located work (paper §3 motivation): a per-device multiplier that
    inflates the device's busy time on a resource.
    """
    k = cost_model.k
    busy = [dict(compute=0.0, memory=0.0, network=0.0) for _ in range(k)]
    for nid, d in assignment.items():
        node = graph.nodes[nid]
        dev = cost_model.devices[d]
        busy[d]["compute"] += node.flops / dev.eff_flops
        busy[d]["memory"] += node.bytes_accessed / dev.eff_hbm
    for e in graph.edges:
        if assignment[e.src] != assignment[e.dst] and e.weight:
            t_link = cost_model.link_cost(e.weight, assignment[e.src],
                                          assignment[e.dst])
            busy[assignment[e.src]]["network"] += t_link
            busy[assignment[e.dst]]["network"] += t_link
    if interference:
        for d in range(k):
            for r, mult in interference[d].items():
                busy[d][r] *= mult
    step_time = max(max(b.values()) for b in busy) or 1.0
    # a disconnected-link crossing prices as inf (cost_model.link_cost);
    # inf/inf is nan, so pin saturated resources to 1.0 explicitly
    def util(t: float) -> float:
        return 1.0 if t == step_time else min(1.0, t / step_time)
    return [{r: util(b[r]) for r in b} for b in busy]


def modeled_step_time(graph: Graph, assignment: dict[str, int],
                      cost_model: CostModel,
                      interference: Optional[list[dict[str, float]]] = None,
                      ) -> float:
    """Critical-path step time (s): max over devices of Σ resource busy time."""
    k = cost_model.k
    busy = [dict(compute=0.0, memory=0.0, network=0.0) for _ in range(k)]
    for nid, d in assignment.items():
        node = graph.nodes[nid]
        dev = cost_model.devices[d]
        busy[d]["compute"] += node.flops / dev.eff_flops
        busy[d]["memory"] += node.bytes_accessed / dev.eff_hbm
    for e in graph.edges:
        if assignment[e.src] != assignment[e.dst] and e.weight:
            busy[assignment[e.dst]]["network"] += cost_model.link_cost(
                e.weight, assignment[e.src], assignment[e.dst])
    if interference:
        for d in range(k):
            for r, mult in interference[d].items():
                busy[d][r] *= mult
    # compute and memory overlap within a device (roofline); network serializes
    return max(max(b["compute"], b["memory"]) + b["network"] for b in busy)


def find_unlinked_cut(graph: Graph, assignment: dict[str, int], nid: str,
                      dst: int, topology) -> Optional[tuple]:
    """The first data edge a ``nid -> dst`` move would cut across a
    missing fabric link (zero topology bandwidth), as ``(src_dev,
    dst_dev, edge)`` — or None when the move is link-feasible.  Shared by
    the assistants' acquire rule and ``CompiledPlan.validate_delta`` so
    the two can never drift apart on what counts as reachable."""
    for e in graph.in_edges(nid):
        src_dev = assignment[e.src]
        if e.weight and src_dev != dst and topology.link_bw(src_dev, dst) <= 0:
            return (src_dev, dst, e)
    for e in graph.out_edges(nid):
        dst_dev = assignment[e.dst]
        if e.weight and dst_dev != dst and topology.link_bw(dst, dst_dev) <= 0:
            return (dst, dst_dev, e)
    return None


# =============================================================================
# The assistant protocol
# =============================================================================

@dataclass
class PlanDelta:
    """One typed adaptation record: move ``node`` from ``src`` to ``dst``.

    The assistants emit these instead of silently mutating raw assignment
    dicts; ``CompiledPlan.apply`` validates and applies them transactionally,
    so a serving run's adaptation history is an auditable, replayable trace.
    ``gain`` is the modeled step-time reduction of this single move (filled
    by ``run_adaptation``; 0.0 when unknown), ``cycle`` the assistant cycle
    that produced it."""

    node: str
    src: int
    dst: int
    resource: str = ""
    gain: float = 0.0
    cycle: int = -1

    def to_json(self) -> dict:
        return {"node": self.node, "src": self.src, "dst": self.dst,
                "resource": self.resource, "gain": self.gain,
                "cycle": self.cycle}

    @classmethod
    def from_json(cls, doc: dict) -> "PlanDelta":
        return cls(node=doc["node"], src=int(doc["src"]), dst=int(doc["dst"]),
                   resource=doc.get("resource", ""),
                   gain=float(doc.get("gain", 0.0)),
                   cycle=int(doc.get("cycle", -1)))


# Deprecated name, kept for one release: the out-box records were called
# ``Migration`` before the typed adaptation protocol landed.
Migration = PlanDelta


@dataclass
class AssistantState:
    # out_boxes[device][resource] -> node ids offered for migration
    out_boxes: list[dict[str, list[str]]] = field(default_factory=list)


class SchedulingAssistants:
    """One assistant per device, executing the paper's θ/γ/out-box rules."""

    def __init__(self, graph: Graph, cost_model: CostModel,
                 config: AssistantConfig = AssistantConfig()):
        self.g = graph
        self.cm = cost_model
        self.cfg = config
        self.state = AssistantState(
            out_boxes=[{r: [] for r in ("compute", "memory", "network")}
                       for _ in range(cost_model.k)])
        self._clock = 0
        self._last_moved: dict[str, int] = {}

    # -- rule 1: overloaded devices offer nodes -------------------------------
    def _offer(self, assignment: dict[str, int],
               utils: list[dict[str, float]]) -> None:
        for d in range(self.cm.k):
            for res in ("compute", "memory", "network"):
                if utils[d][res] <= self.cfg.theta:
                    continue
                box = self.state.out_boxes[d][res]
                if len(box) >= self.cfg.max_outbox:
                    continue
                tag = TAG_OF_RESOURCE[res]
                # offer the costliest matching relocatable node on this device
                # (skipping nodes still in their post-migration cooldown)
                cands = [nid for nid, dev in assignment.items()
                         if dev == d and self.g.nodes[nid].relocatable
                         and self.g.nodes[nid].tag == tag and nid not in box
                         and self._clock - self._last_moved.get(
                             nid, -self.cfg.cooldown) >= self.cfg.cooldown]
                if cands:
                    cands.sort(key=lambda nid: -self.g.nodes[nid].flops)
                    box.append(cands[0])

    # -- rule 2: underloaded devices acquire nodes ------------------------------
    def _acquire(self, assignment: dict[str, int],
                 utils: list[dict[str, float]]) -> list[PlanDelta]:
        migrations: list[PlanDelta] = []
        for d in range(self.cm.k):
            for res in ("compute", "memory", "network"):
                if utils[d][res] >= self.cfg.gamma:
                    continue
                # take from the most-utilized donor's out-box
                donors = sorted(
                    (q for q in range(self.cm.k)
                     if q != d and self.state.out_boxes[q][res]),
                    key=lambda q: -utils[q][res])
                if not donors:
                    continue
                q = donors[0]
                box = self.state.out_boxes[q][res]
                nid = box[0]
                if assignment.get(nid) != q:
                    box.pop(0)  # stale offer: the node moved away, discard
                    continue
                if find_unlinked_cut(self.g, assignment, nid, d,
                                     self.cm.topology) is not None:
                    # no fabric link for the cut this acquirer would
                    # create — leave the offer for a linked device
                    continue
                box.pop(0)
                assignment[nid] = d
                migrations.append(PlanDelta(nid, q, d, res,
                                            cycle=self._clock))
        return migrations

    def step(self, assignment: dict[str, int],
             utils: list[dict[str, float]]) -> list[PlanDelta]:
        """One assistant cycle: offers then acquisitions.

        Emits the accepted moves as typed :class:`PlanDelta` records.  The
        *working* ``assignment`` dict is updated in place so the next cycle's
        offers see the new placement (legacy contract); callers holding a
        ``CompiledPlan`` should feed it a copy and apply the returned deltas
        through ``CompiledPlan.apply`` (see ``repro_torch.core.plan.adapt_plan``).
        """
        self._clock += 1
        self._offer(assignment, utils)
        migrations = self._acquire(assignment, utils)
        for m in migrations:
            self._last_moved[m.node] = self._clock
        return migrations


@dataclass
class AdaptationTrace:
    step_times: list[float]
    migrations: list[list[PlanDelta]]

    @property
    def improvement(self) -> float:
        if not self.step_times:
            return 0.0
        return 1.0 - self.step_times[-1] / self.step_times[0]

    @property
    def deltas(self) -> list[PlanDelta]:
        """The flat, ordered adaptation trace (replayable)."""
        return [m for migs in self.migrations for m in migs]

    def replay(self, assignment: dict[str, int]) -> dict[str, int]:
        """Re-apply the trace to a fresh copy of ``assignment``.

        Raises ``ValueError`` on a stale delta (node not on the recorded
        ``src``), so a trace can only replay against the placement it was
        recorded from — the audit property serving telemetry relies on."""
        assignment = dict(assignment)
        for d in self.deltas:
            if assignment.get(d.node) != d.src:
                raise ValueError(
                    f"stale delta: {d.node} is on "
                    f"{assignment.get(d.node)}, trace expected {d.src}")
            assignment[d.node] = d.dst
        return assignment

    def to_json(self) -> dict:
        return {"step_times": list(self.step_times),
                "migrations": [[m.to_json() for m in migs]
                               for migs in self.migrations]}

    @classmethod
    def from_json(cls, doc: dict) -> "AdaptationTrace":
        return cls(step_times=[float(t) for t in doc["step_times"]],
                   migrations=[[PlanDelta.from_json(m) for m in migs]
                               for migs in doc["migrations"]])


def run_adaptation(graph: Graph, assignment: dict[str, int],
                   cost_model: CostModel,
                   interference: Optional[list[dict[str, float]]] = None,
                   config: AssistantConfig = AssistantConfig(),
                   max_steps: int = 50,
                   telemetry: Optional[Callable] = None) -> AdaptationTrace:
    """Run assistant cycles until placement stabilizes (or max_steps).

    Returns the modeled step-time trajectory — it shows
    the assistants recovering from cost-model error / interference (the
    paper's §3 claim). ``telemetry`` may replace the analytical simulator
    with measured utilizations on real hardware.
    """
    assignment = dict(assignment)
    assistants = SchedulingAssistants(graph, cost_model, config)
    telemetry = telemetry or (lambda a: simulate_utilization(
        graph, a, cost_model, interference))
    times = [modeled_step_time(graph, assignment, cost_model, interference)]
    all_migrations: list[list[PlanDelta]] = []
    for _ in range(max_steps):
        utils = telemetry(assignment)
        prev = dict(assignment)
        migs = assistants.step(assignment, utils)
        # attribute a modeled gain to each delta by applying the cycle's
        # moves one at a time to the pre-cycle placement (sequential, so
        # the per-delta gains sum to the cycle's total change; gains
        # telescope across cycles to times[0] - times[-1])
        t_prev = times[-1]
        for m in migs:
            prev[m.node] = m.dst
            t_next = modeled_step_time(graph, prev, cost_model, interference)
            m.gain = t_prev - t_next
            t_prev = t_next
        # prev has converged to the post-cycle assignment, so t_prev IS
        # this cycle's step time — no recomputation needed
        all_migrations.append(migs)
        times.append(t_prev)
        # legacy termination: stop only once nothing moved AND every offer
        # was consumed.  An offer no underloaded device can take (e.g.
        # link-infeasible on a partial fabric) keeps the loop idling to
        # max_steps — idle cycles are cheap (one utilization simulation).
        if not migs and not any(
                any(box.values()) for box in assistants.state.out_boxes):
            break
    return AdaptationTrace(times, all_migrations)
