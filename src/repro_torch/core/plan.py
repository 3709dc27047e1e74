"""Compiled placement plans — the compiler's one serializable artifact.

The port's copy of ``repro.core.plan``: the same names, arithmetic
and iteration order, so that floats agree with the reference exactly;
only the imports differ.  Pure Python: no ``torch``.

The paper's deliverable is a compiler: a costed dataflow graph is
partitioned once into a placement plan, and hardware scheduling assistants
fine-tune that plan at runtime (§3).  :class:`CompiledPlan` makes that plan
a first-class artifact instead of an ephemeral in-memory object:

* **versioned + hash-keyed** — :func:`plan_key` digests the model config,
  input shape, device :class:`~repro_torch.core.topology.Topology`, and
  partitioner strategy, so a plan names exactly the compilation problem it
  solves;
* **JSON-serializable** — ``to_json``/``from_json`` round-trip the graph,
  the assignment, and the stage tables bit-identically; cost summaries are
  recomputed (never trusted) on load;
* **cached** — :func:`compile` consults the on-disk cache in
  :mod:`repro_torch.core.plan_cache`, so planning is plan-once / reuse-everywhere
  across launchers, benchmarks, and serving restarts;
* **adaptable** — the §3 assistants emit typed
  :class:`~repro_torch.core.assistants.PlanDelta` records which
  :meth:`CompiledPlan.apply` validates (stale source, pinned node, pipeline
  convexity, optional balance envelope) and applies transactionally, giving
  serving an auditable adaptation trace (:func:`adapt_plan`).

The legacy surface (``plan_model(cfg, shape, k=int)`` returning ``Plan``)
lives on in :mod:`repro_torch.core.planner` as a thin deprecation shim.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import Iterable, Optional, Union

from repro_torch.models.config import ModelConfig, ShapeConfig

from .assistants import (
    AdaptationTrace,
    AssistantConfig,
    PlanDelta,
    find_unlinked_cut,
    modeled_step_time,
    run_adaptation,
)
from .cost_model import CostModel
from .graph import Graph
from .graphgen import build_graph
from .multilevel import multilevel_partition
from .partitioner import RefineResult, balance_stats, cut_bytes, partition
from .topology import Topology

PLAN_SCHEMA_VERSION = 1


class PlanError(ValueError):
    """A plan artifact is structurally unusable for the requested operation."""


class PlanDeltaError(PlanError):
    """A PlanDelta failed validation; the plan was left untouched."""


@dataclass(frozen=True)
class PartitionStrategy:
    """The partitioner knobs that (with config/shape/topology) key a plan."""

    strategy: str = "block"  # "block" | "random" | "multilevel"
    refine: bool = True
    epsilon_frac: float = 0.10
    gain_mode: str = "paper"
    seed: int = 0
    cost_mode: str = "roofline"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, doc: dict) -> "PartitionStrategy":
        return cls(**doc)


def _cfg_to_json(cfg: ModelConfig) -> dict:
    return dataclasses.asdict(cfg)


def _cfg_from_json(doc: dict) -> ModelConfig:
    doc = dict(doc)
    doc["layer_cycle"] = tuple(tuple(pair) for pair in doc["layer_cycle"])
    return ModelConfig(**doc)


def plan_key(
    cfg: ModelConfig,
    shape: ShapeConfig,
    topology: Topology,
    backend: str = "tensor",
    strategy: PartitionStrategy = PartitionStrategy(),
) -> str:
    """Stable content hash of one compilation problem (the cache key)."""
    blob = json.dumps(
        {
            "plan_version": PLAN_SCHEMA_VERSION,
            "cfg": _cfg_to_json(cfg),
            "shape": dataclasses.asdict(shape),
            "topology": topology.to_json(),
            "backend": backend,
            "strategy": strategy.to_json(),
        },
        sort_keys=True,
        separators=(",", ":"),
    )
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:24]


def _layer_stage_table(
    graph: Graph,
    assignment: dict[str, int],
    cost_model: CostModel,
    n_layers: int,
    enc: bool = False,
) -> list[int]:
    """Per-layer stage = cost-weighted majority of the layer's nodes, made
    monotone non-decreasing (pipeline stages must respect topology).
    Encoder layers are numbered from 1000 in graphgen."""
    base = 1000 if enc else 0
    votes: list[dict[int, float]] = [dict() for _ in range(n_layers)]
    for nid, dev in assignment.items():
        node = graph.nodes[nid]
        if node.layer is None:
            continue
        li = node.layer - base
        if 0 <= li < n_layers:
            votes[li][dev] = votes[li].get(dev, 0.0) + cost_model.node_cost(node, dev)
    table = []
    for li in range(n_layers):
        stage = max(votes[li].items(), key=lambda kv: kv[1])[0] if votes[li] else 0
        table.append(stage)
    for i in range(1, n_layers):
        table[i] = max(table[i], table[i - 1])
    return table


@dataclass
class CompiledPlan:
    """One compiled placement: what runs where, for which machine.

    ``graph`` and ``cost_model`` are honestly Optional: a plan stripped of
    its graph (or a hand-built stub) raises a loud :class:`PlanError` from
    every property that needs them, instead of the silent ``None``s the
    legacy ``Plan`` carried in fields typed as required.
    """

    cfg: ModelConfig
    shape: ShapeConfig
    topology: Topology
    backend: str  # "tensor" | "pipeline"
    strategy: PartitionStrategy
    assignment: dict[str, int]
    layer_to_stage: list[int]  # decoder layer index -> stage
    enc_layer_to_stage: list[int]  # encoder layer index -> stage
    result: RefineResult
    graph: Optional[Graph] = field(repr=False, default=None)
    cost_model: Optional[CostModel] = field(repr=False, default=None)
    version: int = PLAN_SCHEMA_VERSION
    from_cache: bool = field(default=False, repr=False, compare=False)

    # -- structural accessors -------------------------------------------------
    @property
    def k(self) -> int:
        return self.topology.k

    @property
    def key(self) -> str:
        return plan_key(
            self.cfg, self.shape, self.topology, self.backend, self.strategy
        )

    def _require_graph(self) -> Graph:
        if self.graph is None or self.cost_model is None:
            raise PlanError(
                f"plan {self.cfg.name} x {self.shape.name} has no attached "
                "graph/cost model — load it with CompiledPlan.from_json "
                "(which rebuilds both) before asking for cost summaries"
            )
        return self.graph

    # -- cost summaries (always recomputed from the graph) --------------------
    @property
    def cut_bytes(self) -> float:
        return cut_bytes(self._require_graph(), self.assignment)

    @property
    def step_time(self) -> float:
        return modeled_step_time(
            self._require_graph(), self.assignment, self.cost_model
        )

    def balance(self) -> dict:
        return balance_stats(self._require_graph(), self.assignment, self.cost_model)

    def stage_boundaries(self) -> list[int]:
        """Layer indices at which a new stage starts (pipeline realization)."""
        bounds = [0]
        for i in range(1, len(self.layer_to_stage)):
            if self.layer_to_stage[i] != self.layer_to_stage[i - 1]:
                bounds.append(i)
        return bounds

    def summary(self) -> dict:
        b = self.balance()
        return {
            "cut_bytes": self.cut_bytes,
            "step_time_s": self.step_time,
            "imbalance": b["imbalance"],
            "stages": self.stage_boundaries(),
        }

    def describe(self) -> str:
        b = self.balance()
        return (
            f"CompiledPlan[{self.cfg.name} x {self.shape.name} k={self.k} "
            f"{self.backend}] key={self.key} cut={self.cut_bytes:.3e}B "
            f"imbalance={b['imbalance']:.3f} "
            f"stages={self.stage_boundaries()} "
            f"t_step={self.step_time * 1e3:.2f}ms"
        )

    # -- the typed adaptation protocol ----------------------------------------
    def validate_delta(
        self,
        delta: PlanDelta,
        *,
        balance_epsilon: Optional[float] = None,
        check_convex: Optional[bool] = None,
    ) -> None:
        """Raise :class:`PlanDeltaError` unless ``delta`` is applicable.

        Always checked: the node exists, is relocatable, currently sits on
        ``delta.src``, and ``delta.dst`` is a different, valid device.  On
        pipeline plans (or with ``check_convex=True``) the move must also
        keep the assignment convex (stage(pred) <= stage(node) <=
        stage(succ)); :func:`adapt_plan` disables this because the §3
        assistants are placement-general and the stage tables are
        re-derived per apply.  ``balance_epsilon`` additionally enforces
        the paper's two balance conjuncts with the given epsilon fraction
        of the ideal share.
        """
        g = self._require_graph()
        node = g.nodes.get(delta.node)
        if node is None:
            raise PlanDeltaError(f"unknown node {delta.node!r}")
        cur = self.assignment.get(delta.node)
        if cur != delta.src:
            raise PlanDeltaError(
                f"stale delta: {delta.node} sits on device {cur}, "
                f"delta recorded src={delta.src}"
            )
        if not 0 <= delta.dst < self.k:
            raise PlanDeltaError(
                f"destination device {delta.dst} outside topology k={self.k}"
            )
        if delta.dst == delta.src:
            raise PlanDeltaError(f"no-op delta: src == dst == {delta.src}")
        if not node.relocatable:
            raise PlanDeltaError(
                f"{delta.node} is pinned (paper phase-1 selection) and "
                "cannot be migrated"
            )
        unlinked = find_unlinked_cut(
            g, self.assignment, delta.node, delta.dst, self.topology
        )
        if unlinked is not None:
            src_dev, dst_dev, edge = unlinked
            raise PlanDeltaError(
                f"no fabric link {src_dev} -> {dst_dev} for edge "
                f"{edge.src} -> {edge.dst} cut by this move"
            )
        if check_convex is None:
            check_convex = self.backend == "pipeline"
        if check_convex:
            lo, hi = 0, self.k - 1
            for e in g.in_edges(delta.node):
                lo = max(lo, self.assignment[e.src])
            for e in g.out_edges(delta.node):
                hi = min(hi, self.assignment[e.dst])
            if not lo <= delta.dst <= hi:
                raise PlanDeltaError(
                    f"convexity violation: {delta.node} -> device "
                    f"{delta.dst} outside its stage interval [{lo}, {hi}]"
                )
        if balance_epsilon is not None:
            cm = self.cost_model
            loads = cm.assignment_costs(g, self.assignment)
            ideal = cm.ideal_share(g)
            eps = balance_epsilon * ideal
            recv = loads[delta.dst] + cm.node_cost(node, delta.dst)
            send = loads[delta.src] - cm.node_cost(node, delta.src)
            if recv - ideal > eps or ideal - send > eps:
                raise PlanDeltaError(
                    f"balance violation: moving {delta.node} leaves loads "
                    f"recv={recv:.3e}s send={send:.3e}s outside "
                    f"ideal {ideal:.3e}s +- {eps:.3e}s"
                )

    def apply(
        self,
        delta: PlanDelta,
        *,
        balance_epsilon: Optional[float] = None,
        check_convex: Optional[bool] = None,
    ) -> "CompiledPlan":
        """Validate and apply one delta, returning a NEW plan.

        Transactional: validation failures raise :class:`PlanDeltaError`
        and leave this plan untouched; on success the returned plan carries
        the updated assignment and recomputed stage tables while this plan
        still describes the pre-move placement.
        """
        self.validate_delta(
            delta, balance_epsilon=balance_epsilon, check_convex=check_convex
        )
        assignment = dict(self.assignment)
        assignment[delta.node] = delta.dst
        g, cm = self.graph, self.cost_model
        return dataclasses.replace(
            self,
            assignment=assignment,
            # keep the partitioner-result surface in lockstep so the plan
            # never carries two divergent assignments through a round trip
            result=dataclasses.replace(self.result, assignment=assignment),
            layer_to_stage=_layer_stage_table(g, assignment, cm, self.cfg.n_layers),
            enc_layer_to_stage=_layer_stage_table(
                g, assignment, cm, self.cfg.n_enc_layers, enc=True
            ),
        )

    def apply_trace(
        self,
        deltas: Union[AdaptationTrace, Iterable[PlanDelta]],
        *,
        balance_epsilon: Optional[float] = None,
        check_convex: Optional[bool] = None,
    ) -> "CompiledPlan":
        """Apply a whole adaptation trace delta-by-delta (each validated)."""
        if isinstance(deltas, AdaptationTrace):
            deltas = deltas.deltas
        plan = self
        for delta in deltas:
            plan = plan.apply(
                delta, balance_epsilon=balance_epsilon, check_convex=check_convex
            )
        return plan

    def diff(self, other: "CompiledPlan") -> dict:
        """What changed between two plans (for the CLI / audit trails)."""
        moved = sorted(
            nid
            for nid, dev in self.assignment.items()
            if other.assignment.get(nid, dev) != dev
        )
        out = {
            "moved": moved,
            "n_moved": len(moved),
            "only_self": sorted(set(self.assignment) - set(other.assignment)),
            "only_other": sorted(set(other.assignment) - set(self.assignment)),
            "same_key": self.key == other.key,
        }
        if self.graph is not None and other.graph is not None:
            out["step_time_s"] = (self.step_time, other.step_time)
            out["cut_bytes"] = (self.cut_bytes, other.cut_bytes)
        return out

    # -- serialization --------------------------------------------------------
    def to_json(self) -> dict:
        g = self._require_graph()
        res = self.result
        return {
            "version": self.version,
            "key": self.key,
            "cfg": _cfg_to_json(self.cfg),
            "shape": dataclasses.asdict(self.shape),
            "topology": self.topology.to_json(),
            "backend": self.backend,
            "strategy": self.strategy.to_json(),
            "assignment": dict(self.assignment),
            "layer_to_stage": list(self.layer_to_stage),
            "enc_layer_to_stage": list(self.enc_layer_to_stage),
            "result": {
                "passes": res.passes,
                "comm_moves": res.comm_moves,
                "balance_moves": res.balance_moves,
                "cut_before": res.cut_before,
                "cut_after": res.cut_after,
                "history": res.history,
            },
            "graph": g.to_json(),
            # display-only: recomputed (and optionally verified) on load
            "summary": self.summary(),
        }

    @classmethod
    def from_json(cls, doc: dict, *, verify: bool = False) -> "CompiledPlan":
        version = doc.get("version")
        if version != PLAN_SCHEMA_VERSION:
            raise PlanError(
                f"unsupported plan schema version {version} "
                f"(this build reads version {PLAN_SCHEMA_VERSION})"
            )
        cfg = _cfg_from_json(doc["cfg"])
        shape = ShapeConfig(**doc["shape"])
        topology = Topology.from_json(doc["topology"])
        strategy = PartitionStrategy.from_json(doc["strategy"])
        graph = Graph.from_json(doc["graph"])
        raw = doc["assignment"]
        missing = [nid for nid in graph.nodes if nid not in raw]
        if missing:
            raise PlanError(
                f"artifact assignment is missing {len(missing)} graph "
                f"node(s), e.g. {missing[:3]}; the file is truncated or "
                "was edited by hand"
            )
        # canonical order (see compile): JSON may have sorted the dict
        assignment = {nid: int(raw[nid]) for nid in graph.nodes}
        cost_model = CostModel(topology, mode=strategy.cost_mode)
        res = doc["result"]
        plan = cls(
            cfg=cfg,
            shape=shape,
            topology=topology,
            backend=doc["backend"],
            strategy=strategy,
            assignment=assignment,
            layer_to_stage=[int(s) for s in doc["layer_to_stage"]],
            enc_layer_to_stage=[int(s) for s in doc["enc_layer_to_stage"]],
            result=RefineResult(
                assignment=assignment,
                passes=res["passes"],
                comm_moves=res["comm_moves"],
                balance_moves=res["balance_moves"],
                cut_before=res["cut_before"],
                cut_after=res["cut_after"],
                history=list(res.get("history", [])),
            ),
            graph=graph,
            cost_model=cost_model,
            version=version,
        )
        if verify:
            stored = doc.get("summary", {})
            recomputed = plan.summary()
            for key in ("cut_bytes", "step_time_s"):
                if key in stored and not math.isclose(
                    stored[key], recomputed[key], rel_tol=1e-6, abs_tol=1e-12
                ):
                    raise PlanError(
                        f"stored {key}={stored[key]!r} disagrees with the "
                        f"recomputed value {recomputed[key]!r}; artifact is "
                        "stale or was edited by hand"
                    )
        return plan

    def save(self, path) -> str:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_json(), fh, indent=1, sort_keys=True)
        return str(path)

    @classmethod
    def load(cls, path, *, verify: bool = True) -> "CompiledPlan":
        with open(path, encoding="utf-8") as fh:
            return cls.from_json(json.load(fh), verify=verify)


# =============================================================================
# compile: the plan-once / reuse-everywhere entry point
# =============================================================================


def _resolve_topology(topology: Union[Topology, int]) -> Topology:
    if isinstance(topology, int):
        return Topology.homogeneous(topology)
    if not isinstance(topology, Topology):
        raise TypeError(
            "compile() needs a Topology (or a device count meaning "
            f"Topology.homogeneous(k)), got {type(topology).__name__}"
        )
    return topology


def compile(
    cfg: ModelConfig,
    shape: ShapeConfig,
    topology: Union[Topology, int],
    *,
    backend: str = "tensor",
    strategy: Optional[PartitionStrategy] = None,
    cache=None,
) -> CompiledPlan:
    """Run the paper's compiler for one (config x shape x topology) problem.

    ``cache`` may be ``None`` (use the default on-disk cache, honouring the
    ``REPRO_TORCH_PLAN_CACHE`` env var — set it to ``0``/``off`` to disable),
    ``False`` (never touch disk), ``True`` (force the default cache), or a
    :class:`repro_torch.core.plan_cache.PlanCache` instance.  A cache hit returns
    the stored artifact with ``from_cache=True`` and its cost summaries
    re-verified against the deserialized graph.
    """
    assert backend in ("tensor", "pipeline")
    topology = _resolve_topology(topology)
    strategy = strategy or PartitionStrategy()

    from .plan_cache import resolve_cache

    store = resolve_cache(cache)
    key = plan_key(cfg, shape, topology, backend, strategy)
    if store is not None:
        hit = store.load(key)
        if hit is not None:
            return hit

    graph = build_graph(cfg, shape)
    cm = CostModel(topology, mode=strategy.cost_mode)
    cm.select_relocatable(graph)  # phase 1
    cm.tag_nodes(graph)  # §3 tags for the assistants
    convex = backend == "pipeline"
    if strategy.strategy == "multilevel":
        res = multilevel_partition(
            graph,
            cm,
            epsilon_frac=strategy.epsilon_frac,
            gain_mode=strategy.gain_mode,
            convex=convex,
        )
    else:
        res = partition(  # phases 3-4
            graph,
            cm,
            strategy=strategy.strategy,
            refine=strategy.refine,
            epsilon_frac=strategy.epsilon_frac,
            gain_mode=strategy.gain_mode,
            convex=convex,
            seed=strategy.seed,
        )
    # canonical assignment order (graph insertion order): cost summaries
    # sum floats in a deterministic order, so a deserialized plan — whose
    # JSON may have reordered the dict — reproduces them bit-identically
    ordered = {nid: res.assignment[nid] for nid in graph.nodes}
    res = dataclasses.replace(res, assignment=ordered)
    plan = CompiledPlan(
        cfg=cfg,
        shape=shape,
        topology=topology,
        backend=backend,
        strategy=strategy,
        assignment=ordered,
        layer_to_stage=_layer_stage_table(graph, res.assignment, cm, cfg.n_layers),
        enc_layer_to_stage=_layer_stage_table(
            graph, res.assignment, cm, cfg.n_enc_layers, enc=True
        ),
        result=res,
        graph=graph,
        cost_model=cm,
    )
    if store is not None:
        try:
            store.store(plan)
        except OSError:
            pass  # caching is best-effort: a full/read-only disk never fails a compile
    return plan


# the public name is ``compile``; this alias keeps call sites greppable
# without shadowing the builtin at import sites
compile_plan = compile


# =============================================================================
# adapt: the §3 protocol over a CompiledPlan
# =============================================================================


def adapt_plan(
    plan: CompiledPlan,
    *,
    interference=None,
    config: AssistantConfig = AssistantConfig(),
    max_steps: int = 50,
    telemetry=None,
) -> tuple[CompiledPlan, AdaptationTrace]:
    """Run the scheduling assistants against ``plan`` transactionally.

    The assistants run on a scratch copy of the assignment; every accepted
    migration comes back as a typed :class:`PlanDelta`, which is replayed
    through :meth:`CompiledPlan.apply` (validated, copy-on-write).  Returns
    the adapted plan plus the auditable trace; ``plan`` itself is never
    mutated.
    """
    graph = plan._require_graph()
    trace = run_adaptation(
        graph,
        dict(plan.assignment),
        plan.cost_model,
        interference=interference,
        config=config,
        max_steps=max_steps,
        telemetry=telemetry,
    )
    # the assistants are placement-general (no convexity notion); stage
    # tables are re-derived from the adapted assignment per apply
    adapted = plan.apply_trace(trace, check_convex=False)
    return adapted, trace
