"""The paper's contribution: compiler-driven automatic model parallelism.

The port's copy of ``repro.core`` but ``placement`` (multi-device sharding,
which waits for the port's multi-device work), plus ``H100_SXM``.  Pure
Python: nothing here imports ``torch``.

Pipeline: ``graphgen.build_graph`` -> ``cost_model.CostModel`` ->
``partitioner.partition`` -> ``plan.CompiledPlan`` (serializable, cached,
keyed by config x shape x ``topology.Topology`` x strategy) -> launch-layer
realization, with ``assistants`` providing the runtime adaptation of paper
§3 as typed ``PlanDelta`` records that ``CompiledPlan.apply`` replays
transactionally.  ``planner.plan_model`` / ``planner.Plan`` remain as
deprecation shims for one release.
"""

from .graph import Graph, Node, Edge, TAG_COMPUTE, TAG_MEMORY, TAG_NETWORK
from .cost_model import (CostModel, DeviceSpec, H100_SXM, TPU_V5E,
                         homogeneous_devices, heterogeneous_devices)
from .topology import Topology
from .partitioner import (block_partition, random_partition, partition,
                          Refiner, RefineResult, cut_bytes, comm_score,
                          balance_stats)
from .assistants import (AssistantConfig, SchedulingAssistants, Migration,
                         PlanDelta, simulate_utilization, modeled_step_time,
                         run_adaptation, AdaptationTrace)
from .multilevel import multilevel_partition
from .graphgen import build_graph
from .plan import (CompiledPlan, PartitionStrategy, PlanError,
                   PlanDeltaError, adapt_plan, compile_plan, plan_key)
from .plan_cache import PlanCache, default_cache_dir
from .planner import Plan, plan_model

__all__ = [
    "Graph", "Node", "Edge", "TAG_COMPUTE", "TAG_MEMORY", "TAG_NETWORK",
    "CostModel", "DeviceSpec", "TPU_V5E", "H100_SXM", "homogeneous_devices",
    "heterogeneous_devices", "Topology", "block_partition",
    "random_partition", "partition", "Refiner", "RefineResult", "cut_bytes",
    "comm_score", "balance_stats", "AssistantConfig",
    "SchedulingAssistants", "Migration", "PlanDelta",
    "simulate_utilization", "modeled_step_time", "run_adaptation",
    "AdaptationTrace", "build_graph", "CompiledPlan", "PartitionStrategy",
    "PlanError", "PlanDeltaError", "adapt_plan", "compile_plan",
    "plan_key", "PlanCache", "default_cache_dir", "Plan", "plan_model",
    "multilevel_partition",
]
