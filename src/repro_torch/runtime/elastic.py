"""Elastic scaling + assistant-driven re-planning.

The port's copy of ``repro.runtime.elastic`` (only the imports differ).
The paper's compiler/assistant split maps naturally onto elastic serving
and training:

* device count changes (node failure, pool resize) -> re-compile the plan
  for the new topology (``replan``; the on-disk plan cache makes repeated
  resizes between the same sizes instant) — automatic model parallelism is
  what makes this a no-human-in-the-loop operation;
* cost-model drift / interference -> the scheduling assistants emit typed
  ``PlanDelta`` records which ``adapt`` replays through
  ``CompiledPlan.apply`` (``core.plan.adapt_plan``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core import (AdaptationTrace, AssistantConfig, CompiledPlan,
                              PartitionStrategy, Topology, adapt_plan,
                              compile_plan)
from repro_torch.models.config import ModelConfig, ShapeConfig


@dataclass
class ElasticController:
    cfg: ModelConfig
    shape: ShapeConfig
    backend: str = "tensor"
    topology: Optional[Topology] = None     # set by the first replan()
    # auditable adaptation history: (adapted plan, delta trace) per adapt()
    traces: list = field(default_factory=list)

    def replan(self, k: int, seed: int = 0) -> CompiledPlan:
        """New placement after a device-count change (plan-cache backed)."""
        self.topology = Topology.homogeneous(k)
        return compile_plan(self.cfg, self.shape, self.topology,
                            backend=self.backend,
                            strategy=PartitionStrategy(seed=seed))

    def adapt(self, plan: CompiledPlan, interference=None,
              config: AssistantConfig = AssistantConfig(),
              ) -> tuple[CompiledPlan, AdaptationTrace]:
        """Run the §3 assistant protocol on ``plan`` transactionally.

        Returns ``(adapted_plan, trace)`` — the trace is the replayable
        PlanDelta record; both are appended to ``traces``."""
        adapted, trace = adapt_plan(plan, interference=interference,
                                    config=config)
        self.traces.append((adapted, trace))
        return adapted, trace

    def should_replan(self, old_k: int, new_k: int) -> bool:
        return old_k != new_k
