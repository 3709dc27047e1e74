"""Deprecated planning surface — kept for one release.

The port's copy of ``repro.core.planner``: the same names, arithmetic
and iteration order, so that floats agree with the reference exactly;
only the imports differ.  Pure Python: no ``torch``.

The compiler's real entry point is now :func:`repro_torch.core.plan.compile`,
which takes an explicit :class:`repro_torch.core.topology.Topology` and returns a
serializable, cacheable :class:`repro_torch.core.plan.CompiledPlan`.  This
module keeps the legacy
names importable:

* ``Plan`` — alias of :class:`CompiledPlan` (the old dataclass's fields and
  properties are all preserved on the new artifact);
* ``plan_model(cfg, shape, k=int, device=..., devices=...)`` — thin shim
  that builds the equivalent ``Topology`` and calls ``compile`` with the
  on-disk plan cache bypassed (exactly the old ephemeral behaviour).

Both emit :class:`DeprecationWarning`; out-of-tree callers should move to::

    from repro_torch.core import Topology, compile_plan
    plan = compile_plan(cfg, shape, Topology.homogeneous(8))
"""

from __future__ import annotations

import warnings
from typing import Optional

from repro_torch.models.config import ModelConfig, ShapeConfig

from .cost_model import DeviceSpec, TPU_V5E
from .plan import CompiledPlan, PartitionStrategy, compile_plan
from .topology import Topology

# Deprecated alias: the plan artifact used to be an ephemeral ``Plan``.
Plan = CompiledPlan


def plan_model(cfg: ModelConfig, shape: ShapeConfig, k: int, *,
               backend: str = "tensor", strategy: str = "block",
               refine: bool = True, epsilon_frac: float = 0.10,
               gain_mode: str = "paper", seed: int = 0,
               device: DeviceSpec = TPU_V5E,
               devices: Optional[list[DeviceSpec]] = None,
               cost_mode: str = "roofline") -> CompiledPlan:
    """DEPRECATED: use ``repro_torch.core.plan.compile`` with a ``Topology``.

    Runs the same compiler pipeline for one (arch x shape) cell, with the
    ``k: int`` (+ optional device list) expanded into a ``Topology``.  The
    plan cache is bypassed so the call stays side-effect free.
    """
    warnings.warn(
        "plan_model(cfg, shape, k=...) is deprecated; build a "
        "repro_torch.core.Topology and call repro_torch.core.plan.compile "
        "instead",
        DeprecationWarning, stacklevel=2)
    topology = (Topology.from_devices(devices) if devices is not None
                else Topology.homogeneous(k, device))
    return compile_plan(
        cfg, shape, topology, backend=backend,
        strategy=PartitionStrategy(
            strategy=strategy, refine=refine, epsilon_frac=epsilon_frac,
            gain_mode=gain_mode, seed=seed, cost_mode=cost_mode),
        cache=False)
