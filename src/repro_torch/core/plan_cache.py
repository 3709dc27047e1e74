"""On-disk cache of compiled-plan artifacts: plan once, reuse everywhere.

The port's copy of ``repro.core.plan_cache``: the same names, arithmetic
and iteration order, so that floats agree with the reference exactly;
only the imports differ, and the cache has its own variable and
directory, so that neither package reads an artifact the other
wrote.  Pure Python: no ``torch``.

``repro_torch.core.plan.compile`` keys every compilation problem with
:func:`repro_torch.core.plan.plan_key` (config + shape + topology + strategy +
schema version) and stores the JSON artifact here, so launchers, benchmarks
and serving restarts that ask for the same placement get the cached plan
back instead of re-running the partitioner.

Resolution order for the cache location:

* ``REPRO_TORCH_PLAN_CACHE=<dir>`` — use that directory;
* ``REPRO_TORCH_PLAN_CACHE`` in ``{"0", "off", "none", ""}`` — caching disabled;
* otherwise ``$XDG_CACHE_HOME/repro_torch/plans`` (default ``~/.cache/...``).

Loads are verified (cost summaries recomputed from the deserialized graph
must match the stored ones); a stale or corrupt entry is treated as a miss
and silently recompiled over.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Optional, Union

from .plan import CompiledPlan, PlanError

_DISABLED = {"0", "off", "none", "false", ""}


def default_cache_dir() -> Optional[Path]:
    """The configured cache directory, or None when caching is disabled."""
    env = os.environ.get("REPRO_TORCH_PLAN_CACHE")
    if env is not None:
        if env.strip().lower() in _DISABLED:
            return None
        return Path(env).expanduser()
    xdg = os.environ.get("XDG_CACHE_HOME", "~/.cache")
    return Path(xdg).expanduser() / "repro_torch" / "plans"


class PlanCache:
    """A directory of ``<plan_key>.json`` compiled-plan artifacts."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root).expanduser()
        self.root.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0

    @classmethod
    def default(cls) -> Optional["PlanCache"]:
        """The configured default cache — or None when disabled OR when the
        location is unusable (read-only filesystem, path collides with a
        file, ...): default caching is best-effort, never fatal."""
        root = default_cache_dir()
        if root is None:
            return None
        try:
            return cls(root)
        except OSError:
            return None

    def path_for(self, key: str) -> Path:
        return self.root / f"{key}.json"

    def load(self, key: str) -> Optional[CompiledPlan]:
        """The cached plan for ``key``, or None (counts a hit/miss)."""
        path = self.path_for(key)
        if not path.exists():
            self.misses += 1
            return None
        try:
            with open(path, encoding="utf-8") as fh:
                plan = CompiledPlan.from_json(json.load(fh), verify=True)
        except (OSError, ValueError, KeyError, TypeError, PlanError):
            # stale schema / corrupt file: recompile over it
            self.misses += 1
            return None
        if plan.key != key:
            self.misses += 1
            return None
        plan.from_cache = True
        self.hits += 1
        return plan

    def store(self, plan: CompiledPlan) -> Path:
        """Atomically write ``plan`` under its own key."""
        path = self.path_for(plan.key)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                json.dump(plan.to_json(), fh, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path

    def keys(self) -> list[str]:
        return sorted(p.stem for p in self.root.glob("*.json"))

    def __len__(self) -> int:
        return len(self.keys())

    def clear(self) -> int:
        n = 0
        for p in self.root.glob("*.json"):
            p.unlink()
            n += 1
        return n


def resolve_cache(cache) -> Optional[PlanCache]:
    """Normalize ``compile(cache=...)``: None/True -> default, False -> off."""
    if cache is None or cache is True:
        return PlanCache.default()
    if cache is False:
        return None
    return cache
