"""Serving telemetry: the part of ``repro.runtime.telemetry.ServeTelemetry``
that the continuous-batching engine records each step (slot occupancy,
block-pool pressure, residency overall and by cache group, emitted
tokens, step time), plus the split of each step's host-clock time into
its prefill and decode parts, and the chunk steps' share of the prefill
part; and its bridge to the paper's §3 scheduling assistants
(``device_interference``, ``assistant_callback``), copied from the
reference.

The engine reads a token back to the host at the end of every prefill and
every decode step, which waits for the device, so these host-clock times
include the device work they cover.
"""

from __future__ import annotations

import statistics
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, ClassVar


@dataclass
class ServeStep:
    """One continuous-batching engine step's counters."""

    step: int
    seconds: float
    active_slots: tuple          # slot indices that decoded this step
    n_slots: int
    blocks_in_use: int
    n_blocks: int
    prefills: int = 0            # prefills completed (one token each)
    prefill_chunks: int = 0      # chunked-prefill work units this step
    new_tokens: int = 0          # decode tokens emitted
    resident_bytes: int = 0
    capacity_bytes: int = 0
    # residency by cache group: {"global"/"window"/"recurrent": bytes}
    resident_by_group: dict = field(default_factory=dict)
    prefill_seconds: float = 0.0  # admissions, whole prefills, chunks
    decode_seconds: float = 0.0
    chunk_seconds: float = 0.0    # the chunk steps alone


@dataclass
class ServeTelemetry:
    """Per-step serving counters with whole-run aggregates, and the bridge
    to the §3 assistants.

    ``device_interference`` maps slot occupancy onto the device mesh (slot s
    is served by device ``s % k``, the engine's round-robin lane placement)
    and cache pressure onto memory, producing the per-device busy-time
    multipliers ``core.assistants.simulate_utilization`` consumes.
    """

    alpha: ClassVar[float] = 0.75  # compute inflation per unit occupancy
    beta: ClassVar[float] = 0.5    # memory inflation per unit cache pressure

    window: int = 50
    history: int = 10_000        # retained ServeStep records
    steps: deque = field(default_factory=deque)

    def __post_init__(self):
        self.steps = deque(self.steps, maxlen=self.history)
        self._total_tokens = 0
        self._busy_seconds = 0.0
        self._peak_pressure = 0.0
        self._max_concurrency = 0
        self._peak_resident_bytes = 0
        self._peak_group_bytes: dict = {}
        self._prefills = 0
        self._prefill_seconds = 0.0
        self._chunks = 0
        self._chunk_seconds = 0.0
        self._decode_steps = 0
        self._decode_seconds = 0.0

    def record_step(self, step: int, seconds: float, active_slots,
                    n_slots: int, blocks_in_use: int, n_blocks: int,
                    prefills: int = 0, prefill_chunks: int = 0,
                    new_tokens: int = 0,
                    resident_bytes: int = 0, capacity_bytes: int = 0,
                    resident_by_group: dict = None,
                    prefill_seconds: float = 0.0,
                    decode_seconds: float = 0.0,
                    chunk_seconds: float = 0.0) -> None:
        self.steps.append(ServeStep(
            step=step, seconds=seconds, active_slots=tuple(active_slots),
            n_slots=n_slots, blocks_in_use=blocks_in_use, n_blocks=n_blocks,
            prefills=prefills, prefill_chunks=prefill_chunks,
            new_tokens=new_tokens,
            resident_bytes=resident_bytes, capacity_bytes=capacity_bytes,
            resident_by_group=dict(resident_by_group or {}),
            prefill_seconds=prefill_seconds, decode_seconds=decode_seconds,
            chunk_seconds=chunk_seconds))
        # chunk work units are not emitted tokens: only completed prefills
        # (one token each) and decode tokens count
        self._total_tokens += new_tokens + prefills
        self._busy_seconds += seconds
        if n_blocks:
            self._peak_pressure = max(self._peak_pressure,
                                      blocks_in_use / n_blocks)
        self._max_concurrency = max(self._max_concurrency, len(active_slots))
        self._peak_resident_bytes = max(self._peak_resident_bytes,
                                        resident_bytes)
        for group, nbytes in (resident_by_group or {}).items():
            self._peak_group_bytes[group] = max(
                self._peak_group_bytes.get(group, 0), nbytes)
        self._prefills += prefills
        self._prefill_seconds += prefill_seconds
        self._chunks += prefill_chunks
        self._chunk_seconds += chunk_seconds
        if active_slots:
            self._decode_steps += 1
            self._decode_seconds += decode_seconds

    def _recent(self) -> list:
        return list(self.steps)[-self.window:]

    def occupancy(self) -> float:
        """Mean fraction of slots decoding over the recent window."""
        vals = [len(s.active_slots) / s.n_slots for s in self._recent()
                if s.n_slots]
        return statistics.mean(vals) if vals else 0.0

    def cache_pressure(self) -> float:
        """Mean fraction of cache blocks allocated over the recent window
        (0 when no step had a block pool, as for a pure-recurrent model)."""
        vals = [s.blocks_in_use / s.n_blocks for s in self._recent()
                if s.n_blocks]
        return statistics.mean(vals) if vals else 0.0

    def peak_cache_pressure(self) -> float:
        return self._peak_pressure

    def peak_resident_bytes(self) -> int:
        return self._peak_resident_bytes

    def peak_resident_bytes_by_group(self) -> dict:
        """Peak residency per cache group ({"global"/"window"/"recurrent"}
        -> bytes); the window entry is bounded by n_slots rings at their
        cap and the recurrent entry by n_slots state slots, whatever the
        generated length."""
        return dict(self._peak_group_bytes)

    def max_concurrency(self) -> int:
        return self._max_concurrency

    def mean_prefill_ms(self) -> float:
        """Whole-run mean prefill time per prompt: its admission and its
        whole (or bucketed) prefill with the insertion into the paged pools
        or its lane, or all its chunk steps."""
        return self._prefill_seconds / self._prefills * 1e3 \
            if self._prefills else 0.0

    def prefill_chunks(self) -> int:
        """Chunked-prefill work units over the whole run."""
        return self._chunks

    def mean_chunk_ms(self) -> float:
        """Whole-run mean time of one chunked-prefill step."""
        return self._chunk_seconds / self._chunks * 1e3 \
            if self._chunks else 0.0

    def mean_decode_step_ms(self) -> float:
        """Whole-run mean time of one batched decode step."""
        return self._decode_seconds / self._decode_steps * 1e3 \
            if self._decode_steps else 0.0

    def total_tokens(self) -> int:
        return self._total_tokens

    def tokens_per_sec(self) -> float:
        if self._busy_seconds <= 0:
            return 0.0
        return self._total_tokens / self._busy_seconds

    # -- assistant bridge (paper §3) -------------------------------------------
    def device_interference(self, k: int) -> list:
        """Per-device busy-time multipliers from serving load.

        Slot s maps to device ``s % k``; a device whose lanes are saturated
        gets its compute busy time inflated by ``1 + alpha``, and cache
        pressure inflates every device's memory busy time.
        """
        recent = self._recent()
        press = self.cache_pressure()
        per_dev = [0.0] * k
        if recent:
            for s in recent:
                slots_per_dev = max(1, -(-s.n_slots // k))
                hits = [0] * k
                for slot in s.active_slots:
                    hits[slot % k] += 1
                for d in range(k):
                    per_dev[d] += min(1.0, hits[d] / slots_per_dev)
            per_dev = [x / len(recent) for x in per_dev]
        return [{"compute": 1.0 + self.alpha * per_dev[d],
                 "memory": 1.0 + self.beta * press,
                 "network": 1.0} for d in range(k)]

    def assistant_callback(self, graph, cost_model) -> Callable:
        """A ``telemetry=`` callback for ``core.assistants.run_adaptation``:
        utilization under the measured serving interference, re-evaluated
        against each candidate assignment as the assistants migrate nodes."""
        from repro_torch.core.assistants import simulate_utilization

        interference = self.device_interference(cost_model.k)

        def callback(assignment):
            return simulate_utilization(graph, assignment, cost_model,
                                        interference=interference)
        return callback
