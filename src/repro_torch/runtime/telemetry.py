"""Training and serving telemetry.

``Telemetry`` is the reference's training telemetry (step times, losses,
stragglers: a step slower than 1.5x the median of the last 50, once 10
are in), copied.

Serving telemetry: the part of ``repro.runtime.telemetry.ServeTelemetry``
that the continuous-batching engine records each step (slot occupancy,
block-pool pressure, residency overall and by cache group, emitted
tokens, step time, lazy-pricing preemptions, speculative drafts, accepts
and rewound rows, prefix-cache lookups, hits and sharing, decode lanes
that shared a step with prefill work), plus the split of each step's
host-clock time into its prefill and decode parts, and the chunk steps'
share of the prefill part; and its bridge to the paper's §3 scheduling
assistants (``device_interference``, ``assistant_callback``), copied from
the reference.  ``FleetTelemetry`` reduces the per-replica feeds of a
multi-replica router and carries the same bridge for the fleet.

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
class Telemetry:
    window: int = 50
    straggler_factor: float = 1.5
    steps: list = field(default_factory=list)      # (step, seconds, loss)
    stragglers: list = field(default_factory=list)

    def record(self, step: int, seconds: float, loss: float) -> None:
        self.steps.append((step, seconds, loss))
        recent = [s for _, s, _ in self.steps[-self.window:]]
        if len(recent) >= 10:
            med = statistics.median(recent)
            if seconds > self.straggler_factor * med:
                self.stragglers.append((step, seconds, med))

    def median_ms(self) -> float:
        if not self.steps:
            return 0.0
        return statistics.median(s for _, s, _ in self.steps) * 1e3

    def n_stragglers(self) -> int:
        return len(self.stragglers)

    def losses(self) -> list:
        return [l for _, _, l in self.steps]


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
    # residency by cache group: {"global"/"window"/"recurrent"/"cross":
    # bytes}; an enc-dec lane's cross entry is flat for its whole run
    resident_by_group: dict = field(default_factory=dict)
    prefill_seconds: float = 0.0  # admissions, whole prefills, chunks
    decode_seconds: float = 0.0   # the batched step, or the rounds
    chunk_seconds: float = 0.0    # the chunk steps alone
    # lazy pricing's safety net: slots evicted and requeued this step
    preemptions: int = 0
    # prefix cache: prompt tokens looked up and served from the cache at
    # this step's admissions, and the pool's sharing state after it
    prefix_hit_tokens: int = 0
    prefix_lookup_tokens: int = 0
    shared_saved_bytes: int = 0       # bytes deduplicated right now
    cached_blocks: int = 0            # refcount-0 committed blocks resident
    # self-speculative decoding: draft tokens proposed and accepted this
    # step, and cache rows written then rewound after a rejection
    drafted: int = 0
    accepted: int = 0
    rewound_tokens: int = 0


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
        self._zero()

    def reset(self) -> None:
        """Drop every recorded step and whole-run aggregate."""
        self.steps.clear()
        self._zero()

    def _zero(self) -> None:
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
        self._total_preemptions = 0
        self._total_drafted = 0
        self._total_accepted = 0
        self._total_rewound = 0
        self._prefix_hit_tokens = 0
        self._prefix_lookup_tokens = 0
        self._peak_shared_saved_bytes = 0
        self._starved_decode_steps = 0

    def record_step(self, step: int, seconds: float, active_slots,
                    n_slots: int, blocks_in_use: int, n_blocks: int,
                    prefills: int = 0, prefill_chunks: int = 0,
                    new_tokens: int = 0,
                    resident_bytes: int = 0, capacity_bytes: int = 0,
                    resident_by_group: dict = None,
                    prefill_seconds: float = 0.0,
                    decode_seconds: float = 0.0,
                    chunk_seconds: float = 0.0, preemptions: int = 0,
                    prefix_hit_tokens: int = 0,
                    prefix_lookup_tokens: int = 0,
                    shared_saved_bytes: int = 0, cached_blocks: int = 0,
                    drafted: int = 0, accepted: int = 0,
                    rewound_tokens: int = 0) -> None:
        self.steps.append(ServeStep(
            step=step, seconds=seconds, active_slots=tuple(active_slots),
            n_slots=n_slots, blocks_in_use=blocks_in_use, n_blocks=n_blocks,
            prefills=prefills, prefill_chunks=prefill_chunks,
            new_tokens=new_tokens,
            resident_bytes=resident_bytes, capacity_bytes=capacity_bytes,
            resident_by_group=dict(resident_by_group or {}),
            prefill_seconds=prefill_seconds, decode_seconds=decode_seconds,
            chunk_seconds=chunk_seconds, preemptions=preemptions,
            prefix_hit_tokens=prefix_hit_tokens,
            prefix_lookup_tokens=prefix_lookup_tokens,
            shared_saved_bytes=shared_saved_bytes,
            cached_blocks=cached_blocks, drafted=drafted,
            accepted=accepted, rewound_tokens=rewound_tokens))
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
        self._total_preemptions += preemptions
        self._total_drafted += drafted
        self._total_accepted += accepted
        self._total_rewound += rewound_tokens
        self._prefix_hit_tokens += prefix_hit_tokens
        self._prefix_lookup_tokens += prefix_lookup_tokens
        self._peak_shared_saved_bytes = max(self._peak_shared_saved_bytes,
                                            shared_saved_bytes)
        # every decode lane that shared this step with prefill work had its
        # token delayed by that prefill: the displacement disaggregated
        # prefill and decode removes
        if (prefills or prefill_chunks) and active_slots:
            self._starved_decode_steps += len(tuple(active_slots))

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
        """Peak residency per cache group
        ({"global"/"window"/"recurrent"/"cross"} -> bytes); the window
        entry is bounded by n_slots rings at their cap, the recurrent entry
        by n_slots state slots and the cross entry by n_slots static cross
        block sets, whatever the generated length."""
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

    def total_preemptions(self) -> int:
        """Whole-run count of lazy-pricing evict-and-requeue preemptions."""
        return self._total_preemptions

    def accept_rate(self) -> float:
        """Fraction of drafted speculative tokens the verify pass accepted
        over the whole run (0 when speculation is off)."""
        if not self._total_drafted:
            return 0.0
        return self._total_accepted / self._total_drafted

    def total_drafted(self) -> int:
        return self._total_drafted

    def total_rewound_tokens(self) -> int:
        """Whole-run count of cache rows a draft or verify pass wrote and a
        rejection rewound (table tail, window ring, recurrent state)."""
        return self._total_rewound

    def prefix_hit_rate(self) -> float:
        """Fraction of looked-up prompt tokens served from the prefix cache
        over the whole run (0 when no admission carried a hash chain)."""
        if not self._prefix_lookup_tokens:
            return 0.0
        return self._prefix_hit_tokens / self._prefix_lookup_tokens

    def peak_shared_saved_bytes(self) -> int:
        """Peak device bytes deduplicated by prefix-block sharing."""
        return self._peak_shared_saved_bytes

    def decode_starvation(self) -> int:
        """Whole-run count of decode-lane steps displaced by prefill work:
        each decoding lane of a step that also ran a whole prefill or a
        chunk counts one."""
        return self._starved_decode_steps

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


class FleetTelemetry:
    """The per-replica ``ServeTelemetry`` feeds of a multi-replica
    ``serve.Router``, reduced on demand (the replicas' records are held by
    reference, never copied).  Counters (tokens, starvation, preemptions)
    sum over the replicas; ratios (occupancy, cache pressure) average over
    the replicas that have recorded a step, so that an idle prefill
    replica does not dilute them; the prefix hit rate pools the lookups.
    ``device_interference`` is the element-wise mean of the replicas'
    per-device multipliers, which ``Router.adapt`` feeds into one §3
    adaptation for the whole fleet."""

    def __init__(self):
        self.replicas: list[tuple[str, ServeTelemetry]] = []

    def attach(self, name: str, telemetry: ServeTelemetry) -> None:
        self.replicas.append((name, telemetry))

    def _live(self) -> list:
        return [t for _, t in self.replicas if t.steps]

    def total_tokens(self) -> int:
        return sum(t.total_tokens() for _, t in self.replicas)

    def total_preemptions(self) -> int:
        return sum(t.total_preemptions() for _, t in self.replicas)

    def decode_starvation(self) -> int:
        """Fleet-wide decode-lane steps displaced by prefill work (a
        prefill-only replica's steps carry no decode lane)."""
        return sum(t.decode_starvation() for _, t in self.replicas)

    def occupancy(self) -> float:
        live = self._live()
        return statistics.mean(t.occupancy() for t in live) if live else 0.0

    def cache_pressure(self) -> float:
        live = self._live()
        return statistics.mean(t.cache_pressure() for t in live) \
            if live else 0.0

    def prefix_hit_rate(self) -> float:
        looked = sum(t._prefix_lookup_tokens for _, t in self.replicas)
        hit = sum(t._prefix_hit_tokens for _, t in self.replicas)
        return hit / looked if looked else 0.0

    def max_concurrency(self) -> int:
        return sum(t.max_concurrency() for _, t in self.replicas)

    def summary(self) -> dict:
        """Per-replica snapshot keyed by replica name."""
        return {name: {"tokens": t.total_tokens(),
                       "occupancy": t.occupancy(),
                       "cache_pressure": t.cache_pressure(),
                       "decode_starvation": t.decode_starvation(),
                       "steps": len(t.steps)}
                for name, t in self.replicas}

    # -- assistant bridge (paper §3, fleet level) ------------------------------
    def device_interference(self, k: int) -> list:
        """Element-wise mean of the replicas' per-device interference: the
        fleet's measured serving load on one k-device mesh."""
        live = self._live()
        if not live:
            return [{"compute": 1.0, "memory": 1.0, "network": 1.0}
                    for _ in range(k)]
        per = [t.device_interference(k) for t in live]
        return [{res: statistics.mean(p[d][res] for p in per)
                 for res in ("compute", "memory", "network")}
                for d in range(k)]

    def assistant_callback(self, graph, cost_model) -> Callable:
        """The ``telemetry=`` feed of one fleet-level ``run_adaptation``."""
        from repro_torch.core.assistants import simulate_utilization

        interference = self.device_interference(cost_model.k)

        def callback(assignment):
            return simulate_utilization(graph, assignment, cost_model,
                                        interference=interference)
        return callback
