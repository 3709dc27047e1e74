"""Multi-replica serving: a cache-aware router over N ``ContinuousEngine``
replicas, with optional disaggregated prefill and decode roles.

The port of ``repro.serve.router``.  The ``Router`` owns N replicas (each
may be sized by its own compiled plan, ``ContinuousEngine(plan=)``) and
places every request on the replica maximizing

    score(r) = (1 + hit_tokens(r)) / ((1 + queue_depth(r)) * (1 + pressure(r)))

where ``hit_tokens`` is the prompt's longest prefix resident in replica
r's content index (``BlockAllocator.match_tokens``, a read-only peek),
``queue_depth`` its pending and active requests and ``pressure`` its block
pool's occupancy.  Ties go to the lowest replica index, and every input is
a function of the submitted trace, so placement replays exactly and each
request's tokens are those of single-replica serving.

Disaggregation (``role="prefill"`` / ``"decode"``): a request first runs
its prefill on a prefill-only replica (admitted with ``max_new_tokens=1``;
the probe token is dropped, and the decode replica emits it again); its
committed prompt blocks are exported by content hash, staged in a
``BlockTransferBuffer`` and imported into a decode replica's pool as
cached committed blocks, and the full request submitted there is an
ordinary prefix hit: its chunked prefill recomputes only the unhashed
tail and the last prompt position.  A chain the buffer dropped, or the
importing pool could not take whole, only means recomputation; a prompt
shorter than one block skips the handoff.  Archs whose cache content is
not a function of the token prefix (``lm.prefix_sharable_reason``) cannot
hand blocks over, and ``Router.build`` degrades them to co-located
(mixed) replicas, recording why.

All replicas of one card launch their kernels on the current stream from
one host thread, one engine step after the other: the paged kernel's
per-device ticket buffer allows no overlapping launches.  Each replica
counts its own steps in its telemetry; ``runtime.FleetTelemetry`` reduces
them, and ``Router.adapt`` feeds the fleet's interference into one §3
adaptation over the lead replica's plan and migrates queued (never
admitted) requests between replicas (``rebalance``).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.models import lm
from repro_torch.runtime.telemetry import FleetTelemetry, ServeTelemetry

from .cache import BlockTransferBuffer
from .engine import ContinuousEngine

ROLES = ("mixed", "prefill", "decode")


class _PrefillTicket:
    """Private rid for the prefill leg of a disaggregated request —
    object identity keeps it disjoint from every user rid."""

    __slots__ = ("rid",)

    def __init__(self, rid):
        self.rid = rid

    def __repr__(self):
        return f"prefill({self.rid!r})"


@dataclass
class RoutedRequest:
    """A request queued at the router, not yet placed on a replica."""

    rid: object
    prompt: list
    max_new_tokens: int
    arrival: int                      # router step (one step = one sweep
                                      # of every replica's engine step)
    eos_id: Optional[int] = None
    frontend_emb: Optional[object] = None
    sampling: Optional[object] = None
    block_hashes: tuple = ()
    seq: int = 0                      # submit order (FCFS tie-break)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def worst(self) -> int:
        return self.prompt_len + self.max_new_tokens


@dataclass(frozen=True)
class RouteDecision:
    """One routing outcome (kept for reproducibility assertions)."""

    rid: object
    replica: int
    kind: str                         # "direct" | "prefill" | "handoff"
    score: float
    hit_tokens: int
    queue_depth: int
    pressure: float


@dataclass(frozen=True)
class RequestMigration:
    """A queued request moved between replicas by ``rebalance``."""

    rid: object
    src: int
    dst: int
    step: int


@dataclass
class FleetAdaptation:
    """What one ``Router.adapt`` pass did: queued-request migrations plus
    the (optional) plan-level adaptation trace."""

    migrations: list = field(default_factory=list)
    plan: Optional[object] = None     # adapted CompiledPlan (None: no plan)
    trace: Optional[object] = None    # AdaptationTrace


@dataclass
class Replica:
    """One engine plus its fleet role."""

    name: str
    engine: ContinuousEngine
    role: str = "mixed"

    @property
    def decode_capable(self) -> bool:
        return self.role in ("mixed", "decode")

    def queue_depth(self) -> int:
        sched = self.engine.scheduler
        return sched.n_pending() + len(sched.active)


class Router:
    """Cache-aware router over N ``ContinuousEngine`` replicas (module
    docstring has the full protocol).  All replicas must serve the same
    config with the same params — token identity across replicas is what
    makes routing invisible to each request's output."""

    def __init__(self, engines, roles=None, *,
                 transfer: Optional[BlockTransferBuffer] = None,
                 rebalance_every: int = 0):
        if not engines:
            raise ValueError("a router needs at least one replica")
        roles = list(roles) if roles is not None else ["mixed"] * len(engines)
        if len(roles) != len(engines):
            raise ValueError(f"{len(engines)} engines but {len(roles)} roles")
        for role in roles:
            if role not in ROLES:
                raise ValueError(f"unknown role {role!r} (one of {ROLES})")
        cfg = engines[0].cfg
        for e in engines[1:]:
            if e.cfg != cfg:
                raise ValueError(
                    "all replicas must serve the same config "
                    f"({e.cfg.name!r} differs from {cfg.name!r})")
        self.cfg = cfg
        self.replicas = [Replica(name=f"replica{i}", engine=e, role=r)
                         for i, (e, r) in enumerate(zip(engines, roles))]
        if not any(r.decode_capable for r in self.replicas):
            raise ValueError("no decode-capable (mixed/decode) replica")
        prefills = [r for r in self.replicas if r.role == "prefill"]
        if prefills:
            reason = lm.prefix_sharable_reason(cfg)
            if reason is not None:
                raise ValueError(
                    f"{cfg.name}: prefill/decode disaggregation transfers "
                    f"blocks by content hash, unavailable — {reason}")
            for r in prefills:
                if not (r.engine.prefix_cache and r.engine.prefill_chunk):
                    raise ValueError(
                        f"{r.name}: prefill replicas need prefix_cache "
                        "and chunked prefill (the handoff exports the "
                        "committed chain)")
            for r in self.replicas:
                if r.decode_capable and not r.engine.prefix_cache:
                    raise ValueError(
                        f"{r.name}: decode replicas need prefix_cache "
                        "(the handoff imports into the content index)")
        self.transfer = transfer if transfer is not None \
            else BlockTransferBuffer()
        self.rebalance_every = rebalance_every
        self.disagg_unsupported_reason: Optional[str] = None
        self.telemetry = FleetTelemetry()
        for r in self.replicas:
            self.telemetry.attach(r.name, r.engine.telemetry)
        self._pending: deque[RoutedRequest] = deque()
        self._unsorted: list[RoutedRequest] = []
        self._handoffs: dict[_PrefillTicket, RoutedRequest] = {}
        self._rids: set = set()
        self._seq = 0
        self._step = 0
        self.decisions: list[RouteDecision] = []
        self.migrations: list[RequestMigration] = []
        self.stats: dict[str, int] = {
            "routed": 0, "handoffs": 0, "transferred_blocks": 0,
            "handoff_skipped_resident": 0, "handoff_skipped_short": 0}
        self.routed_per_replica = [0] * len(self.replicas)

    # -- construction -----------------------------------------------------------
    @classmethod
    def build(cls, cfg, params, *, n_replicas: int = 2,
              disaggregate: bool = False, kv_len: int = 0,
              n_slots: Optional[int] = None, plans=None,
              dtype=torch.float32, paged: bool = False,
              prefill_chunk: int = 0,
              prefix_cache: Optional[bool] = None,
              transfer_capacity: int = 0, rebalance_every: int = 0,
              telemetry_window: int = 50, device=None,
              **engine_kw) -> "Router":
        """Construct a fleet of ``n_replicas`` engines over shared params.

        ``disaggregate=True`` makes replica 0 prefill-only and the rest
        decode (needs ``n_replicas >= 2``), forcing the paged +
        prefix-cache + chunked-prefill combination the block handoff
        requires — on archs where blocks are not content-transferable
        (``lm.prefix_sharable_reason``) the fleet degrades gracefully to
        co-located mixed replicas and ``disagg_unsupported_reason``
        records why.  ``plans`` sizes each replica from a compiled plan:
        one artifact (shared) or a per-replica list.  Every replica runs
        on ``device`` and serves the one ``params`` dict (shared, never
        copied: weights are read-only while serving).
        """
        reason = lm.prefix_sharable_reason(cfg)
        want_disagg = disaggregate and reason is None
        if disaggregate and n_replicas < 2:
            raise ValueError("disaggregation needs >= 2 replicas "
                             "(one prefill + at least one decode)")
        if want_disagg:
            paged = True
            prefix_cache = True
            prefill_chunk = prefill_chunk or 16
            roles = ["prefill"] + ["decode"] * (n_replicas - 1)
        else:
            roles = ["mixed"] * n_replicas
        if prefix_cache is None:
            prefix_cache = paged and reason is None
        if isinstance(plans, (list, tuple)):
            if len(plans) != n_replicas:
                raise ValueError(f"{n_replicas} replicas but "
                                 f"{len(plans)} plans")
        else:
            plans = [plans] * n_replicas
        engines = [ContinuousEngine(
            cfg, params, kv_len=kv_len, n_slots=n_slots, dtype=dtype,
            paged=paged, prefill_chunk=prefill_chunk,
            prefix_cache=prefix_cache, plan=plans[i], device=device,
            telemetry=ServeTelemetry(window=telemetry_window), **engine_kw)
            for i in range(n_replicas)]
        router = cls(engines, roles=roles,
                     transfer=BlockTransferBuffer(transfer_capacity),
                     rebalance_every=rebalance_every)
        if disaggregate and not want_disagg:
            router.disagg_unsupported_reason = reason
        return router

    # -- intake -----------------------------------------------------------------
    @property
    def now(self) -> int:
        """Current router step — ``submit`` arrivals are absolute
        against it (one router step = one engine step on every replica
        that has work)."""
        return self._step

    def submit(self, prompt, max_new_tokens: int, *, rid=None,
               arrival: int = 0, eos_id: Optional[int] = None,
               frontend_emb=None, sampling=None) -> object:
        """Queue a request with the router (same contract as
        ``ContinuousEngine.submit``; ``arrival`` is in router steps).
        Placement happens when the request arrives, against the fleet's
        state at that step."""
        prompt = [int(t) for t in prompt]
        if rid is None:
            rid = self._seq
            while rid in self._rids:
                rid += 1
        elif rid in self._rids:
            raise ValueError(f"duplicate request id {rid!r}")
        if max_new_tokens < 1:
            raise ValueError(f"request {rid!r}: max_new_tokens < 1")
        if not prompt:
            raise ValueError(f"request {rid!r}: empty prompt")
        worst = len(prompt) + max_new_tokens
        fit = max((r.engine.kv_len for r in self.replicas
                   if r.decode_capable), default=0)
        if worst > fit:
            raise ValueError(
                f"request {rid!r}: prompt {len(prompt)} + max_new "
                f"{max_new_tokens} exceeds every decode-capable replica's "
                f"kv_len (max {fit})")
        hashes = ()
        bs = next((r.engine.block_size for r in self.replicas
                   if r.decode_capable and r.engine.prefix_cache), None)
        if bs is not None:
            hashes = lm.prompt_block_hashes(prompt, bs)
        req = RoutedRequest(rid=rid, prompt=prompt,
                            max_new_tokens=max_new_tokens, arrival=arrival,
                            eos_id=eos_id, frontend_emb=frontend_emb,
                            sampling=sampling,
                            block_hashes=hashes,
                            seq=self._seq)
        self._seq += 1
        self._rids.add(rid)
        self._unsorted.append(req)
        return rid

    # -- scoring ----------------------------------------------------------------
    def _score(self, replica: Replica, req: RoutedRequest) -> tuple:
        """(score, hit_tokens, queue_depth, pressure) for placing ``req``
        on ``replica`` — every input is deterministic fleet state."""
        eng = replica.engine
        hit = eng.allocator.match_tokens(req.block_hashes) \
            if eng.prefix_cache else 0
        depth = replica.queue_depth()
        pressure = eng.allocator.pressure()
        score = (1.0 + hit) / ((1.0 + depth) * (1.0 + pressure))
        return score, hit, depth, pressure

    def _best(self, req: RoutedRequest, candidates) -> tuple:
        """Highest-scoring candidate index; strict ``>`` while scanning
        in index order makes ties deterministic (lowest index wins)."""
        best_i, best = None, None
        for i in candidates:
            s = self._score(self.replicas[i], req)
            if best is None or s[0] > best[0]:
                best_i, best = i, s
        return best_i, best

    def _decode_candidates(self, req: RoutedRequest) -> list:
        return [i for i, r in enumerate(self.replicas)
                if r.decode_capable and req.worst <= r.engine.kv_len]

    # -- placement --------------------------------------------------------------
    def _place_direct(self, req: RoutedRequest, kind: str = "direct") -> int:
        idx, s = self._best(req, self._decode_candidates(req))
        rep = self.replicas[idx]
        rep.engine.submit(req.prompt, req.max_new_tokens, rid=req.rid,
                          arrival=rep.engine.now, eos_id=req.eos_id,
                          frontend_emb=req.frontend_emb,
                          sampling=req.sampling)
        self.decisions.append(RouteDecision(
            rid=req.rid, replica=idx, kind=kind, score=s[0],
            hit_tokens=s[1], queue_depth=s[2], pressure=s[3]))
        self.stats["routed"] += 1
        self.routed_per_replica[idx] += 1
        return idx

    def _place(self, req: RoutedRequest) -> None:
        prefills = [i for i, r in enumerate(self.replicas)
                    if r.role == "prefill"
                    and req.prompt_len + 1 <= r.engine.kv_len]
        if not prefills:
            self._place_direct(req)
            return
        if not req.block_hashes:
            # shorter than one full block: nothing transferable
            self.stats["handoff_skipped_short"] += 1
            self._place_direct(req)
            return
        full = len(req.block_hashes) * \
            self.replicas[prefills[0]].engine.block_size
        hits = [self.replicas[i].engine.allocator.match_tokens(
            req.block_hashes) for i in self._decode_candidates(req)]
        if hits and max(hits) >= full:
            # some decode replica already holds the whole chain — the
            # affinity score routes there; a prefill leg would be waste
            self.stats["handoff_skipped_resident"] += 1
            self._place_direct(req)
            return
        # least-loaded prefill replica (tie: lowest index) runs the
        # prefill leg; the decode replica is chosen at handoff time,
        # against the fleet state the blocks actually land in
        idx = min(prefills,
                  key=lambda i: (self.replicas[i].queue_depth(), i))
        rep = self.replicas[idx]
        ticket = _PrefillTicket(req.rid)
        rep.engine.submit(req.prompt, 1, rid=ticket,
                          arrival=rep.engine.now,
                          sampling=req.sampling)
        self._handoffs[ticket] = req
        s = self._score(rep, req)
        self.decisions.append(RouteDecision(
            rid=req.rid, replica=idx, kind="prefill", score=s[0],
            hit_tokens=s[1], queue_depth=s[2], pressure=s[3]))
        self.routed_per_replica[idx] += 1

    def _complete_handoff(self, prefill_idx: int,
                          ticket: _PrefillTicket) -> None:
        """The prefill leg finished: export its committed chain, stage it
        in the transfer buffer, deliver to the best decode replica, and
        re-submit the full request there as a prefix-cache hit."""
        req = self._handoffs.pop(ticket)
        src = self.replicas[prefill_idx].engine
        self.transfer.put_chain(src.export_prefix_blocks(req.block_hashes))
        idx, s = self._best(req, self._decode_candidates(req))
        dst = self.replicas[idx].engine
        chain = self.transfer.take_chain(req.block_hashes)
        if chain:
            self.stats["transferred_blocks"] += \
                dst.import_prefix_blocks(chain)
        dst.submit(req.prompt, req.max_new_tokens, rid=req.rid,
                   arrival=dst.now, eos_id=req.eos_id,
                   frontend_emb=req.frontend_emb, sampling=req.sampling)
        self.stats["handoffs"] += 1
        self.stats["routed"] += 1
        self.routed_per_replica[idx] += 1
        self.decisions.append(RouteDecision(
            rid=req.rid, replica=idx, kind="handoff", score=s[0],
            hit_tokens=s[1], queue_depth=s[2], pressure=s[3]))

    # -- serving loop ------------------------------------------------------------
    def _route_arrivals(self) -> None:
        while self._pending and self._pending[0].arrival <= self._step:
            self._place(self._pending.popleft())

    def _absorb_submissions(self) -> None:
        if self._unsorted:
            merged = sorted(list(self._pending) + self._unsorted,
                            key=lambda r: (r.arrival, r.seq))
            self._pending = deque(merged)
            self._unsorted = []

    def has_work(self) -> bool:
        return bool(self._unsorted or self._pending or self._handoffs
                    or any(r.engine.scheduler.has_work()
                           for r in self.replicas))

    def run(self, max_steps: Optional[int] = None) -> dict:
        """Serve every queued request to completion across the fleet;
        returns ``{rid: [generated token ids]}`` exactly like a single
        engine's ``run`` (prefill probe tokens of handoff legs are
        consumed internally and never surface)."""
        results: dict = {}
        steps = 0
        self._absorb_submissions()
        while self.has_work():
            if max_steps is not None and steps >= max_steps:
                break
            self._route_arrivals()
            progressed = False
            for i, rep in enumerate(self.replicas):
                if not rep.engine.scheduler.has_work():
                    continue
                progressed = True
                for rid, toks in rep.engine.run(max_steps=1).items():
                    if isinstance(rid, _PrefillTicket):
                        self._complete_handoff(i, rid)
                    else:
                        results[rid] = toks
            if not progressed:
                nxt = self._pending[0].arrival if self._pending else None
                if nxt is None:
                    break
                self._step = max(self._step + 1, nxt)  # idle: jump ahead
                continue
            self._step += 1
            steps += 1
            if self.rebalance_every and \
                    self._step % self.rebalance_every == 0:
                self.rebalance()
        return results

    # -- fleet adaptation (paper §3) ---------------------------------------------
    def rebalance(self, min_gap: int = 2) -> list:
        """Migrate queued requests from the most- to the least-loaded
        decode-capable replica while the load gap is at least
        ``min_gap`` (moving across a gap of 1 just swaps who waits).
        Only *queued* requests move — an admitted request's lane, cache
        blocks, and tokens are never touched — so migration is invisible
        to every request's output.  The youngest queued request moves
        (FCFS order of the remaining donor queue is preserved) and joins
        the tail of the acceptor's queue.  Returns the migrations."""
        moved: list[RequestMigration] = []
        while True:
            loads = [(r.queue_depth(), i)
                     for i, r in enumerate(self.replicas)
                     if r.decode_capable]
            donors = [(d, i) for d, i in loads
                      if self.replicas[i].engine.scheduler.n_pending()]
            if not donors or len(loads) < 2:
                break
            d_load, d_idx = max(donors, key=lambda t: (t[0], -t[1]))
            a_load, a_idx = min(loads, key=lambda t: (t[0], t[1]))
            if a_idx == d_idx or d_load - a_load < min_gap:
                break
            req = self.replicas[d_idx].engine.scheduler.steal_newest()
            if req is None:
                break
            acceptor = self.replicas[a_idx].engine
            acceptor.scheduler.submit(req)
            acceptor._rids.add(req.rid)
            moved.append(RequestMigration(rid=req.rid, src=d_idx,
                                          dst=a_idx, step=self._step))
        self.migrations.extend(moved)
        return moved

    def adapt(self) -> FleetAdaptation:
        """One fleet-level adaptation pass: rebalance queued requests
        under the measured load, then feed the fleet-aggregated
        interference into one ``core.assistants.run_adaptation`` over
        the lead replica's compiled plan (the first replica that carries
        one).  Returns what moved and the adaptation trace."""
        out = FleetAdaptation(migrations=self.rebalance())
        plan = next((r.engine.plan for r in self.replicas
                     if r.engine.plan is not None), None)
        if plan is not None:
            from repro_torch.core import adapt_plan
            cb = self.telemetry.assistant_callback(plan.graph,
                                                   plan.cost_model)
            out.plan, out.trace = adapt_plan(
                plan,
                interference=self.telemetry.device_interference(plan.k),
                telemetry=cb)
        return out

    def reset_stats(self) -> None:
        """Zero routing counters, decisions, and every replica's
        telemetry (benchmarks call this after compile warmup so gated
        counters — decode starvation above all — measure only the
        trace).  Placed requests and cache contents are untouched; pair
        with ``allocator.drop_cached()`` to also empty the prefix
        indexes."""
        for r in self.replicas:
            r.engine.telemetry.reset()
        self.decisions.clear()
        self.migrations.clear()
        for k in self.stats:
            self.stats[k] = 0
        self.routed_per_replica = [0] * len(self.replicas)
        self.transfer.stats.update(staged=0, delivered=0, dropped=0)

    # -- reporting ---------------------------------------------------------------
    def fleet_stats(self) -> dict:
        """One flat dict for launchers/benchmarks: routing + transfer
        counters, per-replica placement, and the fleet telemetry."""
        return dict(self.stats,
                    routed_per_replica=list(self.routed_per_replica),
                    migrations=len(self.migrations),
                    decode_starvation=self.telemetry.decode_starvation(),
                    total_tokens=self.telemetry.total_tokens(),
                    occupancy=self.telemetry.occupancy(),
                    cache_pressure=self.telemetry.cache_pressure(),
                    prefix_hit_rate=self.telemetry.prefix_hit_rate(),
                    transfer=dict(self.transfer.stats))
