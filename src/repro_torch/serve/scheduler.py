"""Request queue and slot scheduler for continuous batching.

The port's copy of ``repro.serve.scheduler``: the engine owns ``n_slots``
decode lanes, and queued requests are admitted into free lanes mid-stream,
strictly first come first served, when the block allocator can price them.
Two pricing modes (``pricing=``):

* ``"worst"`` (default) — admission reserves the worst case
  (``prompt_len + max_new_tokens``) with the allocator, so an admitted
  request always decodes to its budget.
* ``"lazy"`` — admission prices the prefill only (``prompt_len + 1``);
  decode growth claims blocks as it goes and can meet ``CacheExhausted``,
  on which the engine preempts the youngest slot (``preempt``) and
  requeues its request at the head of the queue.

A router rebalancing its replicas moves queued requests only, the
youngest first (``steal_newest``).

Arrivals are in engine steps (one step = one batched decode).
"""

from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from .cache import BlockAllocator


@dataclass
class Request:
    """One serving request: prompt token ids and a decode budget.
    ``frontend_emb`` carries a modality-frontend or enc-dec request's
    precomputed frontend embeddings ([frontend_tokens, frontend_dim]); the
    projection or the encoder runs once, at admission.  ``block_hashes``
    is the prompt's content hash chain over full cache blocks
    (``models.lm.prompt_block_hashes``), filled in by the engine when its
    prefix cache is on and matched by the allocator at admission."""

    rid: object
    prompt: object                   # int sequence of token ids
    max_new_tokens: int
    arrival: int = 0                 # engine step at which it exists
    eos_id: Optional[int] = None     # stop early when this token is emitted
    frontend_emb: Optional[object] = None
    block_hashes: Optional[tuple] = None
    sampling: Optional[object] = None  # SamplingParams; None is greedy

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


@dataclass
class ActiveSlot:
    """A request bound to a decode lane."""

    request: Request
    slot: int
    admitted_at: int
    tokens: list = field(default_factory=list)   # generated token ids
    first_token_step: Optional[int] = None       # step the prefill finished

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    @property
    def position(self) -> int:
        """Absolute position of the next token to be decoded."""
        return self.request.prompt_len + self.n_generated

    def is_finished(self) -> bool:
        if self.n_generated >= self.request.max_new_tokens:
            return True
        eos = self.request.eos_id
        return bool(eos is not None and self.tokens
                    and self.tokens[-1] == eos)


class SlotScheduler:
    """FCFS admission of queued requests into free slots, priced by
    ``pricing`` ("worst" reserves each admission's worst case, "lazy" its
    prefill only, with ``preempt`` as the safety net).  Free slots form a
    min-heap, so the lowest free slot is always reused first, under
    finish and preempt churn alike."""

    def __init__(self, n_slots: int, allocator: BlockAllocator, kv_len: int,
                 pricing: str = "worst"):
        if pricing not in ("worst", "lazy"):
            raise ValueError(f"pricing must be 'worst' or 'lazy', "
                             f"got {pricing!r}")
        self.n_slots = n_slots
        self.pricing = pricing
        self.allocator = allocator
        self.kv_len = kv_len
        self._free_slots: list[int] = list(range(n_slots))
        self._pending: deque[Request] = deque()
        self.active: dict[int, ActiveSlot] = {}
        self.finished: list[ActiveSlot] = []
        self.slot_admissions: dict[int, int] = {s: 0 for s in range(n_slots)}
        self.preemptions = 0

    def submit(self, request: Request) -> None:
        """Queue a request after checking it can ever be served.  The
        bound is in logical tokens: a modality frontend's physical rows
        are priced by the allocator's layout and sized into the engine's
        lanes (``kv_len + frontend_extra``), so a request at exactly the
        bound fits its lane."""
        worst = request.prompt_len + request.max_new_tokens
        if worst > self.kv_len:
            raise ValueError(
                f"request {request.rid!r}: prompt {request.prompt_len} + "
                f"max_new {request.max_new_tokens} exceeds kv_len "
                f"{self.kv_len}")
        if request.max_new_tokens < 1:
            raise ValueError(f"request {request.rid!r}: max_new_tokens < 1")
        if request.prompt_len < 1:
            raise ValueError(f"request {request.rid!r}: empty prompt")
        self._pending.append(request)

    def admit(self, now: int) -> list[ActiveSlot]:
        """Admit arrived requests into free slots, FCFS, until the first
        one that has not arrived yet or does not fit; a request's
        ``block_hashes`` go to the allocator for prefix matching."""
        admitted: list[ActiveSlot] = []
        while self._pending and self._free_slots:
            req = self._pending[0]
            if req.arrival > now:
                break
            reserve = (req.prompt_len + req.max_new_tokens
                       if self.pricing == "worst" else None)
            if not self.allocator.can_allocate(req.prompt_len + 1, reserve):
                break
            self._pending.popleft()
            slot = heapq.heappop(self._free_slots)
            self.allocator.allocate(slot, req.prompt_len + 1,
                                    reserve_tokens=reserve,
                                    block_hashes=req.block_hashes)
            act = ActiveSlot(request=req, slot=slot, admitted_at=now)
            self.active[slot] = act
            self.slot_admissions[slot] += 1
            admitted.append(act)
        return admitted

    def finish(self, slot: int) -> ActiveSlot:
        """Retire the request in ``slot``: its blocks and lane are freed."""
        act = self.active.pop(slot)
        self.allocator.free_slot(slot)
        heapq.heappush(self._free_slots, slot)
        self.finished.append(act)
        return act

    def preempt(self, slot: int) -> ActiveSlot:
        """Evict the request in ``slot`` and requeue it at the head of the
        queue (first in FCFS order, so its re-admission, and its tokens,
        are those of an uninterrupted run).  Its generated tokens are
        dropped: decoding restarts from the prompt, and its re-admission
        matches the prefix blocks it committed again.  The lazy pricing
        mode's safety net against a mid-decode ``CacheExhausted``."""
        act = self.active.pop(slot)
        self.allocator.free_slot(slot)
        heapq.heappush(self._free_slots, slot)
        act.tokens.clear()
        act.first_token_step = None
        self._pending.appendleft(act.request)
        self.preemptions += 1
        return act

    def steal_newest(self) -> Optional[Request]:
        """Pop and return the youngest queued request (the queue's tail),
        or None when nothing is pending: fleet rebalancing takes from the
        tail, so the rest of the queue keeps its FCFS order.  Admitted
        requests are never touched."""
        return self._pending.pop() if self._pending else None

    def has_work(self) -> bool:
        return bool(self._pending or self.active)

    def n_pending(self) -> int:
        return len(self._pending)

    def next_arrival(self) -> Optional[int]:
        """Arrival step of the queue head (None when empty)."""
        return self._pending[0].arrival if self._pending else None

    def max_slot_reuse(self) -> int:
        return max(self.slot_admissions.values(), default=0)
