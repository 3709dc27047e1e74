"""Block (paged) KV cache of the continuous-batching engine: the host-side
``BlockAllocator`` and the physical ``PagedKVStore``.

The port's copy of the global-attention, sliding-window and
recurrent-state parts of ``repro.serve.cache``, with the chunked-prefill
ring layout (``CacheLayout.prefill_chunk``).  Cache memory is divided
into blocks of ``block_size`` tokens; each admitted request owns a
per-slot block table that grows one block at a time as it decodes, and
every block returns to the free list when the request finishes.  A model
with sliding-window layers gives each request a block *ring* instead
(logical block -> physical block): blocks that fall fully behind ``pos -
window`` go back to the free list as the request decodes, so a window lane
pins O(window) blocks whatever its length.  Admission may reserve a
request's worst case (``prompt + max_new`` tokens, a ring at its cap), so
that decode can never run out of blocks; an admission without a
reservation (lazy pricing) grows as it goes and can meet
``CacheExhausted``.  A speculative round rewinds a slot's table and ring
past its rejected rows (``truncate``, ``truncate_window``).  A model with
recurrent (SSD, RG-LRU) layers also holds one state slot per live request
(its lane's O(1) state slabs), accounted apart from the blocks; a model
with no attention layer holds no blocks at all (``CacheLayout``).

Failures are typed as in the reference: ``CacheExhausted`` (a
``MemoryError``) is expected backpressure, ``AllocatorInvariantError`` (an
``AssertionError``) is a bug.

``PagedKVStore`` holds a pair of pools ``[n_layers, n_blocks + 1,
block_size, KV, hd]``; the extra trailing page is the null block that
inactive lanes and unallocated table entries point at.  The engine writes
the pools in place, so a store bound to them never needs rebinding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.device import resolve_device


class CacheError(Exception):
    """Base class for the allocator's typed failures."""


class CacheExhausted(CacheError, MemoryError):
    """Expected capacity backpressure: the pool cannot satisfy this claim
    right now (admission waits for blocks to be freed)."""


class AllocatorInvariantError(CacheError, AssertionError):
    """A broken allocator invariant (double allocate, double free, shrink,
    leaked blocks): a bug in the caller or the allocator itself."""


@dataclass(frozen=True)
class CacheConfig:
    """Block pool geometry: ``n_blocks`` blocks of ``block_size`` tokens."""

    block_size: int = 16
    n_blocks: int = 256

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache entries."""
        return max(0, -(-n_tokens // self.block_size))

    @property
    def null_block(self) -> int:
        """Physical id of the scratch page (one past the allocatable pool)."""
        return self.n_blocks


@dataclass(frozen=True)
class CacheLayout:
    """Which cache groups a model's layers need, in allocator terms: the
    reference's ``CacheLayout`` less the groups the port does not serve
    yet.  Built by the engine from ``models.lm.serve_groups`` and installed
    with ``BlockAllocator.set_layout``; the default is the global-only
    regime.  ``window`` is the sliding-window width (0 = no window group)
    and ``window_cap_blocks`` the admission price of one ring: the most
    blocks a lane can pin at once.  ``state_slots``/``state_bytes_per_slot``
    describe the recurrent lanes (0 slots = no recurrent group).
    ``prefill_chunk`` (chunked prefill): window rings start at block 0 and
    slide forward with the chunks, and the cap counts the in-flight
    chunk's blocks."""

    has_global: bool = True
    window: int = 0
    window_cap_blocks: int = 0
    state_slots: int = 0
    state_bytes_per_slot: int = 0
    prefill_chunk: int = 0


class PagedKVStore:
    """Physical paged storage for a stack of layers: ``k_pages`` and
    ``v_pages`` of shape ``[n_layers, n_blocks + 1, block_size, KV, hd]``,
    page ``n_blocks`` being the null block."""

    def __init__(self, config: CacheConfig, n_layers: int, n_kv_heads: int,
                 head_dim: int, dtype=torch.float32, device=None):
        shape = (n_layers, config.n_blocks + 1, config.block_size,
                 n_kv_heads, head_dim)
        device = resolve_device(device)
        self.config = config
        self.k_pages = torch.zeros(shape, dtype=dtype, device=device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=device)

    @classmethod
    def from_pools(cls, config: CacheConfig, k_pages,
                   v_pages) -> "PagedKVStore":
        """Wrap existing pool tensors (a leaf of the engine's cache tree)."""
        store = cls.__new__(cls)
        store.config = config
        store.rebind(k_pages, v_pages)
        return store

    def rebind(self, k_pages, v_pages) -> None:
        if k_pages.shape[:3] != v_pages.shape[:3]:
            raise ValueError(f"pool shapes disagree: {tuple(k_pages.shape)} "
                             f"vs {tuple(v_pages.shape)}")
        if k_pages.shape[1] != self.config.n_blocks + 1 or \
                k_pages.shape[2] != self.config.block_size:
            raise ValueError(f"pool shape {tuple(k_pages.shape)} does not "
                             f"match {self.config}")
        self.k_pages = k_pages
        self.v_pages = v_pages

    @property
    def n_layers(self) -> int:
        return self.k_pages.shape[0]

    @property
    def block_bytes(self) -> int:
        """Device bytes one block id pins across all layers (both pools)."""
        per_k, per_v = self.k_pages[:, 0], self.v_pages[:, 0]
        return per_k.numel() * per_k.element_size() + \
            per_v.numel() * per_v.element_size()

    def write_token(self, table: list, pos: int, k, v) -> None:
        """Write one token's rows (``[n_layers, KV, hd]``) at logical
        position ``pos`` of the lane backed by ``table``, in place."""
        block = table[pos // self.config.block_size]
        off = pos % self.config.block_size
        self.k_pages[:, block, off] = k
        self.v_pages[:, block, off] = v

    def gather_slot(self, table: list, context_len: int) -> tuple:
        """The lane's logical rows, ``[n_layers, context_len, KV, hd]``
        each, gathered through ``table``."""
        idx = torch.as_tensor(table, dtype=torch.long,
                              device=self.k_pages.device)
        L = self.n_layers
        k = self.k_pages[:, idx].reshape(
            (L, -1) + tuple(self.k_pages.shape[3:]))[:, :context_len]
        v = self.v_pages[:, idx].reshape(
            (L, -1) + tuple(self.v_pages.shape[3:]))[:, :context_len]
        return k, v


class BlockAllocator:
    """Free-list block allocator with one growing block table per slot
    (``tables``), a window block ring per slot when the layout has a
    window group (``window_tables``: logical block -> physical block), and
    a state slot per live request when it has a recurrent group.

    Admissions may carry a worst-case reservation (``reserve_tokens``):
    the reserved but not yet claimed blocks of every live slot are
    subtracted from what ``can_allocate`` promises the next admission, and
    a slot's own ``extend``s (and ring slides) draw on its reservation, so
    a reserving scheduler never sees ``CacheExhausted`` mid-decode.  The
    free list is LIFO, with blocks claimed and returned in the reference's
    order, so both allocators hand out the same block ids for the same
    operations.
    """

    def __init__(self, config: CacheConfig,
                 store: Optional[PagedKVStore] = None):
        self.config = config
        self._free: list[int] = list(range(config.n_blocks - 1, -1, -1))
        self.tables: dict[int, list[int]] = {}     # slot -> block ids
        # slot -> {logical block index: physical block} window ring
        self.window_tables: dict[int, dict[int, int]] = {}
        self._tokens: dict[int, int] = {}          # slot -> resident tokens
        self._reserve: dict[int, int] = {}         # slot -> reserved blocks
        self.stores: list[PagedKVStore] = []
        self.store_groups: list[str] = []
        self.layout = CacheLayout()
        self._state_slots: set[int] = set()
        if store is not None:
            self.attach_store(store)

    def set_layout(self, layout: CacheLayout) -> None:
        """Install the engine's cache-group layout (before any admission)."""
        if self.tables or self.window_tables or self._state_slots:
            raise ValueError("cannot change layout with live allocations")
        self.layout = layout

    # -- queries ----------------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return self.config.n_blocks

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_in_use(self) -> int:
        return self.config.n_blocks - self.n_free

    def _global_blocks(self, n_tokens: int) -> int:
        """Global-table blocks covering ``n_tokens`` (none without a global
        group)."""
        return self.config.blocks_for(n_tokens) if self.layout.has_global \
            else 0

    def blocks_needed(self, n_tokens: int,
                      reserve_tokens: Optional[int] = None) -> int:
        """Admission price of ``n_tokens``, or of the worst case
        ``reserve_tokens`` when that is larger: a global table grows with
        the context; a window ring is capped at ``window_cap_blocks``
        whatever the length."""
        n = max(n_tokens, reserve_tokens or 0)
        need = self._global_blocks(n)
        if self.layout.window:
            need += min(self.config.blocks_for(n),
                        self.layout.window_cap_blocks)
        return need

    def outstanding_blocks(self) -> int:
        """Blocks promised to live reservations but not yet claimed: each
        reservation's remaining global growth plus its ring's headroom up
        to the cap."""
        out = 0
        for slot, reserved in self._reserve.items():
            out += max(0, reserved - len(self.tables.get(slot, ())))
            if self.layout.window and slot in self.window_tables:
                out += max(0, self.layout.window_cap_blocks
                           - len(self.window_tables[slot]))
        return out

    def n_available(self) -> int:
        """Blocks the next admission may be promised."""
        return self.n_free - self.outstanding_blocks()

    def can_allocate(self, n_tokens: int,
                     reserve_tokens: Optional[int] = None) -> bool:
        if self.layout.state_slots and \
                len(self._state_slots) >= self.layout.state_slots:
            return False
        return self.blocks_needed(n_tokens, reserve_tokens) \
            <= self.n_available()

    def state_slots_in_use(self) -> int:
        return len(self._state_slots)

    # -- lifecycle ---------------------------------------------------------------
    def _claim(self, n: int, what: str) -> list[int]:
        if n > self.n_free:
            raise CacheExhausted(
                f"need {n} blocks for {what}, {self.n_free} free")
        return [self._free.pop() for _ in range(max(0, n))]

    def allocate(self, slot: int, n_tokens: int, *,
                 reserve_tokens: Optional[int] = None) -> list[int]:
        """Claim blocks for a request admitted into ``slot`` holding
        ``n_tokens`` (prompt + first generated token); with
        ``reserve_tokens`` also reserve blocks for its worst case (its
        ring at the cap); with a window group place its ring; with a
        recurrent group also take the slot's state slot.  Returns the
        slot's global block ids (none without a global group)."""
        if slot in self.tables:
            raise AllocatorInvariantError(
                f"slot {slot} already has an allocation")
        if not self.can_allocate(n_tokens, reserve_tokens):
            raise CacheExhausted(
                f"need {self.blocks_needed(n_tokens, reserve_tokens)} blocks "
                f"for {n_tokens} tokens, {self.n_available()} available "
                f"({self.n_free} free, {self.outstanding_blocks()} reserved)")
        table = self._claim(self._global_blocks(n_tokens), f"slot {slot}")
        self.tables[slot] = table
        self._tokens[slot] = n_tokens
        if reserve_tokens is not None and self.layout.has_global:
            self._reserve[slot] = self.config.blocks_for(reserve_tokens)
        if self.layout.window:
            self._allocate_window(slot, n_tokens)
            if reserve_tokens is not None:
                self._reserve.setdefault(slot, 0)
        if self.layout.state_slots:
            self._state_slots.add(slot)
        return list(table)

    def _allocate_window(self, slot: int, n_tokens: int) -> None:
        """Initial window ring: a whole-prompt prefill lands only the last
        ``window`` positions in the ring, so cover the blocks holding
        ``[max(0, p - window + 1), p]``, p = ``n_tokens - 1``; chunked
        prefill starts at block 0 and slides forward with the chunks
        (``extend_window``)."""
        bs, W = self.config.block_size, self.layout.window
        if self.layout.prefill_chunk:
            p = min(self.layout.prefill_chunk, n_tokens) - 1
            lo = 0
        else:
            p = n_tokens - 1
            lo = max(0, p - W + 1) // bs
        blocks = self._claim(p // bs - lo + 1, f"slot {slot} window ring")
        self.window_tables[slot] = {lo + i: b for i, b in enumerate(blocks)}

    def extend(self, slot: int, n_tokens_total: int) -> list[int]:
        """Grow ``slot``'s table to cover ``n_tokens_total`` resident
        tokens; returns the newly claimed block ids (usually none).  Growth
        within the slot's reservation always succeeds; beyond it, it must
        fit in the unreserved headroom, else ``CacheExhausted``."""
        if slot not in self.tables:
            raise AllocatorInvariantError(f"slot {slot} has no allocation")
        if n_tokens_total < self._tokens[slot]:
            raise AllocatorInvariantError(
                f"slot {slot}: cannot shrink {self._tokens[slot]} -> "
                f"{n_tokens_total}")
        need = self._global_blocks(n_tokens_total) - len(self.tables[slot])
        if need > 0:
            own = max(0, self._reserve.get(slot, 0) - len(self.tables[slot]))
            extra = max(0, need - own)
            if extra > self.n_available():
                raise CacheExhausted(
                    f"slot {slot}: needs {need} more blocks ({extra} beyond "
                    f"its reservation), {self.n_available()} available")
        fresh = self._claim(max(0, need), f"slot {slot}")
        self.tables[slot].extend(fresh)
        self._tokens[slot] = n_tokens_total
        return fresh

    def extend_window(self, slot: int, n_tokens_total: int,
                      first_query_pos: Optional[int] = None) -> tuple:
        """Slide ``slot``'s window ring forward to cover position
        ``n_tokens_total - 1``: claim blocks up to its logical block, and
        free every block that has fallen fully behind
        ``first_query_pos - window`` (default: the covered position itself,
        the decode case; chunked prefill passes the chunk's first row, so
        that its earlier queries keep their window).  Returns ``(fresh,
        freed)`` physical block ids; either non-empty means the published
        table row must be rebuilt."""
        if slot not in self.window_tables:
            raise AllocatorInvariantError(f"slot {slot} has no window ring")
        bs, W = self.config.block_size, self.layout.window
        ring = self.window_tables[slot]
        p = n_tokens_total - 1
        fq = p if first_query_pos is None else first_query_pos
        lo = max(0, fq - W + 1) // bs
        freed = [ring.pop(i) for i in sorted(ring) if i < lo]
        self._free.extend(reversed(freed))
        cur_hi = max(ring, default=lo - 1)
        n_claim = max(0, p // bs - cur_hi)
        if n_claim and slot not in self._reserve \
                and n_claim > self.n_available():
            # a reserving slot's ring headroom is counted in
            # outstanding_blocks(); an unreserved one must not eat into
            # other slots' reservations
            raise CacheExhausted(
                f"slot {slot}: window ring needs {n_claim} more blocks, "
                f"{self.n_available()} available")
        fresh = self._claim(n_claim, f"slot {slot} window ring")
        for i, b in enumerate(fresh):
            ring[cur_hi + 1 + i] = b
        return fresh, freed

    def truncate(self, slot: int, n_tokens_total: int) -> list[int]:
        """Shrink ``slot``'s global table to cover ``n_tokens_total``
        resident tokens: the speculative rewind past rejected draft rows.
        Whole tail blocks only are freed (a partly vacated tail block stays:
        its stale rows sit past the slot's position, where no query reads
        them, and the next accepted token overwrites them).  Returns the
        freed block ids; they re-enter the free list so the next growth
        reclaims them first, in table order."""
        if slot not in self.tables:
            raise AllocatorInvariantError(f"slot {slot} has no allocation")
        if n_tokens_total > self._tokens[slot]:
            raise AllocatorInvariantError(
                f"slot {slot}: truncate cannot grow "
                f"{self._tokens[slot]} -> {n_tokens_total}")
        table = self.tables[slot]
        keep = self.config.blocks_for(n_tokens_total) \
            if self.layout.has_global else len(table)
        freed = table[keep:]
        del table[keep:]
        self._free.extend(reversed(freed))
        self._tokens[slot] = n_tokens_total
        return freed

    def truncate_window(self, slot: int, n_tokens_total: int) -> list[int]:
        """Rewind ``slot``'s window ring: free the ring blocks whose logical
        index lies wholly past position ``n_tokens_total - 1``.  The low
        edge stays (a speculative round slides it with ``first_query_pos``
        at the pre-draft position, so every block a query after the rewind
        can attend is still resident).  Returns the freed block ids."""
        if slot not in self.window_tables:
            raise AllocatorInvariantError(f"slot {slot} has no window ring")
        ring = self.window_tables[slot]
        hi = (n_tokens_total - 1) // self.config.block_size
        freed = [ring.pop(i) for i in sorted(ring, reverse=True) if i > hi]
        self._free.extend(freed)
        return freed

    def free_slot(self, slot: int) -> int:
        """Return every block of ``slot``, its global table's and its
        ring's, to the free list (in table order, so the next claims reuse
        them first) and release its state slot; returns how many
        blocks."""
        if slot not in self.tables:
            raise AllocatorInvariantError(f"slot {slot} has no allocation")
        blocks = self.tables.pop(slot)
        self._tokens.pop(slot)
        self._reserve.pop(slot, None)
        self._free.extend(reversed(blocks))
        ring = self.window_tables.pop(slot, None)
        if ring:
            ring_blocks = [ring[i] for i in sorted(ring, reverse=True)]
            self._free.extend(ring_blocks)
            blocks = blocks + ring_blocks
        self._state_slots.discard(slot)
        return len(blocks)

    def padded_table(self, slot: int, width: int) -> list[int]:
        """``slot``'s table padded to ``width`` entries with the null
        block (unallocated logical blocks resolve to the scratch page)."""
        table = self.tables[slot]
        if len(table) > width:
            raise ValueError(
                f"table of {len(table)} blocks exceeds width {width}")
        return table + [self.config.null_block] * (width - len(table))

    def padded_window_table(self, slot: int, width: int) -> list[int]:
        """``slot``'s window ring as a full-width logical table: entry i is
        the physical block of logical block i, or the null block when i is
        behind the window (freed) or not yet written."""
        ring = self.window_tables[slot]
        if ring and max(ring) >= width:
            raise ValueError(
                f"window ring reaches block {max(ring)}, width {width}")
        null = self.config.null_block
        return [ring.get(i, null) for i in range(width)]

    def window_blocks_in_use(self) -> int:
        return sum(len(ring) for ring in self.window_tables.values())

    # -- invariants --------------------------------------------------------------
    def check(self) -> None:
        """Every block is free or in exactly one table or ring, each table
        covers exactly its slot's tokens, every ring belongs to a live slot
        and with a window group every live slot has one, reservations fit
        the free pool, and with a recurrent group every live slot holds
        exactly one state slot."""
        owned = [b for t in self.tables.values() for b in t]
        window = [b for ring in self.window_tables.values()
                  for b in ring.values()]
        everything = self._free + owned + window
        if len(set(everything)) != len(everything):
            raise AllocatorInvariantError("a block is owned twice")
        if sorted(everything) != list(range(self.config.n_blocks)):
            raise AllocatorInvariantError(
                f"{self.config.n_blocks - len(everything)} blocks "
                "unaccounted for")
        for slot, table in self.tables.items():
            if len(table) != self._global_blocks(self._tokens[slot]):
                raise AllocatorInvariantError(
                    f"slot {slot}: {len(table)} blocks for "
                    f"{self._tokens[slot]} tokens")
        if set(self.window_tables) - set(self.tables):
            raise AllocatorInvariantError(
                "window rings held by no live slot: "
                f"{sorted(set(self.window_tables) - set(self.tables))}")
        if self.layout.window and set(self.window_tables) != \
                set(self.tables):
            raise AllocatorInvariantError(
                "live slots without a window ring: "
                f"{sorted(set(self.tables) - set(self.window_tables))}")
        if set(self._reserve) - set(self.tables):
            raise AllocatorInvariantError("reservation without a table")
        if self.outstanding_blocks() > self.n_free:
            raise AllocatorInvariantError(
                f"reservations outstanding ({self.outstanding_blocks()}) "
                f"exceed free blocks ({self.n_free})")
        if self._state_slots - set(self.tables):
            raise AllocatorInvariantError(
                "state slots held by no live slot: "
                f"{sorted(self._state_slots - set(self.tables))}")
        if self.layout.state_slots and \
                self._state_slots != set(self.tables):
            raise AllocatorInvariantError(
                "live slots without a state slot: "
                f"{sorted(set(self.tables) - self._state_slots)}")
        if len(self._state_slots) > self.layout.state_slots:
            raise AllocatorInvariantError(
                f"{len(self._state_slots)} state slots in use, layout has "
                f"{self.layout.state_slots}")

    def check_no_leaks(self) -> None:
        """With no live slot, every block is free and no ring or state
        slot is held; then ``check()``."""
        if self.tables:
            raise AllocatorInvariantError(
                f"live tables remain: {sorted(self.tables)}")
        if self.window_tables:
            raise AllocatorInvariantError(
                f"live window rings remain: {sorted(self.window_tables)}")
        if self._state_slots:
            raise AllocatorInvariantError(
                f"live state slots remain: {sorted(self._state_slots)}")
        if len(self._free) != self.config.n_blocks:
            raise AllocatorInvariantError(
                f"{self.config.n_blocks - len(self._free)} blocks leaked")
        self.check()

    # -- physical store ----------------------------------------------------------
    def attach_store(self, store: PagedKVStore,
                     group: str = "global") -> None:
        """Bind a physical store whose blocks the ``group`` ("global" or
        "window") tables address."""
        if store.config != self.config:
            raise ValueError("store geometry does not match allocator config")
        self.stores.append(store)
        self.store_groups.append(group)

    def resident_bytes(self) -> int:
        """Device bytes pinned by allocated blocks across the stores and by
        live state slots."""
        return sum(self.resident_bytes_by_group().values())

    def resident_bytes_by_group(self) -> dict[str, int]:
        """Residency split by cache group, as the reference splits it:
        ``"global"`` and ``"window"`` are each group's blocks in use times
        the bytes per block of that group's stores (a group appears when it
        has stores or blocks in use), ``"recurrent"`` state slots in use
        times the layout's bytes per slot."""
        out: dict[str, int] = {}
        in_use = {"global": sum(len(t) for t in self.tables.values()),
                  "window": self.window_blocks_in_use()}
        for group, n in in_use.items():
            block_bytes = sum(s.block_bytes for s, g in
                              zip(self.stores, self.store_groups)
                              if g == group)
            if block_bytes or n:
                out[group] = n * block_bytes
        if self.layout.state_slots:
            out["recurrent"] = len(self._state_slots) * \
                self.layout.state_bytes_per_slot
        return out

    def capacity_bytes(self) -> int:
        total = self.config.n_blocks * sum(s.block_bytes
                                           for s in self.stores)
        return total + self.layout.state_slots * \
            self.layout.state_bytes_per_slot
