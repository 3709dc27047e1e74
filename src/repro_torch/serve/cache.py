"""Block (paged) KV cache of the continuous-batching engine: the host-side
``BlockAllocator`` and the physical ``PagedKVStore``.

The port's copy of ``repro.serve.cache``: global attention,
sliding-window rings, recurrent state slots and enc-dec cross block sets,
with the chunked-prefill ring layout (``CacheLayout.prefill_chunk``).  Cache memory is divided
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
with no attention layer holds no blocks at all (``CacheLayout``).  An
enc-dec model's requests each hold a static cross block set, sized for
the encoder's ``frontend_tokens`` rows, claimed whole at admission (and
priced there), never extended, and freed at retirement; a modality
frontend's rows share the global table, so ``frontend_extra`` widens every
admission's global and window price and the per-slot ledger counts
physical rows.

Prefix cache (``CacheLayout.sharable``): global-group blocks are
content-addressed.  Each full prompt block is named by a hash chain
(``models.lm.prompt_block_hashes``) and refcounted; an admission maps the
longest indexed prefix of its chain read-only into the head of its table,
and ``commit_slot`` publishes a slot's full prompt blocks into the index
once its prefill is resident.  ``free_slot`` releases instead of freeing:
a committed block whose refcount falls to 0 parks in an LRU *cached* pool,
which still counts as allocatable, and ``_claim`` evicts the least
recently used cached block only when the free list is empty, never a
block with a live reference.  A write into a shared or indexed block forks
it first (``ensure_private``, copy-on-write).  ``BlockTransferBuffer``
stages committed blocks between replicas (the prefill -> decode handoff).

Failures are typed as in the reference: ``CacheExhausted`` (a
``MemoryError``) is expected backpressure, ``AllocatorInvariantError`` (an
``AssertionError``) is a bug.

``PagedKVStore`` holds a pair of pools ``[n_layers, n_blocks + 1,
block_size, KV, hd]``; the extra trailing page is the null block that
inactive lanes and unallocated table entries point at.  The engine writes
the pools in place, so a store bound to them never needs rebinding.
"""

from __future__ import annotations

from collections import OrderedDict
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
    reference's ``CacheLayout``, field for field.  Built by the engine from ``models.lm.serve_groups`` and installed
    with ``BlockAllocator.set_layout``; the default is the global-only
    regime.  ``window`` is the sliding-window width (0 = no window group)
    and ``window_cap_blocks`` the admission price of one ring: the most
    blocks a lane can pin at once.  ``state_slots``/``state_bytes_per_slot``
    describe the recurrent lanes (0 slots = no recurrent group).
    ``prefill_chunk`` (chunked prefill): window rings start at block 0 and
    slide forward with the chunks, and the cap counts the in-flight
    chunk's blocks.  ``cross_tokens``/``cross_cap_blocks`` describe the
    enc-dec static cross block set (0 tokens = no cross group);
    ``frontend_extra`` is the modality-frontend rows every admission
    holds in the global and window groups on top of its tokens.
    ``sharable`` turns on the content-addressed prefix cache over the
    global group (the engine sets it only when
    ``models.lm.prefix_sharable_reason`` is None)."""

    has_global: bool = True
    window: int = 0
    window_cap_blocks: int = 0
    state_slots: int = 0
    state_bytes_per_slot: int = 0
    prefill_chunk: int = 0
    cross_tokens: int = 0
    cross_cap_blocks: int = 0
    frontend_extra: int = 0
    sharable: bool = False


class PagedKVStore:
    """Physical paged storage for a stack of layers of one cache group: a
    pair of page pools ``k_pages`` and ``v_pages`` of shape ``[n_layers,
    n_blocks + 1, block_size, *row]``, page ``n_blocks`` being the null
    block.  Attention leaves pair K/V rows (``row = (KV, hd)``); MLA leaves
    pair the latent ``ckv`` rows ``[kv_lora_rank]`` with the RoPE-key
    ``krope`` rows ``[qk_rope_dim]``, so the two pools may differ in row
    width (``from_pools``), and a block's bytes are the sum of both."""

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
        if k_pages.shape[:3] != v_pages.shape[:3]:      # rows may differ
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
        """Write one token's rows (``[n_layers, *row]``) at logical
        position ``pos`` of the lane backed by ``table``, in place."""
        block = table[pos // self.config.block_size]
        off = pos % self.config.block_size
        self.k_pages[:, block, off] = k
        self.v_pages[:, block, off] = v

    def gather_slot(self, table: list, context_len: int) -> tuple:
        """The lane's logical rows, ``[n_layers, context_len, *row]``
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
    window group (``window_tables``: logical block -> physical block), a
    static cross block set per slot when it has a cross group
    (``cross_tables``), and a state slot per live request when it has a
    recurrent group.

    Every global-table entry is refcounted: with a sharable layout one
    physical block may back several slots' tables and outlive them all in
    the LRU cached pool (module docstring).  A block is free (on the free
    list), cached (committed content, refcount 0, evictable, still
    allocatable) or live (refcount >= 1).

    Admissions may carry a worst-case reservation (``reserve_tokens``):
    the reserved but not yet claimed blocks of every live slot are
    subtracted from what ``can_allocate`` promises the next admission, and
    a slot's own ``extend``s (and ring slides) draw on its reservation, so
    a reserving scheduler never sees ``CacheExhausted`` mid-decode.  The
    free list is LIFO, the cached pool in LRU order, and blocks are
    claimed, released, committed and evicted in the reference's order, so
    both allocators hand out the same block ids for the same operations.
    """

    def __init__(self, config: CacheConfig,
                 store: Optional[PagedKVStore] = None):
        self.config = config
        self._free: list[int] = list(range(config.n_blocks - 1, -1, -1))
        self.tables: dict[int, list[int]] = {}     # slot -> block ids
        # slot -> {logical block index: physical block} window ring
        self.window_tables: dict[int, dict[int, int]] = {}
        # slot -> static cross block set (fixed length, never extended)
        self.cross_tables: dict[int, list[int]] = {}
        self._tokens: dict[int, int] = {}          # slot -> resident tokens
        self._reserve: dict[int, int] = {}         # slot -> reserved blocks
        # prefix cache and refcounts (global group only)
        self._ref: dict[int, int] = {}             # live block -> refcount
        self._hash_of: dict[int, str] = {}         # committed block -> hash
        self._index: dict[str, int] = {}           # content hash -> block
        self._cached: OrderedDict[int, int] = OrderedDict()  # LRU, ref 0
        self._tick = 0                             # LRU recency counter
        self._slot_hashes: dict[int, tuple] = {}   # slot -> prompt chain
        # slot -> prompt tokens served from the index at admission (the
        # engine starts prefill at the first uncached position)
        self.matched_tokens: dict[int, int] = {}
        self.stats: dict[str, int] = {
            "admissions": 0, "hit_admissions": 0, "lookup_tokens": 0,
            "hit_tokens": 0, "commits": 0, "evictions": 0, "cow_forks": 0}
        self.stores: list[PagedKVStore] = []
        self.store_groups: list[str] = []
        self.layout = CacheLayout()
        self._state_slots: set[int] = set()
        if store is not None:
            self.attach_store(store)

    def set_layout(self, layout: CacheLayout) -> None:
        """Install the engine's cache-group layout (before any admission)."""
        if self.tables or self.window_tables or self.cross_tables or \
                self._state_slots or self._cached:
            raise ValueError("cannot change layout with live allocations "
                             "or cached prefix blocks")
        self.layout = layout

    # -- queries ----------------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return self.config.n_blocks

    @property
    def n_free(self) -> int:
        """Allocatable blocks: the free list and the refcount-0 cached
        blocks (the prefix cache is reclaimable capacity, not pressure)."""
        return len(self._free) + len(self._cached)

    @property
    def n_in_use(self) -> int:
        return self.config.n_blocks - self.n_free

    def pressure(self) -> float:
        """Fraction of the block pool allocated, in [0, 1]."""
        return self.n_in_use / self.config.n_blocks \
            if self.config.n_blocks else 0.0

    def _global_blocks(self, n_tokens: int) -> int:
        """Global-table blocks covering ``n_tokens`` (none without a global
        group)."""
        return self.config.blocks_for(n_tokens) if self.layout.has_global \
            else 0

    def _sharing(self) -> bool:
        return self.layout.sharable and self.layout.has_global

    def blocks_needed(self, n_tokens: int,
                      reserve_tokens: Optional[int] = None) -> int:
        """Admission price of ``n_tokens``, or of the worst case
        ``reserve_tokens`` when that is larger, in physical rows (a
        modality frontend's ``frontend_extra`` rows added): a global table
        grows with the context; a window ring is capped at
        ``window_cap_blocks`` whatever the length; a cross block set costs
        its whole static size up front, so that an enc-dec request is
        never admitted without room for all of its cross K/V."""
        n = max(n_tokens, reserve_tokens or 0) + self.layout.frontend_extra
        need = self._global_blocks(n)
        if self.layout.window:
            need += min(self.config.blocks_for(n),
                        self.layout.window_cap_blocks)
        if self.layout.cross_tokens:
            need += self.layout.cross_cap_blocks
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
        """Pop ``n`` blocks: the free list first, then LRU eviction of
        refcount-0 cached blocks (with their index entries)."""
        if n > self.n_free:
            raise CacheExhausted(
                f"need {n} blocks for {what}, {self.n_free} allocatable "
                f"({len(self._free)} free + {len(self._cached)} cached)")
        return [self._free.pop() if self._free else self._evict_lru()
                for _ in range(max(0, n))]

    def _evict_lru(self) -> int:
        """Evict the least recently used cached block from the index.  Its
        chain's later blocks may stay indexed: a lookup stops at the first
        miss, so they are unreachable and age out on their own."""
        block, _ = self._cached.popitem(last=False)
        if self._ref.get(block):
            raise AllocatorInvariantError(
                f"cached block {block} has refcount {self._ref[block]}")
        h = self._hash_of.pop(block)
        if self._index.get(h) == block:
            del self._index[h]
        self.stats["evictions"] += 1
        return block

    def _retain(self, block: int) -> None:
        """One more live reference to a global block (out of the cached
        pool on the 0 -> 1 transition)."""
        r = self._ref.get(block, 0)
        if r == 0:
            self._cached.pop(block, None)
        self._ref[block] = r + 1

    def _release(self, block: int) -> None:
        """One live reference less; at refcount 0 a committed block parks
        in the LRU cached pool, any other returns to the free list."""
        r = self._ref.get(block)
        if r is None:
            raise AllocatorInvariantError(
                f"block {block} released with no live reference "
                "(double free?)")
        if r > 1:
            self._ref[block] = r - 1
            return
        del self._ref[block]
        if block in self._hash_of:
            self._tick += 1
            self._cached[block] = self._tick
        else:
            self._free.append(block)

    def allocate(self, slot: int, n_tokens: int, *,
                 reserve_tokens: Optional[int] = None,
                 block_hashes=None) -> list[int]:
        """Claim blocks for a request admitted into ``slot`` holding
        ``n_tokens`` (prompt + first generated token); with
        ``reserve_tokens`` also reserve blocks for its worst case (its
        ring at the cap); with a window group place its ring; with a
        recurrent group also take the slot's state slot, and with a cross
        group claim its whole cross block set.  The slot's token ledger
        is physical: ``frontend_extra`` is added to ``n_tokens`` and
        ``reserve_tokens``, so the engine's later ``extend`` calls pass
        resident rows.  With a sharable
        layout, ``block_hashes`` (the prompt's chain) maps the longest
        indexed prefix read-only into the head of the table
        (``matched_tokens[slot]`` says how many tokens it covers) and only
        the rest is claimed fresh; the block holding the first generated
        token is past the chain, so the tail is always private.  Returns
        the slot's global block ids (none without a global group)."""
        if slot in self.tables:
            raise AllocatorInvariantError(
                f"slot {slot} already has an allocation")
        if not self.can_allocate(n_tokens, reserve_tokens):
            raise CacheExhausted(
                f"need {self.blocks_needed(n_tokens, reserve_tokens)} blocks "
                f"for {n_tokens} tokens, {self.n_available()} available "
                f"({self.n_free} allocatable, "
                f"{self.outstanding_blocks()} reserved)")
        phys = n_tokens + self.layout.frontend_extra
        need = self._global_blocks(phys)
        self.stats["admissions"] += 1
        table: list[int] = []
        if block_hashes and self._sharing():
            for h in block_hashes:
                block = self._index.get(h)
                if block is None or len(table) >= need:
                    break
                table.append(block)
            self.stats["lookup_tokens"] += \
                len(block_hashes) * self.config.block_size
            self.stats["hit_tokens"] += len(table) * self.config.block_size
            if table:
                self.stats["hit_admissions"] += 1
            for block in table:
                self._retain(block)
        matched = len(table)
        fresh = self._claim(need - matched, f"slot {slot}")
        for block in fresh:
            self._retain(block)
        table.extend(fresh)
        self.tables[slot] = table
        self._tokens[slot] = phys
        self.matched_tokens[slot] = matched * self.config.block_size
        self._slot_hashes[slot] = tuple(block_hashes or ())
        if reserve_tokens is not None and self.layout.has_global:
            self._reserve[slot] = self.config.blocks_for(
                reserve_tokens + self.layout.frontend_extra)
        if self.layout.window:
            self._allocate_window(slot, phys)
            if reserve_tokens is not None:
                self._reserve.setdefault(slot, 0)
        if self.layout.cross_tokens:
            self.cross_tables[slot] = self._claim(
                self.layout.cross_cap_blocks, f"slot {slot} cross block set")
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
        for block in fresh:
            self._retain(block)
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
        Whole tail blocks only are released (a partly vacated tail block
        stays: its stale rows sit past the slot's position, where no query
        reads them, and the next accepted token overwrites them).  A
        shared or indexed block in the dropped tail is an
        ``AllocatorInvariantError``: decode tails are private (admission
        forks the boundary block before the first decode write, and a
        rewind never reaches back into the committed prompt).  Returns the
        released block ids; they re-enter the free list so the next growth
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
        for idx in range(keep, len(table)):
            if self.is_block_shared(slot, idx):
                raise AllocatorInvariantError(
                    f"slot {slot}: rewind would drop shared/indexed block "
                    f"{table[idx]} (table entry {idx})")
        freed = table[keep:]
        del table[keep:]
        for block in reversed(freed):
            self._release(block)
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
        """Reclaim every resource of ``slot``: its global table's entries
        are released (a block another slot references stays live, a
        committed one at refcount 0 parks in the cached pool, the rest
        return to the free list in table order, so the next claims reuse
        them first), its ring's and its cross set's blocks are freed and
        its state slot is let go.  Returns how many table, ring and cross
        entries it gave up."""
        if slot not in self.tables:
            raise AllocatorInvariantError(f"slot {slot} has no allocation")
        blocks = self.tables.pop(slot)
        self._tokens.pop(slot)
        self._reserve.pop(slot, None)
        self._slot_hashes.pop(slot, None)
        self.matched_tokens.pop(slot, None)
        for block in reversed(blocks):
            self._release(block)
        ring = self.window_tables.pop(slot, None)
        if ring:
            ring_blocks = [ring[i] for i in sorted(ring, reverse=True)]
            self._free.extend(ring_blocks)
            blocks = blocks + ring_blocks
        cross = self.cross_tables.pop(slot, None)
        if cross:
            self._free.extend(reversed(cross))
            blocks = blocks + cross
        self._state_slots.discard(slot)
        return len(blocks)

    # -- prefix cache -----------------------------------------------------------
    def match_tokens(self, block_hashes) -> int:
        """Tokens the longest indexed prefix of ``block_hashes`` covers now:
        a read-only peek (no claim, no refcount, no LRU touch), the router's
        affinity signal; 0 without a sharable layout."""
        if not self._sharing():
            return 0
        n = 0
        for h in block_hashes or ():
            if h not in self._index:
                break
            n += 1
        return n * self.config.block_size

    def lookup_block(self, block_hash: str) -> Optional[int]:
        """The physical block committed under ``block_hash``, or None: the
        export side of a prefill -> decode handoff reads pages through
        it."""
        return self._index.get(block_hash)

    def inject_cached(self, block_hashes) -> list[tuple]:
        """Install content produced elsewhere into the index: for each hash
        of the chain, in order, claim one block and park it committed at
        refcount 0 in the cached pool.  Returns the ``(hash, block)``
        pairs claimed; the caller copies the pages into those blocks
        before any admission can match them.  Hashes already indexed are
        skipped; injection stops at the first hash the pool cannot take,
        or that would evict a block this call injected (a shorter chain
        degrades gracefully: the importer recomputes the rest).  Requires
        a sharable layout."""
        if not self._sharing():
            raise AllocatorInvariantError(
                "inject_cached requires a sharable global layout")
        injected: list[tuple] = []
        own = set()
        for h in block_hashes or ():
            if h in self._index:
                continue
            if not self._free and self._cached and \
                    next(iter(self._cached)) in own:
                break
            try:
                block = self._claim(1, f"injected prefix block {h[:12]}")[0]
            except CacheExhausted:
                break
            self._index[h] = block
            self._hash_of[block] = h
            self._tick += 1
            self._cached[block] = self._tick
            injected.append((h, block))
            own.add(block)
        return injected

    def commit_slot(self, slot: int) -> int:
        """Publish ``slot``'s full prompt blocks into the index (once its
        prompt is resident, when its prefill completes).  Blocks already
        indexed (its matched prefix, or content another slot committed
        first) are skipped, so a hash maps to one block.  Returns how many
        blocks were newly indexed; 0 without a sharable layout."""
        if not self._sharing():
            return 0
        if slot not in self.tables:
            raise AllocatorInvariantError(f"slot {slot} has no allocation")
        fresh = 0
        for h, block in zip(self._slot_hashes.get(slot, ()),
                            self.tables[slot]):
            if self._hash_of.get(block) == h:
                continue                      # already carries this content
            if h in self._index or block in self._hash_of:
                continue                      # content owned elsewhere
            self._index[h] = block
            self._hash_of[block] = h
            fresh += 1
        self.stats["commits"] += fresh
        return fresh

    def is_block_shared(self, slot: int, block_idx: int) -> bool:
        """True when a write to ``slot``'s table entry ``block_idx`` would
        be seen beyond the slot: another slot references the block, or the
        index expects its content to stay."""
        block = self.tables[slot][block_idx]
        return self._ref.get(block, 0) > 1 or block in self._hash_of

    def ensure_private(self, slot: int, block_idx: int) -> Optional[tuple]:
        """Copy-on-write: give ``slot`` a private block at table entry
        ``block_idx`` when the current one is shared or indexed.  Returns
        ``(src, dst)`` when forked (the caller copies the pages src -> dst
        before writing), else None.  The source keeps its index entry."""
        table = self.tables[slot]
        src = table[block_idx]
        if not self.is_block_shared(slot, block_idx):
            return None
        dst = self._claim(1, f"slot {slot} CoW fork")[0]
        self._retain(dst)
        table[block_idx] = dst
        self._release(src)
        self.stats["cow_forks"] += 1
        return src, dst

    def copy_block(self, src: int, dst: int, group: str = "global") -> None:
        """Copy one block's pages across the ``group`` stores, in place."""
        for store, g in zip(self.stores, self.store_groups):
            if g == group:
                store.k_pages[:, dst].copy_(store.k_pages[:, src])
                store.v_pages[:, dst].copy_(store.v_pages[:, src])

    def drop_cached(self) -> int:
        """Evict every cached (refcount-0) block to the free list; returns
        how many.  The index keeps only live content afterwards."""
        n = 0
        while self._cached:
            self._free.append(self._evict_lru())
            n += 1
        return n

    def cached_blocks(self) -> int:
        return len(self._cached)

    def prefix_stats(self) -> dict:
        """The cumulative prefix-cache counters and the pool's sharing
        state now."""
        shared = sum(1 for r in self._ref.values() if r > 1)
        saved = sum(r - 1 for r in self._ref.values() if r > 1)
        return dict(self.stats, cached_blocks=len(self._cached),
                    shared_blocks=shared, saved_blocks=saved,
                    indexed_blocks=len(self._index))

    def shared_saved_bytes(self) -> int:
        """Device bytes prefix sharing saves now: one global block's bytes
        per extra reference to a live block."""
        bb = sum(s.block_bytes for s, g in zip(self.stores,
                                               self.store_groups)
                 if g == "global")
        return sum(r - 1 for r in self._ref.values() if r > 1) * bb

    # -- invariants --------------------------------------------------------------
    def check(self) -> None:
        """Refcounts equal the tables' references; every block is free,
        cached, live, in exactly one ring or in exactly one cross set (each
        of a live slot, and of the layout's size); the index is a bijection
        onto
        committed blocks, none of them free, and cached blocks are
        committed with refcount 0; each table covers exactly its slot's
        tokens, every ring belongs to a live slot and with a window group
        every live slot has one, reservations fit the allocatable pool,
        and with a recurrent group every live slot holds exactly one state
        slot."""
        refs: dict[int, int] = {}
        for table in self.tables.values():
            for block in table:
                refs[block] = refs.get(block, 0) + 1
        if refs != self._ref:
            diff = {b: (refs.get(b), self._ref.get(b))
                    for b in set(refs) | set(self._ref)
                    if refs.get(b) != self._ref.get(b)}
            raise AllocatorInvariantError(
                f"refcount ledger disagrees with tables "
                f"(block: tables vs ledger): {diff}")
        window = [b for ring in self.window_tables.values()
                  for b in ring.values()]
        cross = [b for t in self.cross_tables.values() for b in t]
        everything = self._free + list(self._cached) + list(self._ref) + \
            window + cross
        if len(set(everything)) != len(everything):
            raise AllocatorInvariantError(
                "a block is owned twice across free/cached/live/window/cross")
        if sorted(everything) != list(range(self.config.n_blocks)):
            raise AllocatorInvariantError(
                f"{self.config.n_blocks - len(everything)} blocks "
                "unaccounted for")
        for h, block in self._index.items():
            if self._hash_of.get(block) != h:
                raise AllocatorInvariantError(
                    f"index maps {h!r} to block {block} whose committed "
                    f"hash is {self._hash_of.get(block)!r}")
        free_set = set(self._free)
        for block in self._hash_of:
            if block in free_set:
                raise AllocatorInvariantError(
                    f"committed block {block} is on the free list")
        for block in self._cached:
            if block not in self._hash_of:
                raise AllocatorInvariantError(
                    f"cached block {block} has no committed hash")
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
        if set(self.cross_tables) - set(self.tables):
            raise AllocatorInvariantError(
                "cross block sets held by no live slot: "
                f"{sorted(set(self.cross_tables) - set(self.tables))}")
        for slot, t in self.cross_tables.items():
            if len(t) != self.layout.cross_cap_blocks:
                raise AllocatorInvariantError(
                    f"slot {slot}: cross set of {len(t)} blocks, layout "
                    f"has {self.layout.cross_cap_blocks}")
        if self.layout.cross_tokens and set(self.cross_tables) != \
                set(self.tables):
            raise AllocatorInvariantError(
                "live slots without a cross block set: "
                f"{sorted(set(self.tables) - set(self.cross_tables))}")
        if set(self._reserve) - set(self.tables):
            raise AllocatorInvariantError("reservation without a table")
        if self.outstanding_blocks() > self.n_free:
            raise AllocatorInvariantError(
                f"reservations outstanding ({self.outstanding_blocks()}) "
                f"exceed allocatable blocks ({self.n_free})")
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
        """With no live slot, every block is free or cached (refcount 0)
        and no ring or state slot is held; then ``check()``."""
        if self.tables:
            raise AllocatorInvariantError(
                f"live tables remain: {sorted(self.tables)}")
        if self.window_tables:
            raise AllocatorInvariantError(
                f"live window rings remain: {sorted(self.window_tables)}")
        if self.cross_tables:
            raise AllocatorInvariantError(
                f"live cross block sets remain: {sorted(self.cross_tables)}")
        if self._state_slots:
            raise AllocatorInvariantError(
                f"live state slots remain: {sorted(self._state_slots)}")
        if len(self._free) + len(self._cached) != self.config.n_blocks:
            leaked = self.config.n_blocks - len(self._free) \
                - len(self._cached)
            raise AllocatorInvariantError(f"{leaked} blocks leaked")
        self.check()

    # -- physical store ----------------------------------------------------------
    def attach_store(self, store: PagedKVStore,
                     group: str = "global") -> None:
        """Bind a physical store whose blocks the ``group`` ("global",
        "window" or "cross") tables address."""
        if store.config != self.config:
            raise ValueError("store geometry does not match allocator config")
        self.stores.append(store)
        self.store_groups.append(group)

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

    def padded_cross_table(self, slot: int, width: int) -> list[int]:
        """``slot``'s static cross block set padded to ``width`` entries
        with the null block; the set never grows, so its row is published
        once per admission."""
        table = self.cross_tables[slot]
        if len(table) > width:
            raise ValueError(
                f"cross table of {len(table)} blocks exceeds width {width}")
        return table + [self.config.null_block] * (width - len(table))

    def window_blocks_in_use(self) -> int:
        return sum(len(ring) for ring in self.window_tables.values())

    def resident_bytes(self) -> int:
        """Device bytes pinned by allocated blocks across the stores and by
        live state slots."""
        return sum(self.resident_bytes_by_group().values())

    def resident_bytes_by_group(self) -> dict[str, int]:
        """Residency split by cache group, as the reference splits it:
        ``"global"``, ``"window"`` and ``"cross"`` are each group's blocks
        in use times the bytes per block of that group's stores (a group
        appears when it has stores or blocks in use), ``"recurrent"`` state
        slots in use times the layout's bytes per slot."""
        out: dict[str, int] = {}
        in_use = {"global": len(self._ref),
                  "window": self.window_blocks_in_use(),
                  "cross": sum(len(t) for t in self.cross_tables.values())}
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


class BlockTransferBuffer:
    """Staging buffer of the prefill -> decode block handoff between engine
    replicas.

    A prefill replica commits a finished prompt's full blocks to its index
    and exports their pages here, keyed by content hash
    (``ContinuousEngine.export_prefix_blocks``: copies, since the port's
    pools are written in place and the exporting replica may reuse the
    block); the router delivers the chain to a decode replica, which claims
    blocks for the payloads and parks them committed at refcount 0 in its
    own index (``import_prefix_blocks``), so that the request's admission
    there is an ordinary full prefix hit.  The buffer owns no pool block on
    either side, so no refcount passes through it.

    Failure degrades, never corrupts: a payload dropped here (FIFO at
    ``capacity_blocks``, 0 = unbounded) or a chain the importing pool
    cannot take whole only means the decode replica recomputes those
    positions; ``take_chain`` returns a prefix of the requested chain.
    """

    def __init__(self, capacity_blocks: int = 0):
        if capacity_blocks < 0:
            raise ValueError("capacity_blocks must be >= 0")
        self.capacity_blocks = capacity_blocks
        self._entries: OrderedDict[str, object] = OrderedDict()
        self.stats: dict[str, int] = {"staged": 0, "delivered": 0,
                                      "dropped": 0}

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, block_hash: str, payload) -> None:
        """Stage one block's pages under its hash; staging a held hash again
        replaces its payload and refreshes its recency."""
        if block_hash in self._entries:
            self._entries.move_to_end(block_hash)
            self._entries[block_hash] = payload
            return
        while self.capacity_blocks and \
                len(self._entries) >= self.capacity_blocks:
            self._entries.popitem(last=False)
            self.stats["dropped"] += 1
        self._entries[block_hash] = payload
        self.stats["staged"] += 1

    def put_chain(self, entries) -> None:
        """Stage an exported ``(hash, payload)`` chain, head first."""
        for h, payload in entries:
            self.put(h, payload)

    def take_chain(self, block_hashes) -> list[tuple]:
        """Remove and return the longest staged prefix of ``block_hashes``
        as ``(hash, payload)`` pairs, stopping at the first hash not held
        (a later block could never be matched anyway)."""
        out: list[tuple] = []
        for h in block_hashes or ():
            payload = self._entries.pop(h, None)
            if payload is None:
                break
            out.append((h, payload))
        self.stats["delivered"] += len(out)
        return out
