"""The port's copied allocator, store, scheduler and telemetry against the
reference's: randomized churn with ``check()`` after every operation,
identical block ids to ``repro.serve.cache.BlockAllocator`` for the same
operations (global-only, global with state slots, and state slots alone;
and window rings, alone, with state slots as recurrentgemma lays them out,
and beside a global table), typed failures, state-slot accounting
(admission gated by free slots, release on finish, ``check()`` catching a
leaked slot, recurrent residency), ``check()`` catching a leaked window
ring, the torch ``PagedKVStore``, and FCFS admission with worst-case
reservations.  Also the speculative rewind (``truncate``,
``truncate_window``, a rewind churn against the reference),
``check_no_leaks``, lazy pricing and ``preempt``, the speculation and
preemption telemetry, and F5 (a window ring's reservation over-counted
beside a global table) pinned in both packages."""

import numpy as np
import pytest
import torch

from repro.serve import cache as jcache
from repro.serve import scheduler as jsched
from repro_torch.serve.cache import (AllocatorInvariantError, BlockAllocator,
                                     CacheConfig, CacheExhausted, CacheLayout,
                                     PagedKVStore)
from repro_torch.serve import scheduler as psched
from repro_torch.serve.scheduler import Request, SlotScheduler
from repro_torch.runtime.telemetry import ServeTelemetry

torch.set_num_threads(2)


LAYOUTS = {"global": {},
           "global+state": {"state_slots": 4, "state_bytes_per_slot": 96},
           "state": {"has_global": False, "state_slots": 4,
                     "state_bytes_per_slot": 96}}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_churn_matches_reference(seed, layout):
    rng = np.random.default_rng(seed)
    n_blocks = 0 if layout == "state" else 24
    cfg = CacheConfig(block_size=4, n_blocks=n_blocks)
    port = BlockAllocator(cfg)
    ref = jcache.BlockAllocator(jcache.CacheConfig(block_size=4,
                                                   n_blocks=n_blocks))
    port.set_layout(CacheLayout(**LAYOUTS[layout]))
    ref.set_layout(jcache.CacheLayout(**LAYOUTS[layout]))
    live: dict[int, list] = {}                  # slot -> [tokens, reserve]
    for _ in range(300):
        op = rng.integers(3)
        slot = int(rng.integers(6))
        if op == 0 and slot not in live:
            n = int(rng.integers(1, 20))
            reserve = n + int(rng.integers(0, 12))
            ok = port.can_allocate(n, reserve)
            assert ok == ref.can_allocate(n, reserve)
            if ok:
                assert port.allocate(slot, n, reserve_tokens=reserve) == \
                    ref.allocate(slot, n, reserve_tokens=reserve)
                live[slot] = [n, reserve]
        elif op == 1 and slot in live:
            tokens, reserve = live[slot]
            grow = min(reserve, tokens + int(rng.integers(0, 6)))
            assert port.extend(slot, grow) == ref.extend(slot, grow)
            live[slot][0] = grow
        elif op == 2 and slot in live:
            assert port.free_slot(slot) == ref.free_slot(slot)
            del live[slot]
        port.check()
        ref.check()
        assert port.tables == ref.tables
        assert port.n_available() == ref.n_available()
        assert port.state_slots_in_use() == ref.state_slots_in_use()
        assert port.resident_bytes_by_group().get("recurrent") == \
            ref.resident_bytes_by_group().get("recurrent")
        for s in live:
            assert port.padded_table(s, 8) == ref.padded_table(s, 8)
    for s in list(live):
        port.free_slot(s)
    port.check()
    assert port.n_free == cfg.n_blocks
    assert port.state_slots_in_use() == 0


def test_allocator_typed_failures():
    alloc = BlockAllocator(CacheConfig(block_size=4, n_blocks=4))
    alloc.allocate(0, 5, reserve_tokens=12)          # 2 blocks, 3 reserved
    assert not alloc.can_allocate(5)                 # 1 left unreserved
    with pytest.raises(CacheExhausted):
        alloc.allocate(1, 5)
    with pytest.raises(AllocatorInvariantError):
        alloc.allocate(0, 1)                         # double allocate
    with pytest.raises(AllocatorInvariantError):
        alloc.extend(0, 3)                           # shrink
    alloc.extend(0, 12)                              # inside the reservation
    with pytest.raises(CacheExhausted):
        alloc.extend(0, 20)                          # beyond it, pool empty
    assert isinstance(CacheExhausted("x"), MemoryError)
    assert not isinstance(AllocatorInvariantError("x"), MemoryError)
    alloc.free_slot(0)
    with pytest.raises(AllocatorInvariantError):
        alloc.free_slot(0)                           # double free
    alloc.check()


def test_state_slots_gate_admission_and_are_released():
    alloc = BlockAllocator(CacheConfig(block_size=4, n_blocks=0))
    alloc.set_layout(CacheLayout(has_global=False, state_slots=2,
                                 state_bytes_per_slot=1000))
    assert alloc.blocks_needed(100, reserve_tokens=500) == 0
    assert alloc.allocate(0, 9, reserve_tokens=40) == []
    assert alloc.allocate(1, 3) == []
    assert not alloc.can_allocate(1)                 # both slots taken
    with pytest.raises(CacheExhausted):
        alloc.allocate(2, 1)
    assert alloc.extend(0, 30) == []                 # state lanes never grow
    assert alloc.resident_bytes_by_group() == {"recurrent": 2000}
    assert alloc.resident_bytes() == 2000
    assert alloc.capacity_bytes() == 2000
    alloc.free_slot(1)
    assert alloc.state_slots_in_use() == 1 and alloc.can_allocate(1)
    assert alloc.resident_bytes_by_group() == {"recurrent": 1000}
    with pytest.raises(ValueError, match="layout"):
        alloc.set_layout(CacheLayout())              # live allocations
    alloc.check()
    alloc.free_slot(0)
    alloc.check()
    assert alloc.state_slots_in_use() == 0 and alloc.resident_bytes() == 0


def test_check_catches_leaked_and_missing_state_slots():
    alloc = BlockAllocator(CacheConfig(block_size=4, n_blocks=8))
    alloc.set_layout(CacheLayout(state_slots=3, state_bytes_per_slot=8))
    alloc.allocate(0, 5)
    alloc.check()
    alloc._state_slots.add(2)                        # held by no request
    with pytest.raises(AllocatorInvariantError, match="state slots"):
        alloc.check()
    alloc._state_slots.discard(2)
    alloc._state_slots.discard(0)                    # live slot without one
    with pytest.raises(AllocatorInvariantError, match="state slot"):
        alloc.check()
    alloc._state_slots.add(0)
    alloc.check()


def test_paged_store_roundtrip_and_residency():
    cfg = CacheConfig(block_size=4, n_blocks=6)
    store = PagedKVStore(cfg, n_layers=2, n_kv_heads=2, head_dim=16,
                         device="cpu")
    alloc = BlockAllocator(cfg, store)
    table = alloc.allocate(0, 7)
    rows = [torch.randn(2, 2, 16) for _ in range(7)]
    for pos, r in enumerate(rows):
        store.write_token(table, pos, r, -r)
    k, v = store.gather_slot(table, 7)
    assert k.shape == (2, 7, 2, 16)
    for pos, r in enumerate(rows):
        assert torch.equal(k[:, pos], r) and torch.equal(v[:, pos], -r)
    assert store.block_bytes == 2 * (2 * 4 * 2 * 16 * 4)
    assert alloc.resident_bytes() == 2 * store.block_bytes
    assert alloc.capacity_bytes() == 6 * store.block_bytes
    with pytest.raises(ValueError):
        PagedKVStore.from_pools(cfg, torch.zeros(2, 5, 4, 2, 16),
                                torch.zeros(2, 5, 4, 2, 16))


def test_scheduler_admits_like_the_reference():
    """Same trace through both schedulers: identical admissions (FCFS,
    worst-case reservation, lowest free slot first) step by step."""
    def run(mod_sched, alloc):
        sched = mod_sched.SlotScheduler(3, alloc, kv_len=32)
        for i, (n, new, arr) in enumerate([(5, 8, 0), (9, 20, 0),
                                           (3, 4, 1), (12, 10, 1),
                                           (7, 7, 2), (2, 3, 5)]):
            sched.submit(mod_sched.Request(rid=i, prompt=list(range(n)),
                                           max_new_tokens=new, arrival=arr))
        log = []
        for now in range(12):
            log.append([(a.request.rid, a.slot) for a in sched.admit(now)])
            for slot in sorted(sched.active):
                if (now + slot) % 3 == 0:
                    sched.finish(slot)
        return log, sched.max_slot_reuse()

    port = run(psched, BlockAllocator(CacheConfig(block_size=4,
                                                  n_blocks=12)))
    ref = run(jsched, jcache.BlockAllocator(jcache.CacheConfig(
        block_size=4, n_blocks=12)))
    assert port == ref


def test_scheduler_rejects_requests_that_can_never_run():
    sched = SlotScheduler(2, BlockAllocator(CacheConfig(4, 8)), kv_len=16)
    with pytest.raises(ValueError, match="kv_len"):
        sched.submit(Request(rid=0, prompt=[1] * 10, max_new_tokens=7))
    with pytest.raises(ValueError, match="empty"):
        sched.submit(Request(rid=1, prompt=[], max_new_tokens=2))
    with pytest.raises(ValueError, match="max_new"):
        sched.submit(Request(rid=2, prompt=[1], max_new_tokens=0))


def test_telemetry_aggregates():
    tel = ServeTelemetry()
    tel.record_step(0, 0.5, (), 4, 3, 8, prefills=2, prefill_seconds=0.4)
    tel.record_step(1, 0.1, (0, 1), 4, 4, 8, new_tokens=2,
                    resident_bytes=100,
                    decode_seconds=0.08)
    assert tel.total_tokens() == 4
    assert tel.tokens_per_sec() == pytest.approx(4 / 0.6)
    assert tel.mean_prefill_ms() == pytest.approx(200.0)
    assert tel.mean_decode_step_ms() == pytest.approx(80.0)
    assert tel.peak_cache_pressure() == 0.5
    assert tel.max_concurrency() == 2
    assert tel.occupancy() == pytest.approx(0.25)
    assert tel.peak_resident_bytes() == 100
    tel.record_step(2, 0.1, (0,), 4, 0, 0, new_tokens=1,
                    resident_by_group={"recurrent": 64})
    tel.record_step(3, 0.1, (0, 1), 4, 0, 0, new_tokens=2,
                    resident_by_group={"recurrent": 128})
    tel.record_step(4, 0.1, (1,), 4, 0, 0, new_tokens=1,
                    resident_by_group={"recurrent": 64})
    assert tel.peak_resident_bytes_by_group() == {"recurrent": 128}
    assert tel.steps[-1].resident_by_group == {"recurrent": 64}


WINDOW_LAYOUTS = {
    "window": {"has_global": False, "window": 10, "window_cap_blocks": 4},
    "window+state": {"has_global": False, "window": 8,
                     "window_cap_blocks": 3, "state_slots": 4,
                     "state_bytes_per_slot": 96},
    "global+window": {"window": 8, "window_cap_blocks": 3},
}


def _stores(alloc, cfg, groups):
    """One small torch store per group, so residency has bytes."""
    for i, group in enumerate(groups):
        alloc.attach_store(PagedKVStore(cfg, n_layers=1 + i, n_kv_heads=1,
                                        head_dim=16, device="cpu"),
                           group=group)


def _outcome(fn, *args):
    """("ok", result) or ("raised", exception class name)."""
    try:
        return "ok", fn(*args)
    except (AssertionError, MemoryError) as exc:
        return "raised", type(exc).__name__


def _check_message(alloc):
    """``alloc.check()``'s complaint, or None (both packages' invariant
    errors are ``AssertionError``s)."""
    try:
        alloc.check()
    except AssertionError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("layout", sorted(WINDOW_LAYOUTS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_ring_churn_matches_reference(seed, layout):
    """Admissions, decode growth (table extend and ring slide, as the
    engine calls them) and retirements: the same block ids, rings, freed
    blocks, availability and residency by group as the reference
    allocator, with ``check()`` after every operation.  Both checks must
    agree, and so must every failed growth; the one complaint allowed is
    the reference's own: with a global table beside the ring, a pool
    smaller than the engine sizes it, and a reservation shorter than the
    ring's cap, the reservation counts the whole cap while admission priced
    only the blocks the request can use, so "reservations outstanding" can
    exceed the free blocks, and growth inside a reservation can then meet
    ``CacheExhausted`` (ROADMAP F5).  The port copies that arithmetic so
    that block ids match."""
    rng = np.random.default_rng(seed)
    spec = WINDOW_LAYOUTS[layout]
    cfg = CacheConfig(block_size=4, n_blocks=20)
    port = BlockAllocator(cfg)
    ref = jcache.BlockAllocator(jcache.CacheConfig(block_size=4,
                                                   n_blocks=20))
    groups = (["global"] if spec.get("has_global", True) else []) + \
        ["window"]
    _stores(port, cfg, groups)
    for i, group in enumerate(groups):
        ref.attach_store(jcache.PagedKVStore(
            jcache.CacheConfig(block_size=4, n_blocks=20), n_layers=1 + i,
            n_kv_heads=1, head_dim=16), group=group)
    port.set_layout(CacheLayout(**spec))
    ref.set_layout(jcache.CacheLayout(**spec))
    has_global = spec.get("has_global", True)
    live: dict[int, list] = {}                  # slot -> [tokens, reserve]
    for _ in range(300):
        op = rng.integers(3)
        slot = int(rng.integers(6))
        if op == 0 and slot not in live:
            n = int(rng.integers(1, 30))
            reserve = n + int(rng.integers(0, 20))
            ok = port.can_allocate(n, reserve)
            assert ok == ref.can_allocate(n, reserve)
            if ok:
                assert port.allocate(slot, n, reserve_tokens=reserve) == \
                    ref.allocate(slot, n, reserve_tokens=reserve)
                live[slot] = [n, reserve]
        elif op == 1 and slot in live:
            tokens, reserve = live[slot]
            grow = min(reserve, tokens + int(rng.integers(0, 6)))
            calls = (["extend"] if has_global else []) + ["extend_window"]
            for i, name in enumerate(calls):
                got = _outcome(getattr(port, name), slot, grow)
                assert got == _outcome(getattr(ref, name), slot, grow)
                if got[0] == "raised":
                    assert got[1] == "CacheExhausted" and \
                        layout == "global+window", got
                    break
                if i == 0:                      # the token count moved
                    live[slot][0] = grow
        elif op == 2 and slot in live:
            assert port.free_slot(slot) == ref.free_slot(slot)
            del live[slot]
        complaint = _check_message(port)
        assert complaint == _check_message(ref) or \
            complaint.split(" (")[0] == _check_message(ref).split(" (")[0]
        assert complaint is None or (
            complaint.startswith("reservations outstanding")
            and layout == "global+window"), complaint
        assert port.tables == ref.tables
        assert port.window_tables == ref.window_tables
        assert port.n_free == ref.n_free
        assert port.n_available() == ref.n_available()
        assert port.resident_bytes_by_group() == \
            ref.resident_bytes_by_group()
        for s in live:
            assert port.padded_window_table(s, 16) == \
                ref.padded_window_table(s, 16)
    for s in list(live):
        port.free_slot(s)
    port.check()
    assert port.n_free == cfg.n_blocks and not port.window_tables
    assert port.window_blocks_in_use() == 0


def test_window_ring_slides_and_frees_behind_the_window():
    alloc = BlockAllocator(CacheConfig(block_size=4, n_blocks=8))
    alloc.set_layout(CacheLayout(has_global=False, window=8,
                                 window_cap_blocks=3))
    assert alloc.blocks_needed(30) == 3           # capped ring
    assert alloc.allocate(0, 11, reserve_tokens=20) == []
    assert sorted(alloc.window_tables[0]) == [0, 1, 2]   # covers 3..10
    fresh, freed = alloc.extend_window(0, 13)      # position 12: block 3
    assert len(fresh) == 1 and len(freed) == 1     # block 0 behind 5
    assert sorted(alloc.window_tables[0]) == [1, 2, 3]
    assert alloc.padded_window_table(0, 5) == [8] + \
        [alloc.window_tables[0][i] for i in (1, 2, 3)] + [8]
    assert alloc.extend_window(0, 14) == ([], [])
    alloc.check()
    assert alloc.free_slot(0) == 3
    alloc.check()
    assert alloc.n_free == 8


def test_check_catches_a_leaked_window_ring():
    alloc = BlockAllocator(CacheConfig(block_size=4, n_blocks=8))
    alloc.set_layout(CacheLayout(has_global=False, window=8,
                                 window_cap_blocks=3, state_slots=2,
                                 state_bytes_per_slot=8))
    alloc.allocate(0, 9)
    alloc.check()
    leaked = alloc.window_tables.pop(0)             # ring lost, blocks not
    with pytest.raises(AllocatorInvariantError, match="unaccounted|ring"):
        alloc.check()
    alloc.window_tables[0] = leaked
    alloc.window_tables[3] = {0: alloc._free.pop()}  # ring of no request
    with pytest.raises(AllocatorInvariantError, match="window rings"):
        alloc.check()
    alloc._free.append(alloc.window_tables.pop(3)[0])
    alloc.check()
    alloc.free_slot(0)
    alloc.check()
    assert alloc.n_free == 8


# =============================================================================
# speculative rewind, lazy pricing and preemption
# (tests/test_serve_paged.py:387-470, tests/test_serve_prefix_cache.py:395-410)
# =============================================================================

def _window_pair(n_blocks, bs, window, cap, has_global=True):
    """(port, reference) allocators with the same window layout."""
    spec = {"has_global": has_global, "window": window,
            "window_cap_blocks": cap}
    port = BlockAllocator(CacheConfig(block_size=bs, n_blocks=n_blocks))
    ref = jcache.BlockAllocator(jcache.CacheConfig(block_size=bs,
                                                   n_blocks=n_blocks))
    port.set_layout(CacheLayout(**spec))
    ref.set_layout(jcache.CacheLayout(**spec))
    return port, ref


def test_truncate_frees_whole_tail_blocks_only():
    """A rewind frees only the blocks wholly past the kept length (a partly
    vacated tail block stays), in the reference's order: the freed tail
    block is the next one handed out."""
    for alloc in (BlockAllocator(CacheConfig(block_size=4, n_blocks=8)),
                  jcache.BlockAllocator(jcache.CacheConfig(block_size=4,
                                                           n_blocks=8))):
        alloc.allocate(0, 3)
        alloc.extend(0, 11)                    # 3 blocks
        freed = alloc.truncate(0, 6)           # keep blocks_for(6) == 2
        assert len(freed) == 1 and len(alloc.tables[0]) == 2
        alloc.check()
        assert alloc.truncate(0, 5) == []      # the same covering blocks
        alloc.check()
        assert alloc.extend(0, 11) == freed    # LIFO reuse
        alloc.free_slot(0)
        alloc.check_no_leaks()


def test_truncate_guards():
    for mod in (None, jcache):
        alloc = BlockAllocator(CacheConfig(4, 8)) if mod is None else \
            mod.BlockAllocator(mod.CacheConfig(4, 8))
        err = AllocatorInvariantError if mod is None else \
            mod.AllocatorInvariantError
        with pytest.raises(err):
            alloc.truncate(0, 2)               # no allocation
        alloc.allocate(0, 5)
        with pytest.raises(err):
            alloc.truncate(0, 9)               # cannot grow
        alloc.free_slot(0)
        alloc.check_no_leaks()
    alloc = BlockAllocator(CacheConfig(4, 8))
    alloc.set_layout(CacheLayout(has_global=False, window=8,
                                 window_cap_blocks=3))
    with pytest.raises(AllocatorInvariantError, match="window ring"):
        alloc.truncate_window(0, 4)            # no ring


def test_truncate_window_rolls_the_ring_back():
    """The rewind pops exactly the ring entries past the kept position and
    leaves the low edge (slid with the query pinned at the pre-draft
    position) alone, with the reference's block ids."""
    port, ref = _window_pair(16, 4, 8, 5, has_global=False)
    for alloc in (port, ref):
        alloc.allocate(0, 6)                   # logical blocks 0..1
        alloc.extend_window(0, 12, first_query_pos=5)
        assert max(alloc.window_tables[0]) == 2
    assert port.window_tables == ref.window_tables
    freed = port.truncate_window(0, 7)
    assert freed == ref.truncate_window(0, 7) and len(freed) == 1
    assert sorted(port.window_tables[0]) == [0, 1]
    assert port.window_tables == ref.window_tables
    port.check()
    assert port.extend_window(0, 10, first_query_pos=6) == \
        ref.extend_window(0, 10, first_query_pos=6)
    port.free_slot(0)
    port.check_no_leaks()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rewind_churn_matches_reference(seed):
    """Speculative churn as the engine drives it (grow k + 1 rows with the
    ring's query pinned at the pre-draft position, rewind to a random
    acceptance point, retire) on a global table beside a window ring: the
    reference's block ids and rings, ``check()`` after every rewind, and
    nothing leaked at the end."""
    rng = np.random.default_rng(seed)
    port, ref = _window_pair(24, 4, 8, 4)
    live: dict[int, int] = {}                 # slot -> resident tokens
    next_slot = 0
    for _ in range(200):
        op = rng.random()
        if op < 0.3 and len(live) < 4:
            n = int(rng.integers(1, 10))
            ok = port.can_allocate(n)
            assert ok == ref.can_allocate(n)
            if ok:
                assert port.allocate(next_slot, n) == \
                    ref.allocate(next_slot, n)
                live[next_slot] = n
                next_slot += 1
        elif op < 0.85 and live:
            slot = sorted(live)[int(rng.integers(len(live)))]
            pos = live[slot]
            k = int(rng.integers(1, 5))
            grown = pos + k + 1
            if not port.can_allocate(grown - pos):
                continue
            for alloc in (port, ref):
                alloc.extend(slot, grown)
                alloc.extend_window(slot, grown, first_query_pos=pos - 1)
            keep = pos + int(rng.integers(0, k + 1)) + 1
            assert port.truncate(slot, keep) == ref.truncate(slot, keep)
            assert port.truncate_window(slot, keep) == \
                ref.truncate_window(slot, keep)
            port.check()
            live[slot] = keep
        elif live:
            slot = sorted(live)[int(rng.integers(len(live)))]
            assert port.free_slot(slot) == ref.free_slot(slot)
            del live[slot]
        assert port.tables == ref.tables
        assert port.window_tables == ref.window_tables
        assert port.n_free == ref.n_free
    for slot in sorted(live):
        port.free_slot(slot)
    port.check_no_leaks()


def test_check_no_leaks_catches_live_state():
    alloc = BlockAllocator(CacheConfig(4, 8))
    alloc.set_layout(CacheLayout(state_slots=2, state_bytes_per_slot=8))
    alloc.allocate(0, 5)
    with pytest.raises(AllocatorInvariantError, match="live tables"):
        alloc.check_no_leaks()
    alloc.free_slot(0)
    alloc.check_no_leaks()
    alloc._free.pop()                          # a block lost
    with pytest.raises(AllocatorInvariantError, match="leaked"):
        alloc.check_no_leaks()


def test_preempt_resets_slot_state_and_requeues_at_the_head():
    """``SlotScheduler.preempt`` clears the generated tokens, returns the
    slot to the free heap, requeues at the head of the queue and counts
    the eviction, as the reference's does."""
    for mod, alloc in ((psched, BlockAllocator(CacheConfig(4, 16))),
                       (jsched, jcache.BlockAllocator(
                           jcache.CacheConfig(4, 16)))):
        s = mod.SlotScheduler(2, alloc, kv_len=32, pricing="lazy")
        for rid in (0, 1, 2):
            s.submit(mod.Request(rid=rid, prompt=[1, 2, 3],
                                 max_new_tokens=4))
        s.admit(0)
        victim = s.active[1]
        victim.tokens.extend([7, 8])
        victim.first_token_step = 0
        s.preempt(1)
        assert s.preemptions == 1 and 1 not in s.active
        assert victim.tokens == [] and victim.first_token_step is None
        assert s.n_pending() == 2
        readmitted = s.admit(1)                # the head of the queue again
        assert [(a.request.rid, a.slot) for a in readmitted] == [(1, 1)]
        assert alloc.n_in_use == 2


def test_lazy_pricing_admits_like_the_reference():
    """Lazy pricing prices the prefill only: more admissions fit than under
    worst-case pricing, in the same order as the reference's scheduler."""
    def run(mod_sched, alloc, pricing):
        sched = mod_sched.SlotScheduler(4, alloc, kv_len=32,
                                        pricing=pricing)
        for i, (n, new) in enumerate([(5, 20), (9, 20), (3, 25), (12, 14)]):
            sched.submit(mod_sched.Request(rid=i, prompt=list(range(n)),
                                           max_new_tokens=new))
        return [(a.request.rid, a.slot) for a in sched.admit(0)]

    for pricing in ("worst", "lazy"):
        assert run(psched, BlockAllocator(CacheConfig(4, 16)), pricing) == \
            run(jsched, jcache.BlockAllocator(jcache.CacheConfig(4, 16)),
                pricing)
    assert len(run(psched, BlockAllocator(CacheConfig(4, 16)), "lazy")) > \
        len(run(psched, BlockAllocator(CacheConfig(4, 16)), "worst"))
    with pytest.raises(ValueError, match="pricing"):
        SlotScheduler(2, BlockAllocator(CacheConfig(4, 8)), 16,
                      pricing="eager")


def test_speculation_and_preemption_telemetry_match_the_reference():
    from repro.runtime.telemetry import ServeTelemetry as JServeTelemetry
    steps = [dict(preemptions=1), dict(drafted=8, accepted=3,
                                       rewound_tokens=5),
             dict(drafted=4, accepted=4), dict(preemptions=2)]
    tel, jtel = ServeTelemetry(), JServeTelemetry()
    for i, kw in enumerate(steps):
        for t in (tel, jtel):
            t.record_step(i, 0.1, (0,), 4, 2, 8, new_tokens=1, **kw)
    for name in ("total_preemptions", "accept_rate", "total_drafted",
                 "total_rewound_tokens", "total_tokens"):
        assert getattr(tel, name)() == getattr(jtel, name)(), name
    assert tel.accept_rate() == 7 / 12 and tel.total_preemptions() == 3
    assert tel.steps[1].rewound_tokens == 5


def test_f5_ring_reservation_overcounts_beside_a_global_table():
    """F5 settled: ``outstanding_blocks`` is the wrong side.  A request
    whose worst case is shorter than the window ring's cap can only ever
    pin ``blocks_for(worst)`` ring blocks, which ``blocks_needed`` prices;
    ``outstanding_blocks`` charges its ring up to the whole cap.  With a
    global table beside the ring and a pool below ``n_slots * (max_blocks
    + cap)``, two such admissions leave "reservations outstanding" above
    the free blocks: ``check()`` fails on a sound pool, an admission that
    fits is refused, and ``n_available()`` turns negative, so growth
    *inside* a reservation raises ``CacheExhausted`` (0 blocks beyond the
    reservation > -1 available) with 5 blocks free and 4 truly promised.
    Under worst-case pricing that growth is promised never to fail.  Both
    packages give the same numbers and the same failure (the port keeps
    the reference's arithmetic, so that block ids match)."""
    # block 4, window 8 (cap 3 blocks), pool 9 < 2 slots * (4 + 3)
    port, ref = _window_pair(9, 4, 8, 3)
    for alloc in (port, ref):
        assert alloc.blocks_needed(3, 6) == 4          # 2 global + 2 ring
        alloc.allocate(0, 3, reserve_tokens=6)
        # the ring holds 1 block and can reach 2; it is charged up to 3
        assert alloc.outstanding_blocks() == 3
        assert alloc.n_free == 7 and alloc.n_available() == 4
        assert alloc.can_allocate(3, 6)
        alloc.allocate(1, 3, reserve_tokens=6)
        assert alloc.outstanding_blocks() == 6 and alloc.n_free == 5
        assert alloc.n_available() == -1
        assert _check_message(alloc).startswith(
            "reservations outstanding (6) exceed")
        assert not alloc.can_allocate(1, 1)            # 1 block would fit
        # slot 0 grows to 6 tokens, inside its reservation of 2 blocks:
        # what each slot may still claim is 1 global + 1 ring block, 4 in
        # all, and 5 are free
        with pytest.raises(MemoryError, match="0 beyond"):
            alloc.extend(0, 6)
        assert alloc.n_free == 5
    assert port.tables == ref.tables
    assert port.window_tables == ref.window_tables
    for slot in (0, 1):
        port.free_slot(slot)
    port.check_no_leaks()
