"""The port's copied allocator, store, scheduler and telemetry against the
reference's: randomized churn with ``check()`` after every operation,
identical block ids to ``repro.serve.cache.BlockAllocator`` for the same
operations (global-only, global with state slots, and state slots alone;
and window rings, alone, with state slots as recurrentgemma lays them out,
and beside a global table), typed failures, state-slot accounting
(admission gated by free slots, release on finish, ``check()`` catching a
leaked slot, recurrent residency), ``check()`` catching a leaked window
ring, the torch ``PagedKVStore``, and FCFS admission with worst-case
reservations."""

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
