"""The port's prefix cache against the JAX package, on the CPU at the
reduced sizes in f32.

* The allocator: each row drives one sequence of operations through both
  packages' ``BlockAllocator`` in lock step (``_Twin``) and, after every
  operation, holds the results and the whole state equal: block tables,
  free list, hash index, LRU order of the cached pool, refcounts, matched
  tokens, ``prefix_stats`` and the type of any error.  The rows mirror the
  reference's allocator tests (match and share, commit, cached-not-free,
  LRU eviction, copy-on-write, ``drop_cached``, reservations), plus the
  truncate guard, ``inject_cached`` and a random churn over fixed seeds.
* ``prompt_block_hashes`` string for string, ``prefix_sharable_reason``,
  and ``copy_paged_block`` and ``insert_paged_prompt(skip_below=)`` on
  reduced TinyLlama pools, bit for bit.
* The engine matrix: reduced TinyLlama and paper-mlp x {whole, bucketed,
  chunk 8, speculate 2, lazy pricing over an undersized pool}, on a trace
  with a shared prefix, a repeated prompt and a block-aligned duplicate:
  each request's tokens equal the JAX ``ContinuousEngine(prefix_cache=
  True)``'s and the port's B=1 ``Engine``'s, with equal ``prefix_stats``
  and hit rate; minicpm-2b (whole, chunk 8) and command-r-35b (whole,
  bucketed) on the same trace.
* The refusals with the reference's messages, and the export, evict and
  import aliasing of the block handoff.

Seeds are fixed; no Hypothesis.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve import BlockAllocator as JBlockAllocator
from repro.serve import CacheConfig as JCacheConfig
from repro.serve import CacheLayout as JCacheLayout
from repro.serve import ContinuousEngine as JContinuousEngine
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm
from repro_torch.serve import (AllocatorInvariantError, BlockAllocator,
                               CacheConfig, CacheExhausted, CacheLayout,
                               ContinuousEngine, Engine)

torch.set_num_threads(2)
KV_LEN = 64
BS = 16


# =============================================================================
# the allocator, in lock step with the reference's
# =============================================================================

def _state(a) -> tuple:
    return (dict(a.tables), list(a._free), dict(a._index),
            list(a._cached.items()), dict(a._ref), dict(a._hash_of),
            dict(a.matched_tokens), a.prefix_stats(), a.n_free,
            a.n_available(), a.outstanding_blocks())


class _Twin:
    """Both packages' allocators driven by the same calls; every call's
    result (or error type) and the state after it must agree."""

    def __init__(self, n_blocks=16, block_size=4, sharable=True):
        self.j = JBlockAllocator(JCacheConfig(block_size=block_size,
                                              n_blocks=n_blocks))
        self.t = BlockAllocator(CacheConfig(block_size=block_size,
                                            n_blocks=n_blocks))
        if sharable:
            self.j.set_layout(JCacheLayout(has_global=True, sharable=True))
            self.t.set_layout(CacheLayout(has_global=True, sharable=True))

    def __getattr__(self, name):
        def call(*args, **kw):
            outs, errs = [], []
            for alloc in (self.j, self.t):
                try:
                    outs.append(getattr(alloc, name)(*args, **kw))
                    errs.append(None)
                except Exception as exc:        # compared by type name
                    outs.append(None)
                    errs.append(exc)
            assert [type(e).__name__ for e in errs] == \
                [type(e).__name__ for e in reversed(errs)], (name, errs)
            assert outs[0] == outs[1], (name, args, outs)
            assert _state(self.j) == _state(self.t), name
            if errs[1] is not None:
                raise errs[1]
            return outs[1]
        return call


def _hashes(prompt, bs=4):
    h = lm.prompt_block_hashes(prompt, bs)
    assert h == jlm.prompt_block_hashes(prompt, bs)
    return h


def test_prompt_block_hashes_equal_the_reference():
    rng = np.random.default_rng(3)
    for bs in (1, 4, 16):
        for n in (0, 3, 16, 17, 64, 131):
            p = rng.integers(0, 32_000, n).tolist()
            assert lm.prompt_block_hashes(p, bs) == \
                jlm.prompt_block_hashes(p, bs)
    p = list(range(1, 11))
    h = lm.prompt_block_hashes(p, 4)
    assert len(h) == 2 and lm.prompt_block_hashes(p[:8], 4) == h
    assert lm.prompt_block_hashes([99] + p[1:], 4)[1] != h[1]
    assert lm.prompt_block_hashes(p[:3], 4) == ()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "paper-mlp",
                                  "mamba2-370m", "recurrentgemma-2b"])
def test_prefix_sharable_reason_equals_the_reference(arch):
    cfg, jcfg = configs.get(arch).reduced(), jconfigs.get(arch).reduced()
    assert lm.prefix_sharable_reason(cfg) == jlm.prefix_sharable_reason(jcfg)
    assert (lm.prefix_sharable_reason(cfg) is None) == \
        (arch in ("tinyllama-1.1b", "paper-mlp"))


def test_admission_matches_committed_prefix_and_shares_blocks():
    a = _Twin()
    h = _hashes(list(range(12)))                 # 3 full blocks
    t0 = a.allocate(0, 13, block_hashes=h)
    a.commit_slot(0)
    t1 = a.allocate(1, 13, block_hashes=h)
    assert a.t.matched_tokens[1] == 12 and t1[:3] == t0[:3]
    assert t1[3] != t0[3]
    assert a.shared_saved_bytes() == 0           # no stores attached
    assert a.prefix_stats()["saved_blocks"] == 3
    a.check()
    a.free_slot(1)
    a.free_slot(0)
    a.check_no_leaks()


def test_commit_is_idempotent_and_deduplicates_content():
    a = _Twin()
    h = _hashes(list(range(8)))
    a.allocate(0, 9, block_hashes=h)
    assert a.commit_slot(0) == 2
    assert a.commit_slot(0) == 0
    a.allocate(1, 9, block_hashes=h)
    assert a.commit_slot(1) == 0
    assert a.prefix_stats()["indexed_blocks"] == 2
    a.free_slot(0)
    a.free_slot(1)
    a.check_no_leaks()


def test_freed_committed_blocks_become_cached_not_free():
    a = _Twin()
    h = _hashes(list(range(8)))
    t0 = a.allocate(0, 9, block_hashes=h)
    a.commit_slot(0)
    a.free_slot(0)
    assert a.cached_blocks() == 2 and a.t.n_free == a.t.n_blocks
    t1 = a.allocate(1, 9, block_hashes=h)
    assert t1[:2] == t0[:2]
    a.free_slot(1)
    a.check_no_leaks()


def test_lru_evicts_oldest_cached_first_and_never_a_live_block():
    a = _Twin(n_blocks=6)
    ha, hb = _hashes([1] * 8), _hashes([2] * 8)
    for h in (ha, hb):
        a.allocate(0, 9, block_hashes=h)
        a.commit_slot(0)
        a.free_slot(0)
    a.allocate(1, 9, block_hashes=hb)
    live = set(a.t.tables[1])
    grabbed = a.allocate(2, 4 * a.t.n_free)
    assert not live & set(grabbed)
    assert a.t.stats["evictions"] >= 1
    with pytest.raises(CacheExhausted):
        a.allocate(3, 4)
    a.check()
    a.free_slot(1)
    a.free_slot(2)
    a.check_no_leaks()


def test_cow_fork_gives_private_block_and_keeps_index():
    a = _Twin()
    h = _hashes(list(range(8)))
    a.allocate(0, 9, block_hashes=h)
    a.commit_slot(0)
    a.allocate(1, 9, block_hashes=h)
    assert a.is_block_shared(1, 1)
    src, dst = a.ensure_private(1, 1)
    assert a.t.tables[1][1] == dst != src
    assert a.ensure_private(1, 1) is None
    a.allocate(2, 9, block_hashes=h)
    assert a.t.tables[2][1] == src and a.t.stats["cow_forks"] == 1
    a.check()
    for s in (0, 1, 2):
        a.free_slot(s)
    a.check_no_leaks()


def test_drop_cached_empties_the_index():
    a = _Twin()
    h = _hashes(list(range(8)))
    a.allocate(0, 9, block_hashes=h)
    a.commit_slot(0)
    a.free_slot(0)
    assert a.drop_cached() == 2
    assert a.prefix_stats()["indexed_blocks"] == 0
    a.allocate(1, 9, block_hashes=h)
    assert a.t.matched_tokens[1] == 0
    a.free_slot(1)
    a.check_no_leaks()
    with pytest.raises(AllocatorInvariantError):
        a.free_slot(1)                           # double free


def test_worst_case_reservation_blocks_overcommitting_admissions():
    a = _Twin(n_blocks=8, sharable=False)
    a.allocate(0, 5, reserve_tokens=24)
    assert a.n_available() == 2
    assert not a.can_allocate(5, reserve_tokens=12)
    assert a.can_allocate(5, reserve_tokens=8)
    for n in range(6, 25):
        a.extend(0, n)
    a.free_slot(0)
    a.check_no_leaks()


def test_truncate_refuses_a_shared_or_indexed_tail_and_set_layout_a_cache():
    a = _Twin()
    h = _hashes(list(range(8)))
    a.allocate(0, 9, block_hashes=h)
    a.commit_slot(0)
    tail = a.extend(0, 13)
    assert a.truncate(0, 9) == tail              # a private decode block
    with pytest.raises(AllocatorInvariantError, match="shared/indexed"):
        a.truncate(0, 4)                         # would drop indexed block 1
    a.free_slot(0)
    for alloc, layout in ((a.j, JCacheLayout()), (a.t, CacheLayout())):
        with pytest.raises(ValueError, match="cached prefix blocks"):
            alloc.set_layout(layout)
    a.drop_cached()
    a.check_no_leaks()


def test_inject_cached_and_lookup():
    a = _Twin(n_blocks=5)
    chain = _hashes(list(range(16)))             # 4 blocks
    pairs = a.inject_cached(chain)
    assert [h for h, _ in pairs] == list(chain)
    assert a.match_tokens(chain) == 16
    assert a.lookup_block(chain[2]) == dict(pairs)[chain[2]]
    assert a.inject_cached(chain) == []          # already resident
    a.allocate(0, 17, block_hashes=chain)
    assert a.t.matched_tokens[0] == 16
    a.free_slot(0)
    # a pool too full for a second chain takes a prefix of it, and never
    # evicts the head of the chain it is injecting
    other = _hashes(list(range(100, 124)))       # 6 blocks
    got = a.inject_cached(other)
    assert 0 < len(got) < len(other)
    a.check()
    j = JBlockAllocator(JCacheConfig(block_size=4, n_blocks=4))
    t = BlockAllocator(CacheConfig(block_size=4, n_blocks=4))
    for alloc in (j, t):
        with pytest.raises(AssertionError, match="sharable"):
            alloc.inject_cached(chain)


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_refcount_invariants_under_randomized_churn(seed):
    """Overlapping prefix admissions, commits, forks and retirements in a
    random order (a local ``random.Random``, the same draws for both
    allocators): equal after every operation, audited by ``check()``, and
    leak-free at the end."""
    rng = random.Random(seed)
    bs = 4
    for _ in range(4):
        a = _Twin(n_blocks=24, block_size=bs)
        live: dict[int, int] = {}
        next_slot = 0
        prefixes = [[rng.randrange(100)] * (bs * rng.randint(1, 3))
                    for _ in range(4)]
        for _ in range(80):
            op = rng.random()
            if op < 0.45:
                prompt = (rng.choice(prefixes)
                          + [rng.randrange(100)
                             for _ in range(rng.randint(0, 2 * bs))])
                want = len(prompt) + 1
                h = _hashes(prompt, bs)
                if a.can_allocate(want):
                    a.allocate(next_slot, want, block_hashes=h)
                    live[next_slot] = want
                    next_slot += 1
            elif op < 0.6 and live:
                a.commit_slot(rng.choice(sorted(live)))
            elif op < 0.75 and live:
                slot = rng.choice(sorted(live))
                idx = rng.randrange(len(a.t.tables[slot]))
                if a.t.n_free >= 1:
                    pair = a.ensure_private(slot, idx)
                    if pair is not None:
                        a.copy_block(*pair)
            elif live:
                slot = rng.choice(sorted(live))
                a.free_slot(slot)
                del live[slot]
            a.check()
        for slot in sorted(live):
            a.free_slot(slot)
        a.check_no_leaks()
        a.drop_cached()
        a.check_no_leaks()
        assert a.t.n_free == a.t.n_blocks and not a.t._cached


# =============================================================================
# the paged pools: copy-on-write copy and masked insertion
# =============================================================================

def _random_pools(jcfg, cfg, n_slots, n_pages, seed):
    """Both packages' paged trees filled with the same random values."""
    rng = np.random.default_rng(seed)
    jtree = jlm.init_paged_caches(jcfg, n_slots, n_pages, BS, jnp.float32)
    nptree = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), jtree)
    ttree = lm.init_paged_caches(cfg, n_slots, n_pages, BS, torch.float32,
                                 "cpu")

    def fill(t, n):
        for k, v in t.items():
            if isinstance(v, dict):
                fill(v, n[k])
            else:
                v.copy_(torch.from_numpy(n[k]))
    fill(ttree, nptree)
    return jax.tree.map(jnp.asarray, nptree), ttree


def _equal_trees(ttree, jtree):
    for k, v in ttree.items():
        if isinstance(v, dict):
            _equal_trees(v, jtree[k])
        else:
            assert np.array_equal(v.numpy(), np.asarray(jtree[k])), k


@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfigs.get("tinyllama-1.1b").reduced()
    cfg = configs.get("tinyllama-1.1b").reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def test_copy_paged_block_equals_the_reference(tiny):
    jcfg, cfg, _, _ = tiny
    jtree, ttree = _random_pools(jcfg, cfg, 2, 9, seed=1)
    jtree = jlm.copy_paged_block(jcfg, jtree, 3, 6)
    assert lm.copy_paged_block(cfg, ttree, 3, 6) is ttree
    _equal_trees(ttree, jtree)


@pytest.mark.parametrize("skip", [0, 16, 20, 32])
def test_insert_paged_prompt_skip_below_equals_the_reference(tiny, skip):
    """A 33-row prefill (the JAX cache, carried across exactly) scattered
    through table row [5, 2, 7, null]: the rows below ``skip`` land on the
    null page only, every other page as in the reference."""
    jcfg, cfg, jp, _ = tiny
    n_pages = 9
    jtree, ttree = _random_pools(jcfg, cfg, 2, n_pages, seed=skip)
    prompt = jnp.asarray(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 33)), jnp.int32)
    _, single, _ = jlm.forward(jcfg, jp, prompt, mode="prefill",
                            cache=jlm.init_cache(jcfg, 1, KV_LEN,
                                                 jnp.float32))
    tsingle = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), single)
    row = np.array([5, 2, 7, n_pages - 1], np.int32)
    jtree = jlm.insert_paged_prompt(
        jcfg, jtree, single, {"global": jnp.asarray(row)}, 1, block_size=BS,
        null_block=n_pages - 1, skip_below=skip)
    lm.insert_paged_prompt(cfg, ttree, tsingle,
                           {"global": torch.from_numpy(row)}, 1,
                           block_size=BS, null_block=n_pages - 1,
                           skip_below=skip)
    # the null page's content depends on the scatter order of colliding
    # rows; every allocatable page must be equal
    _equal_trees({"k": ttree["seg0"]["c0"]["attn"]["k_pages"][:, :-1],
                  "v": ttree["seg0"]["c0"]["attn"]["v_pages"][:, :-1]},
                 {"k": jtree["seg0"]["c0"]["attn"]["k_pages"][:, :-1],
                  "v": jtree["seg0"]["c0"]["attn"]["v_pages"][:, :-1]})
    if skip >= 16:                               # block 5 left untouched
        fresh, _ = _random_pools(jcfg, cfg, 2, n_pages, seed=skip)
        assert np.array_equal(
            ttree["seg0"]["c0"]["attn"]["k_pages"][:, 5].numpy(),
            np.asarray(fresh["seg0"]["c0"]["attn"]["k_pages"][:, 5]))


# =============================================================================
# the engine matrix
# =============================================================================

ARCHS = ("tinyllama-1.1b", "paper-mlp", "deepseek-v2-lite-16b")
ROWS = {
    "whole": {},
    "bucketed": {"bucket_prompts": True},
    "chunk8": {"prefill_chunk": 8},
    "speculate2": {"speculate": 2},
    "lazy": {"pricing": "lazy", "cache_blocks": 5},
}
# minicpm and command-r have TinyLlama's layer structure (global attention,
# a dense FFN) at other head shapes: two rows each
CASES = [(a, r) for a in ARCHS for r in ROWS] + [
    ("minicpm-2b", "whole"), ("minicpm-2b", "chunk8"),
    ("command-r-35b", "whole"), ("command-r-35b", "bucketed")]


def _trace(vocab, seed=0) -> tuple:
    """A shared 16-token prefix under two tails, a repeat, the bare prefix
    twice (block-aligned: the recomputed last position falls in a shared
    block, which forks), and an unrelated prompt; arrivals and budgets
    (long enough for every request to grow into a new block, which an
    undersized pool cannot always give)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 16).tolist()
    p0 = shared + rng.integers(0, vocab, 3).tolist()
    p1 = shared + rng.integers(0, vocab, 5).tolist()
    other = rng.integers(0, vocab, 13).tolist()
    prompts = [p0, p1, p0, shared, shared, other]
    return prompts, [0, 0, 1, 6, 7, 8], [20, 16, 18, 24, 12, 22]


@pytest.fixture(scope="module")
def pairs():
    built: dict = {}

    def get(arch):
        if arch not in built:
            jcfg = jconfigs.get(arch).reduced()
            cfg = configs.get(arch).reduced()
            jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
            tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
            prompts, arrivals, budgets = _trace(cfg.vocab_size)
            oracle = Engine(cfg, tp, kv_len=KV_LEN, device="cpu")
            expects = [oracle.generate(torch.tensor([p]), b)[0].tolist()
                       for p, b in zip(prompts, budgets)]
            built[arch] = (jcfg, cfg, jp, tp, (prompts, arrivals, budgets),
                           expects)
        return built[arch]
    return get


def _serve(eng, trace) -> dict:
    for i, (p, t, b) in enumerate(zip(*trace)):
        eng.submit(p, b, rid=i, arrival=t)
    return eng.run()


@pytest.mark.parametrize("arch,row", CASES)
def test_prefix_cache_matrix_matches_the_reference(pairs, arch, row):
    jcfg, cfg, jp, tp, trace, expects = pairs(arch)
    kw = dict(kv_len=KV_LEN, n_slots=2, paged=True, prefix_cache=True,
              **ROWS[row])
    eng = ContinuousEngine(cfg, tp, device="cpu", **kw)
    got = _serve(eng, trace)
    jeng = JContinuousEngine(jcfg, jp, **kw)
    assert got == _serve(jeng, trace), (arch, row)
    for i, e in enumerate(expects):
        assert got[i] == e, (arch, row, i)
    st, jst = eng.allocator.prefix_stats(), jeng.allocator.prefix_stats()
    assert st == jst, (arch, row)
    assert st["hit_tokens"] > 0 and st["cow_forks"] >= 1
    tel, jtel = eng.telemetry, jeng.telemetry
    assert tel.prefix_hit_rate() == jtel.prefix_hit_rate() > 0
    assert tel.peak_shared_saved_bytes() == jtel.peak_shared_saved_bytes()
    assert tel.decode_starvation() == jtel.decode_starvation()
    assert [(s.prefix_hit_tokens, s.prefix_lookup_tokens, s.cached_blocks)
            for s in tel.steps] == \
        [(s.prefix_hit_tokens, s.prefix_lookup_tokens, s.cached_blocks)
         for s in jtel.steps]
    assert eng.scheduler.preemptions == jeng.scheduler.preemptions
    if row == "lazy":
        assert eng.scheduler.preemptions >= 1
    if row == "speculate2":
        assert tel.total_drafted() == jtel.total_drafted() > 0
    eng.allocator.check_no_leaks()
    eng.allocator.drop_cached()
    eng.allocator.check_no_leaks()
    assert eng.allocator.resident_bytes() == 0


def test_prefix_cache_refusals_match_the_reference(pairs):
    _, cfg, _, tp, _, _ = pairs("paper-mlp")
    msgs = []
    for pkg_cfg, Eng, extra in (
            (cfg, ContinuousEngine, {"device": "cpu"}),
            (jconfigs.get("paper-mlp").reduced(), JContinuousEngine, {})):
        with pytest.raises(ValueError, match="requires paged") as err:
            Eng(pkg_cfg, {}, kv_len=32, prefix_cache=True, **extra)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    for arch in ("mamba2-370m", "recurrentgemma-2b"):
        msgs = []
        for bad, Eng, extra in (
                (configs.get(arch).reduced(), ContinuousEngine,
                 {"device": "cpu"}),
                (jconfigs.get(arch).reduced(), JContinuousEngine, {})):
            with pytest.raises(ValueError,
                               match="prefix cache unavailable") as err:
                Eng(bad, {}, kv_len=KV_LEN, paged=True, prefix_cache=True,
                    **extra)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], arch
    eng = ContinuousEngine(cfg, tp, kv_len=KV_LEN, paged=True, device="cpu")
    for call in (eng.export_prefix_blocks, eng.import_prefix_blocks):
        with pytest.raises(ValueError, match="requires prefix_cache"):
            call([])


def test_preempted_request_rematches_its_committed_blocks(pairs):
    """Lazy pricing over 5 blocks: the preempted request's re-admission
    hits the blocks it committed before it was evicted (the same hits as
    the reference), and its tokens are still the oracle's."""
    _, cfg, _, tp, _, _ = pairs("paper-mlp")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, 17).tolist()
               for _ in range(3)]
    oracle = Engine(cfg, tp, kv_len=KV_LEN, device="cpu")
    eng = ContinuousEngine(cfg, tp, kv_len=KV_LEN, n_slots=3, paged=True,
                           prefix_cache=True, pricing="lazy",
                           cache_blocks=5, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(p, 20, rid=i)
    got = eng.run()
    assert eng.scheduler.preemptions >= 1
    assert eng.allocator.stats["hit_admissions"] >= 1
    for i, p in enumerate(prompts):
        assert got[i] == oracle.generate(torch.tensor([p]), 20)[0].tolist()
    eng.allocator.check_no_leaks()


def test_f8_admission_price_counts_the_revived_block_twice(pairs):
    """F8, pinned in both packages: ``can_allocate`` counts a cached block
    that the admission itself revives as free capacity, and the admission
    price does not count the copy-on-write fork of a block-aligned whole
    hit, so the fork can find the pool empty.  Two blocks, one of them the
    cached prefix: the admission fits, the fork raises ``CacheExhausted``
    (the same in both).  In the engine, under lazy pricing, that error
    leaves ``run`` from the admission, where no preemption catches it."""
    a = _Twin(n_blocks=2)
    h = _hashes([1, 2, 3, 4])
    a.allocate(0, 5, block_hashes=h)
    a.commit_slot(0)
    a.free_slot(0)
    assert a.can_allocate(5)
    a.allocate(1, 5, block_hashes=h)
    with pytest.raises(CacheExhausted, match="CoW fork"):
        a.ensure_private(1, 0)
    jcfg, cfg, jp, tp, trace, _ = pairs("paper-mlp")
    kw = dict(kv_len=KV_LEN, n_slots=3, paged=True, prefix_cache=True,
              pricing="lazy", cache_blocks=5)
    msgs = []
    for eng in (ContinuousEngine(cfg, tp, device="cpu", **kw),
                JContinuousEngine(jcfg, jp, **kw)):
        with pytest.raises(MemoryError, match="CoW fork") as err:
            _serve(eng, trace)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# =============================================================================
# the block handoff: exported pages are copies
# =============================================================================

def test_exported_pages_survive_eviction_and_reuse(pairs):
    """Export a prompt's blocks from engine A, then drop A's cache and serve
    a different prompt on A so that the same physical blocks are written
    again, and only then import the payloads into engine B: B serves the
    first prompt as a full prefix hit with the oracle's tokens (a view of
    A's pools would now hold the second prompt's rows)."""
    _, cfg, _, tp, _, _ = pairs("tinyllama-1.1b")
    rng = np.random.default_rng(9)
    first = rng.integers(0, cfg.vocab_size, 40).tolist()
    second = rng.integers(0, cfg.vocab_size, 40).tolist()
    kw = dict(kv_len=KV_LEN, n_slots=2, paged=True, prefix_cache=True,
              device="cpu")
    a, b = ContinuousEngine(cfg, tp, **kw), ContinuousEngine(cfg, tp, **kw)
    a.submit(first, 1, rid="lead")
    a.run()
    hashes = lm.prompt_block_hashes(first, a.block_size)
    blocks = [a.allocator.lookup_block(h) for h in hashes]
    entries = a.export_prefix_blocks(hashes)
    assert [h for h, _ in entries] == list(hashes)
    a.allocator.drop_cached()
    a.submit(second, 1, rid="other")
    a.run()
    reused = [a.allocator.lookup_block(h) for h in
              lm.prompt_block_hashes(second, a.block_size)]
    assert set(reused) & set(blocks), (reused, blocks)
    assert b.import_prefix_blocks(entries) == len(hashes)
    b.allocator.check()
    b.submit(first, 6, rid="tail")
    got = b.run()["tail"]
    oracle = Engine(cfg, tp, kv_len=KV_LEN, device="cpu")
    assert got == oracle.generate(torch.tensor([first]), 6)[0].tolist()
    assert b.allocator.stats["hit_tokens"] == len(hashes) * b.block_size
    for eng in (a, b):
        eng.allocator.drop_cached()
        eng.allocator.check_no_leaks()
