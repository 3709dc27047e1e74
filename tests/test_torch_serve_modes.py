"""The port's serving modes against the JAX package, on the CPU at the
reduced TinyLlama, mamba2-370m, recurrentgemma-2b and deepseek-v2-lite
sizes in f32 (the mode matrix also at the reduced gemma2-9b, minicpm-2b,
command-r-35b and mixtral-8x7b): dense lanes, bucketed prefill, chunked
prefill and greedy speculation.

Same weights (``repro.models.lm.init_params`` output carried across by
``repro_torch.convert``) and the same numpy-seeded inputs through both
packages:

* the mode matrix of ``tests/test_serve_arch_matrix.py`` (its ``KV_LEN``,
  prompt lengths, budgets and chunk sizes): every arch x {dense,
  dense_bucket, paged, paged_bucket, paged_chunk, paged_bucket_chunk,
  paged_spec} gives each request the tokens of the port's B=1 ``Engine``
  and of the JAX ``Engine``, the paged modes hold the reference's cache
  groups (a window ring, a global table or both), and recurrentgemma's
  chunked engine the JAX engine's per-step telemetry;
* step level: ``make_bucketed_prefill_step`` and ``make_chunk_prefill_step``
  (token, logits, cache leaves within atol = rtol = 1e-5; recurrent state
  leaves within 1e-4, the JAX scan tests' bar), ``ssd_layer`` and
  ``rglru_layer`` with ``valid_len``, ``blocks._prefill_cache`` with
  ``valid_len`` on a window ring shorter than the padded prompt, and
  ``bucket_length``;
* the allocator under a chunk layout: a scripted chunk trace on the
  reduced recurrentgemma's window of 32 gives the reference's block ids,
  freed blocks and ``check()`` outcomes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Engine as JEngine
from repro.serve import cache as jcache
from repro.serve import engine as jengine
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import blocks, lm, rglru, ssm
from repro_torch.serve import (ContinuousEngine, Engine, bucket_length,
                               make_bucketed_prefill_step,
                               make_chunk_prefill_step)
from repro_torch.serve.cache import BlockAllocator, CacheConfig, CacheLayout

torch.set_num_threads(2)
ARCHS = ("tinyllama-1.1b", "mamba2-370m", "recurrentgemma-2b",
         "deepseek-v2-lite-16b")
# the rest of the registry, in the mode matrix only
MATRIX_ARCHS = ARCHS + ("gemma2-9b", "minicpm-2b", "command-r-35b",
                        "mixtral-8x7b")
KV_LEN = 64
PROMPT_LENS = (5, 9, 13, 33)
BUDGETS = (4, 6, 5, 3)
MODES = {
    "dense": {},
    "dense_bucket": {"bucket_prompts": True},
    "paged": {"paged": True},
    "paged_bucket": {"paged": True, "bucket_prompts": True},
    "paged_chunk": {"paged": True, "prefill_chunk": 8},
    # 7 does not divide kv_len: pad rows past the table's reach
    "paged_bucket_chunk": {"paged": True, "bucket_prompts": True,
                           "prefill_chunk": 7},
    "paged_spec": {"paged": True, "speculate": 4},
}
TOL = 1e-5
STATE_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    """arch -> (jax cfg, port cfg, jax params, port params, prompts, tokens
    of the JAX B=1 Engine per request), built once per arch."""
    built: dict = {}

    def get(arch):
        if arch not in built:
            jcfg = jconfigs.get(arch).reduced()
            cfg = configs.get(arch).reduced()
            jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
            tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
            rng = np.random.default_rng(11)
            prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                       for n in PROMPT_LENS]
            ref = JEngine(jcfg, jp, kv_len=KV_LEN)
            expects = [np.asarray(ref.generate(jnp.asarray([p], jnp.int32),
                                               b))[0].tolist()
                       for p, b in zip(prompts, BUDGETS)]
            built[arch] = (jcfg, cfg, jp, tp, prompts, expects)
        return built[arch]

    return get


def _leaves(tree, prefix=""):
    """{path: numpy array} of a nested dict of JAX arrays or tensors."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_leaves(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def _tol(path):
    """The recurrent state leaves' bar, else the cache leaves' one."""
    return STATE_TOL if path.endswith("/state") else TOL


def _close_trees(got, exp, skip_last_page=False):
    got, exp = _leaves(got), _leaves(exp)
    assert got.keys() == exp.keys()
    for path, e in exp.items():
        g = got[path]
        if skip_last_page and path.endswith("_pages"):
            # the null page takes every write with nowhere else to go, in
            # no fixed order
            g, e = g[:, :-1], e[:, :-1]
        assert g.shape == e.shape, path
        np.testing.assert_allclose(g, e, atol=_tol(path), rtol=_tol(path),
                                   err_msg=path)


# =============================================================================
# the mode matrix
# =============================================================================

@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", MATRIX_ARCHS)
def test_mode_matrix_matches_both_engines(setup, arch, mode):
    jcfg, cfg, jp, tp, prompts, expects = setup(arch)
    oracle = Engine(cfg, tp, kv_len=KV_LEN, device="cpu")
    eng = ContinuousEngine(cfg, tp, kv_len=KV_LEN, n_slots=2, device="cpu",
                           **MODES[mode])
    for i, p in enumerate(prompts):
        eng.submit(p, BUDGETS[i], rid=i, arrival=i)
    results = eng.run()
    for i, (p, b) in enumerate(zip(prompts, BUDGETS)):
        assert results[i] == expects[i], (arch, mode, i)
        assert oracle.generate(torch.tensor([p]), b)[0].tolist() == \
            expects[i]
    eng.allocator.check()
    assert eng.allocator.n_in_use == 0
    assert eng.allocator.state_slots_in_use() == 0
    tel = eng.telemetry
    assert tel.total_tokens() == sum(BUDGETS)
    chunk = MODES[mode].get("prefill_chunk", 0)
    chunks = sum(s.prefill_chunks for s in tel.steps)
    assert chunks == (sum(-(-n // chunk) for n in PROMPT_LENS) if chunk
                      else 0)
    assert (tel.mean_chunk_ms() > 0) == bool(chunk)
    if MODES[mode].get("paged"):
        groups = jlm.serve_groups(jcfg)
        peaks = tel.peak_resident_bytes_by_group()
        assert (peaks.get("global", 0) > 0) == bool(groups["paged"]), peaks
        assert (peaks.get("window", 0) > 0) == bool(groups["window"]), peaks
    if MODES[mode].get("speculate"):
        assert tel.total_drafted() > 0
        accepted = sum(s.accepted for s in tel.steps)
        assert tel.total_rewound_tokens() == tel.total_drafted() - accepted


def test_chunked_engine_steps_match_jax_engine(setup):
    """recurrentgemma with bucketed chunks of 7 through both packages'
    engines: the same tokens, and step for step the same prefills,
    chunk units, decoding lanes, blocks in use and residency by cache
    group (window rings started at block 0 and slid with the chunks)."""
    jcfg, cfg, jp, tp, prompts, expects = setup("recurrentgemma-2b")
    opts = MODES["paged_bucket_chunk"]
    jeng = JContinuousEngine(jcfg, jp, kv_len=KV_LEN, n_slots=2, **opts)
    eng = ContinuousEngine(cfg, tp, kv_len=KV_LEN, n_slots=2, device="cpu",
                           **opts)
    for e in (jeng, eng):
        for i, p in enumerate(prompts):
            e.submit(p, BUDGETS[i], rid=i, arrival=i)
    exp, got = jeng.run(), eng.run()
    assert got == exp == dict(enumerate(expects))
    assert eng.allocator.n_blocks == jeng.allocator.n_blocks

    def steps(tel):
        return [(s.step, s.prefills, s.prefill_chunks, s.active_slots,
                 s.blocks_in_use, s.resident_by_group) for s in tel.steps]

    assert steps(eng.telemetry) == steps(jeng.telemetry)


# =============================================================================
# step factories
# =============================================================================

# the last: bucket 64 > the ring of 32, where pad rows must not displace
# real ring slots
BUCKET_CASES = [("tinyllama-1.1b", 13), ("mamba2-370m", 13),
                ("recurrentgemma-2b", 40)]


@pytest.mark.parametrize("arch,n", BUCKET_CASES)
def test_bucketed_prefill_step_matches_jax(setup, arch, n):
    """A prompt right-padded to its bucket: the token, the logits of the
    real rows and every cache leaf (pad rows position-masked, recurrent
    state frozen at the real prompt)."""
    jcfg, cfg, jp, tp, _, _ = setup(arch)
    rng = np.random.default_rng(n)
    sb = bucket_length(n, KV_LEN)
    toks = np.zeros((1, sb), np.int32)
    toks[0, :n] = rng.integers(0, cfg.vocab_size, n)
    jinit = jlm.init_cache(jcfg, 1, KV_LEN, jnp.float32)
    jtok, jc = jax.jit(jengine.make_bucketed_prefill_step(jcfg))(
        jp, jinit, jnp.asarray(toks), jnp.asarray(n, jnp.int32))
    jl = jax.jit(lambda p, c, t: jlm.forward(
        jcfg, p, t, cache=c, mode="prefill", valid_len=n)[0])(
        jp, jinit, jnp.asarray(toks))
    tc = lm.init_cache(cfg, 1, KV_LEN, torch.float32, "cpu")
    ttok, tc = make_bucketed_prefill_step(cfg)(tp, tc, torch.from_numpy(toks),
                                               n)
    assert ttok.tolist() == np.asarray(jtok).tolist()
    _close_trees(tc, jc)
    tl, _, _ = lm.forward(cfg, tp, torch.from_numpy(toks),
                          cache=lm.init_cache(cfg, 1, KV_LEN, torch.float32,
                                              "cpu"),
                          mode="prefill", valid_len=n)
    np.testing.assert_allclose(tl[:, :n].numpy(), np.asarray(jl)[:, :n],
                               atol=TOL, rtol=TOL)


def _set_state(jtree, ttree, seed):
    """The same random values in every recurrent state leaf of both paged
    trees (lane 0 busy with another request, lane 1 zeroed)."""
    rng = np.random.default_rng(seed)
    for seg, jseg in jtree.items():
        for c, jentry in jseg.items():
            for mixer in ("ssd", "rglru"):
                if mixer not in jentry:
                    continue
                for k, arr in jentry[mixer].items():
                    val = rng.standard_normal(arr.shape).astype(np.float32)
                    val[:, 1] = 0.0
                    jentry[mixer][k] = jnp.asarray(val)
                    ttree[seg][c][mixer][k].copy_(torch.from_numpy(val))


@pytest.mark.parametrize("arch,chunk", [(a, 7) for a in ARCHS]
                         + [("recurrentgemma-2b", 8)])
def test_chunk_prefill_step_matches_jax(setup, arch, chunk):
    """A 33-row prompt in chunks through lane 1 of a two-lane paged tree:
    after every chunk the same candidate token, pools and state slabs (lane
    0's untouched); the final chunk's pad rows freeze the state."""
    jcfg, cfg, jp, tp, prompts, _ = setup(arch)
    prompt = np.asarray(prompts[3], np.int32)
    bs, n_pages = 16, 9
    jcaches = jlm.init_paged_caches(jcfg, 2, n_pages, bs, jnp.float32)
    tcaches = lm.init_paged_caches(cfg, 2, n_pages, bs, torch.float32,
                                   "cpu")
    _set_state(jcaches, tcaches, seed=chunk)
    groups = lm.serve_groups(cfg)
    row = np.array([5, 2, 7, n_pages - 1], np.int32)    # [W], null last
    rows = {g: row for g, key in (("global", "paged"), ("window", "window"))
            if groups[key]}
    jstep = jax.jit(jengine.make_chunk_prefill_step(jcfg, chunk))
    tstep = make_chunk_prefill_step(cfg, chunk)
    total = prompt.shape[0]
    for start in range(0, total, chunk):
        piece = np.zeros((1, chunk), np.int32)
        valid = min(chunk, total - start)
        piece[0, :valid] = prompt[start:start + valid]
        last = min(max(total - 1 - start, 0), chunk - 1)
        jtok, jcaches = jstep(
            jp, jcaches, jnp.asarray(piece), jnp.asarray(start, jnp.int32),
            {g: jnp.asarray(r) for g, r in rows.items()},
            jnp.asarray(last, jnp.int32), jnp.asarray(1, jnp.int32),
            jnp.asarray(valid, jnp.int32))
        ttok, tcaches = tstep(tp, tcaches, torch.from_numpy(piece), start,
                              {g: torch.from_numpy(r)
                               for g, r in rows.items()}, last, 1, valid)
        assert ttok.tolist() == np.asarray(jtok).tolist(), start
        _close_trees(tcaches, jcaches, skip_last_page=True)


# =============================================================================
# valid_len in the layers
# =============================================================================

@pytest.mark.parametrize("valid", [1, 7, 16])
@pytest.mark.parametrize("mixer", ["ssd", "rglru"])
def test_recurrent_layers_with_valid_len_match_jax(setup, mixer, valid):
    """A 16-row slice continuing from a random cache with ``valid`` real
    rows: the output's real rows, the conv tail (the last real rows) and
    the final state (frozen past the real rows)."""
    arch = "mamba2-370m" if mixer == "ssd" else "recurrentgemma-2b"
    jcfg, cfg, jp, tp, _, _ = setup(arch)
    jl = jax.tree.map(lambda a: a[0], jp["seg0"]["c0"][mixer])
    tl = {k: v[0] for k, v in tp["seg0"]["c0"][mixer].items()}
    mod, jmod = (ssm, jssm) if mixer == "ssd" else (rglru, jrglru)
    init = ssm.init_ssd_cache if mixer == "ssd" else rglru.init_rglru_cache
    rng = np.random.default_rng(valid)
    shapes = {k: tuple(t.shape) for k, t in
              init(cfg, 1, torch.float32, "cpu").items()}
    cache = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    x = rng.standard_normal((1, 16, cfg.d_model)).astype(np.float32)
    layer = getattr(jmod, f"{mixer}_layer")
    exp, jnew = jax.jit(lambda x, c, n: layer(jcfg, jl, x, cache=c,
                                              valid_len=n))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(valid))
    for impl in ("kernel", "plain"):
        got, new = getattr(mod, f"{mixer}_layer")(
            cfg, tl, torch.from_numpy(x),
            cache={k: torch.from_numpy(v) for k, v in cache.items()},
            impl=impl, valid_len=valid)
        np.testing.assert_allclose(got[:, :valid].numpy(),
                                   np.asarray(exp)[:, :valid],
                                   atol=STATE_TOL, rtol=STATE_TOL)
        _close_trees(new, jnew)


@pytest.mark.parametrize("valid", [None, 5, 32, 33, 40, 64])
def test_prefill_cache_with_valid_len_matches_jax(valid):
    """A window layer's ring of 32 slots, holding earlier rows, takes a
    64-row padded prompt: the last real rows land at position % 32 and pad
    rows never displace what the ring held."""
    rng = np.random.default_rng(0 if valid is None else valid)
    size, S, kv, hd = 32, 64, 2, 16
    ck, cv = (rng.standard_normal((1, size, kv, hd)).astype(np.float32)
              for _ in range(2))
    cpos = rng.permutation(size).astype(np.int32) - 3   # some slots empty
    k, v = (rng.standard_normal((1, S, kv, hd)).astype(np.float32)
            for _ in range(2))
    positions = np.arange(S, dtype=np.int32)
    jc = jblocks._prefill_cache(
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv), "pos": jnp.asarray(cpos)},
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions), 32,
        None if valid is None else jnp.asarray(valid))
    tc = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy()),
          "pos": torch.from_numpy(cpos.copy())}
    out = blocks._prefill_cache(tc, torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(positions), 32, valid)
    assert out is tc
    for key in ("k", "v", "pos"):
        assert np.array_equal(tc[key].numpy(), np.asarray(jc[key])), key


def test_bucket_length_matches_reference():
    for cap in (16, 64, 100, 512):
        for n in range(1, cap + 1):
            assert bucket_length(n, cap) == jengine.bucket_length(n, cap)
    assert bucket_length(3, 64, floor=2) == jengine.bucket_length(3, 64, 2)


# =============================================================================
# the allocator under a chunk layout
# =============================================================================

def _check_message(alloc):
    try:
        alloc.check()
    except AssertionError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("chunk,bs", [(7, 16), (8, 16), (8, 4)])
def test_chunk_layout_allocator_matches_reference(chunk, bs):
    """The engine's chunked-prefill allocator calls on the reduced
    recurrentgemma layout (window 32, state slots, no global table),
    scripted: three requests over two slots, each prompt admitted, then
    its rings slid chunk by chunk (``first_query_pos`` at the chunk's
    first row) and decode step by decode step, then retired.  Every call
    returns the reference's block ids and freed blocks, and ``check()``
    agrees after each."""
    cfg = configs.get("recurrentgemma-2b").reduced()
    window = min(KV_LEN, cfg.window_size)
    bf = lambda n: -(-n // bs)                          # noqa: E731
    cap = min(bf(KV_LEN), bf(window) + 1 + bf(chunk))
    spec = dict(has_global=False, window=window, window_cap_blocks=cap,
                state_slots=2, state_bytes_per_slot=64, prefill_chunk=chunk)
    port = BlockAllocator(CacheConfig(block_size=bs, n_blocks=2 * cap))
    ref = jcache.BlockAllocator(jcache.CacheConfig(block_size=bs,
                                                   n_blocks=2 * cap))
    port.set_layout(CacheLayout(**spec))
    ref.set_layout(jcache.CacheLayout(**spec))
    trace = [(0, 33, 6), (1, 50, 10), (0, 9, 20)]       # slot, prompt, new
    events = []
    for slot, n, new in trace:
        assert port.allocate(slot, n + 1, reserve_tokens=n + new) == \
            ref.allocate(slot, n + 1, reserve_tokens=n + new)
        events.append(("allocate", slot))
        for start in range(0, n, chunk):
            args = (slot, min(start + chunk, n))
            got = port.extend_window(*args, first_query_pos=start)
            assert got == ref.extend_window(*args, first_query_pos=start)
            events.append(("chunk", slot, start, got))
        for pos in range(n, n + new - 1):
            got = port.extend_window(slot, pos + 1)
            assert got == ref.extend_window(slot, pos + 1)
            events.append(("decode", slot, pos, got))
        assert port.window_tables == ref.window_tables
        assert port.padded_window_table(slot, bf(KV_LEN)) == \
            ref.padded_window_table(slot, bf(KV_LEN))
        assert _check_message(port) == _check_message(ref)
        if slot == 0 and n == 33:
            continue                    # slot 0 stays live beside slot 1
        assert port.free_slot(slot) == ref.free_slot(slot)
        if slot == 1:
            assert port.free_slot(0) == ref.free_slot(0)
        assert _check_message(port) == _check_message(ref) is None
        assert port.n_free == ref.n_free
    assert port.n_free == 2 * cap and not port.window_tables
    # the rings started at block 0 and slid: blocks came back mid-prompt
    assert any(e[0] == "chunk" and e[3][1] for e in events)
