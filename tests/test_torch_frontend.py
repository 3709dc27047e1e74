"""The port's modality-frontend and enc-dec archs against the JAX package,
on the CPU at the reduced ``phi-3-vision-4.2b`` (projected frontend rows
prepended to the decoder sequence) and ``seamless-m4t-medium`` (encoder,
cross attention) sizes in f32, with the reference's weights carried
across by ``repro_torch.convert``:

* modules: the encoder's output, every decoder layer's cross K/V
  (``encode_cross_single``) and the embedded prompt rows within 1e-5;
  prefill, dense-cache decode and train-mode logits within 1e-4, the dense
  cache's cross K/V leaves too;
* the allocator's cross block sets and frontend pricing, in lock step with
  the reference's (``tests/test_serve_encdec.py``'s allocator rows), and
  the scheduler's admission gate on a cross set;
* the contracts: a VLM's paged ``kv_len`` must leave ``kv_len + frontend
  rows`` block-aligned, an enc-dec prefill without embeddings raises in
  both packages, and ``submit``'s ``frontend_emb`` checks
  (``tests/test_serve_arch_matrix.py::test_frontend_emb_submission_contract``).

Seeds are fixed (local generators only); no Hypothesis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve.cache import BlockAllocator as JBlockAllocator
from repro.serve.cache import CacheConfig as JCacheConfig
from repro.serve.cache import CacheLayout as JCacheLayout
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import SlotScheduler as JSlotScheduler
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm
from repro_torch.serve import ContinuousEngine
from repro_torch.serve.cache import BlockAllocator, CacheConfig, CacheLayout
from repro_torch.serve.scheduler import Request, SlotScheduler

torch.set_num_threads(2)
VLM = "phi-3-vision-4.2b"
ENCDEC = "seamless-m4t-medium"
ARCHS = (VLM, ENCDEC)
TOL = 1e-5
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    """arch -> (jax cfg, port cfg, jax params, port params)."""
    built: dict = {}

    def get(arch):
        if arch not in built:
            jcfg = jconfigs.get(arch).reduced()
            cfg = configs.get(arch).reduced()
            jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
            tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
            built[arch] = (jcfg, cfg, jp, tp)
        return built[arch]
    return get


def _fe(cfg, seed, *batch):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        tuple(batch) + (cfg.frontend_tokens, cfg.frontend_dim)
    ).astype(np.float32)


def _close(got, exp, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(exp), atol=tol,
                               rtol=tol, err_msg=what)


# =============================================================================
# modules
# =============================================================================

def test_param_tree_matches_reference(setup):
    """The port's own init builds the reference's tree (keys and shapes),
    and the carried-across tree passes the key check of both families."""
    for arch in ARCHS:
        jcfg, cfg, jp, tp = setup(arch)
        own = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                             torch.float32)
        shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
        assert jax.tree.map(lambda t: tuple(t.shape), own) == shapes, arch
        assert ("frontend_proj" in own) == (arch == VLM)
        assert ("enc" in own) == (arch == ENCDEC)
    cfg = setup(VLM)[1]
    with pytest.raises(ValueError, match="parameter keys"):
        params_from_numpy(cfg, {"embed": np.zeros((1, 1))}, "cpu")


def test_encoder_and_cross_kv_match_reference(setup):
    """``_encode``'s output and every decoder layer's cross K/V
    (``encode_cross_single``) against the reference's, within 1e-5."""
    jcfg, cfg, jp, tp = setup(ENCDEC)
    fe = _fe(cfg, 1, 2)
    exp = jlm._encode(jcfg, jp, jnp.asarray(fe), remat=False, unroll=False)
    got = lm._encode(cfg, tp, torch.from_numpy(fe))
    assert got.shape == (2, cfg.frontend_tokens, cfg.d_model)
    _close(got, exp, what="encoder output")
    jx = jlm.encode_cross_single(jcfg, jp, jnp.asarray(fe[:1]))
    tx = lm.encode_cross_single(cfg, tp, torch.from_numpy(fe[:1]))
    for si, seg in enumerate(cfg.segments()):
        for ci in range(len(seg.cycle)):
            for key in ("k", "v"):
                t = tx[f"seg{si}"][f"c{ci}"]["xattn"][key]
                assert t.shape == (seg.repeats, 1, cfg.frontend_tokens,
                                   cfg.n_kv_heads, cfg.head_dim)
                _close(t, jx[f"seg{si}"][f"c{ci}"]["xattn"][key],
                       what=f"seg{si}/c{ci} {key}")


def test_embed_prompt_rows_match_reference(setup):
    """The precomputed row stream of chunked prefill: the projected
    frontend rows, then the token rows, as the reference builds them (and
    for an enc-dec arch the token rows alone)."""
    for arch in ARCHS:
        jcfg, cfg, jp, tp = setup(arch)
        toks = np.array([4, 2, 9], np.int32)
        fe = _fe(cfg, 2)
        exp = jlm.embed_prompt_rows(jcfg, jp, jnp.asarray(toks),
                                    jnp.asarray(fe))
        got = lm.embed_prompt_rows(cfg, tp, torch.from_numpy(toks),
                                   torch.from_numpy(fe))
        F = cfg.frontend_tokens if arch == VLM else 0
        assert got.shape == (F + 3, cfg.d_model)
        _close(got, exp, what=arch)
    with pytest.raises(ValueError, match="frontend_emb"):
        cfg, tp = setup(VLM)[1], setup(VLM)[3]
        lm.embed_prompt_rows(cfg, tp, torch.from_numpy(toks))


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_reference(setup, arch):
    """Prefill into a dense cache (the VLM's F rows first; the enc-dec's
    cross K/V leaves filled from the encoder), three decode steps on that
    cache, and train mode, against the reference at 1e-4; the kernel and
    plain routes agree."""
    jcfg, cfg, jp, tp = setup(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    fe = _fe(cfg, 4, 2)
    F = cfg.frontend_tokens if arch == VLM else 0
    kv = 32
    jl, jcache, _ = jlm.forward(jcfg, jp, jnp.asarray(toks),
                                frontend_emb=jnp.asarray(fe),
                                cache=jlm.init_cache(jcfg, 2, kv,
                                                     jnp.float32),
                                mode="prefill")
    cache = lm.init_cache(cfg, 2, kv, torch.float32, "cpu")
    with torch.no_grad():
        tl, cache, _ = lm.forward(cfg, tp, torch.from_numpy(toks),
                                  frontend_emb=torch.from_numpy(fe),
                                  cache=cache, mode="prefill")
        plain, _, _ = lm.forward(cfg, tp, torch.from_numpy(toks),
                                 frontend_emb=torch.from_numpy(fe),
                                 mode="prefill", impl="plain")
    assert tl.shape == (2, F + 9, cfg.padded_vocab)
    _close(tl, jl, LOGIT_TOL, "prefill")
    _close(plain, tl, LOGIT_TOL, "plain route")
    if arch == ENCDEC:
        for key in ("k", "v"):
            _close(cache["seg0"]["c0"]["xattn"][key],
                   jcache["seg0"]["c0"]["xattn"][key], what=key)
    jt = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)
    tt = tl[:, -1].argmax(dim=-1).to(torch.int32)
    assert tt.tolist() == np.asarray(jt).tolist()
    for step in range(3):
        pos = F + 9 + step
        jl, jcache, _ = jlm.forward(jcfg, jp, jt[:, None],
                                    positions=jnp.asarray(pos, jnp.int32),
                                    cache=jcache, mode="decode")
        with torch.no_grad():
            tl, cache, _ = lm.forward(cfg, tp, tt[:, None],
                                      positions=torch.tensor(
                                          pos, dtype=torch.int32),
                                      cache=cache, mode="decode")
        _close(tl, jl, LOGIT_TOL, f"decode {step}")
        jt = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)
        tt = tl[:, -1].argmax(dim=-1).to(torch.int32)
        assert tt.tolist() == np.asarray(jt).tolist()
    jtrain, _, _ = jlm.forward(jcfg, jp, jnp.asarray(toks),
                               frontend_emb=jnp.asarray(fe), mode="train")
    ttrain, _, _ = lm.forward(cfg, tp, torch.from_numpy(toks),
                              frontend_emb=torch.from_numpy(fe), mode="train",
                              impl="plain")
    _close(ttrain.detach(), jtrain, LOGIT_TOL, "train")


def test_frontend_families_are_served_and_grouped(setup):
    """Neither family is refused any more; the cache-group report is the
    reference's, the cross overlay included, and prefix sharing stays
    refused with the reference's reasons."""
    for arch in ARCHS:
        jcfg, cfg, _, _ = setup(arch)
        full = configs.get(arch)
        assert lm.unsupported_reason(cfg) is None
        assert lm.unsupported_reason(full) is None
        ref = jlm.serve_groups(jcfg)
        assert lm.serve_groups(cfg) == {k: ref[k] for k in
                                        ("paged", "window", "recurrent",
                                         "cross")}
        assert lm.prefix_sharable_reason(cfg) == \
            jlm.prefix_sharable_reason(jcfg) is not None


# =============================================================================
# allocator and scheduler (tests/test_serve_encdec.py's allocator rows)
# =============================================================================

def _twins(block_size, n_blocks, **layout):
    port = BlockAllocator(CacheConfig(block_size=block_size,
                                      n_blocks=n_blocks))
    ref = JBlockAllocator(JCacheConfig(block_size=block_size,
                                       n_blocks=n_blocks))
    port.set_layout(CacheLayout(**layout))
    ref.set_layout(JCacheLayout(**layout))
    return port, ref


def _same(port, ref):
    assert port.tables == ref.tables
    assert port.cross_tables == ref.cross_tables
    assert port.n_in_use == ref.n_in_use
    assert port.n_available() == ref.n_available()
    port.check()
    ref.check()


def test_allocator_prices_cross_at_admission():
    """The cross cap is part of ``blocks_needed``; ``allocate`` claims the
    whole set up front, ``extend`` never touches it, the padded row
    publishes it, ``free_slot`` returns it: block for block the
    reference's."""
    port, ref = _twins(4, 8, has_global=True, cross_tokens=6,
                       cross_cap_blocks=2)
    for a in (port, ref):
        assert a.blocks_needed(4) == 1 + 2
        a.allocate(0, 4)
    _same(port, ref)
    before = list(port.cross_tables[0])
    assert len(before) == 2 and port.n_in_use == 3
    for a in (port, ref):
        a.extend(0, 8)
    _same(port, ref)
    assert port.cross_tables[0] == before and port.n_in_use == 4
    row = port.padded_cross_table(0, 3)
    assert row == ref.padded_cross_table(0, 3)
    assert row[:2] == before and row[2] == port.config.null_block
    with pytest.raises(ValueError, match="exceeds width"):
        port.padded_cross_table(0, 1)
    assert port.free_slot(0) == ref.free_slot(0) == 4
    port.check_no_leaks()
    ref.check_no_leaks()
    assert port._free == ref._free


def test_allocator_frontend_extra_widens_admission_price():
    """A VLM admission pays for its frontend rows in the global group, and
    the slot's ledger is physical; a worst-case reservation counts them
    too."""
    port, ref = _twins(4, 8, has_global=True, frontend_extra=8)
    for a in (port, ref):
        assert a.blocks_needed(4) == 3          # ceil((4 + 8) / 4)
        assert len(a.allocate(0, 4)) == 3
        assert len(a.extend(0, 13)) == 1        # 13 resident rows
    _same(port, ref)
    for a in (port, ref):
        a.free_slot(0)
        a.allocate(1, 2, reserve_tokens=12)     # blocks_for(12 + 8) = 5
    _same(port, ref)
    assert port.outstanding_blocks() == ref.outstanding_blocks() == 2
    for a in (port, ref):
        a.free_slot(1)
        a.check_no_leaks()


def test_cross_set_blocks_admission_until_free():
    """With room for one cross set, the second enc-dec request waits at
    the admission gate for the first to retire (backpressure is a refusal
    at admission, never a mid-decode exhaustion), in both packages."""
    port, ref = _twins(4, 3, has_global=True, cross_tokens=4,
                       cross_cap_blocks=1)
    for alloc, sched_t, req_t in ((port, SlotScheduler, Request),
                                  (ref, JSlotScheduler, JRequest)):
        sched = sched_t(2, alloc, kv_len=8)
        sched.submit(req_t(rid=0, prompt=[1, 2, 3], max_new_tokens=4))
        sched.submit(req_t(rid=1, prompt=[4, 5, 6], max_new_tokens=4))
        admitted = sched.admit(now=0)
        assert [a.request.rid for a in admitted] == [0]
        assert sched.n_pending() == 1
        alloc.extend(0, 7)
        assert len(alloc.cross_tables[sched.active[0].slot]) == 1
        sched.finish(admitted[0].slot)
        second = sched.admit(now=1)
        assert [a.request.rid for a in second] == [1]
        sched.finish(second[0].slot)
        alloc.check_no_leaks()
    assert port._free == ref._free


def test_check_catches_a_broken_cross_set():
    """``check()`` refuses a cross set of the wrong size, one held by no
    live slot and a block owned twice, as it must to back the tests
    above."""
    from repro_torch.serve.cache import AllocatorInvariantError
    alloc, _ = _twins(4, 8, has_global=True, cross_tokens=6,
                      cross_cap_blocks=2)
    alloc.allocate(0, 4)
    alloc.cross_tables[0].append(alloc._free.pop())
    with pytest.raises(AllocatorInvariantError, match="cross set of 3"):
        alloc.check()
    alloc._free.append(alloc.cross_tables[0].pop())
    alloc.cross_tables[5] = [alloc._free.pop(), alloc._free.pop()]
    with pytest.raises(AllocatorInvariantError, match="held by no live"):
        alloc.check()
    del alloc.cross_tables[5]
    alloc.cross_tables[0][1] = alloc.tables[0][0]
    with pytest.raises(AllocatorInvariantError, match="owned twice"):
        alloc.check()


# =============================================================================
# contracts
# =============================================================================

def test_vlm_kv_len_alignment_error_names_frontend_rows(setup):
    """Paged lanes hold the frontend rows ahead of the prompt, so kv_len
    plus those rows must be block-aligned: 64 + 8 is not, 56 + 8 is."""
    _, cfg, _, tp = setup(VLM)
    with pytest.raises(ValueError, match="frontend rows"):
        ContinuousEngine(cfg, params={}, kv_len=64, paged=True,
                         device="cpu")
    eng = ContinuousEngine(cfg, tp, kv_len=56, paged=True, device="cpu")
    assert eng._max_blocks == 4


def test_encdec_prefill_without_embeddings_raises(setup):
    """A forgotten ``frontend_emb`` fails loudly in both packages: only
    the serving chunk path, which carries cross tables, may prefill
    without the encoder.  A VLM prefill needs its embeddings too."""
    jcfg, cfg, jp, tp = setup(ENCDEC)
    toks = np.array([[1, 2, 3]], np.int32)
    with pytest.raises(AssertionError, match="frontend_emb"):
        jlm.forward(jcfg, jp, jnp.asarray(toks),
                    cache=jlm.init_cache(jcfg, 1, 16, jnp.float32),
                    mode="prefill")
    with pytest.raises(ValueError, match="frontend_emb"):
        lm.forward(cfg, tp, torch.from_numpy(toks),
                   cache=lm.init_cache(cfg, 1, 16, torch.float32, "cpu"),
                   mode="prefill")
    with pytest.raises(ValueError, match="frontend_emb"):
        lm.forward(cfg, tp, torch.from_numpy(toks), mode="train",
                   impl="plain")
    _, vcfg, _, vtp = setup(VLM)
    with pytest.raises(ValueError, match="frontend_emb"):
        lm.forward(vcfg, vtp, torch.from_numpy(toks), mode="prefill")


def test_frontend_emb_submission_contract(setup):
    """Frontend and enc-dec requests must carry embeddings of the right
    shape, decoder-only requests none: the same refusals as the
    reference's engine."""
    jcfg, cfg, jp, tp = setup(VLM)
    dec = configs.get("tinyllama-1.1b").reduced()
    dec_p = lm.init_params(dec, torch.Generator().manual_seed(0), "cpu",
                           torch.float32)
    jdec = jconfigs.get("tinyllama-1.1b").reduced()
    jdec_p = jlm.init_params(jdec, jax.random.PRNGKey(0), jnp.float32)
    engines = ((ContinuousEngine(cfg, tp, kv_len=56, paged=True,
                                 device="cpu"),
                ContinuousEngine(dec, dec_p, kv_len=32, device="cpu"),
                torch.zeros),
               (JContinuousEngine(jcfg, jp, kv_len=56, paged=True),
                JContinuousEngine(jdec, jdec_p, kv_len=32),
                jnp.zeros))
    for eng, dec_eng, zeros in engines:
        with pytest.raises(ValueError, match="frontend_emb"):
            eng.submit([1, 2, 3], max_new_tokens=2)
        with pytest.raises(ValueError, match="shape"):
            eng.submit([1, 2, 3], max_new_tokens=2,
                       frontend_emb=zeros((3, 3)))
        with pytest.raises(ValueError, match="decoder-only"):
            dec_eng.submit([1, 2, 3], max_new_tokens=2,
                           frontend_emb=zeros((cfg.frontend_tokens,
                                               cfg.frontend_dim)))
        assert eng.scheduler.n_pending() == 0     # nothing was queued
