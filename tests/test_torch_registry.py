"""The rest of the registry in the port against the JAX package, on the CPU
at the reduced sizes in f32 (the reference's weights carried across by
``repro_torch.convert``, numpy-seeded prompts): ``gemma2-9b`` (sliding-
window layers beside global ones, both softcaps, GeGLU, ``emb_scale``),
``minicpm-2b`` and ``command-r-35b`` (global attention, MHA and GQA) and
``mixtral-8x7b`` (sliding-window attention with an MoE FFN):

* the registry holds every arch of the reference's, each one runs, and
  each init tree has the reference's leaves (mixtral's ``unembed`` and
  f32 ``router``), carried across leaf for leaf;
* ``blocks.dense_init`` draws a stacked leaf slice by slice: N(0, 1/d_in)
  in the leaf's dtype, with no f32 copy of the leaf (peak allocation
  under twice its bytes);
* prefill logits over a prompt longer than the reduced window (32) and
  three dense decode steps after it, within 1e-4;
* gemma2's window rings beside its global tables: longer requests served
  by both packages' ``ContinuousEngine`` (paged, chunked, speculative,
  lazy pricing over an undersized pool) make the same allocator calls
  with the same results (claimed and freed blocks, the ring after each
  slide, rewinds of both groups) and the same tokens;
* gemma2 and mixtral refuse the prefix cache with the reference's reason;
* the launcher serves each arch.

Their engine-mode matrix is in ``test_torch_serve_modes.py``, minicpm's
and command-r's cached runs in ``test_torch_prefix_cache.py``, every
arch's routed fleet in ``test_torch_router.py``.

Seeds are fixed (local generators only); no Hypothesis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve import ContinuousEngine as JContinuousEngine
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import blocks, lm
from repro_torch.serve import ContinuousEngine, Engine

torch.set_num_threads(2)
GEMMA, MINICPM, COMMAND_R, MIXTRAL = ("gemma2-9b", "minicpm-2b",
                                      "command-r-35b", "mixtral-8x7b")
ARCHS = (GEMMA, MINICPM, COMMAND_R, MIXTRAL)
TOL = 1e-4
KV_LEN = 64


@pytest.fixture(scope="module")
def setup():
    """arch -> (jax cfg, port cfg, jax params, port params), built once
    per arch."""
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


def _leaves(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_leaves(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = val
    return out


# =============================================================================
# the registry, the init tree and dense_init
# =============================================================================

def test_registry_holds_every_reference_arch():
    assert configs.available() == jconfigs.available()
    assert len(configs.available()) == 11
    for name in configs.available():
        assert lm.unsupported_reason(configs.get(name)) is None, name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_and_convert_match_the_reference(setup, arch):
    """The port's init tree has the reference's leaves, shapes and dtypes
    (bf16 weights, mixtral's router in f32, an ``unembed`` only where the
    embeddings are untied), and ``params_from_numpy`` carries the
    reference's tree across leaf for leaf, exactly."""
    jcfg, cfg, jp, tp = setup(arch)
    jbf = _leaves(jax.eval_shape(lambda: jlm.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.bfloat16)))
    tbf = _leaves(lm.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu", torch.bfloat16))
    assert sorted(jbf) == sorted(tbf)
    assert ("unembed" in tbf) == (not cfg.tie_embeddings) == \
        (arch == MIXTRAL)
    for key, jleaf in jbf.items():
        assert tuple(jleaf.shape) == tuple(tbf[key].shape), key
        assert str(jleaf.dtype) == str(tbf[key].dtype).split(".")[-1], key
    routers = [k for k in tbf if k.endswith("/router")]
    assert bool(routers) == (arch == MIXTRAL)
    for key, leaf in _leaves(jp).items():
        assert np.array_equal(_leaves(tp)[key].numpy(), np.asarray(leaf)), key


def _peak_cpu_bytes(fn):
    """(fn(), the peak of the bytes the CPU allocator held during the call,
    over the allocations and frees the profiler recorded in order)."""
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        out = fn()
    live = peak = 0
    for evt in sorted(prof.events(), key=lambda e: e.time_range.start):
        live += evt.self_cpu_memory_usage
        peak = max(peak, live)
    return out, peak


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dense_init_draws_a_stacked_leaf_slice_by_slice(dtype):
    """A stacked leaf [8, 64, 512]: the reference's N(0, 1/d_in) (mean
    and variance within sampling error of ``jax.random.normal / sqrt(d_in)``
    over as many draws), the target dtype, and no f32 copy of the leaf
    (peak allocation under twice the leaf's bytes; one whole f32 draw
    before the cast would reach three times a bf16 leaf's)."""
    shape = (8, 64, 512)
    gen = torch.Generator().manual_seed(3)
    w, peak = _peak_cpu_bytes(
        lambda: blocks.dense_init(gen, shape, dtype, "cpu"))
    leaf_bytes = w.numel() * w.element_size()
    assert w.dtype == dtype and tuple(w.shape) == shape
    assert leaf_bytes <= peak < 2 * leaf_bytes
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(3), shape)
                     / np.sqrt(64.0))
    got = w.float().numpy()
    n = got.size
    # the sample mean's and variance's standard errors at n draws
    for sample in (got, ref):
        assert abs(sample.mean()) < 4 / np.sqrt(64.0 * n)
        assert abs(sample.var() * 64.0 - 1.0) < 4 * np.sqrt(2.0 / n)
    # the slices are independent draws, not one draw repeated
    assert not torch.equal(w[0], w[1])


# =============================================================================
# logits
# =============================================================================

@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax(setup, arch):
    """A 45-row prefill (past the reduced window of 32) through a dense
    cache of 64, then three decode steps, within 1e-4 of the reference:
    gemma2's softcaps, GeGLU and ``emb_scale``, mixtral's lossless MoE."""
    jcfg, cfg, jp, tp = setup(arch)
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab_size, (2, 45)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, 2, KV_LEN, jnp.float32)
    tcache = lm.init_cache(cfg, 2, KV_LEN, torch.float32, "cpu")
    jl, jcache, _ = jlm.forward(jcfg, jp, jnp.asarray(toks), cache=jcache,
                                mode="prefill")
    tl, tcache, _ = lm.forward(cfg, tp, torch.from_numpy(toks), cache=tcache,
                               mode="prefill")
    assert np.abs(tl.numpy() - np.asarray(jl)).max() < TOL
    for pos in (45, 46, 47):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache, _ = jlm.forward(jcfg, jp, jnp.asarray(nxt),
                                    positions=jnp.asarray(pos, jnp.int32),
                                    cache=jcache, mode="decode")
        tl, tcache, _ = lm.forward(cfg, tp, torch.from_numpy(nxt),
                                   positions=torch.tensor(pos,
                                                          dtype=torch.int32),
                                   cache=tcache, mode="decode")
        assert np.abs(tl.numpy() - np.asarray(jl)).max() < TOL, pos
    if cfg.final_logit_softcap:
        assert tl.abs().max() < cfg.final_logit_softcap


# =============================================================================
# gemma2: window rings beside global tables
# =============================================================================

RING_PROMPTS = (5, 40, 70, 23)
RING_BUDGETS = (30, 20, 12, 25)
RING_KV_LEN = 128
RING_ROWS = {
    "paged": {},
    "chunk8": {"prefill_chunk": 8},
    "speculate4": {"speculate": 4},
    # 10 blocks: under the worst-case price of two lanes, so growth runs
    # the pool dry and the youngest lane is preempted
    "lazy": {"pricing": "lazy", "cache_blocks": 10},
    # 8 blocks: a ring slide finds the pool empty where no preemption
    # frees it, and ``run`` raises (the same error in both packages)
    "lazy_exhausted": {"pricing": "lazy", "cache_blocks": 8},
}
_LOGGED = ("allocate", "extend", "extend_window", "truncate",
           "truncate_window", "free_slot")


def _log_allocator(alloc) -> list:
    """Record every ring and table call on ``alloc`` as (call, arguments,
    result or error type, the slot's ring and table after it)."""
    log: list = []
    for name in _LOGGED:
        fn = getattr(alloc, name)

        def logged(slot, *args, _fn=fn, _name=name, **kw):
            try:
                out = _fn(slot, *args, **kw)
            except Exception as exc:
                log.append((_name, slot, args, kw, type(exc).__name__))
                raise
            log.append((_name, slot, args, kw, _plain(out),
                        dict(alloc.window_tables.get(slot, {})),
                        list(alloc.tables.get(slot, []))))
            return out

        setattr(alloc, name, logged)
    return log


def _plain(out):
    if isinstance(out, (list, tuple)):
        return tuple(_plain(x) for x in out)
    return int(out) if out is not None else None


@pytest.mark.parametrize("row", list(RING_ROWS))
def test_gemma2_rings_and_tables_match_the_reference(setup, row):
    jcfg, cfg, jp, tp = setup(GEMMA)
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in RING_PROMPTS]
    kw = dict(kv_len=RING_KV_LEN, n_slots=2, paged=True, **RING_ROWS[row])
    outs, logs, engines = [], [], []
    for Eng, params, extra in ((ContinuousEngine, tp, {"device": "cpu"}),
                               (JContinuousEngine, jp, {})):
        eng = Eng(cfg if Eng is ContinuousEngine else jcfg, params, **kw,
                  **extra)
        logs.append(_log_allocator(eng.allocator))
        for i, (p, b) in enumerate(zip(prompts, RING_BUDGETS)):
            eng.submit(p, b, rid=i, arrival=3 * i)
        try:
            outs.append(eng.run())
        except Exception as exc:
            outs.append((type(exc).__name__, str(exc)))
        engines.append(eng)
    assert outs[0] == outs[1]
    assert logs[0] == logs[1]
    eng, jeng = engines
    # the self-sized pool: each lane's full global table and ring cap
    n_blocks = eng.allocator.config.n_blocks
    assert n_blocks == jeng.allocator.config.n_blocks
    if "cache_blocks" not in RING_ROWS[row]:
        assert n_blocks == 2 * (RING_KV_LEN // 16
                                + eng.allocator.layout.window_cap_blocks)
    if row == "lazy_exhausted":
        assert outs[0][0] == "CacheExhausted" and "window ring" in outs[0][1]
        return
    assert eng.scheduler.preemptions == jeng.scheduler.preemptions
    freed = [e for e in logs[0] if e[0] == "extend_window" and e[4][1]]
    assert freed, "no window ring freed a block"
    if row == "speculate4":
        assert any(e[0] == "truncate_window" and e[4] for e in logs[0])
        assert any(e[0] == "truncate" for e in logs[0])
        assert eng.telemetry.total_rewound_tokens() == \
            jeng.telemetry.total_rewound_tokens() > 0
    if row == "lazy":
        assert eng.scheduler.preemptions >= 1
    oracle = Engine(cfg, tp, kv_len=RING_KV_LEN, device="cpu")
    for i, (p, b) in enumerate(zip(prompts, RING_BUDGETS)):
        assert outs[0][i] == oracle.generate(torch.tensor([p]),
                                             b)[0].tolist(), (row, i)
    eng.allocator.check_no_leaks()


@pytest.mark.parametrize("arch", (GEMMA, MIXTRAL))
def test_window_archs_refuse_the_prefix_cache_like_the_reference(setup,
                                                                 arch):
    jcfg, cfg, _, _ = setup(arch)
    assert lm.prefix_sharable_reason(cfg) == jlm.prefix_sharable_reason(jcfg)
    assert "sliding-window" in lm.prefix_sharable_reason(cfg)
    msgs = []
    for bad, Eng, extra in ((cfg, ContinuousEngine, {"device": "cpu"}),
                            (jcfg, JContinuousEngine, {})):
        with pytest.raises(ValueError,
                           match="prefix cache unavailable") as err:
            Eng(bad, {}, kv_len=KV_LEN, paged=True, prefix_cache=True,
                **extra)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# =============================================================================
# the launcher
# =============================================================================

@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_each_arch_on_cpu(capsys, arch):
    """``--arch`` with ``--reduced`` on the CPU: bucketed paged lanes with
    16-row chunks give the dense lanes' tokens; the window archs report
    their ring group and run ``--disaggregate`` as co-located replicas
    with the reference's reason, minicpm and command-r as prefill/decode
    replicas."""
    from repro_torch.launch import serve as launch_serve
    base = ["--arch", arch, "--reduced", "--continuous", "--device", "cpu",
            "--requests", "3", "--prompt-len", "40", "--max-new", "4",
            "--kv-len", "96"]
    launch_serve.main(base + ["--paged", "--bucket", "--chunk-prefill",
                              "16"])
    chunked = capsys.readouterr().out
    launch_serve.main(base + ["--bucket"])
    dense = capsys.readouterr().out
    assert "3 requests, 12 tokens" in chunked and "chunks=" in chunked
    assert "dense lanes" in dense
    assert chunked.splitlines()[-1] == dense.splitlines()[-1]
    groups = lm.serve_groups(configs.get(arch))
    assert ("window=" in chunked) == bool(groups["window"])
    assert ("global=" in chunked) == bool(groups["paged"])
    launch_serve.main(base + ["--paged", "--replicas", "2",
                              "--disaggregate"])
    routed = capsys.readouterr().out
    if groups["window"]:
        assert "disaggregation unavailable (sliding-window layers" in routed
        assert "(mixed/mixed)" in routed
    else:
        assert "over 2 replicas (prefill/decode)" in routed
