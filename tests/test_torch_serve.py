"""The port's model and engines against the JAX package, end to end, on the
CPU at the reduced TinyLlama, mamba2-370m and recurrentgemma-2b sizes in
f32.

Same weights (``repro.models.lm.init_params`` output carried across by
``repro_torch.convert``) and the same prompts through both packages:
``lm.forward`` logits within 1e-4 in prefill and decode; greedy tokens
identical to the JAX ``Engine`` and ``ContinuousEngine(paged=True)``; the
port's ``ContinuousEngine(paged=True)`` token-identical to its own
``Engine`` per request (for mamba2 with more requests than lanes, so
lanes and their state slabs are reused, and with retired lanes whose slabs
the batched step must leave alone; for recurrentgemma with prompts longer
than the window, so that window rings free blocks, and with the same
residency by cache group as the JAX engine).  Also the port's config copy,
parameter init and conversion, its refusals, its device rule, and the
launcher in each arch's paged, bucketed and chunked paged, and dense-lane
continuous modes (``tests/test_torch_serve_modes.py`` holds the modes
themselves against JAX).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Engine as JEngine
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve import ContinuousEngine, Engine, make_paged_decode_step

torch.set_num_threads(2)
ARCH = "tinyllama-1.1b"
SSM_ARCH = "mamba2-370m"
RG_ARCH = "recurrentgemma-2b"
KV_LEN = 48
RG_KV_LEN = 96


def _pair(arch=ARCH, **changes):
    """(jax cfg, port cfg, jax params, port params) on the same weights."""
    jcfg = jconfigs.get(arch).reduced().replace(**changes)
    cfg = configs.get(arch).reduced().replace(**changes)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module")
def ssm_models():
    return _pair(SSM_ARCH)


@pytest.fixture(scope="module")
def rg_models():
    return _pair(RG_ARCH)


def _prompts(n, lens, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n_tok).tolist()
            for n_tok in lens[:n]]


def _shapes(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_shapes(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = tuple(val.shape)
    return out


def test_config_copy_matches_reference():
    for name in configs.available():
        for j, p in ((jconfigs.get(name), configs.get(name)),
                     (jconfigs.get(name).reduced(),
                      configs.get(name).reduced())):
            assert dataclasses.asdict(j) == dataclasses.asdict(p)
            assert [(tuple(s.key for s in seg.cycle), seg.repeats)
                    for seg in j.segments()] == \
                [(tuple(s.key for s in seg.cycle), seg.repeats)
                 for seg in p.segments()]
            assert j.padded_vocab == p.padded_vocab
    odd = configs.get(ARCH).replace(vocab_size=500)
    assert odd.padded_vocab == jconfigs.get(ARCH).replace(
        vocab_size=500).padded_vocab == 2048


def test_serve_groups_match_reference():
    """The per-layer cache-group report over every registry arch (ported
    configs built from the reference's fields), the enc-dec cross overlay
    included, and the port's refusal of every arch with a layer kind other
    than global attention or RG-LRU with a dense FFN, sliding-window
    attention or MLA with a dense or an MoE FFN, or SSD with no FFN,
    whether decoder-only, behind a modality frontend or under an encoder:
    every arch of the registry runs."""
    from repro.models.config import ModelConfig as JModelConfig
    from repro_torch.models.config import ModelConfig
    for name in jconfigs.available():
        jcfg = jconfigs.get(name)
        assert isinstance(jcfg, JModelConfig)
        cfg = ModelConfig(**dataclasses.asdict(jcfg))
        ref = jlm.serve_groups(jcfg)
        assert lm.serve_groups(cfg) == {k: ref[k] for k in
                                        ("paged", "window", "recurrent",
                                         "cross")}
        plain = {s.key for s in cfg.layers()} <= {
            "global+dense", "local+dense", "local+moe", "ssd+none",
            "rglru+dense", "mla+dense", "mla+moe"}
        assert plain and lm.unsupported_reason(cfg) is None, name
    assert lm.unsupported_reason(configs.get(SSM_ARCH)) is None


def test_init_params_tree_matches_reference():
    jcfg, cfg = jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    gen = torch.Generator().manual_seed(0)
    tp = lm.init_params(cfg, gen, "cpu", torch.float32)
    assert _shapes(jp) == _shapes(tp)
    assert abs(tp["embed"].std().item() - 0.02) < 0.002
    wq = tp["seg0"]["c0"]["attn"]["wq"]
    assert abs(wq.std().item() * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert not tp["final_norm"].any()


def test_convert_is_exact_from_bf16_and_checks_keys():
    jcfg, cfg = jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(1), jnp.bfloat16)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu",
                           torch.bfloat16)
    exp = np.asarray(jp["seg0"]["c0"]["ffn"]["w_up"]).astype(np.float32)
    assert np.array_equal(
        tp["seg0"]["c0"]["ffn"]["w_up"].float().numpy(), exp)
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(cfg.replace(tie_embeddings=True),
                          jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("changes", [
    {}, {"tie_embeddings": True}, {"vocab_size": 500},
    {"emb_scale": True, "final_logit_softcap": 30.0,
     "attn_logit_softcap": 50.0}])
def test_forward_logits_match_jax(changes):
    jcfg, cfg, jp, tp = _pair(**changes)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, 2, 32, jnp.float32)
    tcache = lm.init_cache(cfg, 2, 32, torch.float32, "cpu")
    jl, jcache, _ = jlm.forward(jcfg, jp, jnp.asarray(toks), cache=jcache,
                                mode="prefill")
    tl, tcache, _ = lm.forward(cfg, tp, torch.from_numpy(toks), cache=tcache,
                               mode="prefill")
    assert np.abs(tl.numpy() - np.asarray(jl)).max() < 1e-4
    if cfg.padded_vocab != cfg.vocab_size:
        assert (tl[..., cfg.vocab_size:] == -1e30).all()
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jl, _, _ = jlm.forward(jcfg, jp, jnp.asarray(nxt),
                           positions=jnp.asarray(13, jnp.int32),
                           cache=jcache, mode="decode")
    tl, _, _ = lm.forward(cfg, tp, torch.from_numpy(nxt),
                          positions=torch.tensor(13, dtype=torch.int32),
                          cache=tcache, mode="decode")
    assert np.abs(tl.numpy() - np.asarray(jl)).max() < 1e-4


def test_engine_tokens_match_jax_engine(models):
    jcfg, cfg, jp, tp = models
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
    exp = np.asarray(JEngine(jcfg, jp, kv_len=KV_LEN).generate(
        jnp.asarray(toks), 10))
    for impl in ("kernel", "plain"):
        got = Engine(cfg, tp, kv_len=KV_LEN, impl=impl,
                     device="cpu").generate(torch.from_numpy(toks), 10)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), exp)


def test_continuous_engine_matches_both_engines(models):
    """Staggered requests through the port's paged engine: per request
    identical to the JAX paged engine and to the port's own B=1 Engine."""
    jcfg, cfg, jp, tp = models
    prompts = _prompts(5, [5, 17, 9, 30, 3], cfg.vocab_size, seed=3)
    max_new = [8, 12, 1, 10, 15]
    jeng = JContinuousEngine(jcfg, jp, kv_len=KV_LEN, n_slots=2, paged=True)
    eng = ContinuousEngine(cfg, tp, kv_len=KV_LEN, n_slots=2, paged=True,
                           device="cpu")
    for e in (jeng, eng):
        for i, (p, m) in enumerate(zip(prompts, max_new)):
            e.submit(p, m, rid=i, arrival=2 * i)
    exp, got = jeng.run(), eng.run()
    oracle = Engine(cfg, tp, kv_len=KV_LEN, device="cpu")
    for i, (p, m) in enumerate(zip(prompts, max_new)):
        assert got[i] == exp[i]
        assert got[i] == oracle.generate(torch.tensor([p]), m)[0].tolist()
    eng.allocator.check()
    assert eng.allocator.n_in_use == 0
    tel = eng.telemetry
    assert tel.total_tokens() == sum(max_new)
    assert tel.max_concurrency() == 2
    assert tel.mean_decode_step_ms() > 0 and tel.mean_prefill_ms() > 0


def test_continuous_engine_plain_equals_kernel_path_on_cpu(models):
    _, cfg, _, tp = models
    prompts = _prompts(3, [7, 20, 4], cfg.vocab_size, seed=4)
    outs = []
    for impl in ("kernel", "plain"):
        eng = ContinuousEngine(cfg, tp, kv_len=KV_LEN, n_slots=2, paged=True,
                               impl=impl, device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(p, 6, rid=i, eos_id=None)
        outs.append(eng.run())
    assert outs[0] == outs[1]


def test_engines_refuse_what_is_not_ported(models):
    _, cfg, _, tp = models
    kw = dict(kv_len=KV_LEN, device="cpu")
    # the prefix cache shares physical pages (the reference's check)
    with pytest.raises(ValueError, match="prefix_cache requires paged"):
        ContinuousEngine(cfg, tp, paged=False, prefix_cache=True, **kw)
    # the reference's checks: chunks are written into the page pools, and
    # the speculative rewind truncates block tables
    with pytest.raises(ValueError, match="prefill_chunk requires paged"):
        ContinuousEngine(cfg, tp, paged=False, prefill_chunk=16, **kw)
    with pytest.raises(ValueError, match="speculate requires paged"):
        ContinuousEngine(cfg, tp, paged=False, speculate=2, **kw)
    for bad in ({"speculate": -1}, {"draft_layers": 0},
                {"pricing": "eager"}, {"cache_blocks": 0}):
        with pytest.raises(ValueError):
            ContinuousEngine(cfg, tp, paged=True, **bad, **kw)
    eng = ContinuousEngine(cfg, tp, paged=True, **kw)
    with pytest.raises(ValueError, match="SamplingParams"):
        eng.submit([1, 2], 3, sampling=object())
    with pytest.raises(ValueError, match="divisible"):
        ContinuousEngine(cfg, tp, paged=True, kv_len=40, block_size=16,
                         device="cpu")
    # no arch of the registry has global attention with an MoE FFN
    global_moe = cfg.replace(layer_cycle=(("global", "moe"),), n_experts=4,
                             experts_per_token=2, d_ff_expert=64)
    with pytest.raises(NotImplementedError, match="not ported"):
        Engine(global_moe, tp, **kw)


def test_entry_points_need_a_card_unless_told_cpu(models, monkeypatch):
    _, cfg, _, tp = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, tp, kv_len=KV_LEN)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousEngine(cfg, tp, kv_len=KV_LEN, paged=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg, torch.Generator(), dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", ARCH, "--reduced"])


def _launch_modes(capsys, arch, *args):
    """The continuous launcher with ``args`` in the README's bucketed and
    chunked paged mode and with dense lanes; returns both outputs."""
    outs = []
    for mode in (["--paged", "--bucket", "--chunk-prefill", "8"], []):
        launch_serve.main(["--arch", arch, "--reduced", "--continuous",
                           "--device", "cpu", *mode, *args])
        outs.append(capsys.readouterr().out)
    return outs


def test_launcher_serves_on_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--reduced", "--continuous",
                       "--paged", "--device", "cpu", "--requests", "3",
                       "--prompt-len", "6", "--max-new", "4",
                       "--kv-len", "32"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
    chunked, dense = _launch_modes(capsys, ARCH, "--requests", "3",
                                   "--prompt-len", "19", "--max-new", "4",
                                   "--kv-len", "32")
    assert "3 requests, 12 tokens" in chunked and "chunks=9 " in chunked
    assert "3 requests, 12 tokens" in dense and "dense lanes" in dense
    assert chunked.splitlines()[-1] == dense.splitlines()[-1]
    launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "5", "--max-new",
                       "3", "--kv-len", "16"])
    assert "generated (2, 3)" in capsys.readouterr().out


def test_ssm_engines_match_jax_engines(ssm_models):
    """mamba2 through both packages: the port's Engine against the JAX
    Engine, and staggered requests, more than lanes, through the port's
    paged engine against the JAX paged engine and the port's B=1 Engine."""
    jcfg, cfg, jp, tp = ssm_models
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    exp = np.asarray(JEngine(jcfg, jp, kv_len=KV_LEN).generate(
        jnp.asarray(toks), 7))
    for impl in ("kernel", "plain"):
        got = Engine(cfg, tp, kv_len=KV_LEN, impl=impl,
                     device="cpu").generate(torch.from_numpy(toks), 7)
        assert np.array_equal(got.numpy(), exp)

    prompts = _prompts(6, [5, 17, 9, 30, 3, 12], cfg.vocab_size, seed=6)
    max_new = [8, 12, 1, 10, 15, 6]
    jeng = JContinuousEngine(jcfg, jp, kv_len=KV_LEN, n_slots=2, paged=True)
    eng = ContinuousEngine(cfg, tp, kv_len=KV_LEN, n_slots=2, paged=True,
                           device="cpu")
    for e in (jeng, eng):
        for i, (p, m) in enumerate(zip(prompts, max_new)):
            e.submit(p, m, rid=i, arrival=2 * i)
    exp, got = jeng.run(), eng.run()
    oracle = Engine(cfg, tp, kv_len=KV_LEN, device="cpu")
    for i, (p, m) in enumerate(zip(prompts, max_new)):
        assert got[i] == exp[i]
        assert got[i] == oracle.generate(torch.tensor([p]), m)[0].tolist()
    assert eng.scheduler.max_slot_reuse() >= 3
    eng.allocator.check()
    assert eng.allocator.n_blocks == eng.allocator.n_in_use == 0
    assert eng.allocator.state_slots_in_use() == 0
    tel = eng.telemetry
    assert tel.total_tokens() == sum(max_new)
    per_slot = lm.state_bytes_per_slot(cfg, eng._caches)
    assert tel.peak_resident_bytes_by_group() == {"recurrent": 2 * per_slot}
    assert eng.allocator.capacity_bytes() == 2 * per_slot


def _slab_copies(cfg, caches):
    return [{k: t.clone() for k, t in leaf.items()}
            for leaf in lm.state_cache_leaves(cfg, caches)]


def test_freeze_state_lanes_keeps_retired_lanes(ssm_models):
    """One batched paged decode step over two lanes, lane 1 retired: with
    ``freeze_state_lanes`` (the engine's decode step) its slabs keep their
    bytes and lane 0's advance; without it (the plain forward writing every
    lane) lane 1's slabs would take its garbage token."""
    _, cfg, _, tp = ssm_models
    caches = lm.init_paged_caches(cfg, 2, 1, 16, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(3)
    for leaf in lm.state_cache_leaves(cfg, caches):
        for t in leaf.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    before = _slab_copies(cfg, caches)
    toks = torch.tensor([7, 11], dtype=torch.int32)
    pos = torch.tensor([5, 9], dtype=torch.int32)
    active = torch.tensor([True, False])
    step = make_paged_decode_step(cfg)
    _, caches = step(tp, caches, toks, pos, {}, active)
    after = _slab_copies(cfg, caches)
    for old, new in zip(before, after):
        for k in old:
            assert torch.equal(new[k][:, 1], old[k][:, 1])
            assert not torch.equal(new[k][:, 0], old[k][:, 0])

    # the same step without the freeze moves the retired lane's slabs
    unfrozen = lm.init_paged_caches(cfg, 2, 1, 16, torch.float32, "cpu")
    for leaf, snap in zip(lm.state_cache_leaves(cfg, unfrozen), before):
        for k, t in leaf.items():
            t.copy_(snap[k])
    lm.forward(cfg, tp, toks[:, None], positions=pos, cache=unfrozen,
               mode="decode")
    moved = _slab_copies(cfg, unfrozen)
    for old, new, frozen in zip(before, moved, after):
        for k in old:
            assert not torch.equal(new[k][:, 1], old[k][:, 1])
            assert torch.equal(new[k][:, 0], frozen[k][:, 0])


def test_ssm_launcher_serves_on_cpu(capsys):
    launch_serve.main(["--arch", SSM_ARCH, "--reduced", "--continuous",
                       "--paged", "--device", "cpu", "--requests", "3",
                       "--prompt-len", "6", "--max-new", "4",
                       "--kv-len", "32"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
    assert "0 layer pools" in out and "recurrent=" in out
    chunked, dense = _launch_modes(capsys, SSM_ARCH, "--requests", "3",
                                   "--prompt-len", "6", "--max-new", "4",
                                   "--kv-len", "32")
    assert "3 requests, 12 tokens" in chunked and "chunks=3 " in chunked
    assert "3 requests, 12 tokens" in dense and "dense lanes" in dense
    assert chunked.splitlines()[-1] == dense.splitlines()[-1]
    launch_serve.main(["--arch", SSM_ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "5", "--max-new",
                       "3", "--kv-len", "16"])
    assert "generated (2, 3)" in capsys.readouterr().out


def test_rg_engines_match_jax_engines(rg_models):
    """recurrentgemma through both packages: the port's Engine against the
    JAX Engine on prompts longer than the window of 32, and staggered
    requests, more than lanes, through the port's paged engine against the
    JAX paged engine and the port's B=1 Engine.  Window rings slide and
    free blocks; the residency by cache group matches the JAX engine's
    step for step."""
    jcfg, cfg, jp, tp = rg_models
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 41)).astype(np.int32)
    exp = np.asarray(JEngine(jcfg, jp, kv_len=RG_KV_LEN).generate(
        jnp.asarray(toks), 9))
    for impl in ("kernel", "plain"):
        got = Engine(cfg, tp, kv_len=RG_KV_LEN, impl=impl,
                     device="cpu").generate(torch.from_numpy(toks), 9)
        assert np.array_equal(got.numpy(), exp)

    prompts = _prompts(6, [40, 50, 9, 70, 35, 12], cfg.vocab_size, seed=8)
    max_new = [20, 12, 1, 10, 30, 6]
    jeng = JContinuousEngine(jcfg, jp, kv_len=RG_KV_LEN, n_slots=2,
                             paged=True)
    eng = ContinuousEngine(cfg, tp, kv_len=RG_KV_LEN, n_slots=2, paged=True,
                           device="cpu")
    for e in (jeng, eng):
        for i, (p, m) in enumerate(zip(prompts, max_new)):
            e.submit(p, m, rid=i, arrival=2 * i)
    freed = []
    extend_window = eng.allocator.extend_window

    def counting(slot, n_tokens_total):
        fresh, gone = extend_window(slot, n_tokens_total)
        freed.extend(gone)
        return fresh, gone

    eng.allocator.extend_window = counting
    exp, got = jeng.run(), eng.run()
    oracle = Engine(cfg, tp, kv_len=RG_KV_LEN, device="cpu")
    for i, (p, m) in enumerate(zip(prompts, max_new)):
        assert got[i] == exp[i]
        assert got[i] == oracle.generate(torch.tensor([p]), m)[0].tolist()
    assert freed, "no ring block fell behind the window"
    assert eng.scheduler.max_slot_reuse() >= 3
    eng.allocator.check()
    assert eng.allocator.n_in_use == 0 and not eng.allocator.window_tables
    assert eng.allocator.state_slots_in_use() == 0
    # pool: 2 lanes x a ring cap of blocks_for(32) + 1 = 3 blocks
    assert eng.allocator.n_blocks == jeng.allocator.n_blocks == 6
    assert [s.resident_by_group for s in eng.telemetry.steps] == \
        [s.resident_by_group for s in jeng.telemetry.steps]
    peak = eng.telemetry.peak_resident_bytes_by_group()
    assert set(peak) == {"window", "recurrent"}
    block_bytes = sum(s.block_bytes for s in eng.allocator.stores)
    assert peak["window"] <= 6 * block_bytes
    assert peak["recurrent"] == 2 * lm.state_bytes_per_slot(cfg,
                                                            eng._caches)


def test_rg_launcher_serves_on_cpu(capsys):
    launch_serve.main(["--arch", RG_ARCH, "--reduced", "--continuous",
                       "--paged", "--device", "cpu", "--requests", "3",
                       "--prompt-len", "40", "--max-new", "5",
                       "--kv-len", "64"])
    out = capsys.readouterr().out
    assert "3 requests, 15 tokens" in out
    assert "1 layer pools" in out and "window=" in out and \
        "recurrent=" in out
    chunked, dense = _launch_modes(capsys, RG_ARCH, "--requests", "3",
                                   "--prompt-len", "40", "--max-new", "5",
                                   "--kv-len", "64")
    assert "3 requests, 15 tokens" in chunked and "chunks=15 " in chunked
    assert "window=" in chunked
    assert "3 requests, 15 tokens" in dense and "dense lanes" in dense
    assert chunked.splitlines()[-1] == dense.splitlines()[-1]
    launch_serve.main(["--arch", RG_ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "40", "--max-new",
                       "3", "--kv-len", "64"])
    assert "generated (2, 3)" in capsys.readouterr().out
