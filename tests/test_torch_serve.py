"""The port's model and engines against the JAX package, end to end, on the
CPU at the reduced TinyLlama size in f32.

Same weights (``repro.models.lm.init_params`` output carried across by
``repro_torch.convert``) and the same prompts through both packages:
``lm.forward`` logits within 1e-4 in prefill and decode; greedy tokens
identical to the JAX ``Engine`` and ``ContinuousEngine(paged=True)``; the
port's ``ContinuousEngine(paged=True)`` token-identical to its own
``Engine`` per request.  Also the port's config copy, parameter init and
conversion, its refusals, and its device rule.
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
from repro_torch.serve import ContinuousEngine, Engine

torch.set_num_threads(2)
ARCH = "tinyllama-1.1b"
KV_LEN = 48


def _pair(**changes):
    """(jax cfg, port cfg, jax params, port params) on the same weights."""
    jcfg = jconfigs.get(ARCH).reduced().replace(**changes)
    cfg = configs.get(ARCH).reduced().replace(**changes)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def models():
    return _pair()


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
    configs built from the reference's fields), and the port's refusal of
    every arch that is not all global attention with dense FFNs."""
    from repro.models.config import ModelConfig as JModelConfig
    from repro_torch.models.config import ModelConfig
    for name in jconfigs.available():
        jcfg = jconfigs.get(name)
        assert isinstance(jcfg, JModelConfig)
        cfg = ModelConfig(**dataclasses.asdict(jcfg))
        ref = jlm.serve_groups(jcfg)
        assert lm.serve_groups(cfg) == {k: ref[k] for k in
                                        ("paged", "window", "recurrent")}
        plain = all(s.key == "global+dense" for s in cfg.layers()) and \
            not cfg.n_enc_layers and not cfg.frontend
        assert (lm.unsupported_reason(cfg) is None) == plain, name


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
    tl, tcache = lm.forward(cfg, tp, torch.from_numpy(toks), cache=tcache,
                            mode="prefill")
    assert np.abs(tl.numpy() - np.asarray(jl)).max() < 1e-4
    if cfg.padded_vocab != cfg.vocab_size:
        assert (tl[..., cfg.vocab_size:] == -1e30).all()
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jl, _, _ = jlm.forward(jcfg, jp, jnp.asarray(nxt),
                           positions=jnp.asarray(13, jnp.int32),
                           cache=jcache, mode="decode")
    tl, _ = lm.forward(cfg, tp, torch.from_numpy(nxt),
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
    for flag in ({"bucket_prompts": True}, {"prefill_chunk": 16},
                 {"prefix_cache": True}, {"speculate": 2}, {"paged": False}):
        opts = {"paged": True, **flag}
        with pytest.raises(NotImplementedError):
            ContinuousEngine(cfg, tp, **opts, **kw)
    eng = ContinuousEngine(cfg, tp, paged=True, **kw)
    with pytest.raises(NotImplementedError, match="sampling"):
        eng.submit([1, 2], 3, sampling=object())
    with pytest.raises(ValueError, match="divisible"):
        ContinuousEngine(cfg, tp, paged=True, kv_len=40, block_size=16,
                         device="cpu")
    local = cfg.replace(layer_cycle=(("local", "dense"),), window_size=8)
    with pytest.raises(NotImplementedError, match="not ported"):
        Engine(local, tp, **kw)


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


def test_launcher_serves_on_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--reduced", "--continuous",
                       "--paged", "--device", "cpu", "--requests", "3",
                       "--prompt-len", "6", "--max-new", "4",
                       "--kv-len", "32"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
    launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "5", "--max-new",
                       "3", "--kv-len", "16"])
    assert "generated (2, 3)" in capsys.readouterr().out
