"""The port's RG-LRU layer and the reduced recurrentgemma-2b model against
the JAX package on the CPU, in f32.

Same weights (``repro.models.lm.init_params`` output carried across by
``repro_torch.convert``) and the same numpy-seeded inputs through both
packages.  Bars: 1e-4 max abs error on layer outputs, conv tails, states
and logits (f32 arithmetic in another order: the port's scan is
sequential, the reference's associative).  Covers the config copy,
``init_rglru``'s tree and distributions, ``_conv``, ``rglru_layer``
without a cache, prefill from a fresh and from a carried cache, one decode
step, and model logits in prefill (prompts longer than the window, so the
dense window cache fills as a ring) and decode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import rglru as jrglru
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm, rglru

ARCH = "recurrentgemma-2b"
TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _layer(jp, tp, r=0, ci=0):
    """Repeat ``r`` of cycle entry ``ci``'s RG-LRU parameters in both
    packages."""
    return (jax.tree.map(lambda a: a[r], jp["seg0"][f"c{ci}"]["rglru"]),
            {k: v[r] for k, v in tp["seg0"][f"c{ci}"]["rglru"].items()})


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _err(got, exp):
    return float(np.abs(np.asarray(got) - np.asarray(exp)).max())


def _leaf_specs(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_leaf_specs(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = (tuple(val.shape),
                                 str(val.dtype).split(".")[-1])
    return out


def test_config_has_the_reference_layer_pattern():
    full = configs.get(ARCH)
    mixers = [s.mixer for s in full.layers()]
    assert (mixers.count("rglru"), mixers.count("local")) == (18, 8)
    assert [(tuple(s.key for s in seg.cycle), seg.repeats)
            for seg in full.segments()] == [
        (("rglru+dense", "rglru+dense", "local+dense"), 8),
        (("rglru+dense",), 2)]
    assert (full.head_dim, full.n_heads, full.n_kv_heads, full.window_size,
            full.lru_width) == (256, 10, 1, 2048, 2560)
    small = configs.get(ARCH).reduced()
    assert (small.head_dim, small.n_kv_heads, small.window_size,
            small.lru_width) == (16, 1, 32, 64)
    assert lm.unsupported_reason(full) is None
    assert lm.serve_groups(small) == {"paged": (), "window": (2, 5),
                                      "recurrent": (0, 1, 3, 4),
                                      "cross": ()}


def test_init_params_tree_matches_reference():
    jcfg, cfg = jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                        torch.bfloat16)
    assert _leaf_specs(jp) == _leaf_specs(tp)
    leaf = tp["seg0"]["c0"]["rglru"]
    assert leaf["a_param"].dtype == torch.float32
    a = torch.exp(-8.0 * torch.nn.functional.softplus(leaf["a_param"]))
    assert a.min().item() > 0.9 - 1e-6 and a.max().item() < 0.999 + 1e-6
    conv = leaf["conv_w"].float()
    assert abs(conv.std().item() * np.sqrt(cfg.lru_block_width) - 1.0) < 0.2
    w = leaf["w_rg"].float()
    assert abs(w.std().item() * np.sqrt(cfg.lru_width) - 1.0) < 0.1
    assert not leaf["ln"].any()


@pytest.mark.parametrize("with_state", [False, True])
def test_conv_matches_jax(with_state):
    x, w = _x((2, 9, 24), 0), _x((4, 24), 1)
    st = _x((2, 3, 24), 2) if with_state else None
    exp = jrglru._conv(jnp.asarray(x), jnp.asarray(w),
                       None if st is None else jnp.asarray(st))
    got = rglru._conv(torch.from_numpy(x), torch.from_numpy(w),
                      None if st is None else torch.from_numpy(st))
    assert _err(got, exp) < TOL


@pytest.mark.parametrize("S", [1, 16, 37])
def test_rglru_layer_without_cache_matches_jax(model, S):
    jcfg, cfg, jp, tp = model
    jl, tl = _layer(jp, tp)
    x = _x((2, S, cfg.d_model), 3)
    exp, _ = jrglru.rglru_layer(jcfg, jl, jnp.asarray(x))
    for impl in ("kernel", "plain"):
        got, cache = rglru.rglru_layer(cfg, tl, torch.from_numpy(x),
                                       impl=impl)
        assert cache is None
        assert _err(got, exp) < TOL, impl


@pytest.mark.parametrize("carried", [False, True])
def test_prefill_into_cache_matches_jax(model, carried):
    """Output, conv tail and final state from a fresh cache (zeros) and
    from a cache a previous chunk left behind."""
    jcfg, cfg, jp, tp = model
    jl, tl = _layer(jp, tp, r=1, ci=1)
    x = _x((1, 21, cfg.d_model), 4)
    jc = jrglru.init_rglru_cache(jcfg, 1, jnp.float32)
    tc = rglru.init_rglru_cache(cfg, 1, torch.float32, "cpu")
    if carried:
        conv, state = _x(tuple(tc["conv"].shape), 5), \
            _x(tuple(tc["state"].shape), 6)
        jc = {"conv": jnp.asarray(conv), "state": jnp.asarray(state)}
        tc = {"conv": torch.from_numpy(conv),
              "state": torch.from_numpy(state)}
    exp, jnew = jrglru.rglru_layer(jcfg, jl, jnp.asarray(x), cache=jc)
    for impl in ("kernel", "plain"):
        got, new = rglru.rglru_layer(cfg, tl, torch.from_numpy(x), cache=tc,
                                     impl=impl)
        assert _err(got, exp) < TOL
        assert _err(new["conv"], jnew["conv"]) < TOL
        assert _err(new["state"], jnew["state"]) < TOL
        assert new["state"].dtype == torch.float32


def test_decode_step_matches_jax(model):
    jcfg, cfg, jp, tp = model
    jl, tl = _layer(jp, tp, r=0, ci=1)
    tc = rglru.init_rglru_cache(cfg, 3, torch.float32, "cpu")
    conv, state = _x(tuple(tc["conv"].shape), 7), \
        _x(tuple(tc["state"].shape), 8)
    x = _x((3, 1, cfg.d_model), 9)
    exp, jnew = jrglru.rglru_layer(jcfg, jl, jnp.asarray(x), cache={
        "conv": jnp.asarray(conv), "state": jnp.asarray(state)})
    cache = {"conv": torch.from_numpy(conv), "state": torch.from_numpy(state)}
    got, new = rglru.rglru_layer(cfg, tl, torch.from_numpy(x), cache=cache)
    assert _err(got, exp) < TOL
    assert _err(new["conv"], jnew["conv"]) < TOL
    assert _err(new["state"], jnew["state"]) < TOL
    # the layer returns the new leaves and leaves the cache alone
    assert np.array_equal(cache["state"].numpy(), state)


@pytest.mark.parametrize("S", [19, 45])
def test_model_logits_match_jax_in_prefill_and_decode(model, S):
    """Prompts shorter and longer than the window of 32 (the dense window
    cache then holds the last 32 rows as a ring), then decode steps that
    wrap the ring."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(10 + S)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, 2, 64, jnp.float32)
    tcache = lm.init_cache(cfg, 2, 64, torch.float32, "cpu")
    assert tcache["seg0"]["c2"]["attn"]["k"].shape[2] == 32
    jl, jcache, _ = jlm.forward(jcfg, jp, jnp.asarray(toks), cache=jcache,
                                mode="prefill")
    tl, tcache, _ = lm.forward(cfg, tp, torch.from_numpy(toks), cache=tcache,
                               mode="prefill")
    assert _err(tl, jl) < TOL
    for t in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = S + t
        jl, jcache, _ = jlm.forward(jcfg, jp, jnp.asarray(nxt),
                                    positions=jnp.asarray(pos, jnp.int32),
                                    cache=jcache, mode="decode")
        tl, tcache, _ = lm.forward(cfg, tp, torch.from_numpy(nxt),
                                   positions=torch.tensor(pos,
                                                          dtype=torch.int32),
                                   cache=tcache, mode="decode")
        assert _err(tl, jl) < TOL
    for key in ("conv", "state"):
        assert _err(tcache["seg0"]["c0"]["rglru"][key],
                    jcache["seg0"]["c0"]["rglru"][key]) < TOL
    attn, jattn = tcache["seg0"]["c2"]["attn"], jcache["seg0"]["c2"]["attn"]
    assert np.array_equal(attn["pos"].numpy(), np.asarray(jattn["pos"]))
    assert _err(attn["k"], jattn["k"]) < TOL
    # no cache (the reference's train-mode forward) agrees as well
    jl, _, _ = jlm.forward(jcfg, jp, jnp.asarray(toks), mode="train",
                           remat=False)
    for impl in ("kernel", "plain"):
        tl, _, _ = lm.forward(cfg, tp, torch.from_numpy(toks), impl=impl)
        assert _err(tl, jl) < TOL
