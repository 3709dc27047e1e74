"""The port's Mamba-2 SSD layer and the reduced mamba2-370m model against
the JAX package on the CPU, in f32.

Same weights (``repro.models.lm.init_params`` output carried across by
``repro_torch.convert``) and the same numpy-seeded inputs through both
packages.  Bars: 1e-4 max abs error on layer outputs, conv tails, states
and logits (f32 arithmetic in another order; the observed errors are
around 1e-6).  Covers ``init_ssd``'s tree, ``_causal_conv``, ``ssd_layer``
without a cache against JAX ``impl="chunked"`` and ``impl="pallas"``
(interpret mode), prefill from a fresh and from a carried cache, one
``_ssd_decode`` step, and model logits in prefill and decode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm, ssm

torch.set_num_threads(2)
ARCH = "mamba2-370m"
TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _layer(jp, tp, r=0):
    """Layer ``r``'s SSD parameters in both packages."""
    return (jax.tree.map(lambda a: a[r], jp["seg0"]["c0"]["ssd"]),
            {k: v[r] for k, v in tp["seg0"]["c0"]["ssd"].items()})


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


def test_config_has_the_reference_ssd_sizes():
    for j, p in ((jconfigs.get(ARCH), configs.get(ARCH)),
                 (jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced())):
        assert (p.d_inner, p.ssm_heads) == (j.d_inner, j.ssm_heads)
    full = configs.get(ARCH)
    assert (full.d_inner, full.ssm_heads, full.ssm_head_dim,
            full.ssm_state, full.n_layers) == (2048, 32, 64, 128, 48)
    assert configs.get("tinyllama-1.1b").ssm_heads == 0


def test_init_params_tree_matches_reference():
    jcfg, cfg = jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                        torch.bfloat16)
    assert _leaf_specs(jp) == _leaf_specs(tp)
    leaf = tp["seg0"]["c0"]["ssd"]
    assert leaf["A_log"].dtype == torch.float32 and not leaf["A_log"].any()
    assert (leaf["D"] == 1).all() and not leaf["dt_bias"].any()
    conv = leaf["conv_w"].float()
    assert abs(conv.std().item() * np.sqrt(cfg.d_conv) - 1.0) < 0.1
    w = leaf["w_xbc"].float()
    assert abs(w.std().item() * np.sqrt(cfg.d_model) - 1.0) < 0.05


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    x, w = _x((2, 9, 24), 0), _x((4, 24), 1)
    st = _x((2, 3, 24), 2) if with_state else None
    exp = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                            None if st is None else jnp.asarray(st))
    got = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                           None if st is None else torch.from_numpy(st))
    assert _err(got, exp) < TOL


@pytest.mark.parametrize("S", [16, 37])
def test_ssd_layer_without_cache_matches_jax_impls(model, S):
    jcfg, cfg, jp, tp = model
    jl, tl = _layer(jp, tp)
    x = _x((2, S, cfg.d_model), 3)
    for jimpl in ("chunked", "pallas"):
        exp, _ = jssm.ssd_layer(jcfg, jl, jnp.asarray(x), impl=jimpl)
        for impl in ("kernel", "plain"):
            got, cache = ssm.ssd_layer(cfg, tl, torch.from_numpy(x),
                                       impl=impl)
            assert cache is None
            assert _err(got, exp) < TOL, (jimpl, impl)


@pytest.mark.parametrize("carried", [False, True])
def test_prefill_into_cache_matches_jax(model, carried):
    """Output, conv tail and final state from a fresh cache (zeros) and
    from a cache a previous chunk left behind."""
    jcfg, cfg, jp, tp = model
    jl, tl = _layer(jp, tp, r=1)
    x = _x((1, 21, cfg.d_model), 4)
    jc = jssm.init_ssd_cache(jcfg, 1, jnp.float32)
    tc = ssm.init_ssd_cache(cfg, 1, torch.float32, "cpu")
    if carried:
        conv, state = _x(tuple(tc["conv"].shape), 5), \
            _x(tuple(tc["state"].shape), 6)
        jc = {"conv": jnp.asarray(conv), "state": jnp.asarray(state)}
        tc = {"conv": torch.from_numpy(conv),
              "state": torch.from_numpy(state)}
    exp, jnew = jssm.ssd_layer(jcfg, jl, jnp.asarray(x), cache=jc)
    for impl in ("kernel", "plain"):
        got, new = ssm.ssd_layer(cfg, tl, torch.from_numpy(x), cache=tc,
                                 impl=impl)
        assert _err(got, exp) < TOL
        assert _err(new["conv"], jnew["conv"]) < TOL
        assert _err(new["state"], jnew["state"]) < TOL
        assert new["state"].dtype == torch.float32


def test_decode_step_matches_jax(model):
    jcfg, cfg, jp, tp = model
    jl, tl = _layer(jp, tp, r=2)
    tc = ssm.init_ssd_cache(cfg, 3, torch.float32, "cpu")
    conv, state = _x(tuple(tc["conv"].shape), 7), \
        _x(tuple(tc["state"].shape), 8)
    x = _x((3, 1, cfg.d_model), 9)
    exp, jnew = jssm.ssd_layer(jcfg, jl, jnp.asarray(x), cache={
        "conv": jnp.asarray(conv), "state": jnp.asarray(state)})
    cache = {"conv": torch.from_numpy(conv), "state": torch.from_numpy(state)}
    got, new = ssm.ssd_layer(cfg, tl, torch.from_numpy(x), cache=cache)
    assert _err(got, exp) < TOL
    assert _err(new["conv"], jnew["conv"]) < TOL
    assert _err(new["state"], jnew["state"]) < TOL
    # the layer returns the new leaves and leaves the cache alone
    assert np.array_equal(cache["state"].numpy(), state)


def test_model_logits_match_jax_in_prefill_and_decode(model):
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab_size, (2, 19)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, 2, 32, jnp.float32)
    tcache = lm.init_cache(cfg, 2, 32, torch.float32, "cpu")
    jl, jcache, _ = jlm.forward(jcfg, jp, jnp.asarray(toks), cache=jcache,
                                mode="prefill")
    tl, tcache, _ = lm.forward(cfg, tp, torch.from_numpy(toks), cache=tcache,
                               mode="prefill")
    assert _err(tl, jl) < TOL
    for t in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = 19 + t
        jl, jcache, _ = jlm.forward(jcfg, jp, jnp.asarray(nxt),
                                    positions=jnp.asarray(pos, jnp.int32),
                                    cache=jcache, mode="decode")
        tl, tcache, _ = lm.forward(cfg, tp, torch.from_numpy(nxt),
                                   positions=torch.tensor(pos,
                                                          dtype=torch.int32),
                                   cache=tcache, mode="decode")
        assert _err(tl, jl) < TOL
    assert _err(tcache["seg0"]["c0"]["ssd"]["state"],
                jcache["seg0"]["c0"]["ssd"]["state"]) < TOL
    # no cache (the reference's train-mode forward) agrees as well
    jl, _, _ = jlm.forward(jcfg, jp, jnp.asarray(toks), mode="train",
                           remat=False, impl="pallas")
    tl, _, _ = lm.forward(cfg, tp, torch.from_numpy(toks))
    assert _err(tl, jl) < TOL
