"""The port's multi-head latent attention against the JAX package on the
CPU, in f32, at the reduced deepseek-v2-lite-16b size (4 heads, qk 8 + 8,
v 16, latent 32).

Same weights (``repro.models.lm.init_params`` output carried across by
``repro_torch.convert``) and the same numpy-seeded inputs through both
packages.  Bars: 1e-5 max abs error on layer outputs and cache leaves, 1e-4
on model logits (f32 arithmetic in another order).  Covers ``mla_layer``'s
prefill against the reference's ``impl="chunked"`` path (its Pallas path
returns the wrong width, F2, pinned below), the dense cache it fills,
``_mla_decode`` steps, ``_mla_paged`` in its batched-decode and chunk
shapes, attention with a V head dim apart from Q's (qk 24, v 16) through
the port's plain flash version and ``blocks.attention``, the flash
wrapper's refusal of every split pair but (192, 128), the reduced
model's logits in prefill and decode, and the launcher on the arch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention import ops as jfa_ops
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import mla as jmla
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import blocks, lm, mla

torch.set_num_threads(2)
ARCH = "deepseek-v2-lite-16b"
TOL = 1e-5
LOGIT_TOL = 1e-4
KV_LEN = 48


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _layer(jp, tp, seg="seg1", r=0):
    """An MLA layer's parameters in both packages."""
    return (jax.tree.map(lambda a: a[r], jp[seg]["c0"]["mla"]),
            {k: v[r] for k, v in tp[seg]["c0"]["mla"].items()})


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _err(got, exp):
    return float(np.abs(np.asarray(got) - np.asarray(exp)).max())


def _close(got: dict, exp: dict):
    assert got.keys() == exp.keys()
    for key in exp:
        assert _err(got[key], exp[key]) < TOL, key


def test_config_has_the_reference_mla_sizes():
    full = configs.get(ARCH)
    assert (full.n_heads, full.n_kv_heads, full.qk_nope_dim,
            full.qk_rope_dim, full.v_head_dim, full.kv_lora_rank,
            full.q_lora_rank) == (16, 16, 128, 64, 128, 512, 0)
    assert lm.serve_groups(full)["paged"] == tuple(range(27))
    assert lm.prefix_sharable_reason(full) is None


@pytest.mark.parametrize("S", (9, 20))
def test_mla_prefill_matches_chunked_reference(model, S):
    """No cache, and a prefill filling a dense cache (its ckv, krope and
    pos leaves)."""
    jcfg, cfg, jp, tp = model
    jl, tl = _layer(jp, tp, r=S % 3)
    x = _x((2, S, cfg.d_model), seed=S)
    pos = np.arange(S, dtype=np.int32)
    jout, _ = jmla.mla_layer(jcfg, jl, jnp.asarray(x),
                             positions=jnp.asarray(pos), impl="chunked")
    jcache = jmla.init_mla_cache(jcfg, 2, KV_LEN, jnp.float32)
    jout_c, jcache = jmla.mla_layer(jcfg, jl, jnp.asarray(x),
                                    positions=jnp.asarray(pos),
                                    cache=jcache, impl="chunked")
    tcache = mla.init_mla_cache(cfg, 2, KV_LEN, torch.float32, "cpu")
    with torch.no_grad():
        out, none = mla.mla_layer(cfg, tl, torch.from_numpy(x),
                                  positions=torch.from_numpy(pos))
        out_c, tcache = mla.mla_layer(cfg, tl, torch.from_numpy(x),
                                      positions=torch.from_numpy(pos),
                                      cache=tcache)
    assert none is None
    assert out.shape == (2, S, cfg.d_model)
    assert _err(out, jout) < TOL and _err(out_c, jout_c) < TOL
    _close(tcache, jcache)


def test_mla_decode_matches_reference(model):
    """A 13-row prefill, then three ``_mla_decode`` steps: each step's
    output and the dense latent cache after it."""
    jcfg, cfg, jp, tp = model
    jl, tl = _layer(jp, tp, seg="seg0")
    x = _x((1, 16, cfg.d_model), seed=5)
    pos = np.arange(13, dtype=np.int32)
    jcache = jmla.init_mla_cache(jcfg, 1, KV_LEN, jnp.float32)
    _, jcache = jmla.mla_layer(jcfg, jl, jnp.asarray(x[:, :13]),
                               positions=jnp.asarray(pos), cache=jcache)
    tcache = mla.init_mla_cache(cfg, 1, KV_LEN, torch.float32, "cpu")
    with torch.no_grad():
        mla.mla_layer(cfg, tl, torch.from_numpy(x[:, :13]),
                      positions=torch.from_numpy(pos), cache=tcache)
        for t in range(13, 16):
            jout, jcache = jmla.mla_layer(
                jcfg, jl, jnp.asarray(x[:, t:t + 1]),
                positions=jnp.asarray(t, jnp.int32), cache=jcache)
            out, tcache = mla.mla_layer(
                cfg, tl, torch.from_numpy(x[:, t:t + 1]),
                positions=torch.tensor(t, dtype=torch.int32), cache=tcache)
            assert _err(out, jout) < TOL, t
            _close(tcache, jcache)


def _pools(jcfg, cfg, n_pages, bs, seed):
    """The same random latent pools in both packages."""
    jpools = jmla.init_paged_mla_cache(jcfg, n_pages, bs, jnp.float32)
    vals = {k: _x(a.shape, seed + i) for i, (k, a) in
            enumerate(sorted(jpools.items()))}
    tpools = mla.init_paged_mla_cache(cfg, n_pages, bs, torch.float32, "cpu")
    for k, v in vals.items():
        tpools[k].copy_(torch.from_numpy(v))
    return {k: jnp.asarray(v) for k, v in vals.items()}, tpools


@pytest.mark.parametrize("shape", ("decode", "chunk"))
def test_mla_paged_matches_reference(model, shape):
    """Batched decode (two lanes, one row each at its own position) and a
    chunk (one lane, 6 rows): the output and both pools (null page
    excluded: it takes every write with nowhere else to go)."""
    jcfg, cfg, jp, tp = model
    jl, tl = _layer(jp, tp, r=2)
    bs, n_pages = 8, 9
    jpools, tpools = _pools(jcfg, cfg, n_pages, bs, seed=7)
    if shape == "decode":
        tables = np.array([[3, 1, 6, 8], [0, 5, 8, 8]], np.int32)
        pos = np.array([19, 12], np.int32)
        x = _x((2, 1, cfg.d_model), seed=8)
    else:
        tables = np.array([[4, 2, 7, 8]], np.int32)
        pos = np.arange(10, 16, dtype=np.int32)
        x = _x((1, 6, cfg.d_model), seed=9)
    jout, jpools = jmla.mla_layer(
        jcfg, jl, jnp.asarray(x), positions=jnp.asarray(pos),
        cache=jpools, paged_tables=jnp.asarray(tables))
    with torch.no_grad():
        out, tpools = mla.mla_layer(
            cfg, tl, torch.from_numpy(x), positions=torch.from_numpy(pos),
            cache=tpools, paged_tables=torch.from_numpy(tables))
    assert _err(out, jout) < TOL
    _close({k: v[:-1] for k, v in tpools.items()},
           {k: v[:-1] for k, v in jpools.items()})
    with pytest.raises(ValueError, match="block tables"):
        mla.mla_layer(cfg, tl, torch.from_numpy(x),
                      positions=torch.from_numpy(pos), cache=tpools)


def test_paged_decode_equals_dense_decode(model):
    """With kv_len == max_blocks * block_size, a lane's paged decode row
    computes ``_mla_decode``'s arithmetic: the same output bit for bit."""
    jcfg, cfg, jp, tp = model
    _, tl = _layer(jp, tp, r=0)
    bs, width = 8, 4
    x = _x((1, 15, cfg.d_model), seed=10)
    pos = torch.arange(14, dtype=torch.int32)
    dense = mla.init_mla_cache(cfg, 1, bs * width, torch.float32, "cpu")
    pools = mla.init_paged_mla_cache(cfg, width + 1, bs, torch.float32,
                                     "cpu")
    table = torch.tensor([[2, 0, 3, 1]], dtype=torch.int32)
    with torch.no_grad():
        mla.mla_layer(cfg, tl, torch.from_numpy(x[:, :14]), positions=pos,
                      cache=dense)
        caches = {"seg0": {"c0": {"mla": {k: v[None] for k, v in
                                          pools.items()}}}}
        single = {"seg0": {"c0": {"mla": {k: v[None] for k, v in
                                          dense.items()}}}}
        one = configs.get(ARCH).reduced().replace(n_layers=1)
        lm.insert_paged_prompt(one, caches, single, {"global": table[0]}, 0,
                               block_size=bs, null_block=width)
        step = torch.from_numpy(x[:, 14:15])
        want, _ = mla.mla_layer(cfg, tl, step,
                                positions=torch.tensor(14, dtype=torch.int32),
                                cache=dense)
        got, _ = mla.mla_layer(cfg, tl, step,
                               positions=torch.tensor([14], dtype=torch.int32),
                               cache=pools, paged_tables=table)
    assert torch.equal(got, want)


def test_attention_with_its_own_v_head_dim():
    """qk 24, v 16 (the reference's regression case): the port's plain
    flash version and ``blocks.attention(impl="plain")`` return v's width
    and match the reference's chunked and naive attention; the kernel path
    refuses the pair."""
    B, S, H, dqk, dv = 2, 64, 4, 24, 16
    q, k = _x((B, S, H, dqk), 0), _x((B, S, H, dqk), 1)
    v = _x((B, S, H, dv), 2)
    pos = np.arange(S, dtype=np.int32)
    jargs = dict(q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos),
                 causal=True)
    exp = jblocks.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            impl="chunked", chunk=16, **jargs)
    naive = jblocks.attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), impl="naive", **jargs)
    tq, tk, tv, tpos = (torch.from_numpy(a) for a in (q, k, v, pos))
    targs = dict(q_positions=tpos, k_positions=tpos, causal=True)
    got_ref = fa_ref.reference(tq, tk, tv, **targs)
    got = blocks.attention(tq, tk, tv, impl="plain", **targs)
    assert got.shape == got_ref.shape == (B, S, H, dv)
    assert _err(got, exp) < TOL and _err(got_ref, naive) < TOL
    with pytest.raises(ValueError, match="head dim"):
        blocks.attention(tq, tk, tv, impl="kernel", **targs)


def test_f2_reference_pallas_returns_q_width_and_the_port_v_width():
    """F2, pinned: the reference's Pallas flash kernel (interpret mode)
    takes the output width from q, so at MLA's 192/128 it returns 192
    columns where the attention has 128; the port's wrapper returns 128,
    equal to the reference's plain attention."""
    B, S, H, dqk, dv = 1, 16, 2, 192, 128
    q, k = _x((B, S, H, dqk), 3), _x((B, S, H, dqk), 4)
    v = _x((B, S, H, dv), 5)
    pos = np.arange(S, dtype=np.int32)
    jargs = dict(q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos))
    pallas = jfa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **jargs)
    assert pallas.shape == (B, S, H, dqk)
    exp = jblocks.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            impl="chunked", causal=True, **jargs)
    tpos = torch.from_numpy(pos)
    got = fa_ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 q_positions=tpos, k_positions=tpos)
    assert got.shape == exp.shape == (B, S, H, dv)
    assert _err(got, exp) < TOL


@pytest.mark.parametrize("dqk,dv", [(192, 64), (128, 192), (256, 128),
                                    (192, 256), (24, 16), (192, 192),
                                    (80, 80)])
def test_flash_wrapper_refuses_other_head_dim_pairs(dqk, dv):
    """Only equal head dims in 16/64/96/128/256 and (192, 128) pass; the
    checks run before the device dispatch, so a CUDA tensor meets them
    too."""
    q = torch.zeros((1, 4, 2, dqk))
    v = torch.zeros((1, 4, 2, dv))
    pos = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q, q, v, q_positions=pos, k_positions=pos)
    qk = torch.zeros((1, 4, 2, 192))
    ok = fa_ops.flash_attention(qk, qk, torch.zeros((1, 4, 2, 128)),
                                q_positions=pos, k_positions=pos)
    assert ok.shape == (1, 4, 2, 128)


def test_model_logits_match_reference_in_prefill_and_decode(model):
    """The reduced model (layer 0 MLA + dense FFN, then MLA + MoE): prefill
    logits, then four dense-cache decode steps."""
    jcfg, cfg, jp, tp = model
    toks = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (1, 14)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, 1, KV_LEN, jnp.float32)
    jl, jcache, _ = jlm.forward(jcfg, jp, jnp.asarray(toks[:, :10]),
                                cache=jcache, mode="prefill")
    tcache = lm.init_cache(cfg, 1, KV_LEN, torch.float32, "cpu")
    with torch.no_grad():
        tl, tcache, _ = lm.forward(cfg, tp, torch.from_numpy(toks[:, :10]),
                                   cache=tcache, mode="prefill")
        assert _err(tl, jl) < LOGIT_TOL
        for t in range(10, 14):
            jl, jcache, _ = jlm.forward(
                jcfg, jp, jnp.asarray(toks[:, t:t + 1]),
                positions=jnp.asarray(t, jnp.int32), cache=jcache,
                mode="decode")
            tl, tcache, _ = lm.forward(
                cfg, tp, torch.from_numpy(toks[:, t:t + 1]),
                positions=torch.tensor(t, dtype=torch.int32), cache=tcache,
                mode="decode")
            assert _err(tl, jl) < LOGIT_TOL, t


def test_launcher_serves_deepseek(capsys):
    """``--arch deepseek-v2-lite-16b`` through the launcher on the CPU:
    paged lanes over the latent pools, the prefix cache, and a
    disaggregated fleet handing latent blocks over, with the same first
    request's tokens each time."""
    base = ["--arch", ARCH, "--reduced", "--continuous", "--paged",
            "--device", "cpu", "--requests", "4", "--max-new", "4",
            "--prompt-len", "24", "--kv-len", "48", "--stagger", "1"]
    launch_serve.main(base)
    out = capsys.readouterr().out
    assert "2 layer pools" in out
    first = [ln for ln in out.splitlines() if ln.startswith("first")]
    launch_serve.main(base + ["--prefix-cache", "--shared-prefix", "16"])
    out = capsys.readouterr().out
    assert "[serve-cb] prefix-cache: hit_rate=" in out
    launch_serve.main(base + ["--replicas", "2", "--disaggregate",
                              "--chunk-prefill", "8"])
    out = capsys.readouterr().out
    assert "over 2 replicas (prefill/decode)" in out
    assert [ln for ln in out.splitlines() if ln.startswith("first")] == first
