"""The port's model blocks against ``repro.models.blocks`` on the CPU.

Same weights and inputs (numpy, seeded) through the JAX function and its
port, at the reduced TinyLlama size, in f32, atol 1e-5.  Covers RMSNorm,
RoPE, attention layers with no cache, a prefill cache, dense decode and
paged decode and chunk prefill, the gated FFN, and the in-place paged
write; and at the reduced recurrentgemma-2b size (MQA, hd 16, window 32)
the sliding-window attention layer with no cache, a ring-filled prefill
cache, dense decode, and paged decode and chunk prefill through window
ring tables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro_torch import configs
from repro_torch.models import blocks

torch.set_num_threads(2)
ATOL = 1e-5

CFG = configs.get("tinyllama-1.1b").reduced()
JCFG = jconfigs.get("tinyllama-1.1b").reduced()
RG_CFG = configs.get("recurrentgemma-2b").reduced()
RG_JCFG = jconfigs.get("recurrentgemma-2b").reduced()


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _attn_params(seed, jcfg=JCFG):
    p = jblocks.init_attention(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    p["ln"] = jnp.asarray(rng.standard_normal(jcfg.d_model) * 0.1,
                          jnp.float32)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _close(got, exp, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert np.abs(got - np.asarray(exp)).max() < atol


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    jx, tx = _both(rng.standard_normal((2, 5, 64)).astype(np.float32) * 3)
    js, ts = _both(rng.standard_normal(64).astype(np.float32) * 0.1)
    _close(blocks.rms_norm(tx, ts, 1e-6), jblocks.rms_norm(jx, js, 1e-6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 9, 64), (3, 1, 64)],
                         ids=["prefill", "decode"])
def test_rms_norm_forward_is_the_plain_formula(shape, dtype):
    """The ``autograd.Function`` leaves serving's outputs as they were:
    bit for bit the plain formula, on prefill and decode rows."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         * 3).to(dtype)
    s = torch.from_numpy(rng.standard_normal(64).astype(np.float32)
                         * 0.1).to(dtype)
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + 1e-6)
    plain = (xf * rstd * (1.0 + s.float())).to(dtype)
    with torch.inference_mode():
        got = blocks.rms_norm(x, s, 1e-6)
    assert got.dtype == dtype and torch.equal(got, plain)


@pytest.mark.parametrize("batched_positions", [False, True])
def test_apply_rope_matches_jax(batched_positions):
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.standard_normal((3, 7, 4, 16)).astype(np.float32))
    pos = rng.integers(0, 500, (3, 7) if batched_positions else (7,))
    jp, tp = _both(pos.astype(np.int32))
    _close(blocks.apply_rope(tx, tp, 10_000.0),
           jblocks.apply_rope(jx, jp, 10_000.0))


def test_attn_layer_without_cache_matches_jax():
    jp, tp = _attn_params(2)
    rng = np.random.default_rng(2)
    jx, tx = _both(rng.standard_normal((2, 9, 64)).astype(np.float32))
    jpos, tpos = _both(np.arange(9, dtype=np.int32))
    jout, _ = jblocks.attn_layer(JCFG, jp, jx, local=False, positions=jpos)
    for impl in ("kernel", "plain"):
        tout, _ = blocks.attn_layer(CFG, tp, tx, local=False, positions=tpos,
                                    impl=impl)
        _close(tout, jout)


def test_attn_layer_prefill_then_dense_decode_match_jax():
    jp, tp = _attn_params(3)
    rng = np.random.default_rng(3)
    S, kv_len = 6, 16
    jx, tx = _both(rng.standard_normal((1, S, 64)).astype(np.float32))
    jpos, tpos = _both(np.arange(S, dtype=np.int32))
    jc = jblocks.init_attn_cache(JCFG, 1, kv_len, False, jnp.float32)
    tc = blocks.init_attn_cache(CFG, 1, kv_len, torch.float32, "cpu")
    jout, jc = jblocks.attn_layer(JCFG, jp, jx, local=False, positions=jpos,
                                  cache=jc)
    tout, tc = blocks.attn_layer(CFG, tp, tx, local=False, positions=tpos,
                                 cache=tc)
    _close(tout, jout)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))

    jy, ty = _both(rng.standard_normal((1, 1, 64)).astype(np.float32))
    jd, td = _both(np.asarray(S, np.int32))
    jout, jc = jblocks.attn_layer(JCFG, jp, jy, local=False, positions=jd,
                                  cache=jc)
    tout, tc = blocks.attn_layer(CFG, tp, ty, local=False, positions=td,
                                 cache=tc)
    _close(tout, jout)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_attn_layer_paged_decode_matches_jax():
    jp, tp = _attn_params(4)
    rng = np.random.default_rng(4)
    B, bs, width, n_pages = 3, 4, 4, 13
    pools = rng.standard_normal((2, n_pages, bs, CFG.n_kv_heads,
                                 CFG.head_dim)).astype(np.float32)
    tables = np.array([[0, 1, 2, 12], [3, 4, 12, 12], [12, 12, 12, 12]],
                      np.int32)                  # lane 2 is inactive
    pos = np.array([9, 5, 40], np.int32)         # 40: past the table
    jx, tx = _both(rng.standard_normal((B, 1, 64)).astype(np.float32))
    jcache = {"k_pages": jnp.asarray(pools[0]),
              "v_pages": jnp.asarray(pools[1])}
    jout, jcache = jblocks.attn_layer(
        JCFG, jp, jx, local=False, positions=jnp.asarray(pos),
        cache=jcache, paged_tables=jnp.asarray(tables))
    for impl in ("kernel", "plain"):
        tcache = {"k_pages": torch.from_numpy(pools[0].copy()),
                  "v_pages": torch.from_numpy(pools[1].copy())}
        tout, tcache = blocks.attn_layer(
            CFG, tp, tx, local=False, positions=torch.from_numpy(pos),
            cache=tcache, impl=impl, paged_tables=torch.from_numpy(tables))
        _close(tout[:2], jout[:2])                # active lanes
        for key in ("k_pages", "v_pages"):        # scratch page aside
            _close(tcache[key][:-1], jcache[key][:-1])


def test_paged_write_in_place_and_scratch():
    """Rows land at (table[pos // bs], pos % bs) of the very tensors passed
    in; rows past the table's reach go to the last (scratch) page."""
    rng = np.random.default_rng(5)
    kp = torch.zeros(5, 4, 2, 16)
    vp = torch.zeros(5, 4, 2, 16)
    tables = torch.tensor([[2, 0], [1, 3]], dtype=torch.int32)
    pos = torch.tensor([5, 9], dtype=torch.int32)   # lane 1: past 2 blocks
    k = torch.from_numpy(rng.standard_normal((2, 1, 2, 16))
                         .astype(np.float32))
    v = k + 1
    out_k, out_v = blocks.paged_write(kp, vp, tables, pos, k, v)
    assert out_k is kp and out_v is vp
    assert torch.equal(kp[0, 1], k[0, 0]) and torch.equal(vp[0, 1], v[0, 0])
    assert torch.equal(kp[4, 1], k[1, 0])          # scratch page
    jk, jv = jblocks.paged_write(
        jnp.zeros((5, 4, 2, 16)), jnp.zeros((5, 4, 2, 16)),
        jnp.asarray(tables.numpy()), jnp.asarray(pos.numpy()),
        jnp.asarray(k.numpy()), jnp.asarray(v.numpy()))
    assert np.array_equal(kp.numpy(), np.asarray(jk))
    assert np.array_equal(vp.numpy(), np.asarray(jv))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ffn_layer_matches_jax(act):
    jcfg, cfg = JCFG.replace(ffn_act=act), CFG.replace(ffn_act=act)
    jp = jblocks.init_ffn(jax.random.PRNGKey(6), jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(6)
    jx, tx = _both(rng.standard_normal((2, 5, 64)).astype(np.float32))
    _close(blocks.ffn_layer(cfg, tp, tx), jblocks.ffn_layer(jcfg, jp, jx))


def _paged_chunk_case(cfg, jcfg, seed, local, table, start, chunk):
    """One lane's ``chunk`` rows from ``start`` through ``table`` (a block
    table row, or a window ring's), over pools holding earlier rows: the
    output and the pools (null page aside) against JAX, both impls."""
    jp, tp = _attn_params(seed, jcfg)
    rng = np.random.default_rng(seed)
    bs, null = 16, 9
    pools = rng.standard_normal((2, null + 1, bs, cfg.n_kv_heads,
                                 cfg.head_dim)).astype(np.float32)
    tables = np.array([table], np.int32)
    pos = np.arange(start, start + chunk, dtype=np.int32)
    jx, tx = _both(rng.standard_normal((1, chunk, 64)).astype(np.float32))
    jcache = {"k_pages": jnp.asarray(pools[0]),
              "v_pages": jnp.asarray(pools[1])}
    jout, jcache = jblocks.attn_layer(
        jcfg, jp, jx, local=local, positions=jnp.asarray(pos),
        cache=jcache, paged_tables=jnp.asarray(tables))
    for impl in ("kernel", "plain"):
        tcache = {"k_pages": torch.from_numpy(pools[0].copy()),
                  "v_pages": torch.from_numpy(pools[1].copy())}
        tout, tcache = blocks.attn_layer(
            cfg, tp, tx, local=local, positions=torch.from_numpy(pos),
            cache=tcache, impl=impl, paged_tables=torch.from_numpy(tables))
        _close(tout, jout)
        for key in ("k_pages", "v_pages"):
            _close(tcache[key][:-1], jcache[key][:-1])


def test_local_layers_are_not_ported():
    """Sliding-window layers run dense prefill, dense decode and the paged
    decode step (tests below), and the multi-row paged path that chunked
    prefill runs: a chunk of 8 rows at positions 57..64 through a window
    ring whose block 0 fell behind the window of 32 (null) and whose block
    4 the chunk has just claimed."""
    _paged_chunk_case(RG_CFG, RG_JCFG, 7, True, [9, 4, 0, 7, 5, 9], 57, 8)


@pytest.mark.parametrize("start,chunk", [(0, 7), (14, 8), (60, 7)])
def test_attn_layer_paged_chunk_matches_jax(start, chunk):
    """A global layer's multi-row paged path: a chunk from the prompt's
    start, one across a block edge, and one whose last rows reach past the
    table (to the null page)."""
    _paged_chunk_case(CFG, JCFG, 11, False, [3, 1, 6, 2], start, chunk)


@pytest.mark.parametrize("S", [20, 45])
def test_local_attn_layer_without_cache_matches_jax(S):
    jp, tp = _attn_params(8, RG_JCFG)
    rng = np.random.default_rng(8)
    jx, tx = _both(rng.standard_normal((2, S, 64)).astype(np.float32))
    jpos, tpos = _both(np.arange(S, dtype=np.int32))
    jout, _ = jblocks.attn_layer(RG_JCFG, jp, jx, local=True, positions=jpos)
    for impl in ("kernel", "plain"):
        tout, _ = blocks.attn_layer(RG_CFG, tp, tx, local=True,
                                    positions=tpos, impl=impl)
        _close(tout, jout)


@pytest.mark.parametrize("S", [12, 40])
def test_local_attn_layer_prefill_then_dense_decode_match_jax(S):
    """A window cache holds min(kv_len, window) = 32 rows: a 12-row prompt
    fills slots 0.., a 40-row one its last 32 rows at position % 32; the
    decode steps then write at position % 32."""
    jp, tp = _attn_params(9, RG_JCFG)
    rng = np.random.default_rng(9)
    kv_len = 64
    jx, tx = _both(rng.standard_normal((1, S, 64)).astype(np.float32))
    jpos, tpos = _both(np.arange(S, dtype=np.int32))
    jc = jblocks.init_attn_cache(RG_JCFG, 1, kv_len, True, jnp.float32)
    tc = blocks.init_attn_cache(RG_CFG, 1, kv_len, torch.float32, "cpu",
                                local=True)
    assert tc["k"].shape == jc["k"].shape == (1, 32, 1, 16)
    jout, jc = jblocks.attn_layer(RG_JCFG, jp, jx, local=True,
                                  positions=jpos, cache=jc)
    for impl in ("kernel", "plain"):
        out, _ = blocks.attn_layer(RG_CFG, tp, tx, local=True,
                                   positions=tpos, impl=impl,
                                   cache=blocks.init_attn_cache(
                                       RG_CFG, 1, kv_len, torch.float32,
                                       "cpu", local=True))
        _close(out, jout)
    tout, tc = blocks.attn_layer(RG_CFG, tp, tx, local=True, positions=tpos,
                                 cache=tc)
    _close(tout, jout)
    for t in range(3):
        jy, ty = _both(rng.standard_normal((1, 1, 64)).astype(np.float32))
        jd, td = _both(np.asarray(S + t, np.int32))
        jout, jc = jblocks.attn_layer(RG_JCFG, jp, jy, local=True,
                                      positions=jd, cache=jc)
        tout, tc = blocks.attn_layer(RG_CFG, tp, ty, local=True,
                                     positions=td, cache=tc)
        _close(tout, jout)
        for key in ("k", "v"):
            _close(tc[key], jc[key])
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_local_attn_layer_paged_decode_through_ring_matches_jax():
    """Window ring tables: entries behind the window are the null page
    (lane 0 at position 50 keeps blocks 1..3 of 16 rows; lane 1 at 20
    keeps 0..1), lane 2 is retired (all null)."""
    jp, tp = _attn_params(10, RG_JCFG)
    rng = np.random.default_rng(10)
    B, bs, null = 3, 16, 9
    pools = rng.standard_normal((2, null + 1, bs, RG_CFG.n_kv_heads,
                                 RG_CFG.head_dim)).astype(np.float32)
    tables = np.array([[null, 4, 0, 7, null, null],
                       [2, 5, null, null, null, null],
                       [null] * 6], np.int32)
    pos = np.array([50, 20, 3], np.int32)
    jx, tx = _both(rng.standard_normal((B, 1, 64)).astype(np.float32))
    jcache = {"k_pages": jnp.asarray(pools[0]),
              "v_pages": jnp.asarray(pools[1])}
    jout, jcache = jblocks.attn_layer(
        RG_JCFG, jp, jx, local=True, positions=jnp.asarray(pos),
        cache=jcache, paged_tables=jnp.asarray(tables))
    for impl in ("kernel", "plain"):
        tcache = {"k_pages": torch.from_numpy(pools[0].copy()),
                  "v_pages": torch.from_numpy(pools[1].copy())}
        tout, tcache = blocks.attn_layer(
            RG_CFG, tp, tx, local=True, positions=torch.from_numpy(pos),
            cache=tcache, impl=impl, paged_tables=torch.from_numpy(tables))
        _close(tout[:2], jout[:2])                # active lanes
        for key in ("k_pages", "v_pages"):        # scratch page aside
            _close(tcache[key][:-1], jcache[key][:-1])
