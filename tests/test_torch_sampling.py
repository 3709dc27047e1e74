"""The port's sampler (``repro_torch.serve.sampling``) against the
reference's (``repro.serve.sampling``) on the CPU, in f32.

* The PRNG, bit for bit: ``prng_key``, ``fold_in``, ``token_key``, the
  random bits and the uniforms equal ``jax.random``'s over several seeds,
  positions, streams and draw lengths (the reduced vocab of 512 and
  TinyLlama's 32,000).  Gumbel noise: each of its two logs is the f64
  log rounded to f32 (the same on every host), within one ulp of XLA's,
  so the noise is within 2^-23 + 1 ulp.
* The sampler, row by row as ``tests/test_serve_sampling.py`` has them:
  support sets, the greedy limit, seed semantics, batched against single
  lanes, speculative acceptance; and equal to the reference on fixed
  grids: supports, softmax probabilities (bitwise at the test vocab of
  32), sampled tokens, acceptance counts and corrective tokens.
* F1 pinned: top-k and top-p act on the temperature-scaled logits (on
  ``_logits(5)`` at temperature 1.3, top-k 6, top-p 0.7 the raw support is
  {20} and the tempered one {20, 26}); F4 pinned: ``top_p = 1.0`` keeps 30
  of 32 tokens of ``_logits(192)`` in both packages.

Seeds are fixed; no Hypothesis.
"""

import os
import platform

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import sampling as js
from repro_torch.serve import sampling as ts
from repro_torch.serve.sampling import (GREEDY, NEG_INF, STREAM_ACCEPT,
                                        STREAM_DRAFT, STREAM_SAMPLE,
                                        SamplingParams, filter_logits,
                                        sample_lanes, sample_token,
                                        sampling_probs, speculative_accept,
                                        token_key)

torch.set_num_threads(2)
V = 32
SEEDS = (0, 1, 5, 123, 2 ** 31 - 1)


def _jlogits(seed, shape=(V,)):
    return jax.random.normal(jax.random.PRNGKey(seed), shape) * 3.0


def _logits(seed, shape=(V,)):
    """The reference test's ``_logits``, as a torch tensor."""
    return torch.from_numpy(np.array(_jlogits(seed, shape)))


def _np(x):
    """A writable numpy copy (torch.from_numpy warns on read-only ones)."""
    return np.array(x)


def _key(seed):
    return ts.prng_key(seed)


def _support(filtered):
    return set(np.flatnonzero(_np(filtered) > NEG_INF / 2).tolist())


def _ulps(a, b):
    """Largest distance between ``a`` and ``b`` in ulps of the larger."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    sp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return float((np.abs(a.astype(np.float64) - b) / sp).max())


# =============================================================================
# the PRNG, bit for bit
# =============================================================================

@pytest.mark.parametrize("seed", SEEDS + (-7, 3_000_000_000))
def test_keys_and_fold_in_match_jax(seed):
    jk = (jax.random.PRNGKey(seed) if seed < 2 ** 31
          else jnp.asarray([0, seed], jnp.uint32))
    if seed < 2 ** 31:
        assert np.array_equal(_np(jk).astype(np.int64), _key(seed).numpy())
    tk = torch.from_numpy(_np(jk).astype(np.int64))
    for data in (0, 1, 7, 1000, 2 ** 31 + 5):
        assert np.array_equal(_np(jax.random.fold_in(jk, data)),
                              ts.fold_in(tk, data).numpy())
    for pos in (0, 1, 17, 511):
        for stream in (STREAM_SAMPLE, STREAM_DRAFT, STREAM_ACCEPT):
            assert np.array_equal(_np(js.token_key(jk, pos, stream)),
                                  token_key(tk, pos, stream).numpy())


@pytest.mark.parametrize("n", (1, 5, V, 512, 32000))
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniforms_match_jax(seed, n):
    jk, tk = jax.random.PRNGKey(seed), _key(seed)
    assert np.array_equal(_np(jax.random.bits(jk, (n,))).astype(np.int64),
                          ts.random_bits(tk, n).numpy())
    assert np.array_equal(_np(jax.random.uniform(jk, (n,))),
                          ts.uniform(tk, n).numpy())
    tiny = np.finfo(np.float32).tiny
    assert np.array_equal(
        _np(jax.random.uniform(jk, (n,), minval=tiny, maxval=1.0)),
        ts.uniform(tk, n, tiny, 1.0).numpy())


def test_batched_keys_draw_as_single_keys():
    """[B, 2] keys (and per-lane fold_in data) give each lane the draws of
    its own key: the vmap of the reference's single-key functions."""
    keys = torch.stack([_key(s) for s in (3, 4, 5)])
    pos = torch.tensor([9, 0, 300])
    batched = token_key(keys, pos, STREAM_DRAFT)
    bits = ts.random_bits(batched, 100)
    for i, s in enumerate((3, 4, 5)):
        jk = js.token_key(jax.random.PRNGKey(s), int(pos[i]), STREAM_DRAFT)
        assert np.array_equal(_np(jk), batched[i].numpy())
        assert np.array_equal(_np(jax.random.bits(jk, (100,))),
                              bits[i].numpy())


def _host() -> str:
    """What decides the host's float results: torch's CPU code path and
    threads, the processor, and the environment's CPU-dispatch settings
    (a failure message carries it)."""
    env = {k: v for k, v in os.environ.items()
           if k.startswith(("ATEN_CPU", "MKL_", "OMP_", "XLA_"))}
    return (f"cpu capability {torch.backends.cpu.get_cpu_capability()}, "
            f"{torch.get_num_threads()} threads, processor "
            f"{platform.processor() or platform.machine()!r}, env {env}")


def _worst(got, exp) -> str:
    """The element furthest from ``exp`` in ulps: its index and values."""
    got, exp = np.asarray(got, np.float32), np.asarray(exp, np.float32)
    sp = np.spacing(np.maximum(np.abs(got), np.abs(exp)))
    i = int(np.argmax(np.abs(got.astype(np.float64) - exp) / sp))
    return f"worst at {i}: {got[i]!r} against {exp[i]!r}"


def _f32_roundings(v64):
    """The f32 roundings of the f64 values two f64 ulps either side of
    ``v64``: equal except where ``v64`` lies that close to an f32 rounding
    boundary, where a faithful f64 log on another host may round either
    way."""
    lo = np.nextafter(np.nextafter(v64, -np.inf), -np.inf)
    hi = np.nextafter(np.nextafter(v64, np.inf), np.inf)
    return lo.astype(np.float32), hi.astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_one_ulp_per_log(seed):
    """Each of the port's two logs (``log_f32``, not the host's f32
    ``torch.log``, whose rounding depends on the CPU's MKL code path) is
    within one ulp of XLA's on the same input, and the noise within
    2^-23 + 1 ulp of ``jax.random.gumbel``.  A failure names its assertion
    and the host."""
    jk, tk = jax.random.PRNGKey(seed), _key(seed)
    n = 32000
    tiny = np.finfo(np.float32).tiny
    u = _np(jax.random.uniform(jk, (n,), minval=tiny, maxval=1.0))
    inner_j = _np(-jnp.log(u))
    inner_t = (-ts.log_f32(torch.from_numpy(u))).numpy()
    assert _ulps(inner_t, inner_j) <= 1.0, \
        f"inner log: {_worst(inner_t, inner_j)}; {_host()}"
    outer_j = _np(-jnp.log(inner_j))
    outer_t = (-ts.log_f32(torch.from_numpy(inner_j))).numpy()
    assert _ulps(outer_t, outer_j) <= 1.0, \
        f"outer log: {_worst(outer_t, outer_j)}; {_host()}"
    got, exp = ts.gumbel(tk, n).numpy(), _np(jax.random.gumbel(jk, (n,)))
    bar = 2.0 ** -23 + np.spacing(np.abs(exp))
    assert (np.abs(got.astype(np.float64) - exp) <= bar).all(), \
        f"noise: {_worst(got, exp)}; {_host()}"


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_logs_are_correctly_rounded(seed):
    """The port's noise does not depend on the host: each log is the f64
    log rounded to f32 (numpy's f64 log, within two f64 ulps where the
    rounding is that close to a boundary), and the noise is the two logs
    composed, bit for bit."""
    tk = _key(seed)
    n = 32000
    u = ts.uniform(tk, n, np.finfo(np.float32).tiny, 1.0)
    inner = -ts.log_f32(u)
    noise = -ts.log_f32(inner)
    for x, got in ((u, -inner), (inner, -noise)):
        lo, hi = _f32_roundings(np.log(x.numpy().astype(np.float64)))
        got = got.numpy()
        assert ((got == lo) | (got == hi)).all(), \
            f"{_worst(got, lo)}; {_host()}"
    assert torch.equal(ts.gumbel(tk, n), noise)


@pytest.mark.parametrize("seed", range(6))
def test_categorical_matches_jax(seed):
    logits = _jlogits(seed, (4, 512))
    keys = jax.random.split(jax.random.PRNGKey(seed + 50), 4)
    exp = jax.vmap(jax.random.categorical)(keys, logits)
    got = ts.categorical(torch.from_numpy(_np(keys).astype(np.int64)),
                         torch.from_numpy(_np(logits)))
    assert got.tolist() == _np(exp).tolist()


# =============================================================================
# the sampler, row by row (tests/test_serve_sampling.py)
# =============================================================================

def test_params_validation():
    with pytest.raises(ValueError):
        SamplingParams(temperature=-0.1)
    with pytest.raises(ValueError):
        SamplingParams(top_k=-1)
    with pytest.raises(ValueError):
        SamplingParams(top_p=0.0)
    with pytest.raises(ValueError):
        SamplingParams(top_p=1.5)
    with pytest.raises(ValueError):
        ts.prng_key(2 ** 32)
    assert GREEDY.is_greedy
    assert not SamplingParams(temperature=0.7).is_greedy
    assert SamplingParams(seed=9).base_key().tolist() == [0, 9]


def test_top_k_support():
    logits = _logits(0)
    for k in (1, 3, 7, V, V + 5):
        sup = _support(filter_logits(logits, k, 1.0))
        order = np.argsort(-logits.numpy())
        assert sup == set(order[:min(k, V)].tolist())


def test_top_k_zero_disables():
    assert _support(filter_logits(_logits(1), 0, 1.0)) == set(range(V))


def test_top_k_ties_kept():
    logits = torch.tensor([2.0, 2.0, 2.0, 0.0])
    assert _support(filter_logits(logits, 2, 1.0)) == {0, 1, 2}


def test_top_p_smallest_prefix():
    logits = torch.log(torch.tensor([0.5, 0.3, 0.15, 0.05]))
    assert _support(filter_logits(logits, 0, 0.5)) == {0}
    assert _support(filter_logits(logits, 0, 0.51)) == {0, 1}
    assert _support(filter_logits(logits, 0, 0.8001)) == {0, 1, 2}
    assert _support(filter_logits(logits, 0, 1.0)) == {0, 1, 2, 3}


def test_top_p_always_keeps_argmax():
    logits = _logits(2)
    assert _support(filter_logits(logits, 0, 1e-6)) == \
        {int(logits.argmax())}


def test_filters_compose():
    logits = _logits(3)
    sup = _support(filter_logits(logits, 5, 0.6))
    assert sup == (_support(filter_logits(logits, 5, 1.0))
                   & _support(filter_logits(logits, 0, 0.6)))
    assert int(logits.argmax()) in sup


@pytest.mark.parametrize("seed", range(0, 300, 10))
def test_support_and_probs_match_the_reference(seed):
    """Supports equal the reference's over a grid of filters (top_p 1.0
    included: which tail ranks it drops depends on how the f32 sums
    round), and the post-filter probabilities are the reference's bit for
    bit at V = 32."""
    jl = _jlogits(seed)
    tl = torch.from_numpy(_np(jl))
    for k, p in ((0, 1.0), (0, 0.9), (5, 1.0), (7, 0.5), (V, 0.99)):
        assert _support(filter_logits(tl, k, p)) == \
            _support(js.filter_logits(jl, k, p)), (seed, k, p)
    for temp, k, p in ((1.0, 0, 1.0), (0.7, 6, 0.9), (1.3, 0, 0.95)):
        assert np.array_equal(sampling_probs(tl, temp, k, p).numpy(),
                              _np(js.sampling_probs(jl, temp, k, p)))


def test_f4_top_p_one_drops_the_tail_like_the_reference():
    """F4: ``top_p = 1.0`` is not a no-op in f32.  The reference keeps 30
    of the 32 tokens of ``_logits(192)`` (the exclusive prefix sum rounds
    to 1.0 before the last two ranks), and so does the port."""
    jl = _jlogits(192)
    exp = _support(js.filter_logits(jl, 0, 1.0))
    got = _support(filter_logits(torch.from_numpy(_np(jl)), 0, 1.0))
    assert len(exp) == 30 and got == exp


def test_f1_support_is_the_tempered_one():
    """F1: top-k and top-p act on the temperature-scaled logits.  On
    ``_logits(5)`` at temperature 1.3, top-k 6, top-p 0.7 the raw support
    is {20} and the tempered one {20, 26}; every sampled token lies in the
    tempered support and equals the reference's."""
    jl = _jlogits(5)
    tl = torch.from_numpy(_np(jl))
    raw = _support(filter_logits(tl, 6, 0.7))
    tempered = _support(filter_logits(tl / 1.3, 6, 0.7))
    assert raw == {20} and tempered == {20, 26}
    toks = set()
    for i in range(16):
        tok = int(sample_token(tl, _key(i), 1.3, 6, 0.7))
        assert tok == int(js.sample_token(jl, jax.random.PRNGKey(i), 1.3, 6,
                                          0.7))
        toks.add(tok)
    assert toks <= tempered and toks - raw


def test_temperature_zero_is_bitwise_argmax():
    for seed in range(8):
        logits = _logits(seed)
        tok = sample_token(logits, _key(seed), 0.0, 0, 1.0)
        assert int(tok) == int(logits.argmax())
        probs = sampling_probs(logits, 0.0, 5, 0.5)
        assert float(probs[int(tok)]) == 1.0 and float(probs.sum()) == 1.0


def test_low_temperature_approaches_greedy():
    logits = _logits(4)
    toks = {int(sample_token(logits, _key(i), 1e-3, 0, 1.0))
            for i in range(16)}
    assert toks == {int(logits.argmax())}


@pytest.mark.parametrize("vocab", (V, 512))
def test_sampled_tokens_match_the_reference(vocab):
    """A grid of (logits, key, temperature, top-k, top-p): the port draws
    the reference's token every time."""
    grid = [(0.8, 40, 0.95), (1.0, 0, 1.0), (1.3, 6, 0.7), (0.5, 0, 0.9),
            (2.0, 3, 1.0)]
    for seed in range(12):
        jl = _jlogits(seed, (vocab,))
        tl = torch.from_numpy(_np(jl))
        for j, (temp, k, p) in enumerate(grid):
            jkey = js.token_key(jax.random.PRNGKey(seed), 7 + j)
            tkey = token_key(_key(seed), 7 + j)
            exp = int(js.sample_token(jl, jkey, temp, k, p))
            assert int(sample_token(tl, tkey, temp, k, p)) == exp, \
                (seed, temp, k, p)


def test_per_seed_determinism_and_distinct_keys():
    logits = _logits(6)
    p = SamplingParams(temperature=0.9, seed=123)
    a = sample_token(logits, token_key(p.base_key(), 7), 0.9, 0, 1.0)
    b = sample_token(logits, token_key(p.base_key(), 7), 0.9, 0, 1.0)
    assert int(a) == int(b)
    base = SamplingParams(seed=5).base_key()
    keys = {tuple(token_key(base, pos, stream).tolist())
            for pos in range(4)
            for stream in (STREAM_SAMPLE, STREAM_DRAFT, STREAM_ACCEPT)}
    assert len(keys) == 12


def test_batched_vs_single_lane_bitwise():
    jl = _jlogits(7, (3, V))
    logits = torch.from_numpy(_np(jl))
    keys = torch.stack([token_key(_key(s), 9) for s in (1, 2, 3)])
    temp = torch.tensor([0.8, 0.0, 1.4])
    topk = torch.tensor([4, 0, 0])
    topp = torch.tensor([1.0, 1.0, 0.6])
    batched = sample_lanes(logits, keys, temp, topk, topp)
    assert batched.dtype == torch.int32
    jkeys = jnp.stack([js.token_key(jax.random.PRNGKey(s), 9)
                       for s in (1, 2, 3)])
    exp = js.sample_lanes(jl, jkeys, jnp.asarray(temp.numpy()),
                          jnp.asarray(topk.numpy()),
                          jnp.asarray(topp.numpy()))
    assert batched.tolist() == _np(exp).tolist()
    for i in range(3):
        single = sample_token(logits[i], keys[i], temp[i], topk[i], topp[i])
        assert int(batched[i]) == int(single)
    assert int(batched[1]) == int(logits[1].argmax())


# -- speculative acceptance ----------------------------------------------------

def _q(seed, k, temp=1.0):
    return sampling_probs(_logits(seed, (k, V)), temp, 0, 1.0)


def test_greedy_accept_exact_argmax_agreement():
    k = 4
    tgt = _logits(8, (k + 1, V))
    arg = tgt.argmax(dim=-1)
    drafts = torch.tensor([int(arg[0]), int(arg[1]), int((arg[2] + 1) % V),
                           int(arg[3])])
    n_acc, nxt = speculative_accept(tgt, _q(9, k), drafts, k, _key(0), 0.0,
                                    0, 1.0)
    assert int(n_acc) == 2 and int(nxt) == int(arg[2])


def test_greedy_accept_all_gets_bonus():
    k = 3
    tgt = _logits(10, (k + 1, V))
    arg = tgt.argmax(dim=-1)
    n_acc, nxt = speculative_accept(tgt, _q(11, k), arg[:k], k, _key(0),
                                    0.0, 0, 1.0)
    assert int(n_acc) == k and int(nxt) == int(arg[k])


def test_accept_never_exceeds_n_drafted():
    k = 4
    tgt = _logits(12, (k + 1, V))
    arg = tgt.argmax(dim=-1)
    n_acc, nxt = speculative_accept(tgt, _q(13, k), arg[:k], 2, _key(0),
                                    0.0, 0, 1.0)
    assert int(n_acc) == 2 and int(nxt) == int(arg[2])


def test_accept_identical_dists_always_accepts():
    k = 3
    logits = _logits(14, (k + 1, V))
    q = sampling_probs(logits[:k], 1.0, 0, 1.0)
    for seed in range(8):
        keys = torch.stack([token_key(_key(seed), i) for i in range(k)])
        drafts = ts.categorical(keys, logits[:k])
        n_acc, _ = speculative_accept(logits, q, drafts, k, _key(seed + 100),
                                      1.0, 0, 1.0)
        assert int(n_acc) == k


def test_accept_disjoint_dists_rejects_all():
    k = 2
    tgt = torch.full((k + 1, V), NEG_INF)
    tgt[:, 0] = 0.0
    q = torch.zeros((k, V))
    q[:, 1] = 1.0
    n_acc, nxt = speculative_accept(tgt, q, torch.tensor([1, 1]), k,
                                    _key(0), 1.0, 0, 1.0)
    assert int(n_acc) == 0 and int(nxt) == 0


@pytest.mark.parametrize("seed", range(10))
def test_accept_matches_the_reference(seed):
    """Acceptance counts and corrective tokens equal the reference's over
    temperatures (greedy included), filters and drafted counts."""
    k = 4
    jt = _jlogits(seed, (k + 1, V))
    tt = torch.from_numpy(_np(jt))
    for temp, top_k, top_p in ((0.0, 0, 1.0), (1.0, 0, 1.0), (0.8, 8, 0.95),
                               (1.5, 0, 0.8)):
        jq = jax.vmap(lambda r: js.sampling_probs(r, temp, top_k, top_p))(
            _jlogits(seed + 500, (k, V)) * 0.5 + jt[:k] * 0.5)
        tq = torch.from_numpy(_np(jq))
        drafts = np.array(jax.random.randint(
            jax.random.PRNGKey(seed + 9), (k,), 0, V), np.int32)
        drafts[:2] = _np(jnp.argmax(jt[:2], axis=-1))
        for n_drafted in (0, 2, k):
            jk = js.token_key(jax.random.PRNGKey(seed), 3, STREAM_ACCEPT)
            tk = token_key(_key(seed), 3, STREAM_ACCEPT)
            ea, en = js.speculative_accept(jt, jq, jnp.asarray(drafts),
                                           n_drafted, jk, temp, top_k, top_p)
            ga, gn = speculative_accept(tt, tq, torch.from_numpy(drafts),
                                        n_drafted, tk, temp, top_k, top_p)
            assert (int(ga), int(gn)) == (int(ea), int(en)), \
                (seed, temp, n_drafted)
            assert 0 <= int(ga) <= n_drafted
