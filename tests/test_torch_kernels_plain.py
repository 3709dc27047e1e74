"""The port's plain kernel versions against the JAX package on the CPU.

Same inputs, made with numpy from a seed, go through the JAX oracle
(``ref.reference``), the JAX Pallas kernel in interpret mode and the
port's plain version; the bars are the JAX kernel tests' own (paged 1e-5,
flash 2e-5 in f32).  Also pins the port wrappers' dispatch: CPU tensors
run the plain version without counting a launch, and what the CUDA kernels
do not take raises on any device.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro.kernels.paged_attention import ops as jpa_ops
from repro.kernels.paged_attention import ref as jpa_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref

torch.set_num_threads(2)


def _paged_case(seed, B, H, KV, hd, bs, width, lens, n_pages=None,
                dtype=np.float32):
    rng = np.random.default_rng(seed)
    n_pages = n_pages or B * width + 1
    q = rng.standard_normal((B, H, hd)).astype(dtype)
    kp = rng.standard_normal((n_pages, bs, KV, hd)).astype(dtype)
    vp = rng.standard_normal((n_pages, bs, KV, hd)).astype(dtype)
    tables = rng.permutation(n_pages - 1)[:B * width].reshape(B, width)
    return (q, kp, vp, tables.astype(np.int32),
            np.asarray(lens, np.int32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("kv_heads,softcap,window", [
    (1, 0.0, 0), (2, 30.0, 0), (4, 0.0, 0), (2, 0.0, 8), (2, 30.0, 64)])
def test_paged_plain_matches_jax(kv_heads, softcap, window):
    arrs = _paged_case(1, B=4, H=4, KV=kv_heads, hd=16, bs=8, width=5,
                       lens=[1, 17, 33, 40])
    q, kp, vp, tables, lens = arrs
    jq, jkp, jvp, jtab, jlens = _j(*arrs)
    exp_ref = np.asarray(jpa_ref.reference(
        jq[:, None], jkp, jvp, jtab, jlens, q_positions=(jlens - 1)[:, None],
        logit_softcap=softcap, window=window))[:, 0]
    exp_pal = np.asarray(jpa_ops.paged_attention(
        jq, jkp, jvp, jtab, jlens, logit_softcap=softcap, window=window,
        interpret=True))
    tq, tkp, tvp, ttab, tlens = _t(*arrs)
    got = pa_ref.reference(tq[:, None], tkp, tvp, ttab, tlens,
                           q_positions=(tlens - 1)[:, None],
                           logit_softcap=softcap, window=window)[:, 0]
    assert np.abs(got.numpy() - exp_ref).max() < 1e-5
    assert np.abs(got.numpy() - exp_pal).max() < 1e-5
    before = pa_ops.paged_attention.launches
    via_ops = pa_ops.paged_attention(tq, tkp, tvp, ttab, tlens,
                                     logit_softcap=softcap, window=window)
    assert torch.equal(via_ops, got)
    assert pa_ops.paged_attention.launches == before   # CPU: no launch


def test_paged_plain_multirow_queries_match_jax():
    """Multi-row ``q_positions`` (chunk rows of one lane) against the JAX
    oracle, with and without a window."""
    rng = np.random.default_rng(2)
    H, KV, hd, bs, S = 4, 2, 16, 8, 12
    kp = rng.standard_normal((6, bs, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((6, bs, KV, hd)).astype(np.float32)
    q = rng.standard_normal((1, S, H, hd)).astype(np.float32)
    tables = np.array([[3, 1, 4]], np.int32)
    lens = np.array([20], np.int32)
    qpos = (8 + np.arange(S, dtype=np.int32))[None]
    for window in (0, 5):
        exp = np.asarray(jpa_ref.reference(
            *_j(q, kp, vp, tables, lens), q_positions=jnp.asarray(qpos),
            window=window))
        got = pa_ref.reference(*_t(q, kp, vp, tables, lens),
                               q_positions=torch.from_numpy(qpos),
                               window=window)
        assert np.abs(got.numpy() - exp).max() < 1e-5


SPLIT_CASES = [
    # kv_heads, window, softcap: MQA and GQA, global and a window shorter
    # than the longer lanes' contexts
    (1, 0, 0.0), (4, 0, 0.0), (1, 12, 0.0), (4, 12, 30.0)]


@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("kv_heads,window,softcap", SPLIT_CASES)
def test_paged_split_reference_matches_jax(n_split, kv_heads, window,
                                           softcap):
    """The kernel's split over the context and its combine, as plain
    PyTorch, against the JAX oracle: a lane of context 1 (every split but
    one empty at n_split > 1), lanes ending inside a block and on a block
    boundary, the table's full reach."""
    arrs = _paged_case(11, B=4, H=4, KV=kv_heads, hd=16, bs=8, width=6,
                       lens=[1, 9, 40, 48])
    jq, jkp, jvp, jtab, jlens = _j(*arrs)
    exp = np.asarray(jpa_ref.reference(
        jq[:, None], jkp, jvp, jtab, jlens, q_positions=(jlens - 1)[:, None],
        logit_softcap=softcap, window=window))[:, 0]
    tq, tkp, tvp, ttab, tlens = _t(*arrs)
    got = pa_ref.split_reference(tq, tkp, tvp, ttab, tlens, n_split=n_split,
                                 logit_softcap=softcap, window=window)
    assert np.abs(got.numpy() - exp).max() < 1e-5
    before = pa_ops.paged_attention.launches
    via_ops = pa_ops.paged_attention(tq, tkp, tvp, ttab, tlens,
                                     logit_softcap=softcap, window=window,
                                     n_split=n_split)
    assert torch.equal(via_ops, got)
    assert pa_ops.paged_attention.launches == before   # CPU: no launch
    # bf16: probabilities rounded to bf16 before the product with V, as the
    # kernel and the JAX oracle round them
    exp16 = jpa_ref.reference(
        *(jnp.asarray(a, jnp.bfloat16) for a in (arrs[0][:, None], arrs[1],
                                                 arrs[2])),
        jtab, jlens, q_positions=(jlens - 1)[:, None], logit_softcap=softcap,
        window=window)[:, 0]
    got16 = pa_ref.split_reference(tq.bfloat16(), tkp.bfloat16(),
                                   tvp.bfloat16(), ttab, tlens,
                                   n_split=n_split, logit_softcap=softcap,
                                   window=window)
    assert got16.dtype == torch.bfloat16
    assert np.abs(got16.float().numpy()
                  - np.asarray(exp16, np.float32)).max() < 2e-2


def test_paged_split_bounds_partition_each_lane():
    """Each lane's rows inside the window, [first, n_rows), cut by whole
    blocks into contiguous ranges of at least ``min_blocks`` blocks (but the
    last); the empty ranges come after the live ones."""
    lens = torch.tensor([1, 9, 40, 48, 30], dtype=torch.int32)
    bs, width = 8, 6
    for window, n_split, min_blocks in itertools.product(
            (0, 12), (1, 2, 3, 7), (1, 2)):
        begin, end = pa_ref.split_bounds(lens, block_size=bs,
                                         max_blocks=width, n_split=n_split,
                                         window=window, min_blocks=min_blocks)
        for b, n in enumerate(lens.tolist()):
            first = max(0, n - window) if window else 0
            rows, spans = [], []
            for s in range(n_split):
                lo, hi = begin[b, s].item(), end[b, s].item()
                if lo >= hi:
                    continue
                assert lo == first or lo % bs == 0
                assert hi == n or hi % bs == 0
                rows += list(range(lo, hi))
                spans.append(-(-hi // bs) - lo // bs)
            assert rows == list(range(first, n))
            assert all(k >= min_blocks for k in spans[:-1])
            live = (begin[b] < end[b]).tolist()
            assert live == sorted(live, reverse=True)      # empties last
    # a lane of context 1 at n_split 7: one live split, six empty
    begin, end = pa_ref.split_bounds(lens[:1], block_size=bs,
                                     max_blocks=width, n_split=7)
    assert (begin < end).sum().item() == 1


def test_combine_partials_skips_empty_splits():
    """Empty splits (m = -inf, l = 0) drop out without NaN, whatever their
    scratch holds; a lane with no rows at all gives zeros."""
    rng = np.random.default_rng(12)
    m = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(1, 3, (2, 3, 4)).astype(np.float32))
    acc = torch.from_numpy(rng.standard_normal((2, 3, 4, 16))
                           .astype(np.float32))
    m[0, :, 1:] = -np.inf       # lane 0: only split 0 has rows
    l[0, :, 1:] = 0.0
    acc[0, :, 1:] = np.nan      # never read
    m[1, 2] = -np.inf           # lane 1, head 2: no rows at all
    l[1, 2] = 0.0
    acc[1, 2] = np.nan
    out = pa_ref.combine_partials(m, l, acc)
    assert torch.isfinite(out).all()
    assert torch.allclose(out[0], acc[0, :, 0] / l[0, :, 0, None])
    assert torch.equal(out[1, 2], torch.zeros(16))
    w = torch.exp(m[1, :2] - m[1, :2].amax(-1, keepdim=True))
    exp = (w[..., None] * acc[1, :2]).sum(-2) / (w * l[1, :2]).sum(
        -1, keepdim=True)
    assert torch.allclose(out[1, :2], exp, atol=1e-6)


@pytest.mark.parametrize("B,H,KV,max_blocks,window,expect", [
    (4, 32, 4, 32, 0, 9),        # TinyLlama's trace: 16 (lane, KV) pairs
    (4, 10, 1, 32, 2048, 11),    # recurrentgemma's: splits of >= 3 blocks
    (1, 32, 4, 256, 0, 32),      # one lane at context 4096: the cap
    (1, 10, 1, 256, 2048, 32),   # the same under a window of 2048
    (1, 10, 1, 256, 100, 3),     # a short window: ceil(100 / 16) + 1 blocks
    (64, 32, 4, 32, 0, 1),       # a full batch needs no split
])
def test_paged_wrapper_split_choice(B, H, KV, max_blocks, window, expect):
    assert pa_ops.choose_split(B, H, KV, max_blocks, 16, window,
                               132) == expect


FLASH_CASES = [
    # B, Sq, Skv, H, KV, hd, causal, window, cap
    (2, 128, 128, 4, 2, 16, True, 0, 0.0),
    (1, 128, 128, 4, 4, 16, True, 0, 50.0),
    (1, 128, 256, 4, 1, 16, True, 0, 0.0),       # MQA, queries at the end
    (1, 128, 128, 4, 2, 64, True, 32, 0.0),      # sliding window
    (2, 128, 128, 4, 2, 16, False, 0, 0.0),      # bidirectional
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_jax(case):
    B, Sq, Skv, H, KV, hd, causal, window, cap = case
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    qp = np.arange(Skv - Sq, Skv, dtype=np.int32)
    kp = np.arange(Skv, dtype=np.int32)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    jq, jk, jv, jqp, jkp = _j(q, k, v, qp, kp)
    exp_ref = np.asarray(jfa_ref.reference(jq, jk, jv, q_positions=jqp,
                                           k_positions=jkp, **kw))
    exp_pal = np.asarray(jfa_ops.flash_attention(
        jq, jk, jv, q_positions=jqp, k_positions=jkp, interpret=True, **kw))
    tq, tk, tv, tqp, tkp = _t(q, k, v, qp, kp)
    got = fa_ref.reference(tq, tk, tv, q_positions=tqp, k_positions=tkp,
                           **kw).numpy()
    assert np.abs(got - exp_ref).max() < 2e-5
    assert np.abs(got - exp_pal).max() < 2e-5
    before = fa_ops.flash_attention.launches
    via_ops = fa_ops.flash_attention(tq, tk, tv, q_positions=tqp,
                                     k_positions=tkp, **kw)
    assert np.array_equal(via_ops.numpy(), got)
    assert fa_ops.flash_attention.launches == before


def test_flash_plain_ragged_and_empty_slots_match_jax():
    """Shapes that do not tile (the JAX wrapper's fallback) and -1 slots of
    a dense decode cache, in f32 and bf16."""
    rng = np.random.default_rng(4)
    for Sq, Skv, empty_from in ((37, 37, None), (1, 48, 30)):
        q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
        k = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
        v = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
        kp = np.arange(Skv, dtype=np.int32)
        if empty_from is None:
            qp = kp
        else:
            kp = np.where(kp < empty_from, kp, -1).astype(np.int32)
            qp = np.array([empty_from - 1], np.int32)
        exp = np.asarray(jfa_ops.flash_attention(
            *_j(q, k, v), q_positions=jnp.asarray(qp),
            k_positions=jnp.asarray(kp), interpret=True))
        tq, tk, tv, tqp, tkp = _t(q, k, v, qp, kp)
        got = fa_ops.flash_attention(tq, tk, tv, q_positions=tqp,
                                     k_positions=tkp)
        assert np.abs(got.numpy() - exp).max() < 2e-5
        exp16 = jfa_ref.reference(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
            q_positions=jnp.asarray(qp), k_positions=jnp.asarray(kp))
        got16 = fa_ops.flash_attention(
            tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), q_positions=tqp,
            k_positions=tkp)
        err = np.abs(got16.float().numpy()
                     - np.asarray(exp16, np.float32)).max()
        assert err < 2e-2


@pytest.mark.parametrize("n_split", [None, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_head_dim_96_matches_jax(n_split, dtype):
    """Phi-3-Vision's shape class: head dim 96, one query head per KV head
    (MHA), ragged contexts, against the JAX kernel in interpret mode (and
    the split and combine at n_split 3); bf16 to the flash bf16 bar."""
    arrs = _paged_case(21, B=3, H=4, KV=4, hd=96, bs=16, width=4,
                       lens=[1, 33, 64])
    jq, jkp, jvp, jtab, jlens = _j(*arrs)
    tq, tkp, tvp, ttab, tlens = _t(*arrs)
    if dtype == "bfloat16":
        jq, jkp, jvp = (a.astype(jnp.bfloat16) for a in (jq, jkp, jvp))
        tq, tkp, tvp = (a.bfloat16() for a in (tq, tkp, tvp))
    exp = np.asarray(jpa_ops.paged_attention(
        jq, jkp, jvp, jtab, jlens, interpret=True), np.float32)
    got = pa_ops.paged_attention(tq, tkp, tvp, ttab, tlens,
                                 n_split=n_split).float().numpy()
    assert got.shape == (3, 4, 96)
    assert np.abs(got - exp).max() < (1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_head_dim_96_matches_jax(causal):
    """Head dim 96 through the flash plain version and the JAX kernel in
    interpret mode: causal prefill at Phi-3's MHA grouping, and non-causal
    cross attention over a gathered set whose tail positions are -1."""
    rng = np.random.default_rng(22)
    Sq, Skv = (37, 37) if causal else (5, 48)
    q = rng.standard_normal((2, Sq, 4, 96)).astype(np.float32)
    k = rng.standard_normal((2, Skv, 4, 96)).astype(np.float32)
    v = rng.standard_normal((2, Skv, 4, 96)).astype(np.float32)
    kp = np.arange(Skv, dtype=np.int32)
    if causal:
        qp = kp
    else:
        kp = np.where(kp < 40, kp, -1).astype(np.int32)
        qp = np.zeros(Sq, np.int32)
    exp = np.asarray(jfa_ops.flash_attention(
        *_j(q, k, v), q_positions=jnp.asarray(qp),
        k_positions=jnp.asarray(kp), causal=causal, interpret=True))
    tq, tk, tv, tqp, tkp = _t(q, k, v, qp, kp)
    got = fa_ops.flash_attention(tq, tk, tv, q_positions=tqp,
                                 k_positions=tkp, causal=causal)
    assert got.shape == (2, Sq, 4, 96)
    assert np.abs(got.numpy() - exp).max() < 2e-5
    exp16 = np.asarray(jfa_ref.reference(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        q_positions=jnp.asarray(qp), k_positions=jnp.asarray(kp),
        causal=causal), np.float32)
    got16 = fa_ops.flash_attention(tq.bfloat16(), tk.bfloat16(),
                                   tv.bfloat16(), q_positions=tqp,
                                   k_positions=tkp, causal=causal)
    assert np.abs(got16.float().numpy() - exp16).max() < 2e-2


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    q, kp, vp, tables, lens = _t(*_paged_case(5, B=2, H=4, KV=2, hd=16,
                                              bs=8, width=2, lens=[3, 9]))
    with pytest.raises(ValueError, match="group"):
        pa_ops.paged_attention(q[:, :3].contiguous(), kp, vp, tables, lens)
    with pytest.raises(ValueError, match="contiguous"):
        pa_ops.paged_attention(q.transpose(0, 1).contiguous()
                               .transpose(0, 1), kp, vp, tables, lens)
    with pytest.raises(ValueError, match="int32"):
        pa_ops.paged_attention(q, kp, vp, tables.long(), lens)
    with pytest.raises(ValueError, match="head dim"):
        pa_ops.paged_attention(q[..., :8].contiguous(),
                               kp[..., :8].contiguous(),
                               vp[..., :8].contiguous(), tables, lens)
    wide = torch.zeros((1, 17, 256))            # 17 heads on one KV head
    pool = torch.zeros((2, 8, 1, 256))
    with pytest.raises(ValueError, match="heads per KV head"):
        pa_ops.paged_attention(wide, pool, pool, tables[:1], lens[:1])
    for bad in (0, -1, 257, 2.0, True, "3"):
        with pytest.raises(ValueError, match="n_split"):
            pa_ops.paged_attention(q, kp, vp, tables, lens, n_split=bad)

    rng = np.random.default_rng(6)
    fq, fk, fv = _t(rng.standard_normal((1, 9, 4, 16)).astype(np.float32),
                    rng.standard_normal((1, 9, 2, 16)).astype(np.float32),
                    rng.standard_normal((1, 9, 2, 8)).astype(np.float32))
    pos = torch.arange(9, dtype=torch.int32)
    with pytest.raises(ValueError, match="head dims"):   # dv != dqk (MLA)
        fa_ops.flash_attention(fq, fk, fv, q_positions=pos, k_positions=pos)
    with pytest.raises(ValueError, match="group"):
        fa_ops.flash_attention(fq[:, :, :3].contiguous(), fk, fk,
                               q_positions=pos, k_positions=pos)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(fq.transpose(1, 2).contiguous()
                               .transpose(1, 2), fk, fk, q_positions=pos,
                               k_positions=pos)
    with pytest.raises(ValueError, match="dtype"):
        fa_ops.flash_attention(fq.double(), fk.double(), fk.double(),
                               q_positions=pos, k_positions=pos)
