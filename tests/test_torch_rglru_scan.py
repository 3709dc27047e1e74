"""The port's RG-LRU scan plain version and wrapper against the JAX package
on the CPU.

Same inputs, made with numpy from a seed by the recipe of the JAX kernel
test (``tests/test_kernels_rglru.py``: a = sigmoid(N(0, 1)), bx = N(0, 1)),
go through the JAX oracle (``ref.reference``), the JAX Pallas kernel in
interpret mode, the model's ``_lru_scan`` with an initial state, and the
port's plain version.  The bars are the JAX kernel test's own: max abs
error 1e-4 on hs and h_final, and for near-one decay 1e-3 with finite
outputs (f32; the sequential sum rounds in another order than JAX's
associative scan).  Also pins the wrapper's dispatch: CPU tensors run the
plain version without counting a launch, and what the CUDA kernel does
not take raises on any device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import reference as jreference
from repro.kernels.rglru_scan import rglru_scan as jrglru_scan
from repro.models.rglru import _lru_scan as j_lru_scan
from repro_torch.kernels.rglru_scan import ops, ref

TOL = 1e-4
NEAR_ONE_TOL = 1e-3
CASES = [
    # B, S, W, block_w, chunk (the JAX kernel test's CASES)
    (2, 64, 128, 128, 32),
    (1, 128, 256, 128, 64),
    (2, 96, 64, 32, 32),
    (1, 32, 512, 128, 32),
]


def _inputs(B, S, W, seed=0):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))
    bx = rng.standard_normal((B, S, W))
    return a.astype(np.float32), bx.astype(np.float32)


def _h0(B, W, seed):
    return np.random.default_rng(seed).standard_normal((B, W)).astype(
        np.float32)


def _err(got, exp):
    return float(np.abs(np.asarray(got) - np.asarray(exp)).max())


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_reference_and_pallas(case):
    B, S, W, bw, L = case
    a, bx = _inputs(B, S, W)
    hs, hf = ref.reference(torch.from_numpy(a), torch.from_numpy(bx))
    he, hfe = jreference(jnp.asarray(a), jnp.asarray(bx))
    assert _err(hs, he) < TOL and _err(hf, hfe) < TOL
    hp, hfp = jrglru_scan(jnp.asarray(a), jnp.asarray(bx), block_w=bw,
                          chunk=L, interpret=True)
    assert _err(hs, hp) < TOL and _err(hf, hfp) < TOL


def test_near_one_decay_is_stable():
    """a -> 1 (long memory): finite, and within the JAX test's 1e-3 of the
    oracle and of the Pallas kernel."""
    a = np.full((1, 128, 64), 0.9999, np.float32)
    bx = np.full((1, 128, 64), 1e-3, np.float32)
    hs, hf = ref.reference(torch.from_numpy(a), torch.from_numpy(bx))
    assert torch.isfinite(hs).all() and torch.isfinite(hf).all()
    he, _ = jreference(jnp.asarray(a), jnp.asarray(bx))
    hp, _ = jrglru_scan(jnp.asarray(a), jnp.asarray(bx), interpret=True)
    assert _err(hs, he) < NEAR_ONE_TOL and _err(hs, hp) < NEAR_ONE_TOL


@pytest.mark.parametrize("B,S,W", [(1, 1, 64), (2, 17, 64), (3, 40, 96),
                                   (1, 131, 256)])
def test_plain_with_h0_matches_lru_scan_and_oracle(B, S, W):
    a, bx = _inputs(B, S, W, seed=1)
    h0 = _h0(B, W, seed=2)
    hs, hf = ref.reference(torch.from_numpy(a), torch.from_numpy(bx),
                           torch.from_numpy(h0))
    for fn in (j_lru_scan, jreference):
        he, hfe = fn(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
        assert _err(hs, he) < TOL and _err(hf, hfe) < TOL


def test_state_carried_across_calls_equals_one_call():
    """A prefill split in pieces, each piece's final state the next one's
    h0, gives the one-call result bit for bit: the sequential order of the
    Hopper kernel and the plain version."""
    a, bx = (torch.from_numpy(t) for t in _inputs(2, 53, 64, seed=3))
    h0 = torch.from_numpy(_h0(2, 64, seed=4))
    hs_all, hf_all = ref.reference(a, bx, h0)
    pieces, state = [], h0
    for c0 in range(0, 53, 20):
        hs, state = ref.reference(a[:, c0:c0 + 20], bx[:, c0:c0 + 20],
                                  state)
        pieces.append(hs)
    assert torch.equal(torch.cat(pieces, dim=1), hs_all)
    assert torch.equal(state, hf_all)


@pytest.mark.parametrize("with_h0", [False, True])
def test_wrapper_runs_plain_version_on_cpu(with_h0):
    a, bx = (torch.from_numpy(t) for t in _inputs(2, 30, 48, seed=5))
    h0 = torch.from_numpy(_h0(2, 48, seed=6)) if with_h0 else None
    before = ops.rglru_scan.launches
    hs, hf = ops.rglru_scan(a, bx, h0)
    he, hfe = ref.reference(a, bx, h0)
    assert torch.equal(hs, he) and torch.equal(hf, hfe)
    assert hs.dtype == hf.dtype == torch.float32
    assert hs.shape == (2, 30, 48) and hf.shape == (2, 48)
    assert ops.rglru_scan.launches == before


def _bad(name):
    a, bx = (torch.from_numpy(t) for t in _inputs(2, 8, 16, seed=7))
    h0 = None
    if name == "a_dtype":
        a = a.to(torch.bfloat16)
    elif name == "bx_dtype":
        bx = bx.double()
    elif name == "shapes_disagree":
        bx = bx[:, :7].contiguous()
    elif name == "rank":
        a, bx = a[0], bx[0]
    elif name == "non_contiguous":
        a = a.transpose(1, 2).contiguous().transpose(1, 2)
    elif name == "h0_shape":
        h0 = torch.zeros((2, 8))
    elif name == "h0_dtype":
        h0 = torch.zeros((2, 16), dtype=torch.bfloat16)
    elif name == "empty":
        a, bx = a[:, :0], bx[:, :0]
    return a, bx, h0


@pytest.mark.parametrize("name", [
    "a_dtype", "bx_dtype", "shapes_disagree", "rank", "non_contiguous",
    "h0_shape", "h0_dtype", "empty"])
def test_wrapper_refuses_what_the_kernel_does_not_take(name):
    with pytest.raises(ValueError, match="rglru_scan"):
        ops.rglru_scan(*_bad(name))


# The kernel's order on the CPU: ``chunked_reference`` is the two-pass scan
# over n_chunks chunks of the sequence (super-chunks when the sequence is
# longer than 16 rows a chunk), held against the JAX oracle and the
# sequential plain version at the JAX test's bars, with chunk counts that
# leave chunks empty (S < K) and that need several super-chunks.
@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("n_chunks", [1, 2, 3, 7, 16])
@pytest.mark.parametrize("B,S,W", [(2, 64, 128), (1, 131, 256), (2, 5, 48)])
def test_chunked_reference_matches_jax_and_sequential(B, S, W, n_chunks,
                                                      with_h0):
    a, bx = _inputs(B, S, W, seed=11)
    h0 = _h0(B, W, seed=12) if with_h0 else None
    hs, hf = ref.chunked_reference(
        torch.from_numpy(a), torch.from_numpy(bx),
        None if h0 is None else torch.from_numpy(h0), n_chunks=n_chunks)
    jargs = [jnp.asarray(a), jnp.asarray(bx)]
    if h0 is not None:
        jargs.append(jnp.asarray(h0))
    he, hfe = jreference(*jargs)
    assert _err(hs, he) < TOL and _err(hf, hfe) < TOL
    hq, hfq = ref.reference(torch.from_numpy(a), torch.from_numpy(bx),
                            None if h0 is None else torch.from_numpy(h0))
    assert _err(hs, hq) < TOL and _err(hf, hfq) < TOL


@pytest.mark.parametrize("n_chunks", [1, 3, 16])
@pytest.mark.parametrize("S", [128, 2048])
def test_chunked_reference_near_one_decay(S, n_chunks):
    a = np.full((1, S, 64), 0.9999, np.float32)
    bx = np.full((1, S, 64), 1e-3, np.float32)
    hs, hf = ref.chunked_reference(torch.from_numpy(a), torch.from_numpy(bx),
                                   n_chunks=n_chunks)
    assert torch.isfinite(hs).all() and torch.isfinite(hf).all()
    he, _ = jreference(jnp.asarray(a), jnp.asarray(bx))
    assert _err(hs, he) < NEAR_ONE_TOL


@pytest.mark.parametrize("B,S,W,expect", [
    (1, 131, 2560, 16),    # recurrentgemma-2b's prefill: 160 CTAs of 16
    (1, 17, 2560, 2),      # a short prompt: chunks of at least 8 rows
    (1, 1, 2560, 1),
    (4, 131, 2560, 8),     # 640 CTAs fill the card with fewer chunks
    (64, 131, 2560, 1),    # a large batch needs no split
    (1, 2048, 2560, 32),   # a long prompt: the cap, 16 rows a chunk
    (1, 2048, 64, 32),     # a narrow width: the cap
])
def test_wrapper_chunk_choice(B, S, W, expect):
    assert ops.choose_chunks(B, S, W, 132) == expect


@pytest.mark.parametrize("n_chunks", [1, 3, 16])
def test_wrapper_runs_chunked_reference_when_forced_on_cpu(n_chunks):
    a, bx = (torch.from_numpy(t) for t in _inputs(2, 45, 40, seed=13))
    h0 = torch.from_numpy(_h0(2, 40, seed=14))
    before = ops.rglru_scan.launches
    hs, hf = ops.rglru_scan(a, bx, h0, n_chunks=n_chunks)
    he, hfe = ref.chunked_reference(a, bx, h0, n_chunks=n_chunks)
    assert torch.equal(hs, he) and torch.equal(hf, hfe)
    assert ops.rglru_scan.launches == before


@pytest.mark.parametrize("n_chunks", [0, 33, 2.0])
def test_wrapper_refuses_chunk_counts_the_kernel_does_not_take(n_chunks):
    a, bx = (torch.from_numpy(t) for t in _inputs(1, 8, 16, seed=15))
    with pytest.raises(ValueError, match="rglru_scan"):
        ops.rglru_scan(a, bx, n_chunks=n_chunks)
