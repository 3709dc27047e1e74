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
