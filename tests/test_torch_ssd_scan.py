"""The port's SSD-scan plain version and wrapper against the JAX package on
the CPU.

Same inputs, made with numpy from a seed by the recipe of the JAX kernel
test (``tests/test_kernels_ssd.py::_inputs``), go through the JAX oracle
(``ref.reference``), the JAX Pallas kernel in interpret mode, the model's
``_ssd_chunked_core`` with an initial state, and the port's plain version.
The bar is the JAX kernel test's own: max abs error 1e-4 on y and on the
final state (f32).  Also pins the wrapper's dispatch: CPU tensors run the
plain version without counting a launch, and what the CUDA kernel does not
take raises on any device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import reference as jreference
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.models.ssm import _ssd_chunked_core as j_chunked_core
from repro_torch.kernels.ssd_scan import ops, ref

torch.set_num_threads(2)
TOL = 1e-4
CASES = [
    # B, S, nh, hd, ns, chunk (the JAX kernel test's CASES)
    (2, 128, 4, 16, 32, 32),
    (1, 256, 2, 64, 128, 64),
    (2, 64, 8, 32, 16, 64),    # chunk == S
    (1, 96, 3, 8, 8, 32),      # odd head count
]


def _inputs(B, S, nh, hd, ns, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, nh)), 0.0)
    A = -np.exp(rng.standard_normal(nh) * 0.3)
    Bm = rng.standard_normal((B, S, ns)) / np.sqrt(ns)
    Cm = rng.standard_normal((B, S, ns)) / np.sqrt(ns)
    D = np.ones(nh)
    return [a.astype(np.float32) for a in (xs, dt, A, Bm, Cm, D)]


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _err(got, exp):
    return float(np.abs(np.asarray(got) - np.asarray(exp)).max())


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_reference_and_pallas(case):
    B, S, nh, hd, ns, chunk = case
    arrs = _inputs(B, S, nh, hd, ns)
    y, st = ref.reference(*_t(arrs), chunk=chunk)
    ye, ste = jreference(*map(jnp.asarray, arrs), chunk=chunk)
    assert _err(y, ye) < TOL and _err(st, ste) < TOL
    yp, stp = jssd_scan(*map(jnp.asarray, arrs), chunk=chunk,
                        interpret=True)
    assert _err(y, yp) < TOL and _err(st, stp) < TOL


@pytest.mark.parametrize("B,S,nh,hd,ns,chunk", [
    (1, 64, 4, 16, 16, 16),
    (2, 48, 3, 8, 8, 32),       # 32 does not divide 48: L = 24
    (1, 13, 8, 16, 16, 16),     # prime S: one chunk of 13
    (1, 40, 2, 64, 128, 256),   # mamba2-370m's head and state dims
])
def test_plain_with_init_state_matches_chunked_core(B, S, nh, hd, ns,
                                                    chunk):
    arrs = _inputs(B, S, nh, hd, ns, seed=1)
    h0 = np.random.default_rng(2).standard_normal(
        (B, nh, hd, ns)).astype(np.float32)
    y, st = ref.reference(*_t(arrs), chunk=chunk,
                          init_state=torch.from_numpy(h0))
    ye, ste = j_chunked_core(*map(jnp.asarray, arrs), chunk,
                             init_state=jnp.asarray(h0))
    assert _err(y, ye) < TOL and _err(st, ste) < TOL


def test_state_carried_across_calls_equals_one_call():
    """The kernel's scheme on the CPU: fixed 32-row chunks with a ragged
    last one, the state carried from chunk to chunk as the next call's
    initial state, gives the one-call result of a prime length."""
    S = 101
    xs, dt, A, Bm, Cm, D = _t(_inputs(1, S, 4, 16, 32, seed=4))
    y_all, st_all = ref.reference(xs, dt, A, Bm, Cm, D, chunk=S)
    ys, state = [], None
    for c0 in range(0, S, 32):
        sl = slice(c0, min(S, c0 + 32))
        y, state = ref.reference(xs[:, sl], dt[:, sl], A, Bm[:, sl],
                                 Cm[:, sl], D, chunk=32, init_state=state)
        ys.append(y)
    assert _err(torch.cat(ys, dim=1), y_all) < TOL
    assert _err(state, st_all) < TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_runs_plain_version_on_cpu(dtype):
    xs, dt, A, Bm, Cm, D = _t(_inputs(2, 40, 3, 16, 16, seed=5))
    xs, Bm, Cm = xs.to(dtype), Bm.to(dtype), Cm.to(dtype)
    h0 = torch.randn((2, 3, 16, 16), generator=torch.Generator().manual_seed(0))
    before = ops.ssd_scan.launches
    y, st = ops.ssd_scan(xs, dt, A, Bm, Cm, D, chunk=16, init_state=h0)
    ye, ste = ref.reference(xs, dt, A, Bm, Cm, D, chunk=16, init_state=h0)
    assert torch.equal(y, ye) and torch.equal(st, ste)
    assert y.dtype == st.dtype == torch.float32
    assert ops.ssd_scan.launches == before


def _bad(name):
    xs, dt, A, Bm, Cm, D = _t(_inputs(1, 8, 2, 16, 16, seed=6))
    kw = {}
    if name == "head_dim":
        xs = torch.zeros((1, 8, 2, 24))
    elif name == "state_dim":
        Bm, Cm = torch.zeros((1, 8, 64)), torch.zeros((1, 8, 64))
    elif name == "dt_dtype":
        dt = dt.to(torch.bfloat16)
    elif name == "x_dtype":
        xs = xs.half()
    elif name == "mixed_dtypes":
        Bm = Bm.to(torch.bfloat16)
    elif name == "non_contiguous":
        xs = xs.transpose(2, 3).contiguous().transpose(2, 3)
    elif name == "A_shape":
        A = torch.zeros(3)
    elif name == "C_shape":
        Cm = torch.zeros((1, 7, 16))
    elif name == "init_state_shape":
        kw["init_state"] = torch.zeros((1, 2, 16, 8))
    elif name == "init_state_dtype":
        kw["init_state"] = torch.zeros((1, 2, 16, 16), dtype=torch.bfloat16)
    elif name == "empty":
        xs, dt = xs[:, :0], dt[:, :0]
        Bm, Cm = Bm[:, :0], Cm[:, :0]
    return (xs, dt, A, Bm, Cm, D), kw


@pytest.mark.parametrize("name", [
    "head_dim", "state_dim", "dt_dtype", "x_dtype", "mixed_dtypes",
    "non_contiguous", "A_shape", "C_shape", "init_state_shape",
    "init_state_dtype", "empty"])
def test_wrapper_refuses_what_the_kernel_does_not_take(name):
    args, kw = _bad(name)
    with pytest.raises(ValueError, match="ssd_scan"):
        ops.ssd_scan(*args, **kw)


# The kernel's order on the CPU: ``chunked_reference`` walks fixed 64-row
# chunks from the start (the ragged last one padded) and, with
# ``split_operands``, feeds M, h and w x to its products as two bf16 terms,
# as the Hopper kernel's bf16 body does.  Held against the JAX oracle at the
# JAX kernel test's bar, on its cases and at mamba2-370m's full width, with
# f32 x/B/C and with x/B/C rounded to bf16 (both packages get the rounded
# numbers).
FULL_WIDTH = (1, 131, 32, 64, 128, 256)


def _bf16_rounded(arrs):
    """x, B and C rounded to bf16 (kept as float32 numpy arrays)."""
    out = list(arrs)
    for i in (0, 3, 4):
        out[i] = torch.from_numpy(out[i]).to(torch.bfloat16).float().numpy()
    return out


@pytest.mark.parametrize("rounded", [False, True], ids=["f32", "bf16_xbc"])
@pytest.mark.parametrize("split", [False, True], ids=["f32_ops", "hi_lo"])
@pytest.mark.parametrize("case", CASES + [FULL_WIDTH])
def test_chunked_reference_matches_jax(case, split, rounded):
    B, S, nh, hd, ns, chunk = case
    arrs = _inputs(B, S, nh, hd, ns, seed=7)
    if rounded:
        arrs = _bf16_rounded(arrs)
    y, st = ref.chunked_reference(*_t(arrs), chunk=64,
                                  split_operands=split)
    ye, ste = jreference(*map(jnp.asarray, arrs), chunk=chunk)
    assert _err(y, ye) < TOL and _err(st, ste) < TOL


@pytest.mark.parametrize("B,S,nh,hd,ns", [
    (2, 100, 3, 16, 16),       # two chunks, the second ragged
    (1, 131, 32, 64, 128),     # mamba2-370m's prefill of 131 rows
])
def test_chunked_reference_with_init_state_matches_chunked_core(B, S, nh, hd,
                                                                ns):
    arrs = _bf16_rounded(_inputs(B, S, nh, hd, ns, seed=8))
    h0 = np.random.default_rng(9).standard_normal(
        (B, nh, hd, ns)).astype(np.float32)
    xs, dt, A, Bm, Cm, D = _t(arrs)
    y, st = ref.chunked_reference(
        xs.to(torch.bfloat16), dt, A, Bm.to(torch.bfloat16),
        Cm.to(torch.bfloat16), D, chunk=64, split_operands=True,
        init_state=torch.from_numpy(h0))
    ye, ste = j_chunked_core(*map(jnp.asarray, arrs), 256,
                             init_state=jnp.asarray(h0))
    assert _err(y, ye) < TOL and _err(st, ste) < TOL


def test_single_bf16_rounding_misses_the_bar():
    """Why the kernel splits its f32 operands: fed as one bf16 rounding,
    M, h and w x miss the 1e-4 bar at mamba2-370m's width; as hi + lo they
    meet it."""
    arrs = _bf16_rounded(_inputs(*FULL_WIDTH[:5], seed=10))
    ye, ste = jreference(*map(jnp.asarray, arrs), chunk=256)
    errs = {}
    for terms in (1, 2):
        y, st = ref.chunked_reference(*_t(arrs), chunk=64,
                                      split_operands=True, terms=terms)
        errs[terms] = max(_err(y, ye), _err(st, ste))
    assert errs[1] > TOL > errs[2]
