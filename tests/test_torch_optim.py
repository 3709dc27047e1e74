"""The port's RMSNorm backward, cross entropy, AdamW, clipping, schedules
and optimizer-state conversion against the JAX package on the CPU.

Same numpy-seeded inputs through both packages.  Bars, by dtype and by
what differs:

* ``rms_norm``'s VJP: f32 values and cotangents within 1e-6 of the
  leaf's max-abs (the same f32 math, sums in another order); bf16 within
  2^-7 of it (one bf16 rounding step), and the cotangents in the input
  dtypes;
* ``cross_entropy``: loss 1e-6 relative, d logits 1e-6 of their max-abs;
* AdamW over 3 steps (a decayed 2-D leaf, a 1-D leaf, an ``ln`` leaf, a
  bf16 leaf, clipping on and off): parameters, moments, step, grad norm
  within 1e-6;
* schedules: 1e-7 relative (f32 arithmetic in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.train import cross_entropy as jcross_entropy
from repro_torch import configs, optim
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models import blocks
from repro_torch.train import cross_entropy
from repro_torch.tree import flatten, tree_map, unflatten

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _near(got, exp, frac):
    """max |got - exp| <= frac x max |exp|."""
    got, exp = _np(got), _np(exp)
    assert got.shape == exp.shape
    err = np.abs(got - exp).max()
    assert err <= frac * max(np.abs(exp).max(), 1e-30), (err, frac)


@pytest.mark.parametrize("x_dtype,s_dtype", [("float32", "float32"),
                                             ("bfloat16", "bfloat16"),
                                             ("bfloat16", "float32")])
def test_rms_norm_vjp_matches_jax(x_dtype, s_dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    s = rng.standard_normal(64).astype(np.float32) * 0.1
    g = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jx, js = jnp.asarray(x, JDT[x_dtype]), jnp.asarray(s, JDT[s_dtype])
    jout, vjp = jax.vjp(lambda a, b: jblocks.rms_norm(a, b, 1e-6), jx, js)
    jdx, jds = vjp(jnp.asarray(g, JDT[x_dtype]))

    tx = torch.tensor(x).to(TDT[x_dtype]).requires_grad_()
    ts = torch.tensor(s).to(TDT[s_dtype]).requires_grad_()
    tout = blocks.rms_norm(tx, ts, 1e-6)
    tdx, tds = torch.autograd.grad(tout, (tx, ts),
                                   torch.tensor(g).to(TDT[x_dtype]))
    assert (tout.dtype, tdx.dtype, tds.dtype) == (
        TDT[x_dtype], TDT[x_dtype], TDT[s_dtype])
    assert (jdx.dtype, jds.dtype) == (JDT[x_dtype], JDT[s_dtype])
    bar = 1e-6 if x_dtype == "float32" else 2 ** -7
    for got, exp in ((tout, jout), (tdx, jdx), (tds, jds)):
        _near(got, exp, bar)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax_with_pad_columns(dtype):
    rng = np.random.default_rng(4)
    V, real = 40, 32
    logits = (rng.standard_normal((2, 6, V)) * 4).astype(np.float32)
    logits[..., real:] = -1e30                # lm.forward's pad-id mask
    labels = rng.integers(0, real, (2, 6)).astype(np.int32)
    jl = jnp.asarray(logits, JDT[dtype])
    jloss, jgrad = jax.value_and_grad(jcross_entropy)(jl, jnp.asarray(labels))
    tl = torch.tensor(logits).to(TDT[dtype]).requires_grad_()
    tloss = cross_entropy(tl, torch.tensor(labels))
    (tgrad,) = torch.autograd.grad(tloss, tl)
    assert tloss.dtype == torch.float32 and tgrad.dtype == TDT[dtype]
    assert abs(tloss.item() - float(jloss)) <= 1e-6 * abs(float(jloss))
    _near(tgrad, jgrad, 1e-6 if dtype == "float32" else 2 ** -7)


def _opt_tree(rng):
    """A parameter tree with a decayed 2-D leaf, a 1-D leaf, an ``ln``
    leaf of two dims (no decay by its name) and a bf16 leaf."""
    return {"embed": rng.standard_normal((6, 4)).astype(np.float32),
            "bias": rng.standard_normal(4).astype(np.float32),
            "seg0": {"c0": {"attn": {
                "ln": rng.standard_normal((2, 4)).astype(np.float32),
                "wq": rng.standard_normal((2, 4, 4)).astype(np.float32)}}}}


def _both_trees(tree):
    jt = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(a, jnp.bfloat16 if p[-1].key == "wq"
                                 else jnp.float32), tree)
    tt = tree_map(lambda a: torch.tensor(a), tree)
    tt["seg0"]["c0"]["attn"]["wq"] = tt["seg0"]["c0"]["attn"]["wq"].to(
        torch.bfloat16)
    return jt, tt


def _close_trees(ttree, jtree, atol):
    jflat = {tuple(str(k.key) for k in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tflat = dict(flatten(ttree))
    assert set(jflat) == set(tflat)
    for path, leaf in tflat.items():
        assert _np(leaf).dtype == np.float32
        err = np.abs(_np(leaf) - _np(jflat[path])).max()
        assert err <= atol, (path, err)


@pytest.mark.parametrize("grad_scale", [0.05, 5.0])
def test_adamw_three_steps_match_jax(grad_scale):
    """grad_scale 0.05: no step clips; 5.0: every step clips."""
    rng = np.random.default_rng(5)
    jp, tp = _both_trees(_opt_tree(rng))
    jstate, tstate = joptim.init_state(jp), optim.init_state(tp)
    cfg = joptim.AdamWConfig()
    jlr, tlr = joptim.warmup_cosine(1e-2, 1, 3), optim.warmup_cosine(1e-2, 1,
                                                                      3)
    for step in range(3):
        g = jax.tree.map(lambda a: a * grad_scale, _opt_tree(rng))
        jg, tg = _both_trees(g)
        jp, jstate, jm = joptim.update(jp, jg, jstate, jlr(step + 1), cfg)
        tp, tstate, tm = optim.update(tp, tg, tstate, tlr(step + 1),
                                      optim.AdamWConfig())
        assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        assert tm["lr"].item() == float(jm["lr"])
    assert (grad_scale > 1) == (float(jm["grad_norm"]) > cfg.clip_norm)
    assert tp["seg0"]["c0"]["attn"]["wq"].dtype == torch.bfloat16
    assert tstate["step"].dtype == torch.int32
    assert tstate["step"].item() == int(jstate["step"]) == 3
    _close_trees(tp, jp, 1e-6)
    _close_trees(tstate["m"], jstate["m"], 1e-6)
    _close_trees(tstate["v"], jstate["v"], 1e-6)


def test_adamw_decays_only_matrices_without_norm_keys():
    """With zero gradients only decoupled decay moves a leaf: the 2-D
    leaves move, the 1-D leaf and the ``ln`` leaf do not."""
    rng = np.random.default_rng(6)
    _, tp = _both_trees(_opt_tree(rng))
    before = {path: t.clone() for path, t in flatten(tp)}
    zeros = {path: torch.zeros_like(t) for path, t in flatten(tp)}
    optim.update(tp, unflatten(zeros.items()), optim.init_state(tp), 0.5)
    moved = {path[-1] for path, t in flatten(tp)
             if not torch.equal(t, before[path])}
    assert moved == {"embed", "wq"}


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(7)
    jg, tg = _both_trees(_opt_tree(rng))
    jclipped, jnorm = joptim.clip_by_global_norm(jg, max_norm)
    tclipped, tnorm = optim.clip_by_global_norm(tg, max_norm)
    assert abs(tnorm.item() - float(jnorm)) <= 1e-6 * float(jnorm)
    assert abs(optim.global_norm(tg).item() - float(joptim.global_norm(jg))) \
        <= 1e-6 * float(jnorm)
    _close_trees(tclipped, jclipped, 1e-6)


@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (3e-3, 2, 12)),
    ("warmup_cosine", (1e-3, 0, 12, 0.2)),
    ("wsd", (3e-3, 2, 12)),
    ("wsd", (1e-3, 3, 12, 0.25, 0.1)),
    ("constant", (3e-3,)),
])
def test_schedules_match_jax(name, args):
    """1e-7 relative; the cosine's value may differ by up to 2 f32 ulps
    of the cosine at its scale: XLA's f32 ``cos`` can be one ulp from the
    correctly rounded value torch returns (at step 10 of the first case:
    -0x1.9e377cp-1 against -0x1.9e377ap-1), and ``1 + cos`` near -1 keeps
    that ulp while shrinking the value."""
    jlr, tlr = getattr(joptim, name)(*args), getattr(optim, name)(*args)
    cos_slack = 0.0
    if name == "warmup_cosine":
        base, final = args[0], (args[3] if len(args) > 3 else 0.1)
        cos_slack = base * (1 - final) * 0.5 * 2 * 2.0 ** -24
    for step in range(14):
        got, exp = tlr(step), jlr(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(got.item() - float(exp)) <= \
            1e-7 * abs(float(exp)) + cos_slack, step


def test_opt_state_from_numpy_carries_reference_state():
    """The reference's AdamW state after one step, carried across, makes
    the next step of both packages agree."""
    jcfg = jconfigs.get("paper-mlp").reduced()
    cfg = configs.get("paper-mlp").reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    rng = np.random.default_rng(8)
    grads = [jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32) * 0.01), jp)
        for _ in range(2)]
    jp, jstate, _ = joptim.update(jp, grads[0], joptim.init_state(jp), 1e-3)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    tstate = opt_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate),
                                  "cpu")
    assert tstate["step"].dtype == torch.int32 and tstate["step"].item() == 1
    assert all(t.dtype == torch.float32 for _, t in flatten(tstate["m"]))
    _close_trees(tstate["m"], jstate["m"], 0.0)
    _close_trees(tstate["v"], jstate["v"], 0.0)
    tg = params_from_numpy(cfg, jax.tree.map(np.asarray, grads[1]), "cpu")
    jp, jstate, _ = joptim.update(jp, grads[1], jstate, 1e-3)
    tp, tstate, _ = optim.update(tp, tg, tstate, 1e-3)
    _close_trees(tp, jp, 1e-6)
    _close_trees(tstate["v"], jstate["v"], 1e-6)
    with pytest.raises(ValueError, match="optimizer state keys"):
        opt_state_from_numpy(cfg, {"m": {}, "v": {}}, "cpu")
