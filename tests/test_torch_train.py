"""The port's training path against the JAX package on the CPU: one train
step's loss, grad norm and gradients, a 5-step trajectory, gradient
accumulation, rematerialisation, the launcher with checkpoints and resume,
and the kernel wrappers' refusal of inputs that require grad.

The five configs (gemma2-9b: both softcaps, GeGLU, ``emb_scale``, window
layers beside global ones), reduced, in f32, start from the reference's
``lm.init_params`` (carried across by ``repro_torch.convert``) and see the
same ``SyntheticLM`` batches (B 2, S 48: the reduced recurrentgemma's
window of 32 is shorter than the sequence).  The reference trains on its
chunked attention, chunked SSD scan and associative RG-LRU scan; the port
on its plain layers (the sequential RG-LRU scan), so the two differ in
summation order only.  Bars: loss within 1e-5 relative, grad norm within
1e-4 relative, every gradient leaf within 1e-4 of that leaf's max-abs,
and a 5-step trajectory (warmup-cosine, AdamW) within 1e-4 relative.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import lm as jlm
from repro.train import TrainStepConfig as JTrainStepConfig
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs, optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.train import TrainStepConfig, make_train_step, value_and_grad
from repro_torch.tree import flatten, tree_map

ARCHS = ("tinyllama-1.1b", "mamba2-370m", "recurrentgemma-2b", "paper-mlp",
         "gemma2-9b")
SEQ, BATCH = 48, 2
LOSS_RTOL, GNORM_RTOL, LEAF_FRAC, TRAJ_RTOL = 1e-5, 1e-4, 1e-4, 1e-4


def _batch(cfg, step, batch=BATCH, seed=0):
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=batch, seed=seed))
    return {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}


def _jbatch(jcfg, step, batch=BATCH, seed=0):
    data = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                    global_batch=batch, seed=seed))
    return {k: jnp.asarray(v) for k, v in data.batch_at(step).items()}


def _jflat(tree):
    return {tuple(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_grads(loss_fn, params, batch):
    """(loss, metrics, {path: grad}) of the port's ``loss_fn``."""
    loss, metrics, grads = value_and_grad(loss_fn, params, batch)
    assert not any(t.requires_grad for _, t in flatten(params))
    return loss, metrics, {p: g for (p, _), g in zip(flatten(params),
                                                      grads)}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, cfg = jconfigs.get(arch).reduced(), configs.get(arch).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return arch, jcfg, cfg, jp, tp


def test_one_step_gradients_match_jax(model):
    arch, jcfg, cfg, jp, tp = model
    _, jloss_fn = jmake_train_step(jcfg, lambda s: 1e-3, JTrainStepConfig())
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jp, _jbatch(jcfg, 0))
    _, loss_fn = make_train_step(cfg, optim.constant(1e-3))
    loss, metrics, grads = _port_grads(loss_fn, tp, _batch(cfg, 0))

    assert set(metrics) == {"ce", "aux"} and metrics["aux"].item() == 0.0
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * float(jloss)
    jnorm = float(joptim.global_norm(jg))
    tnorm = optim.global_norm(
        {"/".join(p): g for p, g in grads.items()}).item()
    assert abs(tnorm - jnorm) <= GNORM_RTOL * jnorm
    jflat = _jflat(jg)
    assert set(jflat) == set(grads)
    for path, g in grads.items():
        exp = jflat[path]
        err = np.abs(g.numpy() - exp).max()
        assert err <= LEAF_FRAC * np.abs(exp).max(), (arch, path, err)


def test_five_step_trajectory_matches_jax(model):
    arch, jcfg, cfg, jp, tp = model
    jstep, _ = jmake_train_step(jcfg, joptim.warmup_cosine(3e-3, 2, 5))
    jstep = jax.jit(jstep)
    jopt = joptim.init_state(jp)
    step_fn, _ = make_train_step(cfg, optim.warmup_cosine(3e-3, 2, 5))
    tp = tree_map(torch.clone, tp)
    topt = optim.init_state(tp)
    for i in range(5):
        jp, jopt, jm = jstep(jp, jopt, _jbatch(jcfg, i), jnp.asarray(i))
        tp, topt, tm = step_fn(tp, topt, _batch(cfg, i), i)
        assert set(tm) == {"loss", "ce", "aux", "grad_norm", "lr"}
        for key in ("loss", "grad_norm"):
            exp = float(jm[key])
            assert abs(tm[key].item() - exp) <= TRAJ_RTOL * exp, (arch, i,
                                                                  key)
    assert topt["step"].item() == 5
    assert not any(t.requires_grad for _, t in flatten(tp))


def test_grad_accum_matches_jax_grad_accum():
    jcfg = jconfigs.get("tinyllama-1.1b").reduced()
    cfg = configs.get("tinyllama-1.1b").reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    jstep, _ = jmake_train_step(jcfg, lambda s: 1e-3,
                                JTrainStepConfig(grad_accum=2))
    jp2, _, jm = jax.jit(jstep)(jp, joptim.init_state(jp),
                                _jbatch(jcfg, 0, batch=4), jnp.asarray(0))
    step_fn, _ = make_train_step(cfg, optim.constant(1e-3),
                                 TrainStepConfig(grad_accum=2))
    tp2, _, tm = step_fn(tp, optim.init_state(tp), _batch(cfg, 0, batch=4),
                         0)
    for key in ("loss", "ce", "grad_norm"):
        exp = float(jm[key])
        assert abs(tm[key].item() - exp) <= TRAJ_RTOL * exp, key
    # a first AdamW step moves each element by lr g / (|g| + eps), which
    # turns a rounding-sized difference in a near-zero g into up to lr:
    # the parameters are held to a tenth of lr
    jflat = _jflat(jp2)
    for path, t in flatten(tp2):
        assert np.abs(t.numpy() - jflat[path]).max() <= 0.1 * 1e-3, path
    with pytest.raises(ValueError, match="microbatches"):
        step_fn(tp, optim.init_state(tp), _batch(cfg, 0, batch=3), 0)


def test_grad_accum_matches_full_batch():
    """The reference's own bars between grad_accum 2 and 1."""
    cfg = configs.get("paper-mlp").reduced()
    gen = torch.Generator().manual_seed(2)
    p0 = lm.init_params(cfg, gen, "cpu", torch.float32)
    out = []
    for n in (1, 2):
        p = tree_map(torch.clone, p0)
        step_fn, _ = make_train_step(cfg, optim.constant(1e-3),
                                     TrainStepConfig(grad_accum=n))
        out.append(step_fn(p, optim.init_state(p), _batch(cfg, 0, 4), 0))
    (p1, _, m1), (p2, _, m2) = out
    assert abs(m1["loss"].item() - m2["loss"].item()) < 1e-4
    assert max((a - b).abs().max().item() for (_, a), (_, b)
               in zip(flatten(p1), flatten(p2))) < 5e-3


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-2b"])
def test_remat_on_and_off_agree(arch):
    cfg = configs.get(arch).reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                            torch.float32)
    batch = _batch(cfg, 1)
    runs = []
    for remat in (True, False):
        _, loss_fn = make_train_step(cfg, optim.constant(1e-3),
                                     TrainStepConfig(remat=remat))
        runs.append(_port_grads(loss_fn, params, batch))
    (l1, _, g1), (l2, _, g2) = runs
    assert abs(l1.item() - l2.item()) <= 1e-6 * l2.item()
    for path in g1:
        assert (g1[path] - g2[path]).abs().max() <= \
            1e-6 * g2[path].abs().max(), path


def test_train_mode_refuses_kernels_and_caches():
    cfg = configs.get("tinyllama-1.1b").reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(4), "cpu",
                            torch.float32)
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="no kernel"):
        lm.forward(cfg, params, toks, mode="train", impl="kernel")
    with pytest.raises(ValueError, match="no cache"):
        lm.forward(cfg, params, toks, mode="train", impl="plain",
                   cache=lm.init_cache(cfg, 1, 16, torch.float32, "cpu"))
    with pytest.raises(ValueError, match="train mode only"):
        lm.forward(cfg, params, toks, mode="prefill", remat=True)
    logits, cache, _ = lm.forward(cfg, params, toks, mode="train",
                                  impl="plain")
    assert cache is None and logits.shape == (1, 8, cfg.padded_vocab)


def test_ssd_gradients_stay_finite_where_the_reference_overflows():
    """The reference's chunked SSD core masks the chunk's upper triangle
    after ``exp(seg_i - seg_j)``; once a chunk's decay passes ~88 nats
    (here 64 rows at dt 2, A -1; at full width a chunk of 256 rows at dt
    ~0.7) that exp is inf, and the mask's zero cotangent times inf makes
    the gradient of dt (and of all that feeds it) NaN.  The port masks
    before the exp: the same forward,
    finite gradients, equal to those of ``chunked_reference`` (which masks
    the same way in the kernel's order).  The reference's NaN is pinned."""
    from repro.models import ssm as jssm
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    rng = np.random.default_rng(10)
    B, S, nh, hd, ns = 1, 64, 2, 4, 8
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((B, S, nh, hd), (B, S, ns), (B, S, ns), (B, S, nh, hd))]
    dt = np.full((B, S, nh), 2.0, np.float32)
    A, D = -np.ones(nh, np.float32), np.ones(nh, np.float32)
    xs, Bm, Cm, cot = arrs

    def jloss(x, d, b, c):
        y, _ = jssm._ssd_chunked_core(x, d, jnp.asarray(A), b, c,
                                      jnp.asarray(D), S)
        return jnp.sum(y * cot), y

    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                         has_aux=True)(xs, dt, Bm, Cm)
    assert np.isnan(np.asarray(jgrads[1])).all()      # d dt: pinned

    def port(fn):
        ins = [torch.tensor(a, requires_grad=True) for a in (xs, dt, Bm, Cm)]
        y, _ = fn(ins[0], ins[1], torch.tensor(A), ins[2], ins[3],
                  torch.tensor(D), chunk=S)
        return y, torch.autograd.grad((y * torch.tensor(cot)).sum(), ins)

    y, grads = port(ssd_ref.reference)
    _, chunked = port(ssd_ref.chunked_reference)
    err = np.abs(y.detach().numpy() - np.asarray(jy)).max()
    assert err <= 1e-5 * np.abs(np.asarray(jy)).max()
    for i, (g, c) in enumerate(zip(grads, chunked)):
        assert torch.isfinite(g).all()
        assert (g - c).abs().max() <= 1e-4 * c.abs().max()
        if i != 1:                   # x, B, C: the reference's are finite
            exp = np.asarray(jgrads[i])
            assert np.abs(g.numpy() - exp).max() <= \
                1e-4 * np.abs(exp).max()


def _kernel_calls():
    """Each wrapper with small CPU inputs; the first tensor is the one
    that gets ``requires_grad``."""
    g = torch.Generator().manual_seed(5)
    r = lambda *s: torch.randn(s, generator=g)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    pos = torch.arange(4, dtype=torch.int32)
    return {
        "flash_attention": (lambda q: fa_ops.flash_attention(
            q, r(1, 4, 1, 16), r(1, 4, 1, 16), q_positions=pos,
            k_positions=pos), r(1, 4, 2, 16)),
        "paged_attention": (lambda q: pa_ops.paged_attention(
            q, r(3, 4, 1, 16), r(3, 4, 1, 16), i32([0, 1]), i32(5)),
            r(1, 2, 16)),
        "ssd_scan": (lambda xs: ssd_ops.ssd_scan(
            xs, r(1, 8, 2).abs(), -r(2).abs(), r(1, 8, 8), r(1, 8, 8),
            r(2)), r(1, 8, 2, 8)),
        "rglru_scan": (lambda a: rglru_ops.rglru_scan(
            a, r(1, 4, 16), r(1, 16)), torch.rand((1, 4, 16), generator=g)),
    }


@pytest.mark.parametrize("name", sorted(_kernel_calls()))
def test_kernel_wrapper_refuses_inputs_that_require_grad(name):
    call, x = _kernel_calls()[name]
    x.requires_grad_()
    with pytest.raises(RuntimeError,
                       match=f"the {name} kernel has no backward"):
        call(x)
    with torch.no_grad():                      # serving: no gradient asked
        call(x)
    call(x.detach())                           # leaves that need no grad


def test_kernel_forward_with_trainable_params_raises():
    """The hazard the guard closes: a kernel forward under autograd would
    drop every upstream gradient; it raises instead of falling back."""
    cfg = configs.get("tinyllama-1.1b").reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(6), "cpu",
                            torch.float32)
    for _, t in flatten(params):
        t.requires_grad_()
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="has no backward"):
        lm.forward(cfg, params, toks, mode="prefill", impl="kernel")
    with torch.no_grad():
        lm.forward(cfg, params, toks, mode="prefill", impl="kernel")


def _launch(*extra):
    return launch_train.main(["--arch", "tinyllama-1.1b", "--reduced",
                              "--seq", "32", "--batch", "2", "--log-every",
                              "1", "--device", "cpu", *extra])


def test_launcher_trains_checkpoints_and_resumes(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    ckpt = str(tmp_path / "ckpt")
    straight = _launch("--steps", "4")
    out = capsys.readouterr().out
    assert re.search(r"^\[plan\] CompiledPlan\[tinyllama-1\.1b x cli k=2 "
                     r"tensor\]", out, re.M)
    assert "(plan-cache hit)" not in out
    assert re.search(r"^\[init\] tinyllama-1\.1b params=.*dtype=float32",
                     out, re.M)
    assert re.search(r"^\[done\] median step \d+ms; stragglers detected: 0",
                     out, re.M)
    assert straight["plan"].shape.kind == "train"
    assert straight["dtype"] == torch.float32
    assert [h["step"] for h in straight["history"]] == [0, 1, 2, 3]

    first = _launch("--steps", "2", "--ckpt-dir", ckpt)
    assert "(plan-cache hit)" in capsys.readouterr().out     # same shape
    resumed = _launch("--steps", "4", "--ckpt-dir", ckpt, "--resume",
                      "--ckpt-every", "3")
    out = capsys.readouterr().out
    assert "[resume] from step 2" in out and "(plan-cache hit)" in out
    assert [h["step"] for h in resumed["history"]] == [2, 3]
    assert CheckpointManager(ckpt).all_steps() == [2, 3, 4]
    for got, exp in zip(first["history"] + resumed["history"],
                        straight["history"]):
        assert got["step"] == exp["step"] and got["lr"] == exp["lr"]
        assert abs(got["loss"] - exp["loss"]) <= 1e-6 * exp["loss"]
    assert resumed["telemetry"].losses() == [h["loss"] for h in
                                             resumed["history"]]


@pytest.mark.parametrize("flags", [["--data-mesh", "2"],
                                   ["--model-mesh", "2"], ["--multi-pod"]])
def test_launcher_refuses_multi_device(flags):
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        _launch("--steps", "1", *flags)


def test_launcher_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "paper-mlp", "--reduced", "--steps",
                           "1"])
