"""Training the MoE and modality-frontend archs: the port's train step
against the JAX package's on the CPU.

Reduced deepseek-v2-lite-16b (MLA, a dense layer then MoE layers with a
shared expert), mixtral-8x7b (sliding-window attention with a top-2 MoE
FFN), phi-3-vision-4.2b (8 projected frontend rows ahead of the tokens,
dropped before the loss) and seamless-m4t-medium (an encoder over 8 stub
frames, cross attention in every decoder layer), in f32, start from the
reference's ``lm.init_params`` (carried across by ``repro_torch.convert``)
and see the same ``SyntheticLM`` batches with ``frontend_emb`` (B 2, S 48).
The loss is the cross entropy of the token rows plus the MoE layers'
router aux losses in both packages; a MoE layer drops what its capacity
(factor 1.25) does not keep.  Bars, those of ``test_torch_train.py``: loss,
``ce`` and ``aux`` within 1e-5 relative, grad norm within 1e-4 relative,
every gradient leaf within 1e-4 of that leaf's max-abs, and a 5-step
trajectory (warmup-cosine, AdamW) within 1e-4 relative.

Also: ``grad_accum=2`` on one MoE and one frontend arch, ``n_groups`` and
``capacity_factor`` reaching the MoE layers, ``lm.forward``'s train-mode aux
total, the CPU launcher on one MoE and one frontend arch, and the
reference's launcher taking a step again on ``--resume`` beside the port's
(ROADMAP F9).  The launchers run in subprocesses, each with its plan cache
in the test's temporary directory.
"""

import os
import re
import subprocess
import sys
import textwrap

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
from repro_torch.models import lm
from repro_torch.train import TrainStepConfig, make_train_step, value_and_grad
from repro_torch.tree import flatten, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_ARCHS = ("deepseek-v2-lite-16b", "mixtral-8x7b")
FRONTEND_ARCHS = ("phi-3-vision-4.2b", "seamless-m4t-medium")
ARCHS = MOE_ARCHS + FRONTEND_ARCHS
SEQ, BATCH = 48, 2
LOSS_RTOL, GNORM_RTOL, LEAF_FRAC, TRAJ_RTOL = 1e-5, 1e-4, 1e-4, 1e-4


def _data_cfg(cls, cfg, batch, seed):
    return cls(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=batch,
               seed=seed,
               frontend_tokens=cfg.frontend_tokens if cfg.frontend else 0,
               frontend_dim=cfg.frontend_dim if cfg.frontend else 0)


def _batch(cfg, step, batch=BATCH, seed=0):
    data = SyntheticLM(_data_cfg(DataConfig, cfg, batch, seed))
    return {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}


def _jbatch(jcfg, step, batch=BATCH, seed=0):
    data = JSyntheticLM(_data_cfg(JDataConfig, jcfg, batch, seed))
    return {k: jnp.asarray(v) for k, v in data.batch_at(step).items()}


def _jflat(tree):
    return {tuple(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(got, exp):
    return abs(got - exp) / abs(exp)


def _hold_gradients(arch, jg, tgrads):
    """Grad norm and every leaf of the port's {path: grad} against the
    reference's gradient tree."""
    jnorm = float(joptim.global_norm(jg))
    tnorm = optim.global_norm(
        {"/".join(p): g for p, g in tgrads.items()}).item()
    assert _rel(tnorm, jnorm) <= GNORM_RTOL, (arch, tnorm, jnorm)
    jflat = _jflat(jg)
    assert set(jflat) == set(tgrads)
    for path, g in tgrads.items():
        exp = jflat[path]
        err = np.abs(g.numpy() - exp).max()
        assert err <= LEAF_FRAC * np.abs(exp).max(), (arch, path, err)


def _port_grads(loss_fn, params, batch):
    loss, metrics, grads = value_and_grad(loss_fn, params, batch)
    return loss, metrics, {p: g for (p, _), g in zip(flatten(params),
                                                      grads)}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, cfg = jconfigs.get(arch).reduced(), configs.get(arch).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return arch, jcfg, cfg, jp, tp


def test_one_step_loss_and_gradients_match_jax(model):
    arch, jcfg, cfg, jp, tp = model
    _, jloss_fn = jmake_train_step(jcfg, lambda s: 1e-3, JTrainStepConfig())
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jp, _jbatch(jcfg, 0))
    _, loss_fn = make_train_step(cfg, optim.constant(1e-3))
    loss, metrics, grads = _port_grads(loss_fn, tp, _batch(cfg, 0))

    assert set(metrics) == {"ce", "aux"}
    assert _rel(loss.item(), float(jloss)) <= LOSS_RTOL, arch
    assert _rel(metrics["ce"].item(), float(jm["ce"])) <= LOSS_RTOL, arch
    if arch in MOE_ARCHS:
        assert float(jm["aux"]) > 0
        assert _rel(metrics["aux"].item(), float(jm["aux"])) <= LOSS_RTOL
    else:
        assert float(jm["aux"]) == 0.0 and metrics["aux"].item() == 0.0
    _hold_gradients(arch, jg, grads)


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
        for key in ("loss", "ce", "grad_norm"):
            exp = float(jm[key])
            assert _rel(tm[key].item(), exp) <= TRAJ_RTOL, (arch, i, key)
        if arch in MOE_ARCHS:
            assert _rel(tm["aux"].item(), float(jm["aux"])) <= TRAJ_RTOL
    assert topt["step"].item() == 5
    assert not any(t.requires_grad for _, t in flatten(tp))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi-3-vision-4.2b"])
def test_grad_accum_matches_jax_grad_accum(arch):
    """The batch, ``frontend_emb`` included, splits into two microbatches
    in both packages; a MoE layer's capacity is then per microbatch."""
    jcfg, cfg = jconfigs.get(arch).reduced(), configs.get(arch).reduced()
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
        assert _rel(tm[key].item(), float(jm[key])) <= TRAJ_RTOL, key
    # as in test_torch_train.py: a first AdamW step turns a rounding-sized
    # difference in a near-zero gradient into up to lr, so the parameters
    # are held to a tenth of lr
    jflat = _jflat(jp2)
    for path, t in flatten(tp2):
        assert np.abs(t.numpy() - jflat[path]).max() <= 0.1 * 1e-3, path


def test_n_groups_and_capacity_factor_reach_the_moe_layers():
    """Two dispatch groups and a capacity factor of 0.5 (which drops
    slots) change the step in both packages alike."""
    arch = "mixtral-8x7b"
    jcfg, cfg = jconfigs.get(arch).reduced(), configs.get(arch).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(2), jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    losses = []
    for kw in ({}, {"n_groups": 2, "capacity_factor": 0.5}):
        _, jloss_fn = jmake_train_step(jcfg, lambda s: 1e-3,
                                       JTrainStepConfig(**kw))
        (jloss, jm), jg = jax.jit(
            jax.value_and_grad(jloss_fn, has_aux=True))(jp, _jbatch(jcfg, 3))
        _, loss_fn = make_train_step(cfg, optim.constant(1e-3),
                                     TrainStepConfig(**kw))
        loss, metrics, grads = _port_grads(loss_fn, tp, _batch(cfg, 3))
        assert _rel(loss.item(), float(jloss)) <= LOSS_RTOL, kw
        assert _rel(metrics["aux"].item(), float(jm["aux"])) <= LOSS_RTOL
        _hold_gradients(arch, jg, grads)
        losses.append(loss.item())
    assert losses[0] != losses[1]


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_train_returns_the_aux_total(arch, n_groups):
    """``lm.forward(mode="train")`` returns (logits, None, aux), aux the
    sum over the MoE layers, as the reference's forward does."""
    jcfg, cfg = jconfigs.get(arch).reduced(), configs.get(arch).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jl, _, jaux = jlm.forward(jcfg, jp, jnp.asarray(toks), mode="train",
                              n_groups=n_groups)
    with torch.no_grad():
        tl, cache, aux = lm.forward(cfg, tp, torch.from_numpy(toks),
                                    mode="train", impl="plain",
                                    n_groups=n_groups)
    assert cache is None and aux.shape == () and float(jaux) > 0
    assert _rel(aux.item(), float(jaux)) <= LOSS_RTOL
    assert np.abs(tl.numpy() - np.asarray(jl)).max() < 1e-4


def _run(code: str, tmp_path) -> str:
    """``code`` in a fresh interpreter on the CPU, its plan caches under
    ``tmp_path``; returns its standard output."""
    env = dict(os.environ)
    env.update({"PYTHONPATH": os.path.join(ROOT, "src"),
                "JAX_PLATFORMS": "cpu",
                "REPRO_TORCH_PLAN_CACHE": str(tmp_path / "torch-plans"),
                "REPRO_PLAN_CACHE": str(tmp_path / "jax-plans")})
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _losses(out: str) -> dict:
    return {int(s): float(v) for s, v in
            re.findall(r"^\[step +(\d+)\] loss=([-\d.]+)", out, re.M)}


@pytest.mark.parametrize("arch,layers", [("mixtral-8x7b", 2),
                                         ("phi-3-vision-4.2b", None)])
def test_launcher_trains_moe_and_frontend_archs(arch, layers, tmp_path):
    """Three steps with ``--grad-accum 2``; mixtral cut to 2 of its 4
    reduced layers by ``--layers``."""
    cut = f', "--layers", "{layers}"' if layers else ""
    out = _run(f"""
        from repro_torch.launch import train
        res = train.main(["--arch", "{arch}", "--reduced", "--steps", "3",
                          "--seq", "32", "--batch", "4", "--grad-accum",
                          "2", "--log-every", "1", "--device", "cpu"{cut}])
        print("AUX", [h["aux"] for h in res["history"]])
        print("LAYERS", res["cfg"].n_layers, len(res["params"]["seg0"]
                                                    ["c0"]["attn"]["wq"]))
    """, tmp_path)
    assert re.search(rf"^\[init\] {arch} params=.*dtype=float32", out, re.M)
    n = layers or configs.get(arch).reduced().n_layers
    assert re.search(rf"^LAYERS {n} {n}$", out, re.M)
    assert re.search(r"^\[done\] median step \d+ms", out, re.M)
    losses = _losses(out)
    assert sorted(losses) == [0, 1, 2]
    assert all(np.isfinite(v) for v in losses.values())
    aux = [float(a) for a in
           re.search(r"^AUX \[(.*)\]", out, re.M).group(1).split(",")]
    assert all(a > 0 for a in aux) if arch in MOE_ARCHS else aux == [0.0] * 3


RESUME = """
    import glob, shutil
    import numpy as np
    from {package}.launch import train
    args = ["--arch", "tinyllama-1.1b", "--reduced", "--seq", "32",
            "--batch", "2", "--log-every", "1", "--ckpt-dir", "ckpt",
            "--ckpt-every", "2", "--steps", "4"{extra}]
    train.main(args)
    # the run is cut after its mid-run checkpoint: its final one is gone
    shutil.rmtree(sorted(glob.glob("ckpt/step_*"))[-1])
    with np.load(sorted(glob.glob("ckpt/step_*"))[-1] + "/state.npz") as z:
        print("OPT_STEP", int(z["opt/step"]))
    print("RESUMED")
    train.main(args + ["--resume"])
"""


def test_f9_reference_launcher_takes_a_step_again_on_resume(tmp_path):
    """ROADMAP F9, both launchers: a 4-step run with ``--ckpt-every 2``
    whose final checkpoint is lost, then ``--resume``.  The reference saved
    its mid-run checkpoint under 2 after taking steps 0-2 (its AdamW step
    count is 3), so the resumed run takes step 2 again, from parameters
    that step has already moved: its loss there is not the first run's,
    and it saves under 2 again (step count 4).  The port saved under 2
    after steps 0-1, and its resumed steps repeat the first run's
    losses."""
    runs, saved = {}, {}
    for who, package, extra in (("ref", "repro", ""),
                                ("port", "repro_torch",
                                 ', "--device", "cpu"')):
        (tmp_path / who).mkdir()
        out = _run(RESUME.format(package=package, extra=extra),
                   tmp_path / who)
        first, resumed = out.split("RESUMED")
        assert "[resume] from step 2" in resumed, who
        saved[who] = int(re.search(r"^OPT_STEP (\d+)", first, re.M)[1])
        runs[who] = _losses(first), _losses(resumed)
        assert sorted(runs[who][0]) == [0, 1, 2, 3], who
        assert sorted(runs[who][1]) == [2, 3], who
    f, r = runs["ref"]
    assert abs(r[2] - f[2]) > 1e-3                  # step 2 taken again
    f, r = runs["port"]
    assert r == {2: f[2], 3: f[3]}                 # no step taken twice
    # the AdamW step count each package stored under "step 2", after the
    # first run and after the resumed one
    assert saved == {"ref": 3, "port": 2}
    steps = {}
    for who in ("ref", "port"):
        mgr = CheckpointManager(str(tmp_path / who / "ckpt"))
        assert mgr.all_steps() == [2, 4], who
        with np.load(os.path.join(mgr._final_path(2), "state.npz")) as z:
            steps[who] = int(z["opt/step"])
    assert steps == {"ref": 4, "port": 2}
