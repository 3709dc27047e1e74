"""The port's GPipe pipeline (``repro_torch.train.pipeline``) against the
JAX package's on the CPU.

The reference's pipeline is an SPMD program over a ``(data, model)`` mesh;
its numbers come from one subprocess per test module with 8 forced host
devices (``XLA_FLAGS``, as ``tests/test_multidevice.py`` sets them), run
on meshes (1, 2) and (2, 2) with M = 2 microbatches per data replica, and
written to an ``.npz`` under the module's temporary directory with the
weights it started from.  The port's pipeline runs its stages on
``["cpu"] * S``; a data axis of 2 with M microbatches each is the port's
pipeline over the whole batch with 2M microbatches, since the loss is a
sum over tokens and a MoE layer's capacity is per microbatch in both.

Reduced configs in f32, B 8, S 32, the reference's ``lm.init_params``
carried across by ``repro_torch.convert``.  Bars, those of
``test_torch_train.py``: loss within 1e-5 relative, every gradient leaf
(joined back to the one-card layout) within 1e-4 of that leaf's max-abs;
parameters after one AdamW step within a tenth of lr.  Dense archs also
match the port's one-card train step.  Where the reference's pipeline
differs from its own one-card step, the port follows the pipeline, and the
tests pin the difference in both packages (ROADMAP F12): no padded
vocabulary ids are masked, the MoE aux loss is dropped and capacities are
per microbatch, and phi-3-vision trains on its tokens alone.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import lm as jlm
from repro.train import TrainStepConfig as JTrainStepConfig
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs, optim
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import lm
from repro_torch.train import (join_stage_params, make_pipeline_train_step,
                               make_train_step, pipeline_refusal,
                               split_stage_params, value_and_grad)
from repro_torch.tree import flatten, unflatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH, M = 32, 8, 2
LOSS_RTOL, LEAF_FRAC, LR = 1e-5, 1e-4, 1e-4
PAD_VOCAB = 500          # padded to 2048: 1,548 pad ids
# (tag, arch, vocab_size or None, mesh (data, model))
CASES = (("tinyllama_1x2", "tinyllama-1.1b", None, (1, 2)),
         ("tinyllama_2x2", "tinyllama-1.1b", None, (2, 2)),
         ("mixtral_1x2", "mixtral-8x7b", None, (1, 2)),
         ("mixtral_2x2", "mixtral-8x7b", None, (2, 2)),
         ("padded_1x2", "tinyllama-1.1b", PAD_VOCAB, (1, 2)),
         ("phi3_1x2", "phi-3-vision-4.2b", None, (1, 2)))
ACCEPTED = {"command-r-35b", "minicpm-2b", "mixtral-8x7b", "paper-mlp",
            "phi-3-vision-4.2b", "tinyllama-1.1b"}
REFUSED = {"deepseek-v2-lite-16b": "one-layer cycle",
           "gemma2-9b": "one-layer cycle",
           "recurrentgemma-2b": "one-layer cycle",
           "mamba2-370m": "reads p\\['attn'\\]",
           "seamless-m4t-medium": "no cross attention"}

REFERENCE = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro import configs
    from repro.data import DataConfig, SyntheticLM
    from repro.launch.mesh import make_mesh
    from repro.models import lm
    from repro.optim import init_state
    from repro.train import TrainStepConfig, make_train_step
    from repro.train.pipeline import make_pipeline_train_step

    def flat(prefix, tree):
        return {prefix + "/".join(str(k.key) for k in path): np.asarray(x)
                for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}

    out = {}
    for tag, arch, vocab, shape in CASES:
        cfg = configs.get(arch).reduced()
        if vocab:
            cfg = cfg.replace(vocab_size=vocab)
        params = lm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
        raw = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
            frontend_tokens=cfg.frontend_tokens if cfg.frontend else 0,
            frontend_dim=cfg.frontend_dim if cfg.frontend else 0)
        ).batch_at(0)
        batch = {k: jnp.asarray(raw[k]) for k in ("tokens", "labels")}
        mesh = make_mesh(shape, ("data", "model"))
        step, make_loss, _ = make_pipeline_train_step(cfg, mesh,
                                                      n_microbatches=M)
        with mesh:
            fn, _ = make_loss(params)
            loss, grads = jax.jit(jax.value_and_grad(fn))(params, batch)
            if tag == "tinyllama_1x2":
                after, _, metrics = jax.jit(step)(
                    params, init_state(params), batch, jnp.asarray(0))
                out.update(flat(tag + "/after/", after))
                out[tag + "/step_loss"] = np.asarray(metrics["loss"])
                out[tag + "/grad_norm"] = np.asarray(metrics["grad_norm"])
        _, one_card = make_train_step(cfg, lambda s: 1e-3, TrainStepConfig())
        one_loss, one_m = one_card(params, batch | (
            {"frontend_emb": jnp.asarray(raw["frontend_emb"])}
            if "frontend_emb" in raw else {}))
        out.update(flat(tag + "/param/", params))
        out.update(flat(tag + "/grad/", grads))
        out[tag + "/loss"] = np.asarray(loss)
        out[tag + "/one_card_loss"] = np.asarray(one_loss)
        out[tag + "/one_card_ce"] = np.asarray(one_m["ce"])
    np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's numbers of every case, from one subprocess."""
    path = tmp_path_factory.mktemp("pipeline") / "reference.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    code = (f"CASES, SEQ, BATCH, M = {CASES!r}, {SEQ}, {BATCH}, {M}\n"
            + textwrap.dedent(REFERENCE))
    out = subprocess.run([sys.executable, "-c", code, str(path)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _tree(ref: dict, prefix: str) -> dict:
    return unflatten((tuple(k[len(prefix):].split("/")), v)
                     for k, v in ref.items() if k.startswith(prefix))


def _case(reference, tag):
    """(cfg, the port's one-card parameter tree, the batch with
    ``frontend_emb`` where the arch takes it) of a case."""
    _, arch, vocab, _ = next(c for c in CASES if c[0] == tag)
    cfg = configs.get(arch).reduced()
    if vocab:
        cfg = cfg.replace(vocab_size=vocab)
    params = params_from_numpy(cfg, _tree(reference, tag + "/param/"),
                               "cpu")
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
        frontend_tokens=cfg.frontend_tokens if cfg.frontend else 0,
        frontend_dim=cfg.frontend_dim if cfg.frontend else 0))
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    return cfg, params, batch


def _pipeline_grads(cfg, params, batch, n_stages, n_micro):
    """(loss, joined gradient tree) of the port's pipeline."""
    split = split_stage_params(cfg, params, ["cpu"] * n_stages)
    _, loss_fn = make_pipeline_train_step(cfg, ["cpu"] * n_stages,
                                          n_microbatches=n_micro)
    loss, _, grads = value_and_grad(loss_fn, split, batch, allow_unused=True)
    return loss.item(), join_stage_params(unflatten(
        zip((p for p, _ in flatten(split)), grads)))


def _hold_leaves(got: dict, exp: dict, what: str) -> None:
    exp = dict(flatten(exp))
    got = dict(flatten(got))
    assert set(got) == set(exp)
    for path, g in got.items():
        e = np.asarray(exp[path])
        err = np.abs(g.detach().numpy() - e).max()
        assert err <= LEAF_FRAC * np.abs(e).max(), (what, path, err)


def _rel(got, exp):
    return abs(got - exp) / abs(exp)


@pytest.mark.parametrize("tag", ["tinyllama_1x2", "tinyllama_2x2",
                                 "mixtral_1x2", "mixtral_2x2"])
def test_pipeline_matches_the_reference_pipeline(reference, tag):
    cfg, params, batch = _case(reference, tag)
    data, stages = next(c[3] for c in CASES if c[0] == tag)
    loss, grads = _pipeline_grads(cfg, params, batch, stages, M * data)
    assert _rel(loss, float(reference[tag + "/loss"])) <= LOSS_RTOL
    _hold_leaves(grads, _tree(reference, tag + "/grad/"), tag)


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_dense_pipeline_equals_the_one_card_step(reference, n_stages):
    """TinyLlama over 1, 2 and 4 stages, 4 microbatches: the one-card
    train step's loss and gradients, as the reference's pipeline gives its
    own one-card step's."""
    cfg, params, batch = _case(reference, "tinyllama_1x2")
    _, loss_fn = make_train_step(cfg, optim.constant(1e-3))
    one_loss, _, one_grads = value_and_grad(loss_fn, params, batch)
    one = unflatten(zip((p for p, _ in flatten(params)), one_grads))
    loss, grads = _pipeline_grads(cfg, params, batch, n_stages, 4)
    assert _rel(loss, one_loss.item()) <= LOSS_RTOL
    _hold_leaves(grads, one, f"{n_stages} stages")
    # and the reference's pipeline is its one-card step here
    assert _rel(float(reference["tinyllama_1x2/loss"]),
                float(reference["tinyllama_1x2/one_card_loss"])) <= LOSS_RTOL


def test_train_step_matches_the_reference_pipeline_step(reference):
    """One AdamW step at the reference's default lr (1e-4) on the split
    tree: loss, grad norm, and every parameter joined back."""
    tag = "tinyllama_1x2"
    cfg, params, batch = _case(reference, tag)
    split = split_stage_params(cfg, params, ["cpu", "cpu"])
    step, _ = make_pipeline_train_step(cfg, ["cpu", "cpu"], n_microbatches=M)
    split, opt, metrics = step(split, optim.init_state(split), batch, 0)
    assert set(metrics) == {"loss", "grad_norm", "lr"}
    assert _rel(metrics["loss"].item(),
                float(reference[tag + "/step_loss"])) <= LOSS_RTOL
    assert _rel(metrics["grad_norm"].item(),
                float(reference[tag + "/grad_norm"])) <= 1e-4
    assert opt["step"].item() == 1
    assert not any(t.requires_grad for _, t in flatten(split))
    after = dict(flatten(_tree(reference, tag + "/after/")))
    for path, t in flatten(join_stage_params(split)):
        assert np.abs(t.numpy() - after[path]).max() <= 0.1 * LR, path


def test_f12_pipeline_loss_masks_no_padded_ids(reference):
    """Vocabulary 500, padded to 2048: the one-card loss masks the 1,548
    pad ids to -1e30, the pipeline's log-sum-exp runs over them, in both
    packages."""
    tag = "padded_1x2"
    cfg, params, batch = _case(reference, tag)
    assert cfg.padded_vocab == 2048
    ref_pipe = float(reference[tag + "/loss"])
    ref_one = float(reference[tag + "/one_card_loss"])
    assert ref_pipe - ref_one > 0.1
    loss, grads = _pipeline_grads(cfg, params, batch, 2, M)
    assert _rel(loss, ref_pipe) <= LOSS_RTOL
    _hold_leaves(grads, _tree(reference, tag + "/grad/"), tag)
    _, loss_fn = make_train_step(cfg, optim.constant(1e-3))
    one_loss, _, _ = value_and_grad(loss_fn, params, batch)
    assert _rel(one_loss.item(), ref_one) <= LOSS_RTOL


def test_f12_moe_pipeline_drops_aux_and_dispatches_per_microbatch(
        reference):
    """Mixtral: the pipeline drops the router aux loss and dispatches each
    microbatch as its own group, so its loss is neither the one-card loss
    nor the one-card cross entropy, and it changes with the microbatches
    (a data axis of 2 halves them), in both packages."""
    cfg, params, batch = _case(reference, "mixtral_1x2")
    ref = {t: float(reference[f"mixtral_{t}/loss"]) for t in ("1x2", "2x2")}
    one_loss = float(reference["mixtral_1x2/one_card_loss"])
    one_ce = float(reference["mixtral_1x2/one_card_ce"])
    assert min(abs(ref["1x2"] - one_loss), abs(ref["1x2"] - one_ce)) > 1e-3
    assert abs(ref["1x2"] - ref["2x2"]) > 1e-3
    for tag, micro in (("1x2", M), ("2x2", 2 * M)):
        loss, _ = _pipeline_grads(cfg, params, batch, 2, micro)
        assert _rel(loss, ref[tag]) <= LOSS_RTOL, tag


def test_f12_phi3_pipelines_on_its_tokens_alone(reference):
    """Phi-3-vision: the pipeline reads no frontend rows (the batch's
    ``frontend_emb`` is ignored), so the frontend projection's gradient is
    zero and the loss is not the one-card step's, in both packages."""
    tag = "phi3_1x2"
    cfg, params, batch = _case(reference, tag)
    assert "frontend_emb" in batch
    ref_grads = _tree(reference, tag + "/grad/")
    assert not np.asarray(ref_grads["frontend_proj"]).any()
    assert abs(float(reference[tag + "/loss"])
               - float(reference[tag + "/one_card_loss"])) > 1e-3
    loss, grads = _pipeline_grads(cfg, params, batch, 2, M)
    assert _rel(loss, float(reference[tag + "/loss"])) <= LOSS_RTOL
    assert not grads["frontend_proj"].any()
    _hold_leaves(grads, ref_grads, tag)


@pytest.mark.parametrize("arch", configs.available())
def test_pipeline_accepts_and_refuses_the_reference_archs(arch):
    """The archs the reference's pipeline trains as the one-card model
    (one segment, a one-layer attention cycle, no encoder) are taken; the
    others are refused with their reason.  An accepted tree splits and
    joins back to itself."""
    cfg = configs.get(arch).reduced()
    assert (arch in ACCEPTED) != (arch in REFUSED)
    if arch in REFUSED:
        assert pipeline_refusal(cfg, 2) is not None
        with pytest.raises(ValueError, match=REFUSED[arch]):
            make_pipeline_train_step(cfg, ["cpu", "cpu"])
        return
    assert pipeline_refusal(cfg, 2) is None
    make_pipeline_train_step(cfg, ["cpu", "cpu"])
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            torch.float32)
    split = split_stage_params(cfg, params, ["cpu"] * 4)
    assert sorted(k for k in split if k.startswith("stage")) == \
        ["stage0", "stage1", "stage2", "stage3"]
    joined = join_stage_params(split)
    assert [p for p, _ in flatten(joined)] == [p for p, _ in flatten(params)]
    for (_, a), (_, b) in zip(flatten(joined), flatten(params)):
        assert torch.equal(a, b)
    split["stage0"]["attn"]["wq"].add_(1.0)      # a copy, not a view
    assert torch.equal(params["seg0"]["c0"]["attn"]["wq"],
                       joined["seg0"]["c0"]["attn"]["wq"])


def test_pipeline_refuses_uneven_stages_and_batches():
    cfg = configs.get("tinyllama-1.1b").reduced()         # 4 layers
    with pytest.raises(ValueError, match="do not split evenly over 3"):
        make_pipeline_train_step(cfg, ["cpu"] * 3)
    params = lm.init_params(cfg, torch.Generator().manual_seed(1), "cpu",
                            torch.float32)
    with pytest.raises(ValueError, match="do not split evenly over 3"):
        split_stage_params(cfg, params, ["cpu"] * 3)
    _, loss_fn = make_pipeline_train_step(cfg, ["cpu", "cpu"],
                                          n_microbatches=3)
    toks = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="microbatches"):
        loss_fn(split_stage_params(cfg, params, ["cpu", "cpu"]),
                {"tokens": toks, "labels": toks})


def test_pipeline_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("tinyllama-1.1b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pipeline_train_step(cfg, [None, None])


def test_reference_pipeline_cases_match_the_in_process_reference(
        reference):
    """The subprocess's weights and one-card loss are the ones this
    process's reference computes, so the port's side starts where the
    reference's did."""
    jcfg = jconfigs.get("tinyllama-1.1b").reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    sub = dict(flatten(_tree(reference, "tinyllama_1x2/param/")))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        key = tuple(str(k.key) for k in path)
        assert np.array_equal(np.asarray(leaf), sub[key]), key
    raw = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                   global_batch=BATCH)).batch_at(0)
    _, loss_fn = jmake_train_step(jcfg, lambda s: 1e-3, JTrainStepConfig())
    loss, _ = loss_fn(jp, {k: jnp.asarray(v) for k, v in raw.items()})
    assert float(loss) == pytest.approx(
        float(reference["tinyllama_1x2/one_card_loss"]), rel=LOSS_RTOL)
