"""The port's data pipeline, training telemetry and checkpoint manager
against the JAX package on the CPU.

The data pipeline is a numpy copy: its batches and the prefetcher's order
must equal the reference's bit for bit.  Telemetry is a copy: the same
records give the same medians, stragglers and losses.  Checkpoints: the
round trip (f32, bf16 and int leaves, exact), garbage collection, the
atomic commit, asynchronous saves, restoring a given step, shape
mismatches, and a float32 checkpoint written by either package restored
by the other.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import DataConfig as JDataConfig
from repro.data import Prefetcher as JPrefetcher
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import lm as jlm
from repro.optim import init_state as jinit_state
from repro.runtime.telemetry import Telemetry as JTelemetry
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM, make_pipeline
from repro_torch.optim import init_state
from repro_torch.runtime import Telemetry
from repro_torch.tree import flatten


@pytest.mark.parametrize("kw", [
    {},
    {"motif_period": 5, "zipf_a": 1.1, "seed": 3},
    {"motif_period": 0, "seed": 9},
])
@pytest.mark.parametrize("host", [(0, 1), (1, 2)])
def test_synthetic_batches_equal_reference(kw, host):
    common = dict(vocab_size=300, seq_len=24, global_batch=4, **kw)
    ours = SyntheticLM(DataConfig(**common), *host)
    ref = JSyntheticLM(JDataConfig(**common), *host)
    for step in (0, 1, 7, 123):
        got, exp = ours.batch_at(step), ref.batch_at(step)
        assert set(got) == set(exp) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == exp[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], exp[k])


def test_prefetcher_order_equals_reference():
    common = dict(vocab_size=200, seq_len=16, global_batch=2, seed=5)
    ours = Prefetcher(SyntheticLM(DataConfig(**common)), start_step=4)
    ref = JPrefetcher(JSyntheticLM(JDataConfig(**common)), start_step=4)
    try:
        for expect_step in range(4, 10):
            (s1, b1), (s2, b2) = ours.next(), ref.next()
            assert s1 == s2 == expect_step
            np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    finally:
        ours.close()
        ref.close()
    assert not ours._thread.is_alive()
    plain = make_pipeline(DataConfig(**common), prefetch=0)
    assert isinstance(plain, SyntheticLM)


def test_telemetry_equals_reference():
    times = [0.10, 0.11, 0.09, 0.10, 0.30, 0.10, 0.10, 0.12, 0.10, 0.11,
             0.40, 0.10, 0.13, 0.10, 0.16, 0.20]
    ours, ref = Telemetry(), JTelemetry()
    for i, t in enumerate(times):
        ours.record(i, t, 5.0 - 0.1 * i)
        ref.record(i, t, 5.0 - 0.1 * i)
    assert ours.median_ms() == ref.median_ms()
    assert ours.n_stragglers() == ref.n_stragglers() == 3
    assert ours.stragglers == ref.stragglers
    assert ours.losses() == ref.losses()
    assert Telemetry().median_ms() == 0.0


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"embed": torch.randn((5, 3), generator=g),
              "seg0": {"c0": {"attn": {
                  "wq": torch.randn((2, 3, 3), generator=g).to(
                      torch.bfloat16),
                  "ln": torch.randn((2, 3), generator=g)}}}}
    opt = init_state(params)
    opt["step"] += 7
    return {"params": params, "opt": opt}


def _tree_zeros(tree):
    return {k: _tree_zeros(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _assert_equal_trees(a, b):
    fa, fb = flatten(a), flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x, y), path


def test_round_trip_is_exact_with_reference_key_layout(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path))
    final = mgr.save(3, state, meta={"arch": "x"})
    assert final.endswith("step_00000003")
    with np.load(os.path.join(final, "state.npz")) as z:
        keys = set(z.files)
        assert z["params/seg0/c0/attn/wq"].dtype == np.float32  # bf16 kept
        assert z["opt/step"].dtype == np.int32
    assert "opt/m/seg0/c0/attn/ln" in keys and "params/embed" in keys
    restored, meta = mgr.restore(_tree_zeros(state))
    assert meta == {"step": 3, "arch": "x"}
    _assert_equal_trees(restored, state)


def test_gc_keeps_last_and_restores_a_given_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state(step))
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    restored, meta = mgr.restore(_tree_zeros(_state()), step=3)
    assert meta["step"] == 3
    _assert_equal_trees(restored, _state(3))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_state())


def test_commit_is_atomic(tmp_path):
    """A half-written ``tmp.<step>`` (a killed writer) is never a step."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    os.makedirs(tmp_path / "tmp.2")
    (tmp_path / "tmp.2" / "state.npz").write_bytes(b"truncated")
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    mgr.save(2, _state(2))                      # overwrites the stale tmp
    assert mgr.all_steps() == [1, 2]
    assert sorted(os.listdir(tmp_path)) == ["step_00000001", "step_00000002"]


def test_async_save_snapshots_before_returning(tmp_path):
    """The train step updates parameters in place right after a save: the
    checkpoint must hold the values at the time of the call."""
    state = _state()
    snapshot = _tree_zeros(state)
    for (_, dst), (_, src) in zip(flatten(snapshot), flatten(state)):
        dst.copy_(src)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    path = mgr.save(5, state)
    for _, t in flatten(state):
        t.add_(1)                              # what the next step does
    mgr.wait()
    assert os.path.isdir(path)
    restored, _ = mgr.restore(_tree_zeros(state), step=5)
    _assert_equal_trees(restored, snapshot)


def test_restore_checks_shapes_and_casts_to_template(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    bad = _tree_zeros(state)
    bad["params"]["embed"] = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="params/embed"):
        mgr.restore(bad)
    as_f32 = _tree_zeros(state)
    as_f32["params"]["seg0"]["c0"]["attn"]["wq"] = torch.zeros((2, 3, 3))
    restored, _ = mgr.restore(as_f32)
    got = restored["params"]["seg0"]["c0"]["attn"]["wq"]
    assert got.dtype == torch.float32
    assert torch.equal(got, state["params"]["seg0"]["c0"]["attn"]["wq"]
                       .float())


def _jax_state(seed):
    jcfg = jconfigs.get("mamba2-370m").reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    jo = jinit_state(jp)
    jo = {"m": jax.tree.map(lambda a: a + 0.5, jo["m"]), "v": jo["v"],
          "step": jnp.asarray(4, jnp.int32)}
    return {"params": jp, "opt": jo}


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    cfg = configs.get("mamba2-370m").reduced()
    jstate = _jax_state(2)
    JCheckpointManager(str(tmp_path)).save(4, jstate, meta={"arch": "m"})
    host = jax.tree.map(np.asarray, jstate)
    template = {"params": params_from_numpy(cfg, host["params"], "cpu"),
                "opt": opt_state_from_numpy(cfg, host["opt"], "cpu")}
    template = _tree_zeros(template)
    restored, meta = CheckpointManager(str(tmp_path)).restore(template)
    assert meta == {"step": 4, "arch": "m"}
    expect = {"params": params_from_numpy(cfg, host["params"], "cpu"),
              "opt": opt_state_from_numpy(cfg, host["opt"], "cpu")}
    _assert_equal_trees(restored, expect)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    cfg = configs.get("mamba2-370m").reduced()
    jstate = _jax_state(3)
    host = jax.tree.map(np.asarray, jstate)
    ours = {"params": params_from_numpy(cfg, host["params"], "cpu"),
            "opt": opt_state_from_numpy(cfg, host["opt"], "cpu")}
    CheckpointManager(str(tmp_path)).save(4, ours)
    template = jax.tree.map(jnp.zeros_like, jstate)
    restored, meta = JCheckpointManager(str(tmp_path)).restore(template)
    assert meta["step"] == 4
    flat_r = jax.tree_util.tree_flatten_with_path(restored)[0]
    flat_e = dict(jax.tree_util.tree_flatten_with_path(jstate)[0])
    for path, leaf in flat_r:
        assert leaf.dtype == flat_e[path].dtype
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(flat_e[path]))
