"""The planning loop around the port's serving path, against the reference
on the CPU: ``ContinuousEngine(plan=)`` sizing and its refusals, the
``paper-mlp`` config served by the port, the serving telemetry's bridge to
the §3 assistants (``device_interference``, ``assistant_callback``) after
the same trace through both packages' paged engines, the launcher's
``--adapt --devices``, the plan CLI, and ``ElasticController``.

Plans compiled here never touch the home directory: ``cache=False``, a
``tmp_path`` cache, or ``REPRO_TORCH_PLAN_CACHE`` set by ``monkeypatch``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro import configs as jconfigs
from repro.launch import plan as jlaunch_plan
from repro.models import lm as jlm
from repro.runtime import ElasticController as JElastic
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Engine as JEngine
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import plan as launch_plan
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.runtime import ElasticController
from repro_torch.serve import ContinuousEngine, Engine

torch.set_num_threads(2)
MLP = "paper-mlp"
SERVED = ("tinyllama-1.1b", "mamba2-370m", "recurrentgemma-2b", MLP,
          "deepseek-v2-lite-16b")
KV_LEN = 48
PROMPT_LENS = [5, 17, 9, 30, 3]
MAX_NEW = [8, 12, 1, 10, 15]
H100 = dataclasses.asdict(T.H100_SXM)


def _pair(arch):
    """(jax cfg, port cfg, jax params, port params) on the same weights."""
    jcfg, cfg = jconfigs.get(arch).reduced(), configs.get(arch).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in PROMPT_LENS]


def _dumps(doc) -> str:
    return json.dumps(doc, sort_keys=True)


# =============================================================================
# engine sizing from a plan
# =============================================================================

def test_engine_sizes_from_plan():
    """The reference's ``test_engine_sizes_from_plan`` on the port."""
    cfg = configs.get(MLP).reduced()
    shape = ShapeConfig("serve_decode_32", 32, 2, "decode")
    assert ContinuousEngine.decode_shape_for(32, 2) == shape
    assert dataclasses.asdict(shape) == dataclasses.asdict(
        JContinuousEngine.decode_shape_for(32, 2))
    plan = T.compile_plan(cfg, shape, T.Topology.homogeneous(2),
                          cache=False)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            torch.float32)
    eng = ContinuousEngine(cfg, params, plan=plan, device="cpu")
    assert eng.kv_len == 32 and eng.n_slots == 2
    assert eng.decode_shape() == shape
    agree = ContinuousEngine(cfg, params, kv_len=32, n_slots=2, plan=plan,
                             device="cpu")
    assert agree.kv_len == 32
    other = configs.get("tinyllama-1.1b").reduced()
    with pytest.raises(ValueError, match="compiled for"):
        ContinuousEngine(other, params, plan=plan, device="cpu")
    full_plan = T.compile_plan(configs.get(MLP), shape,
                               T.Topology.homogeneous(2), cache=False)
    with pytest.raises(ValueError, match="dims differ"):
        ContinuousEngine(cfg, params, plan=full_plan, device="cpu")
    with pytest.raises(ValueError, match="kv_len"):
        ContinuousEngine(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="seq_len"):
        ContinuousEngine(cfg, params, kv_len=64, plan=plan, device="cpu")
    with pytest.raises(ValueError, match="global_batch"):
        ContinuousEngine(cfg, params, n_slots=4, plan=plan, device="cpu")
    assert ContinuousEngine(cfg, params, kv_len=32,
                            device="cpu").n_slots == 4


def test_engine_refusals_match_reference():
    """The same contradicting sizes give the reference's messages."""
    jcfg, cfg, jp, tp = _pair(MLP)
    jplan = J.compile_plan(jcfg, JContinuousEngine.decode_shape_for(32, 2),
                           J.Topology.homogeneous(2), cache=False)
    tplan = T.compile_plan(cfg, ContinuousEngine.decode_shape_for(32, 2),
                           T.Topology.homogeneous(2), cache=False)
    assert tplan.key == jplan.key
    for kw in ({"kv_len": 64}, {"n_slots": 4}):
        with pytest.raises(ValueError) as jexc:
            JContinuousEngine(jcfg, jp, plan=jplan, **kw)
        with pytest.raises(ValueError) as texc:
            ContinuousEngine(cfg, tp, plan=tplan, device="cpu", **kw)
        assert str(texc.value) == str(jexc.value)


# =============================================================================
# paper-mlp in the port's registry
# =============================================================================

def test_paper_mlp_matches_jax():
    """Reduced paper-mlp (MHA): logits in prefill and decode within 1e-4
    of JAX, greedy tokens equal to the JAX engine's, and the port's paged
    ContinuousEngine token-identical to its own B=1 Engine."""
    jcfg, cfg, jp, tp = _pair(MLP)
    assert cfg.n_heads == cfg.n_kv_heads
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, 2, 32, jnp.float32)
    tcache = lm.init_cache(cfg, 2, 32, torch.float32, "cpu")
    jl, jcache, _ = jlm.forward(jcfg, jp, jnp.asarray(toks), cache=jcache,
                                mode="prefill")
    tl, tcache, _ = lm.forward(cfg, tp, torch.from_numpy(toks), cache=tcache,
                               mode="prefill")
    assert np.abs(tl.numpy() - np.asarray(jl)).max() < 1e-4
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jl, _, _ = jlm.forward(jcfg, jp, jnp.asarray(nxt),
                           positions=jnp.asarray(13, jnp.int32),
                           cache=jcache, mode="decode")
    tl, _, _ = lm.forward(cfg, tp, torch.from_numpy(nxt),
                          positions=torch.tensor(13, dtype=torch.int32),
                          cache=tcache, mode="decode")
    assert np.abs(tl.numpy() - np.asarray(jl)).max() < 1e-4

    exp = np.asarray(JEngine(jcfg, jp, kv_len=KV_LEN).generate(
        jnp.asarray(toks), 9))
    oracle = Engine(cfg, tp, kv_len=KV_LEN, device="cpu")
    assert np.array_equal(oracle.generate(torch.from_numpy(toks), 9).numpy(),
                          exp)
    eng = ContinuousEngine(cfg, tp, kv_len=KV_LEN, n_slots=2, paged=True,
                           device="cpu")
    prompts = _prompts(cfg.vocab_size, seed=3)
    for i, (p, m) in enumerate(zip(prompts, MAX_NEW)):
        eng.submit(p, m, rid=i, arrival=2 * i)
    got = eng.run()
    for i, (p, m) in enumerate(zip(prompts, MAX_NEW)):
        assert got[i] == oracle.generate(torch.tensor([p]), m)[0].tolist()
    eng.allocator.check()
    assert eng.allocator.n_in_use == 0


# =============================================================================
# serving telemetry -> the §3 assistants, through both packages
# =============================================================================

@pytest.mark.parametrize("arch", SERVED)
def test_served_telemetry_drives_the_same_adaptation(arch):
    """One trace through both packages' plan-sized paged engines: the same
    tokens, the same per-device interference, and the same adaptation
    trace and adapted plan on the TPU v5e and the H100 SXM figures."""
    jcfg, cfg, jp, tp = _pair(arch)
    jshape = JContinuousEngine.decode_shape_for(KV_LEN, 2)
    tshape = ContinuousEngine.decode_shape_for(KV_LEN, 2)
    topos = [(J.Topology.homogeneous(4), T.Topology.homogeneous(4)),
             (J.Topology.homogeneous(4, J.DeviceSpec(**H100)),
              T.Topology.homogeneous(4, T.H100_SXM))]
    jplans = [J.compile_plan(jcfg, jshape, jt, cache=False)
              for jt, _ in topos]
    tplans = [T.compile_plan(cfg, tshape, tt, cache=False)
              for _, tt in topos]
    jeng = JContinuousEngine(jcfg, jp, paged=True, plan=jplans[0])
    eng = ContinuousEngine(cfg, tp, paged=True, plan=tplans[0],
                           device="cpu")
    assert (eng.kv_len, eng.n_slots) == (jeng.kv_len, jeng.n_slots)
    prompts = _prompts(cfg.vocab_size, seed=5)
    for e in (jeng, eng):
        for i, (p, m) in enumerate(zip(prompts, MAX_NEW)):
            e.submit(p, m, rid=i, arrival=2 * i)
    assert eng.run() == jeng.run()
    jtel, tel = jeng.telemetry, eng.telemetry
    for k in (2, 3, 4):
        assert tel.device_interference(k) == jtel.device_interference(k)
    assert eng.decode_shape() == tplans[0].shape
    for jplan, tplan in zip(jplans, tplans):
        outs = []
        for core, plan, t in ((J, jplan, jtel), (T, tplan, tel)):
            cb = t.assistant_callback(plan.graph, plan.cost_model)
            assert cb(plan.assignment) == core.simulate_utilization(
                plan.graph, plan.assignment, plan.cost_model,
                interference=t.device_interference(plan.k))
            outs.append(core.adapt_plan(
                plan, interference=t.device_interference(plan.k),
                telemetry=cb))
        (jadapted, jtrace), (tadapted, ttrace) = outs
        assert _dumps(ttrace.to_json()) == _dumps(jtrace.to_json())
        assert _dumps(tadapted.to_json()) == _dumps(jadapted.to_json())
        assert tadapted.assignment == ttrace.replay(tplan.assignment)
        # a tighter assistant configuration, through the same callback
        cfg_j = J.AssistantConfig(theta=0.5, gamma=0.45)
        cfg_t = T.AssistantConfig(theta=0.5, gamma=0.45)
        jt2 = J.adapt_plan(jplan, config=cfg_j, telemetry=jtel
                           .assistant_callback(jplan.graph,
                                               jplan.cost_model))[1]
        tt2 = T.adapt_plan(tplan, config=cfg_t, telemetry=tel
                           .assistant_callback(tplan.graph,
                                               tplan.cost_model))[1]
        assert _dumps(tt2.to_json()) == _dumps(jt2.to_json())


def test_interference_mapping_matches_reference():
    from repro.runtime import ServeTelemetry as JTel
    from repro_torch.runtime import ServeTelemetry as TTel
    tels = [JTel(window=10), TTel(window=10)]
    for t in tels:
        for i in range(12):
            t.record_step(step=i, seconds=1e-3,
                          active_slots=(0, 2) if i % 3 else (1,), n_slots=4,
                          blocks_in_use=16 - i, n_blocks=16, new_tokens=2)
    assert TTel().alpha == JTel().alpha and TTel().beta == JTel().beta
    for k in (1, 2, 4, 8):
        assert tels[1].device_interference(k) == \
            tels[0].device_interference(k)
    inter = tels[1].device_interference(4)
    assert inter[3]["compute"] == 1.0 and inter[0]["compute"] > 1.0
    assert TTel().device_interference(2) == [
        {"compute": 1.0, "memory": 1.0, "network": 1.0}] * 2


# =============================================================================
# CLIs and the elastic controller
# =============================================================================

def test_serve_launcher_adapts_on_cpu(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path))
    argv = ["--arch", MLP, "--reduced", "--continuous", "--paged",
            "--adapt", "--devices", "4", "--device", "cpu", "--requests",
            "3", "--stagger", "3", "--max-new", "4", "--prompt-len", "8",
            "--kv-len", "32"]
    launch_serve.main(argv)
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
    assert "[adapt] plan CompiledPlan[paper-mlp x serve_decode_32 k=4 " \
        "tensor]" in out and "plan-cache hit" not in out
    assert "[adapt] assistants: " in out and "deltas, step time" in out
    assert len(list(tmp_path.glob("*.json"))) == 1
    launch_serve.main(argv)
    assert "(plan-cache hit)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", MLP, "--reduced", "--adapt",
                           "--device", "cpu"])


def test_plan_cli_matches_reference(capsys, tmp_path):
    topo = tmp_path / "topo.json"
    topo.write_text(json.dumps(J.Topology.heterogeneous(
        [0.5, 1.0, 1.0]).to_json()))
    common = ["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
              "--backend", "pipeline", "--topology-json", str(topo),
              "--no-cache"]
    outs = {}
    for name, main in (("ref", jlaunch_plan.main), ("port", launch_plan.main)):
        path = tmp_path / f"{name}.json"
        main(common + ["--save", str(path)])
        outs[name] = [ln for ln in capsys.readouterr().out.splitlines()
                      if "saved ->" not in ln]
        main(common + ["--key-only"])
        outs[name].append(capsys.readouterr().out)
    assert outs["port"] == outs["ref"]
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    with pytest.raises(SystemExit) as exc:
        launch_plan.main(["--diff", str(tmp_path / "port.json"),
                          str(tmp_path / "ref.json")])
    assert exc.value.code == 0
    assert "moved=0" in capsys.readouterr().out
    # the port's own default machine is the modelled H100 SXM
    launch_plan.main(["--arch", MLP, "--devices", "2", "--key-only"])
    key = capsys.readouterr().out.strip()
    assert key == T.plan_key(configs.get(MLP), SHAPES["train_4k"],
                             T.Topology.homogeneous(2, T.H100_SXM))


def test_elastic_controller_matches_reference(monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE", "off")
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", "off")
    jshape = JContinuousEngine.decode_shape_for(512, 4)
    tshape = ContinuousEngine.decode_shape_for(512, 4)
    jc = JElastic(jconfigs.get("tinyllama-1.1b"), jshape)
    tc = ElasticController(configs.get("tinyllama-1.1b"), tshape)
    assert tc.should_replan(4, 8) and not tc.should_replan(4, 4)
    for k in (2, 8):
        jplan, tplan = jc.replan(k, seed=1), tc.replan(k, seed=1)
        assert tc.topology.to_json() == jc.topology.to_json()
        assert _dumps(tplan.to_json()) == _dumps(jplan.to_json())
    inter = [{"compute": 2.5}] + [{}] * 7
    ja, jt = jc.adapt(jplan, interference=inter,
                      config=J.AssistantConfig(theta=0.9, gamma=0.6))
    ta, tt = tc.adapt(tplan, interference=inter,
                      config=T.AssistantConfig(theta=0.9, gamma=0.6))
    assert _dumps(tt.to_json()) == _dumps(jt.to_json())
    assert ta.assignment == ja.assignment
    assert len(tc.traces) == len(jc.traces) == 1
