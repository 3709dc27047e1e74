"""The port's multi-replica ``Router`` against the JAX package's, on the
CPU at the reduced sizes in f32: the same trace through both fleets gives
the same tokens (the port's B=1 ``Engine``'s as well), the same placement
decisions, routing counters, per-replica placement, roles and degrade
reason; the reference router tests' rows (tie-break, replay, affinity,
refusals, the transfer buffer, randomized handoffs, an import into an
exhausted pool, rebalancing, fleet adaptation) on the port, each held to
the reference where the reference computes the same thing;
``FleetTelemetry``; and the launcher's ``--prefix-cache``,
``--shared-prefix``, ``--replicas`` and ``--disaggregate``.

Seeds are fixed (local generators only); no Hypothesis.
"""

import dataclasses
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.runtime import FleetTelemetry as JFleet
from repro.runtime import ServeTelemetry as JServeTelemetry
from repro.serve import BlockTransferBuffer as JBuffer
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Router as JRouter
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.runtime import FleetTelemetry, ServeTelemetry
from repro_torch.serve import (BlockTransferBuffer, ContinuousEngine, Engine,
                               Router)

torch.set_num_threads(2)
KV_LEN = 64
PROMPT_LENS = (5, 9, 13, 33)        # 33 spans two full 16-token blocks
BUDGETS = (4, 6, 5, 3)
ARCHS = ("tinyllama-1.1b", "paper-mlp", "mamba2-370m", "recurrentgemma-2b",
         "deepseek-v2-lite-16b", "minicpm-2b", "command-r-35b", "gemma2-9b",
         "mixtral-8x7b")
MLP = "paper-mlp"


@pytest.fixture(scope="module")
def setup():
    """arch -> (jax cfg, port cfg, jax params, port params, prompts, the
    port's B=1 Engine tokens per request)."""
    built: dict = {}

    def get(arch):
        if arch not in built:
            jcfg = jconfigs.get(arch).reduced()
            cfg = configs.get(arch).reduced()
            jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
            tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
            rng = np.random.default_rng(5)
            prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                       for n in PROMPT_LENS]
            oracle = Engine(cfg, tp, kv_len=KV_LEN, device="cpu")
            expects = [oracle.generate(torch.tensor([p]), b)[0].tolist()
                       for p, b in zip(prompts, BUDGETS)]
            built[arch] = (jcfg, cfg, jp, tp, prompts, expects)
        return built[arch]
    return get


def _decisions(router) -> list:
    return [dataclasses.astuple(d) for d in router.decisions]


def _same_fleet(router, jrouter) -> None:
    assert _decisions(router) == _decisions(jrouter)
    assert router.stats == jrouter.stats
    assert router.routed_per_replica == jrouter.routed_per_replica
    assert [r.role for r in router.replicas] == \
        [r.role for r in jrouter.replicas]
    assert router.disagg_unsupported_reason == \
        jrouter.disagg_unsupported_reason
    assert router.transfer.stats == jrouter.transfer.stats


def _both(setup, arch, **kw) -> tuple:
    jcfg, cfg, jp, tp, _, _ = setup(arch)
    return (Router.build(cfg, tp, device="cpu", **kw),
            JRouter.build(jcfg, jp, **kw))


# =============================================================================
# token identity and placement against the JAX router
# =============================================================================

@pytest.mark.parametrize("arch", ARCHS)
def test_routed_fleet_matches_the_reference(setup, arch):
    """Disaggregation requested for every arch: TinyLlama, paper-mlp,
    deepseek, minicpm and command-r split prefill from decode and hand
    blocks over; mamba2, recurrentgemma, gemma2 and mixtral (window rings
    or recurrent state) degrade to co-located replicas with the
    reference's reason.  Tokens equal the JAX router's and the B=1
    engine's."""
    _, cfg, _, _, prompts, expects = setup(arch)
    router, jrouter = _both(setup, arch, n_replicas=2, disaggregate=True,
                            kv_len=KV_LEN, n_slots=2, paged=True,
                            prefill_chunk=8)
    outs = []
    for r in (router, jrouter):
        for i, p in enumerate(prompts):
            r.submit(p, max_new_tokens=BUDGETS[i], rid=i, arrival=i)
        outs.append(r.run())
    assert outs[0] == outs[1]
    for i in range(len(prompts)):
        assert outs[0][i] == expects[i], (arch, i)
    _same_fleet(router, jrouter)
    sharable = lm.prefix_sharable_reason(cfg) is None
    assert [r.role for r in router.replicas] == \
        (["prefill", "decode"] if sharable else ["mixed", "mixed"])
    if sharable:
        assert router.stats["handoffs"] >= 1
        assert router.stats["transferred_blocks"] >= 2
    else:
        assert router.stats["handoffs"] == 0
        assert router.disagg_unsupported_reason == \
            lm.prefix_sharable_reason(cfg)
    fs, jfs = router.fleet_stats(), jrouter.fleet_stats()
    assert fs == jfs
    assert router.telemetry.summary() == jrouter.telemetry.summary()
    for rep in router.replicas:
        rep.engine.allocator.drop_cached()
        rep.engine.allocator.check_no_leaks()
        assert rep.engine.allocator.resident_bytes() == 0


def test_one_params_dict_serves_every_replica(setup):
    _, cfg, _, tp, _, _ = setup(MLP)
    router = Router.build(cfg, tp, n_replicas=3, kv_len=KV_LEN, n_slots=2,
                          paged=True, device="cpu")
    assert all(r.engine.params is tp for r in router.replicas)
    assert all(r.engine.device == torch.device("cpu")
               for r in router.replicas)


def test_equal_scores_route_to_lowest_replica_index(setup):
    _, _, _, _, prompts, _ = setup(MLP)
    router, jrouter = _both(setup, MLP, n_replicas=3, kv_len=KV_LEN,
                            n_slots=2, paged=True)
    for r in (router, jrouter):
        r.submit(prompts[0], max_new_tokens=2, rid="a", arrival=0)
        r.run(max_steps=1)
    assert router.decisions[0].replica == 0
    _same_fleet(router, jrouter)
    assert router.run() == jrouter.run()


def test_routing_decisions_replay_identically(setup):
    _, _, _, _, prompts, expects = setup(MLP)

    def once(r):
        for i, p in enumerate(prompts):
            r.submit(p, max_new_tokens=BUDGETS[i], rid=i, arrival=i)
        return r.run(), _decisions(r)

    kw = dict(n_replicas=3, disaggregate=True, kv_len=KV_LEN, n_slots=2)
    r1, t1 = once(_both(setup, MLP, **kw)[0])
    r2, t2 = once(_both(setup, MLP, **kw)[0])
    jr, jt = once(_both(setup, MLP, **kw)[1])
    assert t1 == t2 == jt and r1 == r2 == jr
    for i in range(len(prompts)):
        assert r1[i] == expects[i]


def test_affinity_routes_repeat_prefix_to_the_holder(setup):
    _, cfg, _, _, _, _ = setup(MLP)
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab_size, 32).tolist()
    p1, p2 = shared + [1, 2, 3], shared + [4, 5, 6, 7]
    router, jrouter = _both(setup, MLP, n_replicas=2, kv_len=KV_LEN,
                            n_slots=2, paged=True, prefix_cache=True)
    for r in (router, jrouter):
        r.submit(p1, max_new_tokens=2, rid="lead", arrival=0)
        r.run()
        r.submit(p2, max_new_tokens=2, rid="follow", arrival=r.now)
        r.run()
    follow = next(d for d in router.decisions if d.rid == "follow")
    assert follow.replica == 0 and follow.hit_tokens == 32
    _same_fleet(router, jrouter)


# =============================================================================
# refusals
# =============================================================================

def test_router_rejects_bad_fleets(setup):
    _, cfg, _, tp, _, _ = setup(MLP)
    eng = ContinuousEngine(cfg, tp, kv_len=KV_LEN, n_slots=2, device="cpu")
    for engines, roles in (([], None), ([eng], ["prefill"]),
                           ([eng], ["mixed", "mixed"]), ([eng], ["worker"])):
        with pytest.raises(ValueError):
            Router(engines, roles=roles)
    other = ContinuousEngine(configs.get("tinyllama-1.1b").reduced(), {},
                             kv_len=16, n_slots=1, device="cpu")
    with pytest.raises(ValueError, match="same config"):
        Router([eng, other])
    with pytest.raises(ValueError, match=">= 2 replicas"):
        Router.build(cfg, tp, n_replicas=1, disaggregate=True,
                     kv_len=KV_LEN, device="cpu")
    # explicit prefill roles on an arch whose blocks cannot be handed
    # over, or on replicas without the prefix cache, are refused
    rg = configs.get("recurrentgemma-2b").reduced()
    rgs = [ContinuousEngine(rg, {}, kv_len=32, n_slots=1, paged=True,
                            prefill_chunk=8, device="cpu")
           for _ in range(2)]
    jrg = jconfigs.get("recurrentgemma-2b").reduced()
    jrgs = [JContinuousEngine(jrg, {}, kv_len=32, n_slots=1, paged=True,
                              prefill_chunk=8) for _ in range(2)]
    msgs = []
    for fleet, R in ((rgs, Router), (jrgs, JRouter)):
        with pytest.raises(ValueError, match="unavailable") as err:
            R(fleet, roles=["prefill", "decode"])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    plain = [ContinuousEngine(cfg, tp, kv_len=KV_LEN, n_slots=1,
                              paged=True, prefill_chunk=8, device="cpu")
             for _ in range(2)]
    with pytest.raises(ValueError, match="need prefix_cache"):
        Router(plain, roles=["prefill", "decode"])


def test_router_rejects_unservable_and_duplicate_requests(setup):
    _, _, _, _, prompts, _ = setup(MLP)
    router, jrouter = _both(setup, MLP, n_replicas=2, kv_len=KV_LEN,
                            n_slots=2)
    for r in (router, jrouter):
        r.submit(prompts[0], max_new_tokens=2, rid="a")
        for p, m, kw in ((prompts[0], 2, {"rid": "a"}),
                         (prompts[0], KV_LEN, {}), ([], 1, {}),
                         (prompts[0], 0, {})):
            with pytest.raises(ValueError):
                r.submit(p, max_new_tokens=m, **kw)
    assert router.run() == jrouter.run()


# =============================================================================
# the transfer buffer and the handoff
# =============================================================================

def test_transfer_buffer_matches_the_reference():
    bufs = [BlockTransferBuffer(capacity_blocks=2), JBuffer(capacity_blocks=2)]
    for B in (BlockTransferBuffer, JBuffer):
        with pytest.raises(ValueError):
            B(capacity_blocks=-1)
    outs = []
    for buf in bufs:
        buf.put("h1", "p1")
        buf.put("h2", "p2")
        buf.put("h3", "p3")                      # FIFO-drops h1
        got = [len(buf), dict(buf.stats),
               buf.take_chain(["h1", "h2", "h3"]),
               buf.take_chain(["h2", "h3"]), len(buf)]
        buf.put("h4", "old")
        buf.put("h4", "new")
        buf.put_chain([("h5", "p5")])
        got += [buf.take_chain(["h4", "h5"]), dict(buf.stats)]
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[0][2] == [] and outs[0][3] == [("h2", "p2"), ("h3", "p3")]


@pytest.mark.parametrize("seed", [0, 1])
def test_randomized_handoffs_keep_both_pools_audited(setup, seed):
    """Prompts of one to three full blocks prefilled on one engine,
    exported, staged and imported into another in a shuffled order (a
    local ``random.Random``): both allocators pass ``check()`` at every
    stage, the imported chain is matched whole, and the follow-up request
    gets the oracle's tokens."""
    _, cfg, _, tp, _, _ = setup(MLP)
    kw = dict(kv_len=KV_LEN, n_slots=2, paged=True, prefill_chunk=8,
              prefix_cache=True, device="cpu")
    src, dst = ContinuousEngine(cfg, tp, **kw), ContinuousEngine(cfg, tp, **kw)
    oracle = Engine(cfg, tp, kv_len=KV_LEN, device="cpu")
    buf = BlockTransferBuffer()
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    chains = []
    for f in range(3):
        prompt = nrng.integers(0, cfg.vocab_size,
                               rng.choice((17, 33, 48))).tolist()
        src.submit(prompt, max_new_tokens=1, rid=f"lead{f}")
        assert len(src.run()[f"lead{f}"]) == 1
        hashes = lm.prompt_block_hashes(prompt, src.block_size)
        entries = src.export_prefix_blocks(hashes)
        assert [h for h, _ in entries] == list(hashes)
        buf.put_chain(entries)
        chains.append((prompt, hashes))
        src.allocator.check()
    rng.shuffle(chains)
    for i, (prompt, hashes) in enumerate(chains):
        assert dst.import_prefix_blocks(buf.take_chain(hashes)) == \
            len(hashes)
        dst.allocator.check()
        assert dst.allocator.match_tokens(hashes) == \
            len(hashes) * dst.block_size
        dst.submit(prompt, max_new_tokens=2, rid=f"tail{i}")
        assert dst.run()[f"tail{i}"] == \
            oracle.generate(torch.tensor([prompt]), 2)[0].tolist()
        dst.allocator.check()
    assert dst.telemetry.prefix_hit_rate() > 0
    for eng in (src, dst):
        eng.allocator.drop_cached()
        eng.allocator.check_no_leaks()


def test_import_into_exhausted_pool_degrades_not_corrupts(setup):
    _, cfg, _, tp, _, _ = setup(MLP)
    rng = np.random.default_rng(5)
    src = ContinuousEngine(cfg, tp, kv_len=KV_LEN, n_slots=2, paged=True,
                           prefill_chunk=8, prefix_cache=True, device="cpu")
    dst = ContinuousEngine(cfg, tp, kv_len=KV_LEN, n_slots=1, paged=True,
                           prefix_cache=True, cache_blocks=4, device="cpu")
    prompt = rng.integers(0, cfg.vocab_size, 48).tolist()
    src.submit(prompt, max_new_tokens=1, rid="lead")
    src.run()
    entries = src.export_prefix_blocks(
        lm.prompt_block_hashes(prompt, src.block_size))
    busy = rng.integers(0, cfg.vocab_size, 33).tolist()
    dst.submit(busy, max_new_tokens=8, rid="busy")
    dst.run(max_steps=2)                         # admitted, still decoding
    n = dst.import_prefix_blocks(entries)
    assert 0 <= n < len(entries)
    dst.allocator.check()
    dst.run()
    dst.allocator.drop_cached()
    dst.allocator.check_no_leaks()


# =============================================================================
# rebalancing, adaptation, fleet telemetry
# =============================================================================

def test_rebalance_migrates_only_queued_requests(setup):
    _, cfg, _, _, _, _ = setup(MLP)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, 6).tolist() for _ in range(5)]
    router, jrouter = _both(setup, MLP, n_replicas=2, kv_len=KV_LEN,
                            n_slots=1)
    results = []
    for r in (router, jrouter):
        eng0 = r.replicas[0].engine
        for i, p in enumerate(prompts):
            eng0.submit(p, max_new_tokens=3, rid=i, arrival=0)
        eng0.run(max_steps=1)
        moved = r.rebalance()
        assert [m.rid for m in moved] == [4, 3]
        assert all(m.src == 0 and m.dst == 1 for m in moved)
        assert [q.rid for q in eng0.scheduler._pending] == [1, 2]
        assert r.rebalance() == []
        results.append(r.run())
    assert results[0] == results[1]
    assert [dataclasses.astuple(m) for m in router.migrations] == \
        [dataclasses.astuple(m) for m in jrouter.migrations]
    oracle = Engine(cfg, setup(MLP)[3], kv_len=KV_LEN, device="cpu")
    for i, p in enumerate(prompts):
        assert results[0][i] == \
            oracle.generate(torch.tensor([p]), 3)[0].tolist()
    for rep in router.replicas:
        rep.engine.allocator.check_no_leaks()


def test_fleet_adaptation_matches_the_reference(setup):
    """Both fleets sized by a plan of the served decode shape (TPU v5e
    figures in the reference, the same figures and H100 SXM in the port):
    the same tokens, fleet interference, adaptation trace and adapted
    plan; ``reset_stats`` zeroes the counters in both."""
    jcfg, cfg, jp, tp, prompts, _ = setup(MLP)
    h100 = dataclasses.asdict(T.H100_SXM)
    for jtopo, ttopo in ((J.Topology.homogeneous(4),
                          T.Topology.homogeneous(4)),
                         (J.Topology.homogeneous(4, J.DeviceSpec(**h100)),
                          T.Topology.homogeneous(4, T.H100_SXM))):
        jplan = J.compile_plan(
            jcfg, JContinuousEngine.decode_shape_for(KV_LEN, 2), jtopo,
            cache=False)
        tplan = T.compile_plan(
            cfg, ContinuousEngine.decode_shape_for(KV_LEN, 2), ttopo,
            cache=False)
        router = Router.build(cfg, tp, n_replicas=2, paged=True,
                              plans=tplan, device="cpu")
        jrouter = JRouter.build(jcfg, jp, n_replicas=2, paged=True,
                                plans=jplan)
        outs = []
        for r in (router, jrouter):
            for i, p in enumerate(prompts):
                r.submit(p, max_new_tokens=BUDGETS[i], rid=i, arrival=i)
            r.run()
            outs.append(r.adapt())
        t, j = outs
        assert json.dumps(t.trace.to_json(), sort_keys=True) == \
            json.dumps(j.trace.to_json(), sort_keys=True)
        assert json.dumps(t.plan.to_json(), sort_keys=True) == \
            json.dumps(j.plan.to_json(), sort_keys=True)
        assert t.migrations == [] == j.migrations
        for k in (2, 4):
            assert router.telemetry.device_interference(k) == \
                jrouter.telemetry.device_interference(k)
        assert router.fleet_stats() == jrouter.fleet_stats()
        assert router.fleet_stats()["total_tokens"] == sum(BUDGETS)
        for r in (router, jrouter):
            r.reset_stats()
        assert router.fleet_stats() == jrouter.fleet_stats()
        assert router.fleet_stats()["total_tokens"] == 0


def test_fleet_telemetry_matches_the_reference():
    fleets = []
    for Fleet, Tel in ((FleetTelemetry, ServeTelemetry),
                       (JFleet, JServeTelemetry)):
        fleet = Fleet()
        for r in range(3):
            tel = Tel(window=8)
            fleet.attach(f"replica{r}", tel)
            for i in range(5 * r):
                tel.record_step(
                    step=i, seconds=1e-3,
                    active_slots=(0, 2) if (i + r) % 3 else (1,), n_slots=4,
                    blocks_in_use=12 - i, n_blocks=16, new_tokens=2,
                    prefills=i % 2, prefill_chunks=(i + 1) % 3,
                    prefix_hit_tokens=16 * (i % 2),
                    prefix_lookup_tokens=32 * (i % 2),
                    shared_saved_bytes=1024 * i)
        fleets.append(fleet)
    t, j = fleets
    assert t.summary() == j.summary()
    for k in (1, 2, 4):
        assert t.device_interference(k) == j.device_interference(k)
    for name in ("total_tokens", "total_preemptions", "decode_starvation",
                 "occupancy", "cache_pressure", "prefix_hit_rate",
                 "max_concurrency"):
        assert getattr(t, name)() == getattr(j, name)(), name
    assert t.decode_starvation() > 0 and t.prefix_hit_rate() == 0.5
    assert FleetTelemetry().device_interference(2) == \
        JFleet().device_interference(2)


# =============================================================================
# the launcher
# =============================================================================

def test_launcher_prefix_cache_and_router_on_cpu(capsys):
    base = ["--arch", "tinyllama-1.1b", "--reduced", "--continuous",
            "--paged", "--device", "cpu", "--requests", "4", "--max-new",
            "6", "--kv-len", "64"]
    launch_serve.main(base + ["--prefix-cache", "--shared-prefix", "32"])
    out = capsys.readouterr().out
    assert "[serve-cb] prefix-cache: hit_rate=" in out
    assert "(96/192 tokens, 3/4 admissions)" in out
    first = [ln for ln in out.splitlines() if ln.startswith("first")]
    launch_serve.main(base + ["--replicas", "2", "--disaggregate",
                              "--chunk-prefill", "8", "--shared-prefix",
                              "32"])
    out = capsys.readouterr().out
    assert "over 2 replicas (prefill/decode)" in out
    assert "handoffs=4 " in out and "prefix_hit_rate=" in out
    # routing changes placement, never the tokens
    assert [ln for ln in out.splitlines() if ln.startswith("first")] == first
    launch_serve.main(["--arch", "mamba2-370m", "--reduced", "--continuous",
                       "--paged", "--device", "cpu", "--requests", "3",
                       "--max-new", "4", "--replicas", "2",
                       "--disaggregate"])
    out = capsys.readouterr().out
    assert ("disaggregation unavailable (recurrent-state layers carry "
            "per-request scan state slabs, not content-addressable "
            "blocks) — running 2 co-located replicas") in out
    assert "(mixed/mixed)" in out
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "tinyllama-1.1b", "--reduced",
                           "--device", "cpu", "--replicas", "2"])
