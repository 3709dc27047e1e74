"""The port's planning loop (``repro_torch.core``) against the reference
``repro.core``, exactly: graphs, costs and tags, topologies, partitions
(block, random and multilevel; both gain modes; convex on and off),
compiled plans (keys, JSON, stage tables, ``describe``) on the TPU v5e and
the H100 SXM figures, plan operations and their refusals, the plan cache,
and the §3 assistants' adaptation traces.  Every comparison is ``==`` on
floats, dicts and JSON text: the port copies the reference's arithmetic
and its order, so there is no tolerance to allow.

Also F3 (see ``ROADMAP.md``): the paper gain's summed comm score is
``2 * cut_bytes - W`` (``W`` the total edge weight), so a property asking
that one ``_comm_pass`` never raises it asks for cut-monotonicity, which
the paper's incoming-only gain does not give; at the three recorded
counterexamples one pass raises it, by the same amount in both packages.
"""

import dataclasses
import json
import math

import pytest

import repro.core as J
import repro_torch.core as T
from _dags import random_dag
from repro import configs as jconfigs
from repro.core.multilevel import multilevel_partition as j_multilevel
from repro.core.partitioner import Refiner as JRefiner
from repro.models.config import SHAPES as JSHAPES
from repro.models.config import ShapeConfig as JShapeConfig
from repro_torch import configs
from repro_torch.core.multilevel import multilevel_partition as t_multilevel
from repro_torch.core.partitioner import Refiner as TRefiner
from repro_torch.models.config import SHAPES, ShapeConfig

ARCHS = configs.available()
SERVE_SHAPE = ("serve_decode_512", 512, 4, "decode")
SHAPE_NAMES = sorted(SHAPES) + ["serve_decode_512"]
# (nodes, edge probability, seed, devices): a fixed list of random DAGs
DAGS = [(8, 0.375, 2, 2), (12, 0.3, 5, 3), (20, 0.2, 11, 4),
        (34, 0.1796875, 451, 2), (35, 0.296875, 7680, 3), (48, 0.1, 99, 8),
        (80, 0.08, 7, 4)]
# coarsened to 8 nodes, this DAG's quotient graph has a cycle (F6)
MULTILEVEL_CYCLE = (20, 0.2, 11)
# F3's counterexamples to test_paper_gain_moves_reduce_incoming_external_bytes
F3_CASES = [(8, 0.375, 2, 2), (34, 0.1796875, 451, 2),
            (35, 0.296875, 7680, 3)]
H100_FIELDS = dataclasses.asdict(T.H100_SXM)
SPECS = {"tpu": (J.TPU_V5E, T.TPU_V5E),
         "h100": (J.DeviceSpec(**H100_FIELDS), T.H100_SXM)}


def _dumps(doc) -> str:
    return json.dumps(doc, sort_keys=True)


def _cfgs(arch, reduced=False):
    j, t = jconfigs.get(arch), configs.get(arch)
    return (j.reduced(), t.reduced()) if reduced else (j, t)


def _shapes(name):
    if name == "serve_decode_512":
        return JShapeConfig(*SERVE_SHAPE), ShapeConfig(*SERVE_SHAPE)
    return JSHAPES[name], SHAPES[name]


def _dag_pair(n, p, seed):
    jg = random_dag(n, p, seed)
    return jg, T.Graph.from_json(jg.to_json())


def _topologies(k, spec="tpu", hetero=False):
    jspec, tspec = SPECS[spec]
    if hetero:
        speeds = [0.5 + 0.25 * i for i in range(k)]
        return (J.Topology.heterogeneous(speeds, jspec),
                T.Topology.heterogeneous(speeds, tspec))
    return J.Topology.homogeneous(k, jspec), T.Topology.homogeneous(k, tspec)


def _graph_doc(g):
    """Every field of every node (with its flags and tag) and every edge."""
    return {"nodes": [dataclasses.asdict(n) for n in g.nodes.values()],
            "edges": [dataclasses.asdict(e) for e in g.edges]}


# =============================================================================
# configs, shapes and graphs
# =============================================================================

def test_h100_spec_is_the_datasheet_sxm_column():
    assert H100_FIELDS == {"name": "h100-sxm", "flops_per_s": 989e12,
                           "hbm_bw": 3.35e12, "link_bw": 450e9,
                           "memory_bytes": 80e9, "speed_factor": 1.0}
    assert T.__all__ == J.__all__[:J.__all__.index("TPU_V5E") + 1] + \
        ["H100_SXM"] + J.__all__[J.__all__.index("TPU_V5E") + 1:]


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for arch in ARCHS:
        j, t = _cfgs(arch)
        assert [s.key for s in j.enc_layers()] == \
            [s.key for s in t.enc_layers()]


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_graph_matches_reference(arch, reduced, shape):
    jcfg, tcfg = _cfgs(arch, reduced)
    jshape, tshape = _shapes(shape)
    jg, tg = J.build_graph(jcfg, jshape), T.build_graph(tcfg, tshape)
    assert _graph_doc(tg) == _graph_doc(jg)
    assert tg.topo_order() == jg.topo_order()
    assert tg.summary() == jg.summary()
    assert tg.relocatable_ids() == jg.relocatable_ids()
    assert T.Graph.from_json(json.loads(_dumps(jg.to_json()))).to_json() \
        == tg.to_json()


# =============================================================================
# cost model and topology
# =============================================================================

@pytest.mark.parametrize("hetero", [False, True], ids=["homog", "hetero"])
@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("mode", ["paper", "roofline"])
def test_cost_model_matches_reference(mode, spec, hetero):
    jtopo, ttopo = _topologies(4, spec, hetero)
    for arch in ARCHS:
        jshape, tshape = _shapes("serve_decode_512")
        jg = J.build_graph(jconfigs.get(arch), jshape)
        tg = T.build_graph(configs.get(arch), tshape)
        jcm, tcm = J.CostModel(jtopo, mode=mode), T.CostModel(ttopo, mode=mode)
        for d in range(4):
            assert [tcm.node_cost(n, d) for n in tg] == \
                [jcm.node_cost(n, d) for n in jg]
            assert tcm.edge_cost(3e6, d) == jcm.edge_cost(3e6, d)
            assert [tcm.link_cost(5e6, d, r) for r in range(4)] == \
                [jcm.link_cost(5e6, d, r) for r in range(4)]
        jcm.select_relocatable(jg)
        tcm.select_relocatable(tg)
        jcm.tag_nodes(jg, device_idx=1)
        tcm.tag_nodes(tg, device_idx=1)
        assert _graph_doc(tg) == _graph_doc(jg)
        a = {nid: i % 4 for i, nid in enumerate(jg.nodes)}
        assert tcm.assignment_costs(tg, a) == jcm.assignment_costs(jg, a)
        assert tcm.ideal_share(tg) == jcm.ideal_share(jg)
    # the legacy device-list surface wraps a uniform fabric
    jdev = J.homogeneous_devices(3, SPECS[spec][0])
    tdev = T.homogeneous_devices(3, SPECS[spec][1])
    assert [dataclasses.asdict(d) for d in tdev] == \
        [dataclasses.asdict(d) for d in jdev]
    assert T.CostModel(tdev).topology.to_json() == \
        J.CostModel(jdev).topology.to_json()


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_topology_matches_reference(spec):
    jspec, tspec = SPECS[spec]
    pairs = [_topologies(4, spec), _topologies(3, spec, hetero=True)]
    bw = [[0.0, 1e9, 2e9], [1e9, 0.0, 0.0], [2e9, 4e9, 0.0]]
    pairs.append((J.Topology.from_devices(pairs[1][0].devices, bw),
                  T.Topology.from_devices(pairs[1][1].devices, bw)))
    for jt, tt in pairs:
        assert tt.to_json() == jt.to_json()
        assert tt.fingerprint() == jt.fingerprint()
        assert tt.describe() == jt.describe()
        assert tt.is_homogeneous() == jt.is_homogeneous()
        assert [[tt.link_bw(i, j) for j in range(tt.k)]
                for i in range(tt.k)] == \
            [[jt.link_bw(i, j) for j in range(jt.k)] for i in range(jt.k)]
        assert T.Topology.from_json(json.loads(_dumps(jt.to_json()))) == tt
    with pytest.raises(ValueError, match="4x4"):
        T.Topology.from_devices(pairs[0][1].devices, [[0.0]])
    with pytest.raises(ValueError, match="schema version"):
        T.Topology.from_json(dict(pairs[0][1].to_json(), version=2))


# =============================================================================
# partitioner
# =============================================================================

def _partition_both(jg, tg, k, strategy, gain_mode, convex, seed=0):
    jcm = J.CostModel(J.homogeneous_devices(k))
    tcm = T.CostModel(T.homogeneous_devices(k))
    if strategy == "multilevel":
        kw = dict(min_nodes=8, gain_mode=gain_mode, convex=convex)
        return j_multilevel(jg, jcm, **kw), t_multilevel(tg, tcm, **kw)
    kw = dict(strategy=strategy, gain_mode=gain_mode, convex=convex,
              seed=seed)
    return J.partition(jg, jcm, **kw), T.partition(tg, tcm, **kw)


def _outcome(fn):
    """``fn()``'s result, or the type and message of what it raised."""
    try:
        return "ok", fn()
    except ValueError as exc:
        return type(exc).__name__, str(exc)


@pytest.mark.parametrize("convex", [False, True], ids=["free", "convex"])
@pytest.mark.parametrize("gain_mode", ["paper", "symmetric"])
@pytest.mark.parametrize("strategy", ["block", "random", "multilevel"])
def test_partition_dags_match_reference(strategy, gain_mode, convex):
    for n, p, seed, k in DAGS:
        jg, tg = _dag_pair(n, p, seed)
        if strategy == "multilevel" and (n, p, seed) == MULTILEVEL_CYCLE:
            # F6: the coarsening merges a node into a successor that a
            # control edge also reaches from it, and the coarse graph has
            # a cycle; the port raises exactly what the reference raises
            outs = [_outcome(lambda: multilevel(
                g, core.CostModel(core.homogeneous_devices(k)), min_nodes=8,
                gain_mode=gain_mode, convex=convex))
                for core, multilevel, g in ((J, j_multilevel, jg),
                                            (T, t_multilevel, tg))]
            assert outs[0] == outs[1]
            assert outs[1][0] == "ValueError" and "cycle" in outs[1][1]
            continue
        jr, tr = _partition_both(jg, tg, k, strategy, gain_mode, convex,
                                 seed)
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr), \
            (n, p, seed, k)
        jcm = J.CostModel(J.homogeneous_devices(k))
        tcm = T.CostModel(T.homogeneous_devices(k))
        assert T.balance_stats(tg, tr.assignment, tcm) == \
            J.balance_stats(jg, jr.assignment, jcm)
        assert T.cut_bytes(tg, tr.assignment) == \
            J.cut_bytes(jg, jr.assignment)


@pytest.mark.parametrize("strategy", ["block", "random", "multilevel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_partition_config_graphs_match_reference(arch, strategy):
    for shape in ("train_4k", "serve_decode_512"):
        jshape, tshape = _shapes(shape)
        jg = J.build_graph(jconfigs.get(arch), jshape)
        tg = T.build_graph(configs.get(arch), tshape)
        for gain_mode, convex in (("paper", False), ("symmetric", True)):
            jr, tr = _partition_both(jg, tg, 4, strategy, gain_mode, convex,
                                     seed=3)
            assert dataclasses.asdict(tr) == dataclasses.asdict(jr)


def test_random_and_block_partitions_match_reference():
    jg, tg = _dag_pair(30, 0.2, 4)
    for k in (2, 5):
        assert T.random_partition(tg, k, 17) == J.random_partition(jg, k, 17)
        assert T.block_partition(tg, T.CostModel(T.homogeneous_devices(k))) \
            == J.block_partition(jg, J.CostModel(J.homogeneous_devices(k)))
        a = T.random_partition(tg, k, 1)
        for gain_mode in ("paper", "symmetric"):
            assert [T.comm_score(tg, a, nid, d, gain_mode)
                    for nid in tg.nodes for d in range(k)] == \
                [J.comm_score(jg, a, nid, d, gain_mode)
                 for nid in jg.nodes for d in range(k)]


# =============================================================================
# F3: the summed paper comm score is 2 * cut - W
# =============================================================================

def _score_sum(core, g, a):
    return sum(core.comm_score(g, a, nid, a[nid], "paper") for nid in g.nodes)


@pytest.mark.parametrize("dag", DAGS, ids=str)
def test_paper_score_sum_is_twice_cut_minus_total_weight(dag):
    """Each edge's weight counts once at its destination, as external
    (E, cut) or internal (I, uncut): Σ_n D_n = cut - (W - cut)."""
    n, p, seed, k = dag
    jg, tg = _dag_pair(n, p, seed)
    for core, g in ((J, jg), (T, tg)):
        w = g.total_edge_bytes()
        for a in (core.random_partition(g, k, seed),
                  core.block_partition(g, core.CostModel(
                      core.homogeneous_devices(k)))):
            identity = 2.0 * core.cut_bytes(g, a) - w
            assert math.isclose(_score_sum(core, g, a), identity,
                                rel_tol=1e-12, abs_tol=1e-6 * w)


@pytest.mark.parametrize("case", F3_CASES, ids=str)
def test_f3_one_paper_comm_pass_raises_the_sum_in_both_packages(case):
    """F3's counterexamples: the paper gain moves a node whenever its own
    incoming score falls, which can cut more of its outgoing edges, so
    one pass raises Σ D_n (= 2 * cut - W) here; the port does exactly what
    the reference does."""
    n, p, seed, k = case
    jg, tg = _dag_pair(n, p, seed)
    rises = []
    for core, refiner, g in ((J, JRefiner, jg), (T, TRefiner, tg)):
        cm = core.CostModel(core.homogeneous_devices(k))
        a = core.random_partition(g, k, seed)
        r = refiner(g, cm, epsilon_frac=10.0, gain_mode="paper")
        before = (_score_sum(core, g, a), core.cut_bytes(g, a))
        moves = r._comm_pass(a, cm.assignment_costs(g, a))
        after = (_score_sum(core, g, a), core.cut_bytes(g, a))
        assert moves > 0
        assert after[0] > before[0] and after[1] > before[1]
        w = g.total_edge_bytes()
        for total, cut in (before, after):
            assert math.isclose(total, 2.0 * cut - w, rel_tol=1e-12,
                                abs_tol=1e-6 * w)
        rises.append((after[0] - before[0], dict(a)))
    assert rises[0] == rises[1]


# =============================================================================
# compiled plans
# =============================================================================

@pytest.mark.parametrize("backend", ["tensor", "pipeline"])
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("arch", ARCHS)
def test_compile_plan_matches_reference(arch, spec, k, backend):
    jtopo, ttopo = _topologies(k, spec)
    jshape, tshape = _shapes("serve_decode_512")
    for strategy in ("block", "multilevel"):
        jp = J.compile_plan(jconfigs.get(arch), jshape, jtopo,
                            backend=backend, cache=False,
                            strategy=J.PartitionStrategy(strategy=strategy))
        tp = T.compile_plan(configs.get(arch), tshape, ttopo,
                            backend=backend, cache=False,
                            strategy=T.PartitionStrategy(strategy=strategy))
        assert tp.key == jp.key == T.plan_key(
            configs.get(arch), tshape, ttopo, backend,
            T.PartitionStrategy(strategy=strategy))
        assert _dumps(tp.to_json()) == _dumps(jp.to_json())
        assert tp.layer_to_stage == jp.layer_to_stage
        assert tp.enc_layer_to_stage == jp.enc_layer_to_stage
        assert tp.describe() == jp.describe()
        assert tp.summary() == jp.summary()
        clone = T.CompiledPlan.from_json(json.loads(_dumps(jp.to_json())),
                                         verify=True)
        assert clone.assignment == tp.assignment
        assert clone.step_time == tp.step_time


def test_plan_keys_track_every_input():
    cfg, shape = configs.get("tinyllama-1.1b"), SHAPES["train_4k"]
    topo = T.Topology.homogeneous(4, T.H100_SXM)
    base = T.plan_key(cfg, shape, topo)
    assert base != T.plan_key(cfg, shape, T.Topology.homogeneous(4))
    assert base != T.plan_key(cfg, shape,
                              T.Topology.homogeneous(8, T.H100_SXM))
    assert base != T.plan_key(cfg, SHAPES["decode_32k"], topo)
    assert base != T.plan_key(cfg, shape, topo, "pipeline")
    assert base != T.plan_key(cfg, shape, topo,
                              strategy=T.PartitionStrategy(seed=7))
    assert base != T.plan_key(cfg.reduced(), shape, topo)


def _plan_pair(arch="tinyllama-1.1b", k=4, **kw):
    jp = J.compile_plan(jconfigs.get(arch), JSHAPES["train_4k"],
                        J.Topology.homogeneous(k), cache=False, **kw)
    tkw = dict(kw)
    if "strategy" in kw:
        tkw["strategy"] = T.PartitionStrategy(**kw["strategy"].to_json())
    tp = T.compile_plan(configs.get(arch), SHAPES["train_4k"],
                        T.Topology.homogeneous(k), cache=False, **tkw)
    return jp, tp


def _refusal(plan, delta, **kw):
    with pytest.raises(Exception) as exc:
        plan.apply(delta, **kw)
    return type(exc.value).__name__, str(exc.value)


def test_plan_apply_and_refusals_match_reference():
    jp, tp = _plan_pair()
    nid = next(n for n in tp.graph.relocatable_ids() if tp.assignment[n] == 0)
    pinned = next(n for n, node in tp.graph.nodes.items()
                  if not node.relocatable)
    heavy = max((n for n in tp.graph.relocatable_ids()
                 if tp.assignment[n] == 0),
                key=lambda n: tp.graph.nodes[n].flops)
    before = dict(tp.assignment)
    cases = [(("no-such-node", 0, 1), {}), ((nid, 3, 1), {}),
             ((nid, 0, 9), {}), ((nid, 0, 0), {}),
             ((pinned, tp.assignment[pinned],
               (tp.assignment[pinned] + 1) % 4), {}),
             ((heavy, 0, 1), {"balance_epsilon": 1e-9})]
    for args, kw in cases:
        got = _refusal(tp, T.PlanDelta(*args), **kw)
        assert got[0] == "PlanDeltaError"
        assert got == _refusal(jp, J.PlanDelta(*args), **kw)
        assert tp.assignment == before
    jnew = jp.apply(J.PlanDelta(nid, 0, 1, "compute"))
    tnew = tp.apply(T.PlanDelta(nid, 0, 1, "compute"))
    assert tp.assignment == before and tnew.assignment[nid] == 1
    assert tnew.result.assignment == tnew.assignment
    assert _dumps(tnew.to_json()) == _dumps(jnew.to_json())
    assert tp.diff(tnew) == jp.diff(jnew)
    assert tnew.diff(tp) == jnew.diff(jp)
    heavy_j = jp.apply(J.PlanDelta(heavy, 0, 1), balance_epsilon=1e9)
    heavy_t = tp.apply(T.PlanDelta(heavy, 0, 1), balance_epsilon=1e9)
    assert heavy_t.assignment == heavy_j.assignment


def test_pipeline_convexity_refusal_matches_reference():
    jp, tp = _plan_pair(backend="pipeline")
    g = tp.graph
    for nid in g.relocatable_ids():
        lo = max([tp.assignment[e.src] for e in g.in_edges(nid)], default=0)
        hi = min([tp.assignment[e.dst] for e in g.out_edges(nid)],
                 default=tp.k - 1)
        src = tp.assignment[nid]
        bad = [d for d in range(tp.k) if (d < lo or d > hi) and d != src]
        if lo <= hi and bad:
            break
    else:
        raise AssertionError("no convexity-constrained relocatable node")
    got = _refusal(tp, T.PlanDelta(nid, src, bad[0]))
    assert "convexity" in got[1]
    assert got == _refusal(jp, J.PlanDelta(nid, src, bad[0]))
    assert tp.apply(T.PlanDelta(nid, src, bad[0]), check_convex=False) \
        .assignment == jp.apply(J.PlanDelta(nid, src, bad[0]),
                                check_convex=False).assignment


def test_missing_link_refusal_and_artifact_refusals_match_reference():
    jbase, tbase = _topologies(4)
    bw = [[0.0] * 4 for _ in range(4)]
    for i in range(3):
        bw[i][i + 1] = bw[i + 1][i] = 50e9
    kw = dict(cache=False, strategy=None)
    jp = J.compile_plan(jconfigs.get("tinyllama-1.1b"), JSHAPES["train_4k"],
                        J.Topology.from_devices(jbase.devices, bw), **kw)
    tp = T.compile_plan(configs.get("tinyllama-1.1b"), SHAPES["train_4k"],
                        T.Topology.from_devices(tbase.devices, bw), **kw)
    nid = next(n for n in tp.graph.relocatable_ids()
               if tp.assignment[n] == 0
               and any(e.weight and tp.assignment[e.src] == 0
                       for e in tp.graph.in_edges(n)))
    got = _refusal(tp, T.PlanDelta(nid, 0, 3))
    assert "no fabric link" in got[1]
    assert got == _refusal(jp, J.PlanDelta(nid, 0, 3))
    # artifacts: a wrong version, a stale summary, a truncated assignment,
    # a plan without its graph
    for edit in (lambda d: d.update(version=999),
                 lambda d: d["summary"].update(
                     step_time_s=d["summary"]["step_time_s"] * 2.0),
                 lambda d: d["assignment"].pop(next(iter(d["assignment"])))):
        outs = []
        for core, plan in ((J, jp), (T, tp)):
            doc = plan.to_json()
            edit(doc)
            with pytest.raises(core.PlanError) as exc:
                core.CompiledPlan.from_json(doc, verify=True)
            outs.append(str(exc.value))
        assert outs[0] == outs[1]
    bare = dataclasses.replace(tp, graph=None, cost_model=None)
    with pytest.raises(T.PlanError, match="no attached graph"):
        bare.describe()


def test_plan_cache_round_trip_corruption_and_hits(tmp_path):
    cache = T.PlanCache(tmp_path / "plans")
    topo = T.Topology.homogeneous(2, T.H100_SXM)
    shape = SHAPES["decode_32k"]
    first = {arch: T.compile_plan(configs.get(arch), shape, topo,
                                  cache=cache) for arch in ARCHS}
    assert not any(p.from_cache for p in first.values())
    assert (cache.hits, cache.misses, len(cache)) == \
        (0, len(ARCHS), len(ARCHS))
    for arch, plan in first.items():
        hit = T.compile_plan(configs.get(arch), shape, topo, cache=cache)
        assert hit.from_cache and hit.key == plan.key
        # equal, not the same text: a loaded graph holds param_bytes as
        # floats where graphgen made ints (as in the reference)
        assert hit.to_json() == plan.to_json()
    assert cache.hits == len(ARCHS)
    plan = first["tinyllama-1.1b"]
    cache.path_for(plan.key).write_text("{not json")
    again = T.compile_plan(plan.cfg, shape, topo, cache=cache)
    assert not again.from_cache and again.assignment == plan.assignment
    assert T.compile_plan(plan.cfg, shape, topo, cache=cache).from_cache
    assert not T.compile_plan(plan.cfg, shape,
                              T.Topology.homogeneous(8, T.H100_SXM),
                              cache=cache).from_cache
    n = len(cache)
    assert cache.clear() == n and len(cache) == 0


def test_plan_cache_location_and_switches(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert T.default_cache_dir() == tmp_path / "xdg" / "repro_torch" / "plans"
    for off in ("0", "off", "none", ""):
        monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", off)
        assert T.default_cache_dir() is None
        assert T.PlanCache.default() is None
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "mine"))
    assert T.default_cache_dir() == tmp_path / "mine"
    cfg = configs.get("paper-mlp")
    plan = T.compile_plan(cfg, SHAPES["train_4k"], 2)
    assert not plan.from_cache
    assert (tmp_path / "mine" / f"{plan.key}.json").is_file()
    assert T.compile_plan(cfg, SHAPES["train_4k"], 2).from_cache
    # an unusable location skips the cache rather than fail the compile
    blocker = tmp_path / "afile"
    blocker.write_text("not a directory")
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(blocker / "cache"))
    assert not T.compile_plan(cfg, SHAPES["train_4k"], 2).from_cache


def test_plan_model_shim_matches_reference():
    jcfg, tcfg = jconfigs.get("paper-mlp"), configs.get("paper-mlp")
    with pytest.warns(DeprecationWarning):
        jp = J.plan_model(jcfg, JSHAPES["train_4k"], k=4)
    with pytest.warns(DeprecationWarning):
        tp = T.plan_model(tcfg, SHAPES["train_4k"], k=4)
    assert T.Plan is T.CompiledPlan
    assert _dumps(tp.to_json()) == _dumps(jp.to_json())


# =============================================================================
# the §3 assistants
# =============================================================================

def _uniform(core, n=16, pinned=()):
    g = core.Graph()
    for i in range(n):
        g.add_node(core.Node(id=f"n{i}", kind="op", flops=1e12,
                             bytes_accessed=1e3,
                             relocatable=f"n{i}" not in pinned))
    for i in range(n - 1):
        g.add_edge(f"n{i}", f"n{i+1}", bytes=1.0)
    return g


def _skewed_interference(core, k=4):
    """A ServeTelemetry whose device-0 lane was saturated over the whole
    window (``tests/test_serve_telemetry.py``'s ``_skewed_telemetry``, at
    the default ``alpha`` and ``beta``, which the port keeps constant)."""
    from repro.runtime import ServeTelemetry as JTel
    from repro_torch.runtime import ServeTelemetry as TTel
    tel = (JTel if core is J else TTel)()
    for i in range(50):
        tel.record_step(step=i, seconds=1e-3, active_slots=(0,), n_slots=4,
                        blocks_in_use=12, n_blocks=16, new_tokens=1)
    return tel


def _trace(core, case):
    """One adaptation case of the reference's assistant and telemetry
    tests, run in ``core``; returns the trace."""
    if case in ("serve_skew_balanced", "serve_skew_on_0"):
        pinned = ("n0", "n5", "n10")
        g = _uniform(core, 24, pinned)
        cm = core.CostModel(core.homogeneous_devices(4))
        cm.tag_nodes(g)
        a = ({f"n{i}": i % 4 for i in range(24)}
             if case == "serve_skew_balanced"
             else {f"n{i}": 0 for i in range(24)})
        tel = _skewed_interference(core)
        return core.run_adaptation(
            g, dict(a), cm, telemetry=tel.assistant_callback(g, cm),
            interference=tel.device_interference(cm.k),
            config=core.AssistantConfig(theta=0.9, gamma=0.8),
            max_steps=50)
    if case == "all_on_0":
        g = _uniform(core)
        cm = core.CostModel(core.homogeneous_devices(4))
        cm.tag_nodes(g)
        return core.run_adaptation(g, {f"n{i}": 0 for i in range(16)}, cm)
    if case == "interference":
        g = _uniform(core)
        cm = core.CostModel(core.homogeneous_devices(4))
        cm.tag_nodes(g)
        return core.run_adaptation(
            g, {f"n{i}": i % 4 for i in range(16)}, cm,
            interference=[{"compute": 3.0}, {}, {}, {}],
            config=core.AssistantConfig(theta=0.9, gamma=0.6))
    assert case == "tinyllama_hetero"
    shape = JSHAPES["train_4k"] if core is J else SHAPES["train_4k"]
    cfg = (jconfigs if core is J else configs).get("tinyllama-1.1b")
    g = core.build_graph(cfg, shape)
    cm = core.CostModel(core.heterogeneous_devices([0.5] + [1.0] * 7))
    cm.select_relocatable(g)
    cm.tag_nodes(g)
    return core.run_adaptation(g, core.block_partition(g, cm), cm,
                               max_steps=30)


ADAPT_CASES = ["serve_skew_balanced", "serve_skew_on_0", "all_on_0",
               "interference", "tinyllama_hetero"]


@pytest.mark.parametrize("case", ADAPT_CASES)
def test_adaptation_trace_matches_reference(case):
    jt, tt = _trace(J, case), _trace(T, case)
    assert _dumps(tt.to_json()) == _dumps(jt.to_json())
    assert tt.step_times == jt.step_times
    if case != "tinyllama_hetero":
        assert tt.deltas, "this case must migrate nodes"
    clone = T.AdaptationTrace.from_json(json.loads(_dumps(jt.to_json())))
    assert [d.to_json() for d in clone.deltas] == \
        [d.to_json() for d in tt.deltas]


def test_assistant_rules_and_utilization_match_reference():
    outs = []
    for core in (J, T):
        g = _uniform(core, 8)
        cm = core.CostModel(core.homogeneous_devices(2))
        cm.tag_nodes(g)
        a = {f"n{i}": 0 for i in range(8)}
        utils = core.simulate_utilization(g, a, cm)
        assistants = core.SchedulingAssistants(g, cm)
        migs = assistants.step(a, utils)
        inter = [{"compute": 1.5, "memory": 2.0}, {}]
        outs.append((utils, [m.to_json() for m in migs], dict(a),
                     core.modeled_step_time(g, a, cm, inter),
                     core.simulate_utilization(g, a, cm, inter),
                     assistants.state.out_boxes))
    assert outs[0] == outs[1]
    assert T.Migration is T.PlanDelta


@pytest.mark.parametrize("backend", ["tensor", "pipeline"])
def test_adapt_plan_matches_reference_under_fixed_interference(backend):
    cfg = J.AssistantConfig(theta=0.9, gamma=0.6)
    tcfg = T.AssistantConfig(theta=0.9, gamma=0.6)
    jp, tp = _plan_pair(k=8, backend=backend,
                        strategy=J.PartitionStrategy(refine=False))
    inter = [{"compute": 2.5}] + [{}] * 7
    jadapted, jtrace = J.adapt_plan(jp, interference=inter, config=cfg)
    tadapted, ttrace = T.adapt_plan(tp, interference=inter, config=tcfg)
    assert ttrace.deltas
    assert _dumps(ttrace.to_json()) == _dumps(jtrace.to_json())
    assert _dumps(tadapted.to_json()) == _dumps(jadapted.to_json())
    assert tadapted.assignment == ttrace.replay(tp.assignment)
    assert sum(d.gain for d in ttrace.deltas) == pytest.approx(
        ttrace.step_times[0] - ttrace.step_times[-1])
    wrong = {n: (d + 1) % tp.k for n, d in tp.assignment.items()}
    with pytest.raises(ValueError, match="stale"):
        ttrace.replay(wrong)
