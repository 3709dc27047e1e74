"""Multilevel k-way partitioning (Karypis & Kumar 1998) — beyond-paper.

The port's copy of ``repro.core.multilevel``: the same names, arithmetic
and iteration order, so that floats agree with the reference exactly;
only the imports differ.  Pure Python: no ``torch``.

The paper adapts KK's *greedy refinement*; this module adds the full
multilevel scheme the paper cites: (1) COARSEN the graph by heavy-edge
matching until it is small, (2) partition the coarsest graph (block init on
the coarse topo order), (3) UNCOARSEN, projecting the assignment back level
by level and running the paper's directed-KL refinement at each level.

On transformer graphs the matching naturally merges op chains inside a layer
(qkv->attn_core->o_proj share heavy activation edges), so the coarse graph
is approximately the layer DAG — refinement then moves whole layers first
and individual ops last, converging in fewer passes than flat refinement
from random init (the reference's benchmarks/partition_quality.py
--multilevel).
"""

from __future__ import annotations

from dataclasses import dataclass

from .cost_model import CostModel
from .graph import Graph, Node
from .partitioner import RefineResult, Refiner, block_partition, cut_bytes


@dataclass
class _Level:
    graph: Graph
    # fine node id -> coarse node id (for projection back down)
    mapping: dict


def _coarsen_once(g: Graph) -> tuple[Graph, dict]:
    """Heavy-edge matching: greedily merge endpoint pairs of the heaviest
    edges (each node matched at most once; control edges never matched)."""
    edges = sorted((e for e in g.edges if not e.control and e.weight > 0),
                   key=lambda e: -e.weight)
    matched: dict[str, str] = {}
    used: set[str] = set()
    for e in edges:
        if e.src in used or e.dst in used:
            continue
        # merging src into dst must not create a cycle through others: only
        # merge when src is dst's unique data predecessor or vice versa —
        # cheap sufficient condition that keeps the quotient a DAG.
        preds = [p.src for p in g.in_edges(e.dst) if not p.control]
        if preds.count(e.src) != len(preds):
            continue
        matched[e.src] = e.dst
        used.add(e.src)
        used.add(e.dst)

    coarse = Graph()
    mapping: dict[str, str] = {}
    for nid, node in g.nodes.items():
        if nid in matched:           # merged into its successor
            mapping[nid] = matched[nid]
        else:
            mapping[nid] = nid
    # resolve chains a->b where b itself merged (not possible: b in used)
    for nid, node in g.nodes.items():
        cid = mapping[nid]
        if cid not in coarse.nodes:
            base = g.nodes[cid]
            coarse.add_node(Node(
                id=cid, kind="super", flops=0.0, bytes_accessed=0.0,
                param_bytes=0.0, relocatable=True, layer=base.layer))
        cn = coarse.nodes[cid]
        cn.flops += node.flops
        cn.bytes_accessed += node.bytes_accessed
        cn.param_bytes += node.param_bytes
        cn.relocatable = cn.relocatable and node.relocatable

    seen = {}
    for e in g.edges:
        cs, cd = mapping[e.src], mapping[e.dst]
        if cs == cd:
            continue
        key = (cs, cd, e.control)
        if key in seen:
            seen[key] += e.weight
        else:
            seen[key] = e.weight
    for (cs, cd, ctrl), w in seen.items():
        coarse.add_edge(cs, cd, bytes=w, control=ctrl)
    return coarse, mapping


def multilevel_partition(graph: Graph, cost_model: CostModel, *,
                         min_nodes: int = 64, max_levels: int = 6,
                         epsilon_frac: float = 0.10,
                         gain_mode: str = "paper",
                         convex: bool = False,
                         max_passes: int = 8) -> RefineResult:
    """Coarsen -> partition -> uncoarsen + refine (paper's refinement at
    every level). Returns a RefineResult on the ORIGINAL graph."""
    levels: list[_Level] = []
    g = graph
    for _ in range(max_levels):
        if len(g) <= min_nodes:
            break
        coarse, mapping = _coarsen_once(g)
        if len(coarse) >= len(g):    # no progress
            break
        levels.append(_Level(g, mapping))
        g = coarse

    # initial partition at the coarsest level
    assignment = block_partition(g, cost_model)
    res = Refiner(g, cost_model, epsilon_frac=epsilon_frac,
                  gain_mode=gain_mode, convex=convex,
                  max_passes=max_passes).refine(assignment)
    assignment = res.assignment

    cut0 = None
    # uncoarsen: project and refine at each finer level
    for level in reversed(levels):
        assignment = {nid: assignment[level.mapping[nid]]
                      for nid in level.graph.nodes}
        if cut0 is None:
            cut0 = cut_bytes(level.graph, assignment)
        res = Refiner(level.graph, cost_model, epsilon_frac=epsilon_frac,
                      gain_mode=gain_mode, convex=convex,
                      max_passes=max_passes).refine(assignment)
        assignment = res.assignment

    final_cut = cut_bytes(graph, assignment)
    return RefineResult(
        assignment=assignment, passes=res.passes,
        comm_moves=res.comm_moves, balance_moves=res.balance_moves,
        cut_before=cut0 if cut0 is not None else final_cut,
        cut_after=final_cut, history=res.history)
