"""Graph partitioning for automatic model parallelism (paper §2, phases 3-4).

The port's copy of ``repro.core.partitioner``: the same names, arithmetic
and iteration order, so that floats agree with the reference exactly;
only the imports differ.  Pure Python: no ``torch``.

Implements, faithfully:

* **Initial partitioning** — block (topological sort + contiguous C/k blocks)
  and random (§2.3).
* **Iterative repartitioning** (§2.4) — the Kernighan-Lin-style communication
  score adapted to *directed* dataflow graphs,

      D_n^p = E_n^p − I_n^p      (incoming edges only, per the paper),

  with Karypis-Kumar greedy refinement where the load-balance constraint
  ``|C_Di − C/k| ≤ ε`` is *primary*: a communication move is admitted only if
  both endpoint devices stay within ε of the ideal share, and dedicated
  balance moves run when a device sits above the ideal share while another
  sits below (the paper's second condition).

Beyond-paper extensions (flagged, benchmarked separately):

* ``gain_mode="symmetric"`` — include outgoing edges in the score (classic KL
  uses all incident edges; the paper restricts to incoming ones).
* ``convex=True`` — constrain moves so stage(pred) ≤ stage(n) ≤ stage(succ),
  keeping the quotient graph acyclic; required when the partition is realized
  as a pipeline over a mesh axis of devices.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass, field

from .cost_model import CostModel
from .graph import Graph

NEG_INF = float("-inf")
POS_INF = float("inf")


# =============================================================================
# metrics
# =============================================================================

def cut_bytes(graph: Graph, assignment: dict[str, int]) -> float:
    """Total bytes crossing device boundaries — the objective Σ D is a proxy for."""
    return sum(e.weight for e in graph.edges
               if assignment[e.src] != assignment[e.dst])


def comm_score(graph: Graph, assignment: dict[str, int], nid: str,
               device: int, gain_mode: str = "paper") -> float:
    """The paper's D_n^p = E_n^p − I_n^p evaluated as if ``nid`` sat on ``device``.

    E: incoming-edge weight from nodes on *other* devices;
    I: incoming-edge weight from nodes on ``device``.
    ``symmetric`` additionally counts outgoing edges (beyond-paper).
    """
    e_ext = 0.0
    i_int = 0.0
    for e in graph.in_edges(nid):
        if assignment[e.src] == device:
            i_int += e.weight
        else:
            e_ext += e.weight
    if gain_mode == "symmetric":
        for e in graph.out_edges(nid):
            if assignment[e.dst] == device:
                i_int += e.weight
            else:
                e_ext += e.weight
    return e_ext - i_int


def balance_stats(graph: Graph, assignment: dict[str, int],
                  cost_model: CostModel) -> dict:
    loads = cost_model.assignment_costs(graph, assignment)
    ideal = cost_model.ideal_share(graph)
    dev = [abs(l - ideal) for l in loads]
    return {
        "loads": loads,
        "ideal": ideal,
        "max_dev": max(dev) if dev else 0.0,
        "imbalance": (max(loads) / ideal) if ideal > 0 else 1.0,
    }


# =============================================================================
# initial partitioning (paper §2.3)
# =============================================================================

def block_partition(graph: Graph, cost_model: CostModel) -> dict[str, int]:
    """Topologically sort, then split the order into k blocks of ≈C/k cost."""
    k = cost_model.k
    order = graph.topo_order()
    total = sum(cost_model.node_cost(graph.nodes[n], 0) for n in order)
    share = total / k if k else 0.0
    assignment: dict[str, int] = {}
    acc = 0.0
    dev = 0
    for nid in order:
        c = cost_model.node_cost(graph.nodes[nid], dev)
        # close the block when adding this node overshoots the share midpoint
        if dev < k - 1 and acc + c / 2.0 > share * (dev + 1):
            dev += 1
        assignment[nid] = dev
        acc += c
    return assignment


def random_partition(graph: Graph, k: int, seed: int = 0) -> dict[str, int]:
    rng = _random.Random(seed)
    return {nid: rng.randrange(k) for nid in graph.nodes}


# =============================================================================
# iterative repartitioning (paper §2.4)
# =============================================================================

@dataclass
class RefineResult:
    assignment: dict[str, int]
    passes: int
    comm_moves: int
    balance_moves: int
    cut_before: float
    cut_after: float
    history: list[dict] = field(default_factory=list)


class Refiner:
    def __init__(self, graph: Graph, cost_model: CostModel,
                 epsilon_frac: float = 0.10, gain_mode: str = "paper",
                 convex: bool = False, max_passes: int = 20):
        assert gain_mode in ("paper", "symmetric")
        self.g = graph
        self.cm = cost_model
        self.k = cost_model.k
        self.gain_mode = gain_mode
        self.convex = convex
        self.max_passes = max_passes
        self.ideal = cost_model.ideal_share(graph)
        self.epsilon = epsilon_frac * self.ideal

    # -- constraint helpers ----------------------------------------------------
    def _stage_interval(self, assignment: dict[str, int], nid: str) -> tuple[int, int]:
        """Allowed [lo, hi] stages for ``nid`` under the convexity constraint."""
        lo, hi = 0, self.k - 1
        for e in self.g.in_edges(nid):
            lo = max(lo, assignment[e.src])
        for e in self.g.out_edges(nid):
            hi = min(hi, assignment[e.dst])
        return lo, hi

    def _balance_ok_after(self, loads: list[float], nid: str, q: int, r: int) -> bool:
        """Paper's two balance conjuncts for a q -> r move of node ``nid``."""
        node = self.g.nodes[nid]
        c_r = self.cm.node_cost(node, r)
        c_q = self.cm.node_cost(node, q)
        recv_ok = (loads[r] + c_r) - self.ideal <= self.epsilon
        send_ok = self.ideal - (loads[q] - c_q) <= self.epsilon
        return recv_ok and send_ok

    # -- one communication-minimization pass ------------------------------------
    def _comm_pass(self, assignment: dict[str, int], loads: list[float]) -> int:
        moves = 0
        # greedy: order candidates by current score (worst communicators first)
        cands = sorted(
            (nid for nid in self.g.relocatable_ids()),
            key=lambda nid: -comm_score(self.g, assignment, nid,
                                        assignment[nid], self.gain_mode),
        )
        for nid in cands:
            q = assignment[nid]
            d_cur = comm_score(self.g, assignment, nid, q, self.gain_mode)
            lo, hi = (self._stage_interval(assignment, nid) if self.convex
                      else (0, self.k - 1))
            if lo > hi:
                continue
            best_r, best_d = q, d_cur
            for r in range(lo, hi + 1):
                if r == q:
                    continue
                d_r = comm_score(self.g, assignment, nid, r, self.gain_mode)
                if d_r < best_d:
                    best_r, best_d = r, d_r
            # paper's move condition: strictly better comm AND balance kept
            if best_r != q and best_d < d_cur and \
                    self._balance_ok_after(loads, nid, q, best_r):
                node = self.g.nodes[nid]
                loads[q] -= self.cm.node_cost(node, q)
                loads[best_r] += self.cm.node_cost(node, best_r)
                assignment[nid] = best_r
                moves += 1
        return moves

    # -- one load-balance pass ---------------------------------------------------
    def _balance_pass(self, assignment: dict[str, int], loads: list[float]) -> int:
        """Paper: move n q->r if C_Dr + c < C/k and C_Dq − c > C/k."""
        moves = 0
        for nid in self.g.relocatable_ids():
            q = assignment[nid]
            node = self.g.nodes[nid]
            c_q = self.cm.node_cost(node, q)
            if loads[q] - c_q <= self.ideal:
                continue  # source would drop to/below ideal: not overloaded enough
            lo, hi = (self._stage_interval(assignment, nid) if self.convex
                      else (0, self.k - 1))
            if lo > hi:
                continue
            # receive on the least-loaded admissible device; prefer cheapest comm
            best_r, best_key = None, None
            for r in range(lo, hi + 1):
                if r == q:
                    continue
                c_r = self.cm.node_cost(node, r)
                if loads[r] + c_r < self.ideal:
                    d_r = comm_score(self.g, assignment, nid, r, self.gain_mode)
                    key = (loads[r] + c_r, d_r)
                    if best_key is None or key < best_key:
                        best_r, best_key = r, key
            if best_r is not None:
                loads[q] -= c_q
                loads[best_r] += self.cm.node_cost(node, best_r)
                assignment[nid] = best_r
                moves += 1
        return moves

    # -- the refinement loop ---------------------------------------------------
    def refine(self, assignment: dict[str, int]) -> RefineResult:
        assignment = dict(assignment)
        cut0 = cut_bytes(self.g, assignment)
        loads = self.cm.assignment_costs(self.g, assignment)
        comm_moves = balance_moves = passes = 0
        history = []
        for p in range(self.max_passes):
            cm_ = self._comm_pass(assignment, loads)
            bm_ = self._balance_pass(assignment, loads)
            comm_moves += cm_
            balance_moves += bm_
            passes = p + 1
            history.append({
                "pass": passes, "comm_moves": cm_, "balance_moves": bm_,
                "cut_bytes": cut_bytes(self.g, assignment),
                "max_load": max(loads), "min_load": min(loads),
            })
            if cm_ == 0 and bm_ == 0:
                break
        return RefineResult(
            assignment=assignment, passes=passes, comm_moves=comm_moves,
            balance_moves=balance_moves, cut_before=cut0,
            cut_after=cut_bytes(self.g, assignment), history=history,
        )


def partition(graph: Graph, cost_model: CostModel, *, strategy: str = "block",
              refine: bool = True, epsilon_frac: float = 0.10,
              gain_mode: str = "paper", convex: bool = False,
              seed: int = 0, max_passes: int = 20) -> RefineResult:
    """End-to-end: initial partition (§2.3) + iterative repartitioning (§2.4)."""
    if strategy == "block":
        init = block_partition(graph, cost_model)
    elif strategy == "random":
        init = random_partition(graph, cost_model.k, seed)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    if not refine:
        return RefineResult(init, 0, 0, 0, cut_bytes(graph, init),
                            cut_bytes(graph, init))
    return Refiner(graph, cost_model, epsilon_frac=epsilon_frac,
                   gain_mode=gain_mode, convex=convex,
                   max_passes=max_passes).refine(init)
