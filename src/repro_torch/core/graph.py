"""Directed dataflow-graph IR — the object the paper's compiler operates on.

The port's copy of ``repro.core.graph``: the same names, arithmetic
and iteration order, so that floats agree with the reference exactly;
only the imports differ.  Pure Python: no ``torch``.

Nodes are computations (the paper's §2: "nodes indicate computations"); edges
carry data- or control-dependencies ("edges encode the data and control
dependencies"). Edge weight = bytes carried; control edges weigh 0 (paper §2.2).

Adaptation note: parameters are attributes of the op that owns
them (``param_bytes``) rather than separate Variable nodes; ``relocatable``
captures the paper's "computationally expensive AND stateless" node-selection
filter — cheap ops (norms, elementwise glue) are pinned to their consumer and
variables never move except through the explicit resharding path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

# Node resource tags (paper §3) — which resource bottlenecks the op.
TAG_COMPUTE = "compute-bound"
TAG_MEMORY = "memory-bound"
TAG_NETWORK = "network-bound"
TAGS = (TAG_COMPUTE, TAG_MEMORY, TAG_NETWORK)


@dataclass
class Node:
    """One computation in the dataflow graph."""

    id: str
    kind: str                      # op class: "matmul", "attn", "scan", "embed", ...
    flops: float = 0.0             # forward FLOPs of the op at the planned shape
    bytes_accessed: float = 0.0    # HBM traffic of the op (activations + params)
    param_bytes: float = 0.0       # state owned by the op (0 => pure/stateless)
    relocatable: bool = True       # paper phase-1 selection outcome
    layer: Optional[int] = None    # source layer index (None for embed/loss/...)
    tag: str = TAG_COMPUTE         # paper §3 resource tag, set by the cost model
    meta: dict = field(default_factory=dict)


@dataclass(frozen=True)
class Edge:
    """A directed dependency src -> dst carrying ``bytes`` of data (0 = control)."""

    src: str
    dst: str
    bytes: float = 0.0
    control: bool = False

    @property
    def weight(self) -> float:
        return 0.0 if self.control else self.bytes


class Graph:
    """A DAG with O(1) adjacency lookups and cached topological order."""

    def __init__(self) -> None:
        self.nodes: dict[str, Node] = {}
        self.edges: list[Edge] = []
        self._in: dict[str, list[Edge]] = {}
        self._out: dict[str, list[Edge]] = {}
        self._topo: Optional[list[str]] = None

    # -- construction ---------------------------------------------------------
    def add_node(self, node: Node) -> Node:
        if node.id in self.nodes:
            raise ValueError(f"duplicate node {node.id}")
        self.nodes[node.id] = node
        self._in[node.id] = []
        self._out[node.id] = []
        self._topo = None
        return node

    def add_edge(self, src: str, dst: str, bytes: float = 0.0,
                 control: bool = False) -> Edge:
        if src not in self.nodes or dst not in self.nodes:
            raise KeyError(f"edge {src}->{dst} references unknown node")
        e = Edge(src, dst, float(bytes), control)
        self.edges.append(e)
        self._out[src].append(e)
        self._in[dst].append(e)
        self._topo = None
        return e

    # -- queries ----------------------------------------------------------------
    def in_edges(self, nid: str) -> list[Edge]:
        return self._in[nid]

    def out_edges(self, nid: str) -> list[Edge]:
        return self._out[nid]

    def __len__(self) -> int:
        return len(self.nodes)

    def __iter__(self) -> Iterator[Node]:
        return iter(self.nodes.values())

    def topo_order(self) -> list[str]:
        """Kahn topological order (raises on cycles). Cached."""
        if self._topo is not None:
            return self._topo
        indeg = {nid: len(self._in[nid]) for nid in self.nodes}
        # stable: seed queue in insertion order
        queue = [nid for nid in self.nodes if indeg[nid] == 0]
        order: list[str] = []
        head = 0
        while head < len(queue):
            nid = queue[head]
            head += 1
            order.append(nid)
            for e in self._out[nid]:
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    queue.append(e.dst)
        if len(order) != len(self.nodes):
            cyc = [n for n, d in indeg.items() if d > 0]
            raise ValueError(f"graph has a cycle through {cyc[:5]}")
        self._topo = order
        return order

    def validate(self) -> None:
        self.topo_order()  # raises on cycles
        for e in self.edges:
            assert e.bytes >= 0.0

    # -- serialization (compiled-plan artifacts) --------------------------------
    def to_json(self) -> dict:
        """Nodes (in insertion order) + edges (in creation order).

        Insertion order is preserved on load so every order-dependent
        consumer (topo seeding, cost summation) reproduces bit-identical
        results from a deserialized graph."""
        return {
            "nodes": [{
                "id": n.id, "kind": n.kind, "flops": n.flops,
                "bytes_accessed": n.bytes_accessed,
                "param_bytes": n.param_bytes,
                "relocatable": n.relocatable, "layer": n.layer,
                "tag": n.tag, **({"meta": n.meta} if n.meta else {}),
            } for n in self.nodes.values()],
            "edges": [{
                "src": e.src, "dst": e.dst, "bytes": e.bytes,
                "control": e.control,
            } for e in self.edges],
        }

    @classmethod
    def from_json(cls, doc: dict) -> "Graph":
        g = cls()
        for nd in doc["nodes"]:
            g.add_node(Node(
                id=nd["id"], kind=nd["kind"], flops=float(nd["flops"]),
                bytes_accessed=float(nd["bytes_accessed"]),
                param_bytes=float(nd["param_bytes"]),
                relocatable=bool(nd["relocatable"]), layer=nd["layer"],
                tag=nd.get("tag", TAG_COMPUTE), meta=dict(nd.get("meta", {}))))
        for ed in doc["edges"]:
            g.add_edge(ed["src"], ed["dst"], bytes=float(ed["bytes"]),
                       control=bool(ed["control"]))
        return g

    # -- aggregate stats -----------------------------------------------------
    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes.values())

    def total_edge_bytes(self) -> float:
        return sum(e.weight for e in self.edges)

    def relocatable_ids(self) -> list[str]:
        return [n.id for n in self.nodes.values() if n.relocatable]

    def summary(self) -> str:
        return (f"Graph(nodes={len(self.nodes)}, edges={len(self.edges)}, "
                f"flops={self.total_flops():.3e}, "
                f"edge_bytes={self.total_edge_bytes():.3e})")
