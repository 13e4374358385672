"""GCA — Graph Coloring Algorithm (paper §2.3, Algorithm 1).

Detects MaRI-optimizable MatMul (dense) nodes automatically:

1. Initialize: user-side feature nodes Yellow; item/cross-side Blue;
   everything else Uncolored.
2. DFS colour propagation with Blue dominating (a node fed by any Blue
   ancestor is Blue; fed only by Yellow is Yellow).
3. Every ``concat`` whose inputs mix Yellow and Blue is a boundary node.
4. Every matmul reachable from a boundary concat through *non-computational*
   ops (TRANSPARENT_OPS) is MaRI-optimizable.
"""
from __future__ import annotations

import dataclasses
import enum

from repro_torch.graph.ir import Graph, Node, TRANSPARENT_OPS


class Color(enum.Enum):
    UNCOLORED = 0
    YELLOW = 1  # user-side
    BLUE = 2    # item/cross-side


@dataclasses.dataclass
class GCAResult:
    colors: dict[str, Color]
    boundary_concats: list[str]                 # mixed-input concat nodes
    eligible: dict[str, str]                    # dense node -> its boundary concat
    user_subgraph: set[str]                     # Yellow nodes (batch-1 one-shot set)

    def summary(self) -> str:
        ny = sum(1 for c in self.colors.values() if c is Color.YELLOW)
        nb = sum(1 for c in self.colors.values() if c is Color.BLUE)
        return (f"GCA: {ny} yellow / {nb} blue nodes, "
                f"{len(self.boundary_concats)} boundary concats, "
                f"{len(self.eligible)} MaRI-eligible matmuls: "
                f"{sorted(self.eligible)}")


def _init_colors(graph: Graph) -> dict[str, Color]:
    colors = {name: Color.UNCOLORED for name in graph.nodes}
    for n in graph.input_nodes():
        d = n.attrs.get("domain")
        if d == "user":
            colors[n.name] = Color.YELLOW
        elif d in ("item", "cross"):
            colors[n.name] = Color.BLUE
    return colors


def _propagate(graph: Graph, colors: dict[str, Color]) -> None:
    """Algorithm 1, step 2 — DFS with Blue dominance. Adjacency is computed
    once (traverse pruning per the paper's note)."""
    downstream: dict[str, list[str]] = {name: [] for name in graph.nodes}
    for n in graph.topo_order():
        for i in n.inputs:
            downstream[i].append(n.name)

    stack = [name for name, c in colors.items() if c is not Color.UNCOLORED]
    while stack:
        u = stack.pop()
        cu = colors[u]
        for v in downstream[u]:
            updated = False
            if cu is Color.BLUE and colors[v] is not Color.BLUE:
                colors[v] = Color.BLUE
                updated = True
            elif cu is Color.YELLOW and colors[v] is Color.UNCOLORED:
                colors[v] = Color.YELLOW
                updated = True
            if updated:
                stack.append(v)


def _matmuls_via_transparent(graph: Graph, start: str) -> set[str]:
    """Algorithm 1, step 3 — matmul nodes reachable from ``start`` through
    paths containing only non-computational nodes."""
    found: set[str] = set()
    stack = [start]
    seen = {start}
    while stack:
        u = stack.pop()
        for n in graph.consumers(u):
            if n.name in seen:
                continue
            if n.op == "dense":
                found.add(n.name)  # matmul reached — path ends here
            elif n.op in TRANSPARENT_OPS:
                seen.add(n.name)
                stack.append(n.name)
            # any other op is computational: path is broken
    return found


def run_gca(graph: Graph) -> GCAResult:
    colors = _init_colors(graph)
    _propagate(graph, colors)

    boundary: list[str] = []
    eligible: dict[str, str] = {}
    for n in graph.topo_order():
        if n.op != "concat":
            continue
        in_colors = {colors[i] for i in n.inputs}
        if Color.YELLOW in in_colors and Color.BLUE in in_colors:
            boundary.append(n.name)
            for m in _matmuls_via_transparent(graph, n.name):
                # first boundary wins; nested mixed concats keep the nearest
                eligible.setdefault(m, n.name)

    user_sub = {name for name, c in colors.items() if c is Color.YELLOW}
    return GCAResult(colors=colors, boundary_concats=boundary,
                     eligible=eligible, user_subgraph=user_sub)
