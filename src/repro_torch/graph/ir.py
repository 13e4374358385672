"""Lightweight computation-graph IR for ranking models.

Industrial serving systems (the paper's setting) rewrite *graphs* — TF GraphDef
at Kuaishou — not Python closures. This IR is a small, explicit node graph
that the GCA colors, the MaRI pass rewrites, and the executor interprets
eagerly on tensors. A copy of ``repro.graph.ir``: both packages build the
same graphs node for node, so params keyed by node name move across.

Shapes stored on nodes are PER-EXAMPLE (no batch dim); the executor prepends
batch 1 (user-side) or B (item/cross-side) at run time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Sequence

# Ops through which MaRI eligibility propagates (Alg. 1 line 24:
# "paths with only non-computational nodes").
TRANSPARENT_OPS = frozenset({"identity", "cast", "stop_gradient", "reshape"})

# Ops the rewriter can actually move through (must be shape-preserving so the
# weight-row ↔ concat-segment correspondence survives).
REWRITE_SAFE_OPS = frozenset({"identity", "cast", "stop_gradient"})

PARAM_OPS = frozenset({"dense", "mari_dense", "embedding", "target_attention"})

DOMAINS = ("user", "item", "cross")


@dataclasses.dataclass(frozen=True)
class Node:
    name: str
    op: str
    inputs: tuple[str, ...]
    attrs: Mapping[str, Any]

    def attr(self, key: str, default=None):
        return self.attrs.get(key, default)


class Graph:
    """Append-only DAG; insertion order is a valid topological order."""

    def __init__(self):
        self.nodes: dict[str, Node] = {}
        self.outputs: list[str] = []

    # -- construction ------------------------------------------------------
    def add(self, node: Node) -> str:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node {node.name!r}")
        for i in node.inputs:
            if i not in self.nodes:
                raise ValueError(f"node {node.name!r}: unknown input {i!r}")
        self.nodes[node.name] = node
        return node.name

    def set_outputs(self, names: Sequence[str]) -> None:
        for n in names:
            if n not in self.nodes:
                raise ValueError(f"unknown output {n!r}")
        self.outputs = list(names)

    # -- queries -----------------------------------------------------------
    def topo_order(self) -> list[Node]:
        return list(self.nodes.values())

    def consumers(self, name: str) -> list[Node]:
        return [n for n in self.nodes.values() if name in n.inputs]

    def inputs_of_type(self, op: str) -> list[Node]:
        return [n for n in self.nodes.values() if n.op == op]

    def input_nodes(self) -> list[Node]:
        return self.inputs_of_type("input")

    def param_nodes(self) -> list[Node]:
        return [n for n in self.nodes.values() if n.op in PARAM_OPS]

    def copy(self) -> "Graph":
        g = Graph()
        g.nodes = dict(self.nodes)
        g.outputs = list(self.outputs)
        return g

    def dce(self) -> "Graph":
        """Dead-code elimination: keep only ancestors of the outputs."""
        live: set[str] = set()
        stack = list(self.outputs)
        while stack:
            n = stack.pop()
            if n in live:
                continue
            live.add(n)
            stack.extend(self.nodes[n].inputs)
        g = Graph()
        g.nodes = {k: v for k, v in self.nodes.items() if k in live}
        g.outputs = list(self.outputs)
        return g

    def __repr__(self):
        return f"Graph({len(self.nodes)} nodes, outputs={self.outputs})"


class GraphBuilder:
    """Fluent construction helper; methods return node names."""

    def __init__(self):
        self.graph = Graph()
        self._ctr = 0

    def _name(self, base: str) -> str:
        self._ctr += 1
        return f"{base}_{self._ctr}"

    def _add(self, name, op, inputs, **attrs) -> str:
        return self.graph.add(Node(name, op, tuple(inputs), attrs))

    # inputs -----------------------------------------------------------------
    def input(self, name: str, shape: tuple[int, ...], domain: str | None,
              dtype: str = "float32") -> str:
        if domain is not None and domain not in DOMAINS:
            raise ValueError(f"bad domain {domain!r}")
        return self._add(name, "input", [], shape=tuple(shape), domain=domain, dtype=dtype)

    # params -----------------------------------------------------------------
    def dense(self, name: str, x: str, units: int, *, use_bias: bool = True,
              activation: str = "identity") -> str:
        return self._add(name, "dense", [x], units=units, use_bias=use_bias,
                         activation=activation)

    def embedding(self, name: str, ids: str, vocab: int, dim: int,
                  pool: str | None = None) -> str:
        """ids per-example shape () -> (dim,); (H,) -> (H, dim) or pooled (dim,)."""
        return self._add(name, "embedding", [ids], vocab=vocab, dim=dim, pool=pool)

    # structure ----------------------------------------------------------------
    def concat(self, name: str, xs: Sequence[str], axis: int = -1) -> str:
        return self._add(name, "concat", xs, axis=axis)

    def add(self, name: str, a: str, b: str) -> str:
        return self._add(name, "add", [a, b])

    def mul(self, name: str, a: str, b: str) -> str:
        return self._add(name, "mul", [a, b])

    def sub(self, name: str, a: str, b: str) -> str:
        return self._add(name, "sub", [a, b])

    def scale(self, name: str, x: str, factor: float) -> str:
        return self._add(name, "scale", [x], factor=factor)

    def target_attention(self, name: str, query: str, keys: str,
                         mask: str | None = None,
                         mlp_hidden: tuple[int, ...] = (80, 40)) -> str:
        """DIN local-activation unit (composite op with internal attention
        MLP params). query (D,) item-side; keys (L, D) user-side."""
        ins = [query, keys] + ([mask] if mask else [])
        return self._add(name, "target_attention", ins,
                         mlp_hidden=tuple(mlp_hidden), has_mask=mask is not None)

    def act(self, name: str, x: str, fn: str) -> str:
        return self._add(name, "act", [x], fn=fn)

    def softmax(self, name: str, x: str, axis: int = -1) -> str:
        return self._add(name, "softmax", [x], axis=axis)

    def reshape(self, name: str, x: str, shape: tuple[int, ...]) -> str:
        return self._add(name, "reshape", [x], shape=tuple(shape))

    def cast(self, name: str, x: str, dtype: str) -> str:
        return self._add(name, "cast", [x], dtype=dtype)

    def identity(self, name: str, x: str) -> str:
        return self._add(name, "identity", [x])

    def stop_gradient(self, name: str, x: str) -> str:
        return self._add(name, "stop_gradient", [x])

    def reduce(self, name: str, x: str, fn: str = "sum", axis: int = -2) -> str:
        return self._add(name, "reduce", [x], fn=fn, axis=axis)

    def weighted_sum(self, name: str, weights: str, values: str) -> str:
        """weights (..., K), values (..., K, D) -> (..., D)."""
        return self._add(name, "weighted_sum", [weights, values])

    def cross_attention(self, name: str, q: str, k: str, v: str,
                        mask: str | None = None) -> str:
        ins = [q, k, v] + ([mask] if mask else [])
        return self._add(name, "cross_attention", ins, has_mask=mask is not None)

    def fm_interaction(self, name: str, x: str) -> str:
        """x (..., F, D) -> (...,) pairwise-interaction scalar (sum-square trick)."""
        return self._add(name, "fm_interaction", [x])

    def dot_interaction(self, name: str, x: str, keep_self: bool = False) -> str:
        """x (..., F, D) -> (..., F*(F-1)/2) pairwise dots (DLRM)."""
        return self._add(name, "dot_interaction", [x], keep_self=keep_self)

    def stack_features(self, name: str, xs: Sequence[str]) -> str:
        """Each x (..., D) -> (..., F, D)."""
        return self._add(name, "stack_features", xs)

    def output(self, *names: str) -> None:
        self.graph.set_outputs(list(names))


def infer_shapes(graph: Graph) -> dict[str, tuple[int, ...]]:
    """Per-example output shapes for every node (batch dim excluded)."""
    shapes: dict[str, tuple[int, ...]] = {}
    for n in graph.topo_order():
        ins = [shapes[i] for i in n.inputs]
        if n.op == "input":
            s = tuple(n.attrs["shape"])
        elif n.op == "dense" or n.op == "mari_dense":
            s = ins[0][:-1] + (n.attrs["units"],)
        elif n.op == "embedding":
            ids = ins[0]
            dim = n.attrs["dim"]
            if n.attrs.get("pool"):
                s = ids[:-1] + (dim,) if ids else (dim,)
            else:
                s = ids + (dim,)
        elif n.op == "concat":
            last = sum(x[-1] for x in ins)
            s = ins[0][:-1] + (last,)
        elif n.op in ("add", "mul", "sub"):
            s = ins[0] if len(ins[0]) >= len(ins[1]) else ins[1]
        elif n.op in ("act", "softmax", "identity", "stop_gradient", "cast", "scale"):
            s = ins[0]
        elif n.op == "target_attention":
            s = ins[0]  # (D,) pooled interest, same shape as query
        elif n.op == "mari_user_partial":
            s = (n.attrs["units"],)
        elif n.op == "attn_user_part":
            s = (ins[0][0], n.attrs["h1"])
        elif n.op == "attn_user_T":
            s = (ins[0][0], ins[0][1], n.attrs["h1"])
        elif n.op == "reshape":
            s = tuple(n.attrs["shape"])
        elif n.op == "reduce":
            ax = n.attrs["axis"]
            lst = list(ins[0])
            del lst[ax]
            s = tuple(lst)
        elif n.op == "weighted_sum":
            s = ins[1][:-2] + (ins[1][-1],)
        elif n.op == "cross_attention":
            s = ins[0]  # (I, d) or (d,)
        elif n.op == "fm_interaction":
            s = ins[0][:-2] + (1,)
        elif n.op == "dot_interaction":
            f = ins[0][-2]
            keep = n.attrs.get("keep_self", False)
            npair = f * (f + 1) // 2 if keep else f * (f - 1) // 2
            s = ins[0][:-2] + (npair,)
        elif n.op == "gather_last":
            s = ins[0][:-1] + (len(n.attrs["indices"]),)
        elif n.op == "stack_features":
            d = ins[0][-1]
            for x in ins:
                if x[-1] != d:
                    raise ValueError(f"stack_features {n.name}: mismatched dims {ins}")
            s = ins[0][:-1] + (len(ins), d)
        else:
            raise ValueError(f"shape inference: unknown op {n.op!r} ({n.name})")
        shapes[n.name] = s
    return shapes


def dense_in_dim(graph: Graph, node: Node,
                 shapes: dict[str, tuple[int, ...]] | None = None) -> int:
    shapes = shapes or infer_shapes(graph)
    return shapes[node.inputs[0]][-1]
