"""Feature & parameter reorganization (paper §2.4 — "a bitter lesson").

Port of ``repro.core.reorg``. Industrial feature layouts interleave
user/item/cross chunks; naive MaRI then issues many fragmented matmuls
(Table 3). This pass permutes boundary-concat segment order into the neat
``[user | item | cross]`` layout of Eq. 4 and remaps the learnable
parameters (weight rows) of every downstream matmul to match — a lossless
re-layout. Non-matmul consumers of a reorganized concat receive an explicit
``gather_last`` restore node so their semantics are untouched.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gca import GCAResult, run_gca
from repro_torch.core.mari import _segment_domain, _trace_chain
from repro_torch.graph.ir import REWRITE_SAFE_OPS, Graph, Node, infer_shapes

_DOMAIN_RANK = {"user": 0, "item": 1, "cross": 2, "rest": 3}


@dataclasses.dataclass
class ReorgPlan:
    concat: str
    old_order: tuple[str, ...]
    new_order: tuple[str, ...]
    perm: tuple[int, ...]            # new position -> old segment index
    row_perm: np.ndarray             # new row -> old row (for weight remap)
    remapped_denses: tuple[str, ...]
    restored_consumers: tuple[str, ...]


def reorganize(graph: Graph, gca: GCAResult | None = None
               ) -> tuple[Graph, list[ReorgPlan]]:
    gca = gca or run_gca(graph)
    shapes = infer_shapes(graph)
    new = graph.copy()
    plans: list[ReorgPlan] = []

    for cname in gca.boundary_concats:
        concat = graph.nodes[cname]
        segs = concat.inputs
        widths = [shapes[s][-1] for s in segs]
        domains = [_segment_domain(graph, gca.colors, s) for s in segs]
        perm = tuple(sorted(range(len(segs)),
                            key=lambda i: (_DOMAIN_RANK[domains[i]], i)))
        if perm == tuple(range(len(segs))):
            continue  # already neat

        offs = np.concatenate([[0], np.cumsum(widths)]).astype(np.int64)
        row_perm = np.concatenate(
            [np.arange(offs[i], offs[i + 1]) for i in perm])

        new.nodes[cname] = Node(cname, "concat", tuple(segs[i] for i in perm),
                                dict(concat.attrs))

        remapped, restored = [], []
        for dense_name, bc in gca.eligible.items():
            if bc == cname and _trace_chain(graph, graph.nodes[dense_name],
                                            cname) is not None:
                remapped.append(dense_name)
        # consumers not reached through a rewrite-safe chain need a restore.
        reachable_from_denses = set(remapped)
        for cons in graph.consumers(cname):
            if cons.name in reachable_from_denses:
                continue
            if cons.op == "dense" or _leads_only_to_remapped(
                    graph, cons, reachable_from_denses):
                continue
            restore_perm = np.argsort(row_perm)
            rn = f"{cname}__restore_for_{cons.name}"
            new.nodes[rn] = Node(rn, "gather_last", (cname,),
                                 {"indices": tuple(int(i)
                                                   for i in restore_perm)})
            patched = tuple(rn if i == cname else i for i in cons.inputs)
            new.nodes[cons.name] = Node(cons.name, cons.op, patched,
                                        dict(cons.attrs))
            restored.append(cons.name)

        # reinsert restore nodes in topological position: rebuild node dict
        new.nodes = _retopo(new)
        plans.append(ReorgPlan(
            concat=cname, old_order=segs,
            new_order=tuple(segs[i] for i in perm), perm=perm,
            row_perm=row_perm, remapped_denses=tuple(remapped),
            restored_consumers=tuple(restored)))
    return new, plans


def _leads_only_to_remapped(graph: Graph, node: Node, remapped: set[str]
                            ) -> bool:
    """True if ``node`` is a transparent op whose every consumer path ends in
    a remapped dense (so no restore needed)."""
    if node.op not in REWRITE_SAFE_OPS:
        return False
    for c in graph.consumers(node.name):
        if c.name in remapped:
            continue
        if not _leads_only_to_remapped(graph, c, remapped):
            return False
    return True


def _retopo(g: Graph) -> dict[str, Node]:
    """Kahn re-topo-sort of the node dict (restore nodes were appended)."""
    order: dict[str, Node] = {}
    ready = [k for k, v in g.nodes.items() if not v.inputs]
    remaining = {k: set(v.inputs) for k, v in g.nodes.items()}
    while ready:
        k = ready.pop(0)
        order[k] = g.nodes[k]
        for name, deps in remaining.items():
            if k in deps:
                deps.discard(k)
                if not deps and name not in order and name not in ready:
                    ready.append(name)
    if len(order) != len(g.nodes):
        raise ValueError("reorg produced a cyclic graph")
    return order


def convert_params_reorg(plans: list[ReorgPlan], params: dict) -> dict:
    """Remap weight rows of every dense affected by a reorganization.

    The rows are permuted with an index tensor on the weight's own device
    (the result is contiguous); every other leaf is shared by identity."""
    out = dict(params)
    for plan in plans:
        for dense in plan.remapped_denses:
            p = dict(out[dense])
            w = torch.as_tensor(p["w"])
            idx = torch.as_tensor(plan.row_perm, dtype=torch.int64,
                                  device=w.device)
            p["w"] = w.index_select(0, idx)
            out[dense] = p
    return out
