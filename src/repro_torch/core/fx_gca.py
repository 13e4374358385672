"""GCA on traced PyTorch functions — Algorithm 1 applied to an aten graph.

Counterpart of ``repro.core.jaxpr_gca`` (``detect_in_jaxpr``): a jaxpr
exists only in JAX, so this module traces with
``torch.fx.experimental.proxy_tensor.make_fx`` (the counterpart of
``jax.make_jaxpr``) and walks the resulting aten graph instead. The graph-IR
pass (``repro_torch.core.gca``) is the rewriting path; this module is the
*detector* for arbitrary model functions: colour the placeholders by
feature domain, propagate Yellow/Blue through the nodes, find ``aten.cat``
nodes with mixed-colour operands, and report every matmul reachable from
one through non-computational ops.

The trace runs under fake tensors: nothing is computed and no intermediate
is allocated, so a full-width model needs no memory beyond its arguments.
The function must be plain torch (the port's kernel wrappers take their
plain versions on CPU tensors; a CUDA launch through ``ctypes`` cannot be
traced).

Ops are matched by their overload packet (``aten.mm``), never by an
overload's string, so traces of different torch versions compare.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.utils._pytree as pytree
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.core.gca import Color

aten = torch.ops.aten

# Ops that do not compute on values (layout/metadata only) — the aten
# counterparts of the reference's TRANSPARENT_PRIMITIVES: reshape (view,
# _unsafe_view, reshape, unsqueeze), broadcast_in_dim (expand), transpose
# (t, transpose, permute), squeeze, convert_element_type (_to_copy), copy
# (clone) and stop_gradient (detach, alias).
TRANSPARENT_OPS = frozenset({
    aten.view, aten._unsafe_view, aten.reshape, aten.expand, aten.t,
    aten.transpose, aten.permute, aten.squeeze, aten.unsqueeze,
    aten._to_copy, aten.clone, aten.detach, aten.alias,
})

# Matmul ops (the reference's dot_general) -> positions of (lhs, rhs) in the
# node's args. addmm / baddbmm take the bias first; linear's rhs is the
# (out, in) weight. matmul and linear appear only when a trace keeps them.
MATMUL_OPS = {
    aten.mm: (0, 1), aten.bmm: (0, 1), aten.matmul: (0, 1),
    aten.linear: (0, 1), aten.addmm: (1, 2), aten.baddbmm: (1, 2),
}


@dataclasses.dataclass
class EligibleMatMul:
    node_index: int                  # index among the call_function nodes
    op: str
    boundary_concat_index: int
    lhs_shape: tuple[int, ...]
    rhs_shape: tuple[int, ...]


@dataclasses.dataclass
class FxGCAReport:
    colors_in: dict[int, Color]          # placeholder index -> colour
    mixed_concats: list[int]             # node indices of boundary concats
    eligible: list[EligibleMatMul]
    n_nodes: int                         # call_function nodes traced

    def summary(self) -> str:
        return (f"fx-GCA: {self.n_nodes} nodes, "
                f"{len(self.mixed_concats)} boundary concats, "
                f"{len(self.eligible)} eligible matmuls "
                f"{[(e.node_index, e.lhs_shape, e.rhs_shape) for e in self.eligible]}")


def _packet(node: torch.fx.Node):
    return getattr(node.target, "overloadpacket", node.target)


def _shape(a) -> tuple[int, ...]:
    return tuple(int(s) for s in a.meta["val"].shape)


def _merge(colors_in: list[Color]) -> Color:
    if Color.BLUE in colors_in:
        return Color.BLUE
    if Color.YELLOW in colors_in:
        return Color.YELLOW
    return Color.UNCOLORED


def detect_in_fx(fn: Callable, domains: dict[str, str], *example_args
                 ) -> FxGCAReport:
    """Trace ``fn(*example_args)`` and run GCA.

    domains maps flattened-input-leaf *path substrings* (from
    ``torch.utils._pytree.keystr`` over the args tuple, e.g.
    ``[1]['user_x']``, the form of ``jax.tree_util.keystr``) to
    'user'|'item'|'cross'. Leaves not mentioned are Uncoloured (params
    etc.), as are ``get_attr`` nodes (a module's parameters, constants)
    and non-tensor arguments. Feature inputs must therefore arrive in named
    containers (dicts / dataclasses) so their domain is visible in the
    path.
    """
    # a plain function of *args: fx counts a bound method's ``self``
    gm = make_fx(lambda *args: fn(*args), tracing_mode="fake",
                 _allow_non_fake_inputs=True)(*example_args)
    nodes = list(gm.graph.nodes)
    placeholders = [n for n in nodes if n.op == "placeholder"]
    calls = [n for n in nodes if n.op == "call_function"]
    index = {n: i for i, n in enumerate(calls)}

    leaves_with_paths, _ = pytree.tree_flatten_with_path(example_args)
    colors: dict[torch.fx.Node, Color] = {}
    colors_in: dict[int, Color] = {}
    for i, (path, _leaf) in enumerate(leaves_with_paths):
        key = pytree.keystr(path)
        dom = None
        for name, d in domains.items():
            if name in key:
                dom = d
                break
        c = (Color.YELLOW if dom == "user"
             else Color.BLUE if dom in ("item", "cross")
             else Color.UNCOLORED)
        if i < len(placeholders):
            colors[placeholders[i]] = c
            colors_in[i] = c

    mixed: list[int] = []
    for n in calls:
        in_colors = [colors.get(a, Color.UNCOLORED)
                     for a in n.all_input_nodes]
        colors[n] = _merge(in_colors)
        if (_packet(n) is aten.cat
                and Color.YELLOW in in_colors and Color.BLUE in in_colors):
            mixed.append(index[n])

    # forward walk: from each boundary concat, follow transparent nodes to
    # a matmul operand
    eligible: list[EligibleMatMul] = []
    seen: set[torch.fx.Node] = set()
    for cidx in mixed:
        frontier = {calls[cidx]}
        while frontier:
            nxt = set()
            for n in calls:
                op = _packet(n)
                if op in MATMUL_OPS:
                    li, ri = MATMUL_OPS[op]
                    operands = (n.args[li], n.args[ri])
                    if n not in seen and any(a in frontier for a in operands):
                        seen.add(n)
                        eligible.append(EligibleMatMul(
                            node_index=index[n], op=str(op),
                            boundary_concat_index=cidx,
                            lhs_shape=_shape(operands[0]),
                            rhs_shape=_shape(operands[1])))
                elif op in TRANSPARENT_OPS and any(
                        a in frontier for a in n.all_input_nodes):
                    nxt.add(n)
            frontier = nxt

    return FxGCAReport(colors_in=colors_in, mixed_concats=mixed,
                       eligible=eligible, n_nodes=len(calls))
