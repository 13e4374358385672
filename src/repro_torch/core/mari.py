"""MaRI — structural re-parameterization of feature-fusion MatMuls (§2.2).

Port of ``repro.core.mari``. Two layers of API:

* Functional ops (``matmul_mari``, ``matmul_mari_fragmented``) — Eq. 7 as
  plain tensor functions — and the FLOPs of Eq. 8 / Eq. 9.
* Graph rewrite (``mari_rewrite`` + ``convert_params``) — step (3) of the
  MaRI workflow (§2.5): replaces GCA-detected ``dense`` nodes with
  ``mari_dense`` nodes and physically re-partitions the trained weight
  matrices into per-group row blocks (the "re-parameterization"). Lossless
  by the block matmul identity (Eq. 2).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gca import Color, GCAResult, run_gca
from repro_torch.graph.ir import Graph, Node, REWRITE_SAFE_OPS, infer_shapes

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Functional form
# ---------------------------------------------------------------------------

def matmul_vanilla(x_tiled: Tensor, w: Tensor, b: Tensor | None = None
                   ) -> Tensor:
    """Baseline: the full (B, D) @ (D, d) product over tiled features (Eq. 5)."""
    y = x_tiled @ w
    return y if b is None else y + b


def matmul_mari(x_user: Tensor, x_rest: Tensor, w_user: Tensor,
                w_rest: Tensor, b: Tensor | None = None) -> Tensor:
    """Eq. 7 (two-group form): Tile(x_u W_u, B) + x_r W_r.

    x_user: (1, D_u); x_rest: (B, D_r). The tile is a broadcast add — the
    (B, D_u) copy of user features never exists.
    """
    y = x_user @ w_user + x_rest @ w_rest
    return y if b is None else y + b


def matmul_mari3(x_user: Tensor, x_item: Tensor, x_cross: Tensor,
                 w_user: Tensor, w_item: Tensor, w_cross: Tensor,
                 b: Tensor | None = None) -> Tensor:
    """Eq. 7, paper-faithful three-term form."""
    y = x_user @ w_user + x_item @ w_item + x_cross @ w_cross
    return y if b is None else y + b


def matmul_mari_fragmented(segments: list[tuple[Tensor, Tensor]],
                           b: Tensor | None = None) -> Tensor:
    """§2.4 regime: one matmul per interleaved feature chunk."""
    acc = None
    for x, w in segments:
        y = x @ w
        acc = y if acc is None else acc + y
    return acc if b is None else acc + b


def vanilla_flops(batch: int, d_in: int, d_out: int) -> int:
    """Eq. 8."""
    return 2 * batch * d_in * d_out


def mari_flops(batch: int, d_user: int, d_rest: int, d_out: int) -> int:
    """Eq. 9: 2 d [D_u + B (D_i + D_c)]."""
    return 2 * d_out * (d_user + batch * d_rest)


# ---------------------------------------------------------------------------
# Graph rewrite
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DenseRewrite:
    dense: str
    concat: str
    chain: tuple[str, ...]               # transparent node names concat -> dense
    seg_names: tuple[str, ...]           # original concat inputs, in order
    seg_widths: tuple[int, ...]
    seg_groups: tuple[str, ...]          # group label per segment
    groups: tuple[tuple[str, tuple[int, ...]], ...]  # (label, seg indices)
    fragment: bool


@dataclasses.dataclass
class AttnRewrite:
    """Beyond-paper: re-parameterization of the DIN local-activation unit.

    The first attention-MLP layer acts on [k, q, k-q, k*q] @ W1 with
    W1 = [W_k; W_q; W_d; W_p] row blocks. Identically,

        = k @ (W_k + W_d)  +  q @ (W_q - W_d)  +  (k*q) @ W_p

    The first term is user-side (batch 1, one-shot); the second is (B, h)
    broadcast over L; only the Hadamard term scales with B*L — and it
    contracts against the precomputed user-side tensor T[l,d,h] = k[l,d]
    W_p[d,h], so the (B, L, 4D) feature tensor never materializes.
    """
    node: str
    d: int
    h1: int


@dataclasses.dataclass
class MaRIConversion:
    graph: Graph
    rewrites: list[DenseRewrite]
    skipped: list[tuple[str, str]]       # (dense, reason)
    gca: GCAResult
    attn_rewrites: list[AttnRewrite] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        return (f"MaRI: rewrote {len(self.rewrites)} matmuls "
                f"({[r.dense for r in self.rewrites]}), "
                f"{len(self.attn_rewrites)} attention units, "
                f"skipped {len(self.skipped)} {self.skipped}")


def _segment_domain(graph: Graph, colors: dict[str, Color], name: str) -> str:
    """Origin domain of a segment: 'user' if Yellow; for Blue segments,
    'item'/'cross' if all feature ancestors share one domain, else 'rest'."""
    if colors[name] is Color.YELLOW:
        return "user"
    doms: set[str] = set()
    stack, seen = [name], {name}
    while stack:
        u = stack.pop()
        node = graph.nodes[u]
        if node.op == "input" and node.attrs.get("domain"):
            doms.add(node.attrs["domain"])
        for i in node.inputs:
            if i not in seen:
                seen.add(i)
                stack.append(i)
    doms.discard("user")  # user ancestors of a Blue segment don't relabel it
    if doms == {"item"}:
        return "item"
    if doms == {"cross"}:
        return "cross"
    return "rest"


def _trace_chain(graph: Graph, dense: Node, concat: str) -> tuple[str, ...] | None:
    """Walk dense's input upward through transparent ops to ``concat``.
    Returns the chain node names (may be empty) or None if not a clean path."""
    chain: list[str] = []
    cur = dense.inputs[0]
    while cur != concat:
        node = graph.nodes[cur]
        if node.op not in REWRITE_SAFE_OPS or len(node.inputs) != 1:
            return None
        chain.append(cur)
        cur = node.inputs[0]
    return tuple(reversed(chain))


def mari_rewrite(
    graph: Graph,
    gca: GCAResult | None = None,
    *,
    fragment: bool = False,
    group_by_domain: bool = False,
    reparam_attention: bool = False,
) -> MaRIConversion:
    """Replace GCA-detected dense nodes with ``mari_dense`` nodes.

    fragment=False groups concat segments by domain (the §2.4 reorganization:
    user segments → one matmul, rest → one; ``group_by_domain=True`` keeps
    item and cross separate, the paper's three-matmul layout).
    fragment=True keeps one matmul per segment — the Table-3 regime.
    reparam_attention=True additionally re-parameterizes target_attention
    units whose keys are user-side (beyond-paper, see AttnRewrite).
    """
    gca = gca or run_gca(graph)
    shapes = infer_shapes(graph)
    new = graph.copy()
    rewrites: list[DenseRewrite] = []
    skipped: list[tuple[str, str]] = []
    attn_rewrites: list[AttnRewrite] = []

    if reparam_attention:
        for n in graph.topo_order():
            if n.op != "target_attention":
                continue
            if gca.colors[n.inputs[1]] is not Color.YELLOW:
                continue  # keys must be one-shot user-side
            d = shapes[n.inputs[0]][-1]
            h1 = n.attrs["mlp_hidden"][0]
            attrs = dict(n.attrs)
            attrs["decomposed"] = True
            new.nodes[n.name] = Node(n.name, "target_attention", n.inputs,
                                     attrs)
            attn_rewrites.append(AttnRewrite(node=n.name, d=d, h1=h1))

    for dense_name, concat_name in sorted(gca.eligible.items()):
        dense = graph.nodes[dense_name]
        concat = graph.nodes[concat_name]
        if concat.attrs.get("axis", -1) != -1:
            skipped.append((dense_name, "concat axis != -1"))
            continue
        chain = _trace_chain(graph, dense, concat_name)
        if chain is None:
            skipped.append((dense_name, "non-shape-preserving path (reshape)"))
            continue
        seg_names = concat.inputs
        seg_widths = tuple(shapes[s][-1] for s in seg_names)
        if group_by_domain:
            seg_groups = tuple(
                _segment_domain(graph, gca.colors, s) for s in seg_names)
        else:
            seg_groups = tuple(
                "user" if gca.colors[s] is Color.YELLOW else "rest"
                for s in seg_names)
        if "user" not in seg_groups:
            skipped.append((dense_name, "no user segment (nothing to save)"))
            continue
        # group order: user first (computed once), then the batched groups.
        labels = ["user"] + [g for g in dict.fromkeys(seg_groups) if g != "user"]
        groups = tuple(
            (lab, tuple(i for i, g in enumerate(seg_groups) if g == lab))
            for lab in labels)

        cast_dtype = None
        for c in chain:
            if graph.nodes[c].op == "cast":
                cast_dtype = graph.nodes[c].attrs["dtype"]

        attrs = dict(
            units=dense.attrs["units"],
            use_bias=dense.attrs.get("use_bias", True),
            activation=dense.attrs.get("activation", "identity"),
            seg_widths=seg_widths,
            seg_groups=seg_groups,
            groups=groups,
            fragment=fragment,
            cast_dtype=cast_dtype,
        )
        new.nodes[dense_name] = Node(dense_name, "mari_dense", seg_names, attrs)
        rewrites.append(DenseRewrite(
            dense=dense_name, concat=concat_name, chain=chain,
            seg_names=seg_names, seg_widths=seg_widths, seg_groups=seg_groups,
            groups=groups, fragment=fragment))

    new = new.dce()  # drops the concat/tile path if nothing else consumes it
    return MaRIConversion(graph=new, rewrites=rewrites, skipped=skipped,
                          gca=gca, attn_rewrites=attn_rewrites)


def convert_params(conv: MaRIConversion, params: dict) -> dict:
    """Physically re-partition trained weights for the rewritten graph.

    For each rewritten dense: W (D, units) rows are split at segment
    boundaries and regrouped per domain group (the §2.4 parameter remap).
    Biases pass through. All other params are shared by reference.
    """
    out = dict(params)
    for r in conv.rewrites:
        p = params[r.dense]
        w = p["w"]
        offs = [0] + np.cumsum(r.seg_widths).tolist()
        seg_rows = [w[offs[i]:offs[i + 1]] for i in range(len(r.seg_widths))]
        newp = {}
        if r.fragment:
            for i, rows in enumerate(seg_rows):
                newp[f"w_seg{i}"] = rows
        else:
            for label, idx in r.groups:
                newp[f"w_{label}"] = torch.cat([seg_rows[i] for i in idx],
                                               dim=0)
        if "b" in p:
            newp["b"] = p["b"]
        out[r.dense] = newp
    for ar in conv.attn_rewrites:
        p = dict(params[ar.node])
        l0 = p["layer_0"]
        w1, d = l0["w"], ar.d
        wk, wq, wd, wp = (w1[:d], w1[d:2 * d], w1[2 * d:3 * d], w1[3 * d:])
        p["layer_0"] = {"w_kd": wk + wd, "w_qd": wq - wd, "w_p": wp,
                        "b": l0["b"]}
        out[ar.node] = p
    return out


def apply_mari(graph: Graph, params: dict, **kw) -> tuple[Graph, dict, MaRIConversion]:
    """One-call conversion: GCA detect → rewrite → re-parameterize weights."""
    conv = mari_rewrite(graph, **kw)
    return conv.graph, convert_params(conv, params), conv
