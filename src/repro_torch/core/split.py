"""Two-stage bipartition of a (MaRI-rewritten) serving graph — Fig. 2 made
executable.

The MaRI premise is that the user side of a ranking graph is identical for
every candidate in the batch. ``split_two_stage`` cuts a graph into:

* **stage 1** — the user-only precompute subgraph: every node GCA colors
  Yellow (plus their uncolored ancestors), and one *partial* node per
  rewritten unit:

  - each ``mari_dense``'s user-side product ``x_user @ w_user (+ b)``
    (op ``mari_user_partial``) — the ``Tile(·, B)`` operand of Eq. 7,
  - each decomposed ``target_attention``'s one-shot tensors
    ``u_part = k @ w_kd + b`` (op ``attn_user_part``) and
    ``T[l,d,h] = k[l,d] * w_p[d,h]`` (op ``attn_user_T``).

  Stage 1 runs at batch 1, once per (user, feature version); its outputs are
  content-addressed and cached by the serving engine.

* **stage 2** — the batched residual subgraph: every Blue node, with user
  activations arriving as ``input`` nodes (domain ``"user"``) whose names
  equal the stage-1 output names, so ``stage2_feeds = {**stage1_out,
  **candidate_feeds}``. Rewritten ``mari_dense`` nodes consume the
  precomputed partial as their accumulator init (``precomputed_user``);
  decomposed attention consumes ``u_part``/``T`` (``precomputed``).

  Stage-2 user inputs accept TWO batch layouts (the executor dispatches on
  the leading dim): **batch-1** — one user per call, broadcast over all B
  candidate rows (the classic Fig. 2 contract) — or **row-wise batch-B** —
  a cross-user coalesced batch where candidate row b carries *its own*
  user's cached stage-1 outputs, produced by gathering a stacked (U, ...)
  rep table with a per-row user index (``reps[name][user_index]``). The
  serving engine's coalescing runtime uses the row-wise form;
  ``boundary_specs`` gives the per-example shape of every crossing value so
  the runtime can stack/pad rep tables without re-running shape inference.
  Under the engine's gather-at-load options (``kernel_gather``,
  ``gather_attention``) eligible user inputs skip the explicit gather
  entirely: the stacked (U, ...) table is fed as-is and the consuming
  kernel (CUDA ``mari_matmul`` acc-init / ``kernels.gather_einsum``
  attention contractions) indexes it by ``user_index`` at load time.
  Stage-2 gathers clamp their indices, and row results are independent of
  table size and of the contents of unreferenced rows.

A copy of ``repro.core.split``; ``rep_table_pspecs`` states the rep
tables' placement under candidate-axis sharding.

Both stages share ONE params dict: partial nodes reference their source
node's params via ``attrs["param_of"]`` indirection, so no weight is copied
or re-keyed.

Lossless by construction: stage-1 ∘ stage-2 computes exactly the single
graph's values (the split only reassociates where each value is produced).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.gca import Color, GCAResult, run_gca
from repro_torch.graph.ir import Graph, Node, infer_shapes


def rep_table_pspecs(boundary_specs: dict) -> dict:
    """Per-entry placements of the stacked ``(U, ...)`` stage-2 rep tables
    on the 1-D candidate shard axis: ``(Replicate(),)`` for every entry,
    every tensor dim unsharded. THE single source of the rep-table
    sharding contract (``repro_torch.dist.sharding`` serves the rest).

    User representations replicate across candidate shards because every
    shard scores rows of every user; with the gather-at-load options each
    shard indexes its replicated table by its own slice of ``user_index``
    inside the kernel, so no (B, ...)-sized gathered block is ever formed,
    let alone gathered across ranks."""
    from torch.distributed.tensor import Replicate
    return {name: (Replicate(),) for name in boundary_specs}


@dataclasses.dataclass
class TwoStageSplit:
    stage1: Graph                 # inputs: user feeds; outputs: boundary
    stage2: Graph                 # inputs: boundary + candidate feeds
    boundary: tuple[str, ...]     # stage-1 output names == stage-2 user inputs
    user_nodes: frozenset[str]    # stage-1 node set in the source graph
    n_precompute_nodes: int       # compute nodes skipped on a user-cache hit
    # per-example (batch-dim-free) shape of every stage-2 user-side input:
    # boundary activations AND rewritten-unit partials — the contract the
    # coalescing runtime stacks into (U, ...) rep tables
    boundary_specs: dict[str, tuple[int, ...]] = dataclasses.field(
        default_factory=dict)

    def summary(self) -> str:
        return (f"split: stage1 {len(self.stage1.nodes)} nodes "
                f"({self.n_precompute_nodes} compute) -> "
                f"{len(self.boundary)} boundary values; "
                f"stage2 {len(self.stage2.nodes)} nodes")


def _split_mari_dense(n: Node, pre: set[str]) -> tuple[Node, list[Node]]:
    """Peel the user-side product of a ``mari_dense`` into a stage-1 partial.

    Returns (stage-2 node, stage-1 partial nodes). Falls back to the
    unmodified node when there is nothing user-side to peel (the node then
    reads its user segments as boundary inputs — still correct, just less
    precomputation).
    """
    attrs = n.attrs
    base = dict(param_of=n.name, units=attrs["units"],
                use_bias=attrs.get("use_bias", True),
                cast_dtype=attrs.get("cast_dtype"))
    if attrs.get("fragment"):
        user_idx = tuple(i for i, s in enumerate(n.inputs) if s in pre)
        if not user_idx:
            return n, []
        rest_idx = tuple(i for i in range(len(n.inputs)) if i not in user_idx)
        pname = n.name + "::u"
        pnode = Node(pname, "mari_user_partial",
                     tuple(n.inputs[i] for i in user_idx),
                     dict(base, fragment=True, seg_idx=user_idx))
        attrs2 = dict(attrs, precomputed_user=True, use_bias=False,
                      seg_param_idx=rest_idx)
        node2 = Node(n.name, "mari_dense",
                     (pname,) + tuple(n.inputs[i] for i in rest_idx), attrs2)
        return node2, [pnode]

    groups = attrs["groups"]
    user_groups = [(lab, idx) for lab, idx in groups if lab == "user"]
    if len(user_groups) != 1:
        return n, []
    user_idx = user_groups[0][1]
    if any(n.inputs[i] not in pre for i in user_idx):
        # segment labels disagree with the actual coloring — don't peel
        return n, []
    pname = n.name + "::u"
    pnode = Node(pname, "mari_user_partial",
                 tuple(n.inputs[i] for i in user_idx),
                 dict(base, fragment=False))
    new_inputs: list[str] = [pname]
    new_groups: list[tuple[str, tuple[int, ...]]] = []
    for lab, idx in groups:
        if lab == "user":
            continue
        nidx = []
        for i in idx:
            new_inputs.append(n.inputs[i])
            nidx.append(len(new_inputs) - 1)
        new_groups.append((lab, tuple(nidx)))
    attrs2 = dict(attrs, groups=tuple(new_groups), precomputed_user=True,
                  use_bias=False)
    return Node(n.name, "mari_dense", tuple(new_inputs), attrs2), [pnode]


def _split_attention(n: Node) -> tuple[Node, list[Node]]:
    """Peel the one-shot tensors of a decomposed ``target_attention``."""
    h1 = n.attrs["mlp_hidden"][0]
    keys = n.inputs[1]
    pu = Node(n.name + "::u_part", "attn_user_part", (keys,),
              dict(param_of=n.name, h1=h1))
    pt = Node(n.name + "::T", "attn_user_T", (keys,),
              dict(param_of=n.name, h1=h1))
    attrs2 = dict(n.attrs, precomputed=True)
    node2 = Node(n.name, "target_attention",
                 tuple(n.inputs) + (pu.name, pt.name), attrs2)
    return node2, [pu, pt]


def split_two_stage(graph: Graph, gca: GCAResult | None = None) -> TwoStageSplit:
    gca = gca or run_gca(graph)
    shapes = infer_shapes(graph)

    # Stage-1 set: Yellow nodes plus their (necessarily non-Blue) ancestors —
    # an uncolored ancestor of a Yellow node is constant w.r.t. the candidate
    # batch, so precomputing it per user is sound.
    pre = {name for name, c in gca.colors.items() if c is Color.YELLOW}
    for n in reversed(graph.topo_order()):
        if n.name in pre:
            pre.update(n.inputs)

    boundary: list[str] = []
    seen: set[str] = set()

    def need(name: str) -> None:
        if name in pre and name not in seen:
            seen.add(name)
            boundary.append(name)

    partials: list[Node] = []
    s2_body: list[Node] = []
    for n in graph.topo_order():
        if n.name in pre:
            continue
        if n.op == "mari_dense":
            node2, pnodes = _split_mari_dense(n, pre)
        elif (n.op == "target_attention" and n.attrs.get("decomposed")
                and n.inputs[1] in pre):
            node2, pnodes = _split_attention(n)
        else:
            node2, pnodes = n, []
        partials.extend(pnodes)
        for i in node2.inputs:
            need(i)
        s2_body.append(node2)
    for o in graph.outputs:
        need(o)  # a user-only graph output passes straight through stage 2

    # Partial output shapes (per-example, batch dim excluded).
    pshape: dict[str, tuple[int, ...]] = {}
    for p in partials:
        if p.op == "mari_user_partial":
            pshape[p.name] = (p.attrs["units"],)
        elif p.op == "attn_user_part":
            L, _ = shapes[p.inputs[0]]
            pshape[p.name] = (L, p.attrs["h1"])
        else:  # attn_user_T
            L, D = shapes[p.inputs[0]]
            pshape[p.name] = (L, D, p.attrs["h1"])

    # ---- stage 1: user subgraph + partials, pruned to what stage 2 needs
    s1 = Graph()
    for n in graph.topo_order():
        if n.name in pre:
            s1.add(n)
    for p in partials:
        s1.add(p)
    s1.set_outputs(boundary + [p.name for p in partials])
    s1 = s1.dce()

    # ---- stage 2: boundary values arrive as batch-1 "user" inputs
    s2 = Graph()
    for name in boundary:
        n0 = graph.nodes[name]
        if n0.op == "input":
            s2.add(n0)
        else:
            s2.add(Node(name, "input", (),
                        dict(shape=tuple(shapes[name]), domain="user",
                             dtype="float32")))
    for p in partials:
        s2.add(Node(p.name, "input", (),
                    dict(shape=tuple(pshape[p.name]), domain="user",
                         dtype="float32")))
    for n in s2_body:
        s2.add(n)
    s2.set_outputs(graph.outputs)
    s2 = s2.dce()

    n_compute = sum(1 for n in s1.nodes.values() if n.op != "input")
    specs = {name: tuple(shapes[name]) for name in boundary}
    specs.update({p.name: tuple(pshape[p.name]) for p in partials})
    return TwoStageSplit(stage1=s1, stage2=s2,
                         boundary=tuple(s1.outputs),
                         user_nodes=frozenset(pre),
                         n_precompute_nodes=n_compute,
                         boundary_specs=specs)
