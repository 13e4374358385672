"""The multi-hot DLRM serving graph of the port's ``embedding_bag`` path,
and checks of its topology on the CPU (jax-free: ``test_torch_gpu.py``
imports the builder on the card).

``multihot_dlrm(GraphBuilder, rows)`` builds the reference's
``build_dlrm`` topology (13 dense features through the bottom MLP, 26
sparse fields, dot interaction, top MLP; the first 13 fields user-side)
with one difference: sparse field ``i`` takes ids of shape ``(h_i,)``
pooled with ``pool="sum"`` where ``h_i > 1``. The hotness is MLPerf
DLRM-DCNv2's Criteo multi-hot set (MLCommons training,
``recommendation_v2/torchrec_dlrm``, ``--multi_hot_sizes``). It takes the
builder class, so the same function builds the graph in both packages;
``rows`` are the final table sizes (each package's ``pad_vocab`` of
``DLRM_TABLE_ROWS`` scaled).
"""
import numpy as np
import pytest

from repro_torch.core.split import split_two_stage
from repro_torch.graph.ir import GraphBuilder, infer_shapes
from repro_torch.models.recsys import DLRM_TABLE_ROWS, build_dlrm, pad_vocab

MULTI_HOT = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1,
             6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3, 1, 1)


def dlrm_rows(scale_tables: float, pad=pad_vocab) -> list[int]:
    """``build_dlrm``'s table sizes at ``scale_tables``."""
    return [pad(max(4, int(r * scale_tables))) for r in DLRM_TABLE_ROWS]


def multihot_dlrm(builder_cls, rows, *, embed_dim=128,
                  bot_mlp=(512, 256, 128),
                  top_mlp=(1024, 1024, 512, 256, 1), n_dense=13,
                  hotness=MULTI_HOT):
    """``build_dlrm``'s graph with multi-hot sparse fields; returns the
    graph (built by ``builder_cls``)."""
    n_sparse = len(rows)
    names = [f"sparse_{i}" for i in range(n_sparse)]
    n_user = n_sparse // 2            # as build_dlrm: first half user-side
    b = builder_cls()
    h = b.input("user_dense", (n_dense,), "user")
    for li, width in enumerate(bot_mlp):
        h = b.dense(f"bot_mlp_{li}", h, width, activation="relu")
    bot_out = h
    embs = []
    for fi, f in enumerate(names):
        dom = "user" if fi < n_user else "item"
        hot = hotness[fi]
        ids = b.input(f"{f}_ids", (hot,) if hot > 1 else (), dom,
                      dtype="int32")
        embs.append(b.embedding(f"{f}_emb", ids, vocab=rows[fi],
                                dim=embed_dim,
                                pool="sum" if hot > 1 else None))
    stacked = b.stack_features("feat_stack", [bot_out] + embs)
    inter = b.dot_interaction("dot_inter", stacked)
    h = b.concat("top_in", [bot_out, inter])
    for li, width in enumerate(top_mlp):
        last = li == len(top_mlp) - 1
        h = b.dense(f"top_mlp_{li}", h, width,
                    activation="identity" if last else "relu")
    b.output(h)
    return b.graph


def smoke_multihot_dlrm(builder_cls, pad=pad_vocab):
    """The same topology at smoke width (the registry's DLRM smoke
    widths, tables cut to a few hundred rows)."""
    return multihot_dlrm(builder_cls, dlrm_rows(1e-5, pad), embed_dim=16,
                         bot_mlp=(32, 16), top_mlp=(64, 32, 1))


def test_hotness_is_the_mlperf_multi_hot_set():
    item = MULTI_HOT[13:]
    assert len(MULTI_HOT) == 26
    assert sum(h for h in item if h > 1) == 172       # ids in pooled bags
    assert sum(h > 1 for h in item) == 8 and sum(h > 1 for h in
                                                 MULTI_HOT[:13]) == 7
    assert dlrm_rows(0.1)[20] == 2_564_352             # the largest bag's


def test_topology_matches_build_dlrm_but_for_the_bags():
    """Node for node ``build_dlrm``'s graph, except the multi-hot ids and
    their pooling; every pooled embedding has the single-id one's shape."""
    rows = dlrm_rows(1e-5)
    ours = multihot_dlrm(GraphBuilder, rows, embed_dim=16,
                         bot_mlp=(32, 16), top_mlp=(64, 32, 1))
    base, _ = build_dlrm(table_rows=DLRM_TABLE_ROWS, scale_tables=1e-5,
                         embed_dim=16, bot_mlp=(32, 16), top_mlp=(64, 32, 1))
    assert list(ours.nodes) == list(base.nodes)
    s_ours, s_base = infer_shapes(ours), infer_shapes(base)
    for name, node in ours.nodes.items():
        ref = base.nodes[name]
        assert (node.op, node.inputs) == (ref.op, ref.inputs), name
        if node.op == "input" and name.startswith("sparse_"):
            hot = MULTI_HOT[int(name.split("_")[1])]
            assert node.attrs["shape"] == ((hot,) if hot > 1 else ())
            continue
        if node.op == "embedding":
            hot = MULTI_HOT[int(name.split("_")[1])]
            assert node.attrs["pool"] == ("sum" if hot > 1 else None)
        assert s_ours[name] == s_base[name], name


@pytest.mark.parametrize("width", ["smoke", "full"])
def test_split_puts_user_bags_in_stage1_and_item_bags_in_stage2(width):
    graph = (smoke_multihot_dlrm(GraphBuilder) if width == "smoke" else
             multihot_dlrm(GraphBuilder, dlrm_rows(0.1)))
    split = split_two_stage(graph)
    pooled = lambda g: sorted(n.name for n in g.nodes.values()
                              if n.op == "embedding" and n.attrs.get("pool"))
    assert len(pooled(split.stage1)) == 7
    assert len(pooled(split.stage2)) == 8
    ids = sum(int(np.prod(n.attrs["shape"])) for n in
              split.stage2.input_nodes() if n.name.endswith("_ids"))
    assert ids == 177                  # 172 in the 8 bags + 5 single ids
