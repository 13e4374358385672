"""The recsys architectures as colored feature-fusion graphs (port of
``repro.models.recsys``: DLRM, FM, DIN, DeepFM).

Each builder returns ``(Graph, RecSysSpec)`` whose node names, ops and
attrs equal the reference's. Feature fields are split into user-side and
item-side groups (Criteo fields carry no public user/item labels, so the
split is a documented synthetic assignment); the split is what makes
UOI/MaRI applicable, exactly as in the paper's production models.

All graphs output a single ``logit`` node (CTR-style binary task).
"""
from __future__ import annotations

import dataclasses

from repro_torch.graph.ir import Graph, GraphBuilder

# MLPerf DLRM (Criteo 1TB) sparse table row counts [arXiv:1906.00091; MLPerf].
DLRM_TABLE_ROWS = [
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
]


SHARD_PAD = 256       # tables >= SHARD_THRESHOLD rows pad to this multiple so
SHARD_THRESHOLD = 65536  # they shard evenly over ('model','data') (ZeRO)


def pad_vocab(v: int) -> int:
    if v < SHARD_THRESHOLD:
        return v
    return ((v + SHARD_PAD - 1) // SHARD_PAD) * SHARD_PAD


@dataclasses.dataclass(frozen=True)
class RecSysSpec:
    name: str
    user_fields: tuple[str, ...]
    item_fields: tuple[str, ...]
    cross_fields: tuple[str, ...]
    embed_dim: int
    vocab_sizes: dict[str, int]
    seq_len: int = 0                      # DIN behaviour sequence
    n_dense: int = 0                      # DLRM dense features
    expected_eligible: tuple[str, ...] = ()   # matmuls GCA must find

    @property
    def all_fields(self) -> tuple[str, ...]:
        return self.user_fields + self.item_fields + self.cross_fields


def _field_split(n: int, prefix: str, n_user: int) -> tuple[list[str], list[str]]:
    names = [f"{prefix}_{i}" for i in range(n)]
    return names[:n_user], names[n_user:]


# ---------------------------------------------------------------------------
# DLRM (MLPerf config): 13 dense + 26 sparse, dot interaction, top MLP
# ---------------------------------------------------------------------------

def build_dlrm(
    embed_dim: int = 128,
    bot_mlp: tuple[int, ...] = (512, 256, 128),
    top_mlp: tuple[int, ...] = (1024, 1024, 512, 256, 1),
    n_dense: int = 13,
    table_rows: list[int] | None = None,
    scale_tables: float = 1.0,
) -> tuple[Graph, RecSysSpec]:
    rows = table_rows or DLRM_TABLE_ROWS
    rows = [pad_vocab(max(4, int(r * scale_tables))) for r in rows]
    n_sparse = len(rows)
    n_user_sparse = n_sparse // 2  # synthetic split: first half user-side
    user_sp, item_sp = _field_split(n_sparse, "sparse", n_user_sparse)

    b = GraphBuilder()
    # dense features = request/user context -> bottom MLP (user-side, one-shot)
    dense_in = b.input("user_dense", (n_dense,), "user")
    h = dense_in
    for li, width in enumerate(bot_mlp):
        h = b.dense(f"bot_mlp_{li}", h, width, activation="relu")
    bot_out = h  # (embed_dim,)

    emb_nodes = []
    vocab = {}
    for fi, f in enumerate(user_sp + item_sp):
        dom = "user" if f in user_sp else "item"
        ids = b.input(f"{f}_ids", (), dom, dtype="int32")
        emb = b.embedding(f"{f}_emb", ids, vocab=rows[fi], dim=embed_dim)
        vocab[f] = rows[fi]
        emb_nodes.append(emb)

    stacked = b.stack_features("feat_stack", [bot_out] + emb_nodes)
    inter = b.dot_interaction("dot_inter", stacked)
    fusion = b.concat("top_in", [bot_out, inter])  # mixed: user bottom + blue inter
    h = fusion
    for li, width in enumerate(top_mlp):
        last = li == len(top_mlp) - 1
        h = b.dense(f"top_mlp_{li}", h, width,
                    activation="identity" if last else "relu")
    b.output(h)
    spec = RecSysSpec(
        name="dlrm-mlperf", user_fields=tuple(user_sp), item_fields=tuple(item_sp),
        cross_fields=(), embed_dim=embed_dim, vocab_sizes=vocab, n_dense=n_dense,
        expected_eligible=("top_mlp_0",))
    return b.graph, spec


# ---------------------------------------------------------------------------
# FM (Rendle '10): linear + pairwise via sum-square trick, decomposed so the
# user-side partial sums run one-shot (UOI philosophy on a non-matmul op).
# ---------------------------------------------------------------------------

def build_fm(
    n_sparse: int = 39,
    embed_dim: int = 10,
    vocab_size: int = 100_000,
    n_user: int = 20,
) -> tuple[Graph, RecSysSpec]:
    user_f, item_f = _field_split(n_sparse, "field", n_user)
    vocab_size = pad_vocab(vocab_size)
    b = GraphBuilder()
    vocab = {}

    def field_embs(fields, dom):
        vs, lins = [], []
        for f in fields:
            ids = b.input(f"{f}_ids", (), dom, dtype="int32")
            vs.append(b.embedding(f"{f}_v", ids, vocab=vocab_size, dim=embed_dim))
            lins.append(b.embedding(f"{f}_w", ids, vocab=vocab_size, dim=1))
            vocab[f] = vocab_size
        return vs, lins

    uv, ul = field_embs(user_f, "user")
    iv, il = field_embs(item_f, "item")

    # linear term: user part pooled once (batch 1), item part at B.
    u_lin = b.reduce("u_lin_sum", b.stack_features("u_lin_stack", ul), "sum", -2)
    i_lin = b.reduce("i_lin_sum", b.stack_features("i_lin_stack", il), "sum", -2)
    lin = b.add("linear_term", u_lin, i_lin)

    # 2-way term, decomposed: S = S_u + S_i ; SS = SS_u + SS_i
    u_stack = b.stack_features("u_v_stack", uv)     # (1, Fu, D)
    i_stack = b.stack_features("i_v_stack", iv)     # (B, Fi, D)
    s_u = b.reduce("s_u", u_stack, "sum", -2)
    s_i = b.reduce("s_i", i_stack, "sum", -2)
    s = b.add("s_total", s_u, s_i)                   # (B, D)
    sq_u = b.reduce("sq_u", b.mul("u_sq", u_stack, u_stack), "sum", -2)
    sq_i = b.reduce("sq_i", b.mul("i_sq", i_stack, i_stack), "sum", -2)
    sq = b.add("sq_total", sq_u, sq_i)
    s2 = b.mul("s_sq", s, s)
    pair = b.scale("half", b.reduce("pair_sum", b.sub("diff", s2, sq), "sum", -1), 0.5)
    pair = b.reshape("pair_col", pair, (1,))
    logit = b.add("logit", lin, pair)
    b.output(logit)
    spec = RecSysSpec(
        name="fm", user_fields=tuple(user_f), item_fields=tuple(item_f),
        cross_fields=(), embed_dim=embed_dim, vocab_sizes=vocab,
        expected_eligible=())  # FM has no eligible matmul — §Arch-applicability
    return b.graph, spec


# ---------------------------------------------------------------------------
# DIN: target attention over user behaviour sequence + fusion MLP
# ---------------------------------------------------------------------------

def build_din(
    embed_dim: int = 18,
    seq_len: int = 100,
    attn_mlp: tuple[int, ...] = (80, 40),
    mlp: tuple[int, ...] = (200, 80),
    item_vocab: int = 200_000,
    user_profile_dim: int = 36,
    context_dim: int = 12,
) -> tuple[Graph, RecSysSpec]:
    item_vocab = pad_vocab(item_vocab)
    b = GraphBuilder()
    # user side: profile vector + behaviour sequence ids (computed one-shot)
    profile = b.input("user_profile", (user_profile_dim,), "user")
    seq_ids = b.input("user_seq_ids", (seq_len,), "user", dtype="int32")
    seq_emb = b.embedding("user_seq_emb", seq_ids, vocab=item_vocab, dim=embed_dim)

    # item side: candidate id + context
    item_ids = b.input("item_ids", (), "item", dtype="int32")
    item_emb = b.embedding("item_emb", item_ids, vocab=item_vocab, dim=embed_dim)
    context = b.input("cross_context", (context_dim,), "cross")

    interest = b.target_attention("din_attn", item_emb, seq_emb,
                                  mlp_hidden=attn_mlp)  # (B, D)
    fusion = b.concat("fusion", [profile, interest, item_emb, context])
    h = fusion
    for li, width in enumerate(mlp):
        h = b.dense(f"mlp_{li}", h, width, activation="relu")
    logit = b.dense("logit", h, 1)
    b.output(logit)
    spec = RecSysSpec(
        name="din", user_fields=("user_profile", "user_seq_ids"),
        item_fields=("item_ids",), cross_fields=("cross_context",),
        embed_dim=embed_dim, vocab_sizes={"item": item_vocab}, seq_len=seq_len,
        expected_eligible=("mlp_0",))
    return b.graph, spec


# ---------------------------------------------------------------------------
# DeepFM: FM component + deep MLP over concatenated field embeddings
# ---------------------------------------------------------------------------

def build_deepfm(
    n_sparse: int = 39,
    embed_dim: int = 10,
    mlp: tuple[int, ...] = (400, 400, 400),
    vocab_size: int = 100_000,
    n_user: int = 20,
) -> tuple[Graph, RecSysSpec]:
    user_f, item_f = _field_split(n_sparse, "field", n_user)
    vocab_size = pad_vocab(vocab_size)
    b = GraphBuilder()
    vocab = {}
    u_emb, i_emb, u_lin, i_lin = [], [], [], []
    for f in user_f + item_f:
        dom = "user" if f in user_f else "item"
        ids = b.input(f"{f}_ids", (), dom, dtype="int32")
        (u_emb if dom == "user" else i_emb).append(
            b.embedding(f"{f}_v", ids, vocab=vocab_size, dim=embed_dim))
        (u_lin if dom == "user" else i_lin).append(
            b.embedding(f"{f}_w", ids, vocab=vocab_size, dim=1))
        vocab[f] = vocab_size

    # FM component (decomposed like build_fm)
    lin = b.add("linear_term",
                b.reduce("u_lin_sum", b.stack_features("u_lin_stack", u_lin), "sum", -2),
                b.reduce("i_lin_sum", b.stack_features("i_lin_stack", i_lin), "sum", -2))
    u_stack = b.stack_features("u_v_stack", u_emb)
    i_stack = b.stack_features("i_v_stack", i_emb)
    s = b.add("s_total", b.reduce("s_u", u_stack, "sum", -2),
              b.reduce("s_i", i_stack, "sum", -2))
    sq = b.add("sq_total",
               b.reduce("sq_u", b.mul("u_sq", u_stack, u_stack), "sum", -2),
               b.reduce("sq_i", b.mul("i_sq", i_stack, i_stack), "sum", -2))
    pair = b.scale("half", b.reduce("pair_sum",
                                    b.sub("diff", b.mul("s_sq", s, s), sq),
                                    "sum", -1), 0.5)
    fm_logit = b.add("fm_logit", lin, b.reshape("pair_col", pair, (1,)))

    # deep component: concat of ALL field embeddings — mixed concat, fc1 eligible
    deep_in = b.concat("deep_in", u_emb + i_emb)
    h = deep_in
    for li, width in enumerate(mlp):
        h = b.dense(f"deep_mlp_{li}", h, width, activation="relu")
    deep_logit = b.dense("deep_logit", h, 1)
    logit = b.add("logit", fm_logit, deep_logit)
    b.output(logit)
    spec = RecSysSpec(
        name="deepfm", user_fields=tuple(user_f), item_fields=tuple(item_f),
        cross_fields=(), embed_dim=embed_dim, vocab_sizes=vocab,
        expected_eligible=("deep_mlp_0",))
    return b.graph, spec
