"""DIN as a colored feature-fusion graph (port of ``repro.models.recsys``;
the other recsys builders are not ported yet).

The builder returns ``(Graph, RecSysSpec)``. Feature fields are split into
user-side and item-side groups; the split is what makes UOI/MaRI
applicable, exactly as in the paper's production models. The graph
outputs a single ``logit`` node (CTR-style binary task).
"""
from __future__ import annotations

import dataclasses

from repro_torch.graph.ir import Graph, GraphBuilder

SHARD_PAD = 256       # tables >= SHARD_THRESHOLD rows pad to this multiple
SHARD_THRESHOLD = 65536


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
