"""The paper's reference ranking model (Fig. 1): user tower + candidate
cross-attention over the behaviour sequence + MMoE + per-task towers.

Contains all three MaRI sites named in §2.5:
  (1) first FC of every MMoE expert,
  (2) first FC of each task tower,
  (3) the query projection of the cross-attention
and therefore serves as the GCA acceptance test and the Table-1 benchmark
model (coarse-ranking variant uses smaller dims).
"""
from __future__ import annotations

import dataclasses

from repro_torch.graph.ir import Graph, GraphBuilder


@dataclasses.dataclass(frozen=True)
class PaperRankingConfig:
    d_user_profile: int = 4000     # matches Table-2 "D_user = 4000" regime
    d_item: int = 500
    d_cross: int = 500
    seq_len: int = 128             # user behaviour sequence length
    d_seq: int = 64                # per-event embedding dim
    d_attn: int = 64               # cross-attention width
    n_experts: int = 4
    d_expert: tuple[int, ...] = (512, 256)
    n_tasks: int = 2               # e.g. ctr + long-view
    d_tower: tuple[int, ...] = (128, 64)
    d_user_tower: int = 256
    # hidden widths of the user tower before the final d_user_tower layer.
    # None keeps the classic two-layer tower (one d_user_tower hidden); a
    # tuple like (4096, 4096, 4096) builds a deep/wide tower — the
    # industrial regime where stage-1 reuse is worth caching, used by the
    # serving benchmarks to measure cache-hit speedup at realistic
    # stage-1/stage-2 cost ratios.
    user_tower_widths: tuple[int, ...] | None = None

    def scaled(self, f: float) -> "PaperRankingConfig":
        s = lambda x: max(8, int(x * f))
        return dataclasses.replace(
            self, d_user_profile=s(self.d_user_profile), d_item=s(self.d_item),
            d_cross=s(self.d_cross), seq_len=max(4, int(self.seq_len * f)),
            d_seq=s(self.d_seq), d_attn=s(self.d_attn),
            d_expert=tuple(s(x) for x in self.d_expert),
            d_tower=tuple(s(x) for x in self.d_tower),
            d_user_tower=s(self.d_user_tower),
            user_tower_widths=(None if self.user_tower_widths is None
                               else tuple(s(x)
                                          for x in self.user_tower_widths)))


def build_paper_ranking_model(cfg: PaperRankingConfig = PaperRankingConfig()
                              ) -> tuple[Graph, PaperRankingConfig]:
    b = GraphBuilder()
    # ---- inputs ----
    profile = b.input("user_profile", (cfg.d_user_profile,), "user")
    seq = b.input("user_seq", (cfg.seq_len, cfg.d_seq), "user")
    item = b.input("item_feats", (cfg.d_item,), "item")
    cross = b.input("cross_feats", (cfg.d_cross,), "cross")

    # ---- user tower (entirely one-shot under UOI) ----
    # default: the classic fc1(d_user_tower) -> fc2(d_user_tower) pair;
    # user_tower_widths replaces the hidden chain (layer names stay
    # user_tower_fc1..fcN with the final layer projecting to d_user_tower)
    widths = (cfg.user_tower_widths if cfg.user_tower_widths is not None
              else (cfg.d_user_tower,))
    h = profile
    for li, width in enumerate(widths):
        h = b.dense(f"user_tower_fc{li + 1}", h, width, activation="relu")
    u_emb = b.dense(f"user_tower_fc{len(widths) + 1}", h, cfg.d_user_tower,
                    activation="relu")

    # ---- cross attention: candidates attend to user sequence (Eq. 1) ----
    # K/V projections act on the raw (1, L, d) sequence — one-shot.
    k = b.dense("attn_k_proj", seq, cfg.d_attn, use_bias=False)
    v = b.dense("attn_v_proj", seq, cfg.d_attn, use_bias=False)
    # Query takes item feats concat a user context vector -> MaRI site (3).
    u_ctx = b.dense("user_ctx_proj", profile, cfg.d_attn, activation="relu")
    q_in = b.concat("q_concat", [item, u_ctx])
    q = b.dense("attn_q_proj", q_in, cfg.d_attn, use_bias=False)
    e_iu = b.cross_attention("cross_attn", q, k, v)  # (B, d_attn)

    # ---- feature fusion ----
    fusion = b.concat("fusion", [u_emb, e_iu, item, cross])

    # ---- MMoE: experts + per-task gates (MaRI site (1) = expert fc1; GCA
    # additionally discovers the gate projections) ----
    expert_outs = []
    for ei in range(cfg.n_experts):
        h = fusion
        for li, width in enumerate(cfg.d_expert):
            h = b.dense(f"expert{ei}_fc{li}", h, width, activation="relu")
        expert_outs.append(h)
    experts = b.stack_features("expert_stack", expert_outs)  # (B, E, d)

    task_logits = []
    for ti in range(cfg.n_tasks):
        gate_logit = b.dense(f"gate{ti}_proj", fusion, cfg.n_experts)
        gate = b.softmax(f"gate{ti}_softmax", gate_logit)
        mix = b.weighted_sum(f"task{ti}_mix", gate, experts)  # (B, d)
        # tower input re-concats a user-side projection -> MaRI site (2)
        tower_in = b.concat(f"task{ti}_in", [mix, u_emb])
        h = tower_in
        for li, width in enumerate(cfg.d_tower):
            h = b.dense(f"task{ti}_fc{li}", h, width, activation="relu")
        task_logits.append(b.dense(f"task{ti}_logit", h, 1))
    b.output(*task_logits)
    return b.graph, cfg


# Matmuls the paper names as MaRI-optimizable in this architecture.
def expected_eligible(cfg: PaperRankingConfig) -> set[str]:
    out = {"attn_q_proj"}
    out |= {f"expert{e}_fc0" for e in range(cfg.n_experts)}
    out |= {f"gate{t}_proj" for t in range(cfg.n_tasks)}
    out |= {f"task{t}_fc0" for t in range(cfg.n_tasks)}
    return out
