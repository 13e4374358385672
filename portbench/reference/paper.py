"""Plain PyTorch reference of the paper's coarse-ranking model
(arXiv:2602.23105 Fig. 1), the vanilla forward the benchmark holds the
system's scores to.

A user tower over the profile vector; single-head cross attention from
each candidate (its item features concatenated with a ReLU projection of
the profile, projected without bias) to the user's behaviour sequence
(keys and values projected without bias, scores scaled by
``1 / sqrt(d_attn)``); the fusion ``[user tower, attention, item, cross]``
feeds every MMoE expert (ReLU MLPs) and one softmax gate per task; each
task tower takes ``[gated expert mix, user tower]`` and ends in one
logit. Output ``(n, n_tasks)``.

Every matrix product takes its concatenated input whole: no product is
split into user and candidate halves. Parts that read only user inputs
(the user tower, the profile projection, keys and values) are computed
once per request and broadcast, which is the same arithmetic as
computing them per candidate. fp32, TF32 off unless ``allow_tf32``, in
blocks of candidates. Nothing here imports the system under test.
"""
from __future__ import annotations

import math

import torch


def _c(cfg: dict) -> dict:
    c = dict(cfg)
    for k in ("d_expert", "d_tower"):
        c[k] = tuple(int(x) for x in c[k])
    widths = c.get("user_tower_widths")
    c["user_tower_widths"] = (None if widths is None
                              else tuple(int(x) for x in widths))
    return c


def outputs(cfg: dict) -> int:
    return int(cfg["n_tasks"])


def param_shapes(cfg: dict) -> dict:
    c = _c(cfg)
    out = {}

    def dense(name, a, b, bias=True):
        out[name] = {"w": ((a, b), "glorot")}
        if bias:
            out[name]["b"] = ((b,), "bias")

    widths = c["user_tower_widths"] or (c["d_user_tower"],)
    a = c["d_user_profile"]
    for i, w in enumerate(widths):
        dense(f"user_tower_fc{i + 1}", a, w)
        a = w
    dense(f"user_tower_fc{len(widths) + 1}", a, c["d_user_tower"])
    dense("attn_k_proj", c["d_seq"], c["d_attn"], bias=False)
    dense("attn_v_proj", c["d_seq"], c["d_attn"], bias=False)
    dense("user_ctx_proj", c["d_user_profile"], c["d_attn"])
    dense("attn_q_proj", c["d_item"] + c["d_attn"], c["d_attn"], bias=False)
    fusion = c["d_user_tower"] + c["d_attn"] + c["d_item"] + c["d_cross"]
    for e in range(c["n_experts"]):
        a = fusion
        for i, w in enumerate(c["d_expert"]):
            dense(f"expert{e}_fc{i}", a, w)
            a = w
    for t in range(c["n_tasks"]):
        dense(f"gate{t}_proj", fusion, c["n_experts"])
        a = c["d_expert"][-1] + c["d_user_tower"]
        for i, w in enumerate(c["d_tower"]):
            dense(f"task{t}_fc{i}", a, w)
            a = w
        dense(f"task{t}_logit", a, 1)
    return out


def feed_specs(cfg: dict) -> tuple[dict, dict]:
    c = _c(cfg)
    user = {"user_profile": ((c["d_user_profile"],), "float32", None),
            "user_seq": ((c["seq_len"], c["d_seq"]), "float32", None)}
    cand = {"item_feats": ((c["d_item"],), "float32", None),
            "cross_feats": ((c["d_cross"],), "float32", None)}
    return user, cand


def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def forward(params: dict, user: dict, cand: dict, cfg: dict, *,
            block: int = 4096, allow_tf32: bool = False) -> torch.Tensor:
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        with torch.no_grad():
            return _forward(params, user, cand, _c(cfg), block)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _forward(p, user, cand, c, block):
    profile = user["user_profile"]                    # (1, P)
    seq = user["user_seq"][0]                         # (L, d_seq)
    u = profile
    i = 1
    while f"user_tower_fc{i}" in p:
        u = torch.relu(_dense(p[f"user_tower_fc{i}"], u))
        i += 1
    k = _dense(p["attn_k_proj"], seq)                 # (L, d_attn)
    v = _dense(p["attn_v_proj"], seq)
    u_ctx = torch.relu(_dense(p["user_ctx_proj"], profile))
    scale = 1.0 / math.sqrt(c["d_attn"])
    outs = []
    n = cand["item_feats"].shape[0]
    for lo in range(0, n, block):
        item = cand["item_feats"][lo:lo + block]
        cross = cand["cross_feats"][lo:lo + block]
        b = item.shape[0]
        q = _dense(p["attn_q_proj"],
                   torch.cat([item, u_ctx.expand(b, -1)], dim=-1))
        att = torch.softmax((q @ k.T) * scale, dim=-1) @ v
        fusion = torch.cat([u.expand(b, -1), att, item, cross], dim=-1)
        experts = []
        for e in range(c["n_experts"]):
            h = fusion
            for j in range(len(c["d_expert"])):
                h = torch.relu(_dense(p[f"expert{e}_fc{j}"], h))
            experts.append(h)
        experts = torch.stack(experts, dim=1)          # (b, E, d)
        logits = []
        for t in range(c["n_tasks"]):
            g = torch.softmax(_dense(p[f"gate{t}_proj"], fusion), dim=-1)
            mix = torch.einsum("be,bed->bd", g, experts)
            h = torch.cat([mix, u.expand(b, -1)], dim=-1)
            for j in range(len(c["d_tower"])):
                h = torch.relu(_dense(p[f"task{t}_fc{j}"], h))
            logits.append(_dense(p[f"task{t}_logit"], h))
        outs.append(torch.cat(logits, dim=-1))
    return torch.cat(outs, dim=0)
