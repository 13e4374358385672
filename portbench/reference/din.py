"""Plain PyTorch reference of DIN (Zhou et al., arXiv:1706.06978;
github.com/zhougr1993/DeepInterestNetwork ``din/model.py``), the vanilla
forward the benchmark holds the system's scores to.

One request: a user profile vector and a behaviour sequence of item ids
(user side), and per candidate an item id and a context vector. The
local-activation unit scores each history item against the candidate
with an MLP over ``[key, query, key - query, key * query]``, ReLU
between its layers, a softmax over the history, and sums the keys by
those weights. The fusion MLP (ReLU) takes ``[profile, interest, item
embedding, context]``. Departures from the public code, which the
configuration serves as the system builds it: the public unit orders its
features ``[query, key, ...]`` (a permutation of the first layer's rows,
drawn here in this layout), uses sigmoid in the unit and PReLU / Dice in
the fusion MLP, and scales the scores by ``1 / sqrt(D)`` before the
softmax; one ``item_vocab``-row table stands for the public item and
category tables (64 + 64 wide). Every candidate is
computed on its own (nothing re-parameterised, nothing split into user
and candidate halves), in fp32 with TF32 off unless ``allow_tf32``,
in blocks of candidates.

Nothing here imports the system under test.
"""
from __future__ import annotations

import torch


def _sizes(cfg: dict):
    return (int(cfg["embed_dim"]), int(cfg["seq_len"]),
            tuple(int(x) for x in cfg["attn_mlp"]),
            tuple(int(x) for x in cfg["mlp"]), int(cfg["item_vocab"]),
            int(cfg.get("user_profile_dim", 36)),
            int(cfg.get("context_dim", 12)))


def outputs(cfg: dict) -> int:
    return 1


def param_shapes(cfg: dict) -> dict:
    """``{node: {leaf: (shape, kind)}}`` under the graph's node names."""
    d, _, attn, mlp, vocab, prof, ctx = _sizes(cfg)
    out = {"user_seq_emb": {"table": ((vocab, d), "table")},
           "item_emb": {"table": ((vocab, d), "table")}}
    dims = (4 * d,) + attn + (1,)
    out["din_attn"] = {f"layer_{i}": {"w": ((a, b), "glorot"),
                                      "b": ((b,), "bias")}
                       for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}
    widths = (prof + 2 * d + ctx,) + mlp + (1,)
    names = [f"mlp_{i}" for i in range(len(mlp))] + ["logit"]
    for name, a, b in zip(names, widths[:-1], widths[1:]):
        out[name] = {"w": ((a, b), "glorot"), "b": ((b,), "bias")}
    return out


def feed_specs(cfg: dict) -> tuple[dict, dict]:
    """(user feeds, candidate feeds): name -> (row shape, dtype, id range
    or None)."""
    d, seq, _, _, vocab, prof, ctx = _sizes(cfg)
    user = {"user_profile": ((prof,), "float32", None),
            "user_seq_ids": ((seq,), "int32", vocab)}
    cand = {"item_ids": ((), "int32", vocab),
            "cross_context": ((ctx,), "float32", None)}
    return user, cand


def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def forward(params: dict, user: dict, cand: dict, cfg: dict, *,
            block: int = 1024, allow_tf32: bool = False) -> torch.Tensor:
    """Scores ``(n, 1)`` of one request; inputs are tensors on the
    params' device (user feeds with a leading 1)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        with torch.no_grad():
            return _forward(params, user, cand, block)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _forward(params, user, cand, block):
    keys = params["user_seq_emb"]["table"][user["user_seq_ids"][0].long()]
    profile = user["user_profile"][0]
    unit = params["din_attn"]
    n_layers = len(unit)
    outs = []
    n = cand["item_ids"].shape[0]
    for lo in range(0, n, block):
        ids = cand["item_ids"][lo:lo + block].long()
        q = params["item_emb"]["table"][ids]                 # (b, D)
        k = keys[None].expand(q.shape[0], -1, -1)            # (b, L, D)
        qq = q[:, None, :].expand_as(k)
        h = torch.cat([k, qq, k - qq, k * qq], dim=-1)       # (b, L, 4D)
        for i in range(n_layers):
            h = _dense(unit[f"layer_{i}"], h)
            if i < n_layers - 1:
                h = torch.relu(h)
        w = torch.softmax(h[..., 0], dim=-1)                 # (b, L)
        interest = torch.einsum("bl,ld->bd", w, keys)
        x = torch.cat([profile.expand(q.shape[0], -1), interest, q,
                       cand["cross_context"][lo:lo + block]], dim=-1)
        i = 0
        while f"mlp_{i}" in params:
            x = torch.relu(_dense(params[f"mlp_{i}"], x))
            i += 1
        outs.append(_dense(params["logit"], x))
    return torch.cat(outs, dim=0)
