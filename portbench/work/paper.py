"""The paper's ranking model's work, counted from its shapes: the least
the ``mari_matmul`` family's operations need, and the model FLOPs of the
MaRI form (conventions as in ``work/din.py``).

The MaRI sites (§2.5 and the gates GCA finds): the query projection
(candidate side: the item features), each expert's first layer and each
gate (candidate side: attention output, item and cross features), and
each task tower's first layer (candidate side: the gated expert mix);
each runs as one ``mari_matmul`` product over its candidate side, the
user side arriving as a gathered accumulator row.
"""
from __future__ import annotations

F32 = 4


def _c(cfg: dict):
    d_exp = tuple(int(x) for x in cfg["d_expert"])
    d_tow = tuple(int(x) for x in cfg["d_tower"])
    widths = cfg.get("user_tower_widths")
    widths = tuple(int(x) for x in widths) if widths else None
    return cfg, d_exp, d_tow, widths


def mari_sites(cfg: dict) -> list[tuple[int, int, int, bool]]:
    """(candidate-side K, user-side K, N, bias) of each MaRI product."""
    c, d_exp, d_tow, _ = _c(cfg)
    ut, att = int(c["d_user_tower"]), int(c["d_attn"])
    kc = att + int(c["d_item"]) + int(c["d_cross"])
    sites = [(int(c["d_item"]), att, att, False)]
    sites += [(kc, ut, d_exp[0], True)] * int(c["n_experts"])
    sites += [(kc, ut, int(c["n_experts"]), True)] * int(c["n_tasks"])
    sites += [(d_exp[-1], ut, d_tow[0], True)] * int(c["n_tasks"])
    return sites


def candidate_flops(cfg: dict) -> int:
    c, d_exp, d_tow, _ = _c(cfg)
    L, att = int(c["seq_len"]), int(c["d_attn"])
    f = sum(2 * kc * n for kc, _, n, _ in mari_sites(cfg))
    f += 2 * 2 * L * att                                 # scores, values
    f += int(c["n_experts"]) * sum(
        2 * a * b for a, b in zip(d_exp[:-1], d_exp[1:]))
    tow = d_tow + (1,)
    f += int(c["n_tasks"]) * (
        2 * int(c["n_experts"]) * d_exp[-1]              # gated mix
        + sum(2 * a * b for a, b in zip(tow[:-1], tow[1:])))
    return f


def user_flops(cfg: dict) -> int:
    c, _, _, widths = _c(cfg)
    ut, att = int(c["d_user_tower"]), int(c["d_attn"])
    dims = (int(c["d_user_profile"]),) + (widths or (ut,)) + (ut,)
    f = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    f += 2 * 2 * int(c["seq_len"]) * int(c["d_seq"]) * att   # keys, values
    f += 2 * int(c["d_user_profile"]) * att                   # profile proj
    f += sum(2 * ku * n for _, ku, n, _ in mari_sites(cfg))
    return f


def kernel_work(cfg: dict, path: str, rows: int, users: int) -> dict:
    if path != "two_stage":
        raise ValueError(f"unknown path {path!r}")
    B, U = rows, users
    ops = []
    for kc, _, n, bias in mari_sites(cfg):
        ops.append((2 * B * kc * n,
                    F32 * (B * kc + kc * n + U * n + (n if bias else 0)
                           + B * n + B)))
    return {"mari_matmul": ops}
