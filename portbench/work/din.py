"""DIN's work, counted from its shapes: the least a kernel family's
operations need, and the model FLOPs of the MaRI form.

Each operation is a pair ``(flops, bytes)``: flops of its multiplies and
adds (2 per multiply-add), bytes of each input read once and each output
written once (fp32, 4 bytes; an int32 row index, 4). Rows are the real
candidate rows and users the real users of a pack or call: padding is
the program's choice and is not counted. The count is the same whatever
implements the kernel.

Paths: ``two_stage`` is the served engine under the ``tpu`` preset (the
attention unit re-parameterised, user-side tables gathered per row:
``gather_einsum``'s ``bd,uldh->blh`` and ``bl,uld->bd``, and ``mlp_0`` on
``mari_matmul`` with the user partial gathered at its accumulator's
load); ``single_call`` is one user's call with the whole unit on
``din_attention`` and ``mlp_0`` on ``mari_matmul`` with the user partial
broadcast.
"""
from __future__ import annotations

F32 = 4


def _sizes(cfg: dict):
    d, seq = int(cfg["embed_dim"]), int(cfg["seq_len"])
    attn = tuple(int(x) for x in cfg["attn_mlp"])
    mlp = tuple(int(x) for x in cfg["mlp"])
    prof = int(cfg.get("user_profile_dim", 36))
    ctx = int(cfg.get("context_dim", 12))
    return d, seq, attn, mlp, prof, ctx


def _unit_rest_flops(seq: int, attn: tuple) -> int:
    """Per candidate: the unit's layers after the first, over the
    history."""
    dims = attn + (1,)
    return sum(2 * seq * a * b for a, b in zip(dims[:-1], dims[1:]))


def candidate_flops(cfg: dict) -> int:
    """Model FLOPs per candidate in the MaRI form: the query's part of
    the first layer, the key-times-query part over the history, the rest
    of the unit, the pooling, and the candidate side of the fusion MLP."""
    d, seq, attn, mlp, prof, ctx = _sizes(cfg)
    h1 = attn[0]
    unit = (2 * d * h1 + 2 * seq * d * h1 + _unit_rest_flops(seq, attn)
            + 2 * seq * d)
    widths = mlp + (1,)
    fusion = 2 * (2 * d + ctx) * mlp[0] + sum(
        2 * a * b for a, b in zip(widths[:-1], widths[1:]))
    return unit + fusion


def user_flops(cfg: dict) -> int:
    """Model FLOPs per user in the MaRI form: the keys' part of the first
    layer and the profile's part of ``mlp_0``."""
    d, seq, attn, mlp, prof, _ = _sizes(cfg)
    return 2 * seq * d * attn[0] + 2 * prof * mlp[0]


def kernel_work(cfg: dict, path: str, rows: int, users: int) -> dict:
    """``{family: [(flops, bytes), ...]}`` of one pack (``two_stage``) or
    call (``single_call``) of ``rows`` candidates and ``users`` users."""
    d, seq, attn, mlp, prof, ctx = _sizes(cfg)
    h1 = attn[0]
    k, n = 2 * d + ctx, mlp[0]
    B, U = rows, users
    if path == "two_stage":
        idx = F32 * B
        return {
            "gather_einsum": [
                (2 * B * seq * d * h1,
                 F32 * (B * d + U * seq * d * h1 + B * seq * h1) + idx),
                (2 * B * seq * d,
                 F32 * (B * seq + U * seq * d + B * d) + idx)],
            "mari_matmul": [
                (2 * B * k * n,
                 F32 * (B * k + k * n + U * n + n + B * n) + idx)],
        }
    if path == "single_call":
        dims = (4 * d,) + attn + (1,)
        weights = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        unit_flops = B * (2 * d * h1 + 2 * seq * d * h1
                          + _unit_rest_flops(seq, attn) + 2 * seq * d)
        return {
            "din_attention": [
                (unit_flops + 2 * seq * d * h1,
                 F32 * (B * d + seq * d + weights + B * d))],
            "mari_matmul": [
                (2 * B * k * n, F32 * (B * k + k * n + n + n + B * n))],
        }
    raise ValueError(f"unknown path {path!r}")
