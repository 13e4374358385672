"""Gather-aware einsum: the CUDA kernel's wrapper, its plain PyTorch
version, and ``parse_spec`` (port of ``repro.kernels.gather_einsum``).

``gather_einsum(spec, x, table, user_index)`` computes
``einsum(spec, x, table[clamp(user_index)])`` for specs of the form
``"b...,u...->b..."``. A CPU tensor goes to ``gather_einsum_plain`` (any
spec ``parse_spec`` accepts). A CUDA tensor launches
``csrc/gather_einsum.cu`` — the gathered ``(B, ...)`` operand never
materializes — in fp32 or bf16 (f32 products and sums, the output in
bf16): the three ``KERNEL_SPECS`` on their own routes, and every other
spec on the generic route, tiled by ``generic_tile`` from the roles of
the spec's dims (``generic_roles``: output dims in the table only, in x
only or in both; summed dims in both or one) and the shapes, each sum in
the order of commit 521130a's route (``csrc/gather_einsum.cu``'s note; a
GROUPED tiling sorts the rows by user on the card, in a workspace the
wrapper allocates). In bf16, ``bl,uld->bd``, ``blh,uh->bl`` and the
generic route give the fp32 kernel's result on the widened operands,
rounded once; ``bd,uldh->blh`` runs on the bf16
tensor cores, its f32 sums in the ``mma``'s order. ``LAUNCHES`` counts
kernel launches per spec, fp32 under the spec and bf16 under
``<spec>/bf16``, the generic route under ``generic`` and
``generic/bf16``. fp32 ``bd,uldh->blh`` past D = 40 runs on the tensor
cores (3xTF32 ``wgmma``, the rows grouped by user through a counting sort
on the card, a workspace the wrapper allocates) and counts under
``TC_KEY``; its sums over d go by 32-deep k tiles, fixed by D alone.

Index contract (shared with ``mari_matmul``'s gather init): ``user_index``
is ``(B,)`` integer, row ``b`` reads ``table[user_index[b]]``, and
out-of-range values clamp to ``[0, U-1]``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.common import take_clip
from repro_torch.dist.sharding import shard_local
from repro_torch.kernels import build

Tensor = torch.Tensor

# the decomposed-attention contractions, in csrc Spec enum order
KERNEL_SPECS = ("bd,uldh->blh", "bl,uld->bd", "blh,uh->bl")

# fp32 ``bd,uldh->blh`` past D = 40 runs on the tensor cores (csrc
# TC_MIN_D): its launches count under this key
TC_KEY = "bd,uldh->blh/tc"
TC_MIN_D = 41

# kernel launches per spec (one per launch, counted nowhere else)
LAUNCHES = dict.fromkeys(KERNEL_SPECS + (TC_KEY, "generic")
                         + tuple(f"{s}/bf16"
                                 for s in KERNEL_SPECS + ("generic",)), 0)

# the generic route's plan holds at most this many dims of each role
# (csrc GE_MAX_DIMS)
MAX_PLAN_DIMS = 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def parse_spec(spec: str) -> tuple[str, str, str, str]:
    """Validate a gather-einsum spec; returns (x_sub, t_sub, out_sub,
    row_spec) where ``row_spec`` is the per-row einsum after the gather
    (``u`` replaced by ``b``)."""
    try:
        lhs, out = spec.split("->")
        x_sub, t_sub = lhs.split(",")
    except ValueError:
        raise ValueError(f"gather_einsum spec must be 'b...,u...->b...', "
                         f"got {spec!r}") from None
    if not (x_sub.startswith("b") and t_sub.startswith("u")
            and out.startswith("b")):
        raise ValueError(
            f"gather_einsum spec {spec!r}: first operand must lead with the "
            f"row dim 'b', the table with the user dim 'u', the output with "
            f"'b'")
    if "u" in x_sub or "u" in out or "b" in t_sub:
        raise ValueError(f"gather_einsum spec {spec!r}: 'u' lives only on "
                         f"the table operand, 'b' never does")
    for sub in (x_sub, t_sub, out):
        if len(set(sub)) != len(sub):
            raise ValueError(f"gather_einsum spec {spec!r}: repeated dim "
                             f"in {sub!r}")
    if not set(out[1:]) <= set(x_sub[1:]) | set(t_sub[1:]):
        raise ValueError(f"gather_einsum spec {spec!r}: output dim not "
                         f"present in any operand")
    return x_sub, t_sub, out, f"{x_sub},b{t_sub[1:]}->{out}"


def out_shape(spec: str, x: Tensor, table: Tensor,
              user_index: Tensor) -> tuple[int, ...]:
    """Validate operand ranks and shared dims; the output shape."""
    x_sub, t_sub, out_sub, _ = parse_spec(spec)
    if x.ndim != len(x_sub) or table.ndim != len(t_sub):
        raise ValueError(f"gather_einsum {spec!r}: operand ranks "
                         f"{tuple(x.shape)}/{tuple(table.shape)} do not match "
                         f"the spec")
    B = x.shape[0]
    if tuple(user_index.shape) != (B,):
        raise ValueError(f"user_index must be ({B},), got "
                         f"{tuple(user_index.shape)}")
    sizes = dict(zip(x_sub, x.shape))
    for c, s in zip(t_sub, table.shape):
        if sizes.setdefault(c, s) != s:
            raise ValueError(f"gather_einsum {spec!r}: dim {c!r} is "
                             f"{sizes[c]} on x but {s} on the table")
    return tuple(sizes[c] for c in out_sub)


def gather_einsum_plain(spec: str, x: Tensor, table: Tensor,
                        user_index: Tensor) -> Tensor:
    """Plain PyTorch version: an explicit clamped gather, then einsum."""
    _, _, _, row_spec = parse_spec(spec)
    return torch.einsum(row_spec, x, take_clip(table, user_index))


def _contiguous_strides(shape) -> list[int]:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return out[::-1]


def _merge(dims: list[tuple[int, ...]]) -> list[tuple[int, ...]]:
    """Adjacent (size, *strides) dims merged where the outer one steps over
    the inner one on every operand (its stride = the inner's times the
    inner's size, 0 = 0 included); size-1 dims dropped. The walk order of
    the merged dims is the unmerged one's."""
    out: list[tuple[int, ...]] = []
    for d in dims:
        if d[0] == 1:
            continue
        if out and all(a == b * d[0] for a, b in zip(out[-1][1:], d[1:])):
            out[-1] = (out[-1][0] * d[0],) + d[1:]
        else:
            out.append(d)
    return out


def generic_plan(spec: str, x_shape, t_shape) -> dict:
    """The generic route's plan of ``spec`` on contiguous operands of these
    shapes (the offsets the kernel walks, ``generic_tile``'s source): ``out``
    the output dims past b in the output's order, each ``(size, x stride,
    table stride, out stride)``; ``sum`` the summed dims (every dim not in
    the output, in order of first appearance in x then the table), each
    ``(size, x stride, table stride)``; a dim absent from an operand has
    stride 0 there; ``x_row`` / ``t_row`` / ``out_row`` the strides of b and
    u. Strides count elements. Raises ``ValueError`` past
    ``MAX_PLAN_DIMS`` dims of a role."""
    x_sub, t_sub, out_sub, _ = parse_spec(spec)
    sizes = dict(zip(x_sub, x_shape))
    sizes.update(zip(t_sub, t_shape))
    out_shape = [sizes[c] for c in out_sub]
    xs = dict(zip(x_sub, _contiguous_strides(x_shape)))
    ts = dict(zip(t_sub, _contiguous_strides(t_shape)))
    os_ = dict(zip(out_sub, _contiguous_strides(out_shape)))
    out = _merge([(sizes[c], xs.get(c, 0), ts.get(c, 0), os_[c])
                  for c in out_sub[1:]])
    summed = [c for c in dict.fromkeys(x_sub[1:] + t_sub[1:])
              if c not in out_sub]
    sm = _merge([(sizes[c], xs.get(c, 0), ts.get(c, 0)) for c in summed])
    if len(out) > MAX_PLAN_DIMS or len(sm) > MAX_PLAN_DIMS:
        raise ValueError(f"gather_einsum {spec!r}: {len(out)} output and "
                         f"{len(sm)} summed dims once merged, past the "
                         f"generic route's {MAX_PLAN_DIMS} of each")
    return dict(out=out, sum=sm, x_row=xs["b"], t_row=ts["u"],
                out_row=os_["b"])


_DIMS = ctypes.c_longlong * MAX_PLAN_DIMS


class GePlan(ctypes.Structure):
    """The plan the generic entries of commit 521130a took (one thread an
    output; ``tests/data/gather_einsum_521130a.cu``), field for field: what
    the ``compare`` tool and ``chip_smoke.py`` hand that build to time and
    hold the route against it."""
    _fields_ = [("n_out", ctypes.c_int), ("n_sum", ctypes.c_int),
                ("x_row", ctypes.c_longlong), ("t_row", ctypes.c_longlong),
                ("out_row", ctypes.c_longlong),
                ("out_count", ctypes.c_longlong),
                ("sum_count", ctypes.c_longlong),
                ("out_size", _DIMS), ("out_x", _DIMS), ("out_t", _DIMS),
                ("out_o", _DIMS), ("sum_size", _DIMS), ("sum_x", _DIMS),
                ("sum_t", _DIMS)]


def c_plan(plan: dict) -> GePlan:
    """``generic_plan``'s dict as commit 521130a's ``GePlan``."""
    p = GePlan(n_out=len(plan["out"]), n_sum=len(plan["sum"]),
               x_row=plan["x_row"], t_row=plan["t_row"],
               out_row=plan["out_row"],
               out_count=math.prod(d[0] for d in plan["out"]),
               sum_count=math.prod(d[0] for d in plan["sum"]))
    for i, d in enumerate(plan["out"]):
        p.out_size[i], p.out_x[i], p.out_t[i], p.out_o[i] = d
    for i, d in enumerate(plan["sum"]):
        p.sum_size[i], p.sum_x[i], p.sum_t[i] = d
    return p


def generic_roles(spec: str, x_shape, t_shape) -> dict:
    """The role of each dim of ``generic_plan`` (merged dims, each as the
    plan has it), read off its zero strides: output dims ``S`` (in x and
    the table), ``M`` (x only), ``N`` (the table only); summed dims ``K``
    (both), ``Kx`` (x only), ``Kt`` (the table only)."""
    plan = generic_plan(spec, x_shape, t_shape)
    out, sm = plan["out"], plan["sum"]
    return dict(S=[d for d in out if d[1] and d[2]],
                M=[d for d in out if d[1] and not d[2]],
                N=[d for d in out if not d[1]],
                K=[d for d in sm if d[1] and d[2]],
                Kx=[d for d in sm if d[1] and not d[2]],
                Kt=[d for d in sm if not d[1]])


# the generic kernel's constants (csrc GT_*, THREADS); layouts by kind
GT_USERS, GT_ROWS, GT_GROUPED = 0, 1, 2
GT_MODES = ("users", "rows", "grouped")
GT_KINDS = ("P", "W staged", "flat", "W resident")
GT_THREADS, GT_RR, GT_EE, GT_MAX_KC = 256, 8, 4, 1024
GT_MAX_SMEM = 232448
# the staged W layout: x rows and the slice of a stage, aimed at
GT_STAGE_BYTES = 40 * 1024
# products (B x outputs a row x summed values) from which rows are grouped
# by user, so a staged table value feeds 8 rows from a register
GT_HEAVY = 1 << 26
# blocks aimed at an SM: walking direct steps, and where rows are grouped
GT_BLOCKS, GT_GROUP_BLOCKS = 4, 2
# the P layout (csrc GT_NS, GT_P_TRES): stages in its ring; A rows a step
# where rows are many (two consumer warps) and a step's x stays within
# GT_P_STEP_BYTES; every user's table kept where it is at most GT_P_TRES
GT_NS, GT_P_ROWS, GT_P_STEP_BYTES, GT_P_TRES = 4, 64, 10 * 1024, 48 * 1024
# the resident W layout's slices at most this (judged at 4 bytes a value)
GT_RES_BYTES = 64 * 1024
# sums this short take the staged W layout where rows are grouped (one
# chunk, no barrier inside a step's sum)
GT_W_ONE_CHUNK = 32
# the flat layout: a tabled summed walk of at most GT_MAX_FLAT values (csrc
# GT_MAX_FLAT), a sum this short whatever its reads, blocks an SM at most;
# sums of at most GT_FLAT_V4 values take four outputs a thread and are
# flat even where every user's slices would fit (csrc GT_FLAT_V4)
GT_MAX_FLAT, GT_FLAT_K, GT_FLAT_BLOCKS, GT_FLAT_V4 = 8192, 32, 8, 4


class GeTile(ctypes.Structure):
    """``csrc/gather_einsum.cu``'s ``GeTile``, field for field."""
    _fields_ = ([(f, ctypes.c_int) for f in (
        "n_a", "n_g", "n_n", "n_k", "mode", "kind", "ln", "ta", "kc", "nr",
        "a_blk", "grid", "w32", "flags")]
        + [(f, ctypes.c_longlong) for f in (
            "x_row", "t_row", "out_row", "a_count", "g_count", "n_count",
            "k_count")]
        + [(f, _DIMS) for f in (
            "a_size", "a_x", "a_t", "a_o", "g_size", "g_x", "g_t", "g_o",
            "n_size", "n_t", "n_o", "k_size", "k_x", "k_t")]
        + [("mul", (ctypes.c_uint * MAX_PLAN_DIMS) * 5),
           ("shr", (ctypes.c_int * MAX_PLAN_DIMS) * 5)])


def magic(d: int) -> tuple[int, int]:
    """(mul, shr) with n // d == (n * mul >> 32) >> shr for n, d below
    2^31 (CUTLASS's FastDivmod rule); (0, 0) for d = 1."""
    if d <= 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()
    return ((1 << p) + d - 1) // d, p - 32


def _gt_kcp(kc: int, esize: int) -> int:
    return kc + ((12 - kc % 8) % 8 if esize == 4 else (24 - kc % 16) % 16)


# csrc GT_X_RUN, ...: the summed walk steps by one value in x, in the
# table; stays on one x value; consecutive A rows' x lie back to back; so
# do the users' table slices
GT_X_RUN, GT_T_RUN, GT_X_ONE, GT_X_ROWS, GT_T_ROWS = 1, 2, 4, 8, 16


def _run(dims, i, stride=1) -> int:
    """The extent of the row-major walk of ``dims`` where its offsets in
    stride list ``i`` step by ``stride`` from 0, else 0."""
    for d in reversed(dims):
        if d[i] != stride:
            return 0
        stride *= d[0]
    return stride


def _walk_flags(plan, a_list) -> int:
    k_dims = plan["sum"]
    k = math.prod(d[0] for d in k_dims)
    one = bool(k_dims) and all(d[1] == 0 for d in k_dims)
    f = ((GT_X_RUN if _run(k_dims, 1) else 0)
         | (GT_T_RUN if _run(k_dims, 2) else 0) | (GT_X_ONE if one else 0))
    per_row = 1 if one else k if f & GT_X_RUN else 0
    if per_row and _run(a_list, 1, per_row) == plan["x_row"]:
        f |= GT_X_ROWS
    if f & GT_T_RUN and plan["t_row"] == k:
        f |= GT_T_ROWS
    return f


def gt_smem_bytes(t: dict, U: int, esize: int, k_count: int,
                  t_row: int) -> int:
    """The kernel's dynamic shared memory at tiling ``t`` (csrc
    ``gt_smem``, ``gt_pw_bytes``, ``gt_res_bytes``)."""
    up = lambda n: (n + 15) // 16 * 16
    cols = GT_EE * t["ln"]
    kcp = _gt_kcp(t["kc"], esize)
    if t["kind"] == 0:      # csrc gt_p_layout
        slabs = U if t["mode"] == GT_USERS else t["ta"]
        f, whole = t["flags"], k_count <= t["kc"]
        one = f & GT_X_ONE
        xpack = (whole and f & GT_X_ROWS and t["mode"] != GT_GROUPED
                 and (one or k_count % 4 == 0))
        tpack = (whole and f & GT_T_ROWS and t["mode"] == GT_USERS
                 and k_count % 4 == 0)
        xrow = ((1 if xpack else 16 // esize) if one
                else k_count if xpack else kcp)
        tstride = k_count if tpack else kcp
        tres = (t["mode"] == GT_USERS and U * t_row * esize <= GT_P_TRES
                and (t_row % 4 == 0 or not f & GT_T_RUN))
        tcopy = 4 * t["kc"] if tres else slabs * tstride * esize
        stage = up(up(t["ta"] * xrow * esize) + tcopy) + 16 * t["ta"]
        return (16 * (GT_NS + 1) + (up(U * t_row * esize) if tres else 0)
                + GT_NS * stage + 28 * t["ta"] + 16 * t["kc"])
    if t["kind"] == 3:
        slabs = U if t["mode"] == GT_USERS else 1
        return (up(slabs * k_count * cols * esize) + 16 * cols
                + (16 * k_count if t["n_k"] > 1 else 0))
    # the staged W layout (csrc gt_smem): one user's slice a stage
    return (up(2 * t["ta"] * kcp * esize) + up(2 * t["kc"] * cols * esize)
            + 2 * up(16 * t["ta"]) + 2 * up(16 * t["kc"]) + 2 * up(8 * cols))


def _pick_ln(n: int) -> int:
    """Lanes along the columns: the fewest whose one tile holds all ``n``
    columns (a row's outputs in one block), else the most whose padded
    columns stay within a tenth of the fewest."""
    if n <= 4 * 32:
        return next(ln for ln in (8, 16, 32) if 4 * ln >= n)
    pad = {ln: -(-n // (4 * ln)) * 4 * ln for ln in (8, 16, 32)}
    return max(ln for ln in pad if pad[ln] <= 1.1 * min(pad.values()))


@functools.lru_cache(maxsize=256)
def generic_tile(spec: str, x_shape: tuple, t_shape: tuple, esize: int = 4,
                 sms: int = 132) -> tuple[GeTile, dict]:
    """The generic route's tiling of ``spec`` at these shapes, for operands
    of ``esize`` bytes on a card of ``sms`` SMs (csrc ``GeTile``; the note
    there). Where N is empty: the flat layout for light calls with short or
    coalescing sums, else P on warps, staging every user's table slices
    (USERS: no S, at most a warp's rows of users) or one an A row (ROWS).
    Where N is not: the flat layout for a light call whose users' slices do
    not fit, else W with its slices resident: every user's (USERS: no S,
    the slices fit, the call light, of one user or its A rows shared by 8
    of a user) or one user's, rows sorted by user (GROUPED); W staged a
    chunk at a time where even one user's slices do not fit. Returns the
    struct and the same as a dict."""
    plan = generic_plan(spec, x_shape, t_shape)
    B, U = x_shape[0], t_shape[0]
    prod = lambda ds: math.prod(d[0] for d in ds)
    n_dims = [d for d in plan["out"] if not d[1]]
    a_dims = [d for d in plan["out"] if d[1]]
    s_dims = [d for d in a_dims if d[2]]
    m_count = prod([d for d in a_dims if not d[2]])
    k_dims = plan["sum"]
    n_count, k_count = prod(n_dims), prod(k_dims)
    out_count = prod(plan["out"])
    heavy = B * out_count * k_count >= GT_HEAVY
    t = dict(nr=0, a_blk=0, grid=0, B=B, n_k=len(k_dims),
             flags=_walk_flags(plan, a_dims))
    ln = _pick_ln(n_count) if n_dims else 1
    cols = GT_EE * ln
    # judged at 4 bytes a value, so fp32 and bf16 take one layout
    res = lambda slabs: slabs * k_count * cols * 4 <= GT_RES_BYTES
    users = (bool(n_dims) and not s_dims and res(U)
             and (U == 1 or m_count >= GT_RR or not heavy))
    # the flat layout: light calls whose offsets fit 32 bits (and whose
    # summed walk of several dims fits its table), where a warp's reads at
    # one k coalesce or broadcast (the innermost output dim steps 0 or 1 in
    # both operands), the sum is short, or it stays on one x value (each
    # thread then streams one table run, which L1 serves)
    inner = plan["out"][-1][1:3] if plan["out"] else (plan["x_row"], 1)
    fits = (B * out_count < 2 ** 31 and B * plan["x_row"] < 2 ** 31
            and U * plan["t_row"] < 2 ** 31
            and (len(k_dims) < 2 or k_count <= GT_MAX_FLAT))
    if (fits and not heavy and (not users or k_count <= GT_FLAT_V4)
            and (k_count <= GT_FLAT_K or set(inner) <= {0, 1}
                 or (not n_dims and t["flags"] & GT_X_ONE))):
        # outputs a thread (csrc): four where the sum is this short
        v = 4 if out_count % 4 == 0 and k_count <= GT_FLAT_V4 else 1
        t.update(kind=2, mode=GT_ROWS, ln=1, ta=1, kc=1,
                 grid=min(-(-B * out_count // (v * GT_THREADS)),
                          GT_FLAT_BLOCKS * sms))
        c = _c_tile(plan, t, plan["out"], [], [], k_dims)
        t["smem"] = 8 * k_count if len(k_dims) > 1 else 0
        del t["B"], t["n_k"]
        return c, dict(t, mode="flat", layout=GT_KINDS[2])
    if n_dims:
        t.update(ln=ln, ta=GT_RR * GT_THREADS // ln, kc=1,
                 mode=GT_USERS if users else GT_GROUPED)
        # resident slices, but a grouped sum of one staged chunk stages
        t["kind"] = 3 if users or (res(1) and k_count > GT_W_ONE_CHUNK) else 1
    else:
        rows = B * prod(a_dims)
        # steps of about GT_P_STEP_BYTES of x (32 or 64 rows: one or two
        # consumer warps) where there are three blocks' worth an SM, else 32
        # rows and one block an SM; blocks walk the steps
        ta = 32
        if (rows >= GT_P_ROWS * 3 * sms
                and k_count * esize * GT_P_ROWS <= GT_P_STEP_BYTES):
            ta = GT_P_ROWS
        blocks = 3 if rows >= GT_P_ROWS * 3 * sms else 1
        t.update(kind=0, ln=1, ta=ta,
                 mode=(GT_USERS if not s_dims and U <= ta else GT_ROWS),
                 grid=min(-(-rows // ta), GT_BLOCKS * sms))
        slabs = U if t["mode"] == GT_USERS else ta
        xrows = 0 if t["flags"] & GT_X_ONE else ta
        stage = (GT_MAX_SMEM // blocks - 64 * ta - 16 * GT_MAX_KC) // GT_NS
        kc = stage // ((xrows + slabs) * esize) - 16   # less a row's padding
        t["kc"] = min(max(kc // 8 * 8, 8), GT_MAX_KC)
        # the whole walk in one stage where its rows pack (one copy a step),
        # at up to twice the stage
        if (t["flags"] & (GT_X_ROWS | GT_T_ROWS) and k_count % 4 == 0
                and k_count * (xrows + slabs) * esize <= 2 * stage):
            t["kc"] = max(t["kc"], k_count)
    if t["kind"] in (0, 1) and k_count <= t["kc"]:
        t["kc"] = max(k_count, 1)
    if t["kind"] == 1:
        kc = GT_STAGE_BYTES // ((t["ta"] + cols) * esize) // 4 * 4
        t["kc"] = max(1, min(max(kc, 4), GT_MAX_KC, k_count))
    grouped = t["mode"] == GT_GROUPED
    a_list = [d for d in a_dims if not d[2]] if grouped else a_dims
    g_list = s_dims if grouped else []
    if grouped:
        a_count, g_count = prod(a_list), prod(g_list)
        t["a_blk"] = min(a_count, 4 * t["ta"])
        per_tile = (g_count * -(-a_count // t["a_blk"])
                    * -(-n_count // cols))
        want = -(-GT_GROUP_BLOCKS * sms // per_tile)
        step_rows = max(1, t["ta"] // t["a_blk"])
        nr = min(max(step_rows, -(-B // want)),
                 max(step_rows, 16 * t["ta"] // t["a_blk"]))
        t["nr"] = -(-nr // step_rows) * step_rows
    elif t["kind"] != 0:    # blocks walking many steps: two an SM
        t["grid"] = 2 * sms
    while (gt_smem_bytes(t, U, esize, k_count, plan["t_row"]) > GT_MAX_SMEM
           and t["kc"] > 1):
        t["kc"] = max(1, t["kc"] // 2)
    c = _c_tile(plan, t, a_list, g_list, n_dims, k_dims)
    t["smem"] = gt_smem_bytes(t, U, esize, k_count, plan["t_row"])
    del t["B"], t["n_k"]
    return c, dict(t, mode=GT_MODES[t["mode"]], layout=GT_KINDS[t["kind"]])


def _c_tile(plan, t, a_list, g_list, n_dims, k_dims) -> GeTile:
    prod = lambda ds: math.prod(d[0] for d in ds)
    t["flags"] = _walk_flags(plan, a_list)
    c = GeTile(n_a=len(a_list), n_g=len(g_list), n_n=len(n_dims),
               n_k=len(k_dims), x_row=plan["x_row"], t_row=plan["t_row"],
               out_row=plan["out_row"], a_count=prod(a_list),
               g_count=prod(g_list), n_count=prod(n_dims),
               k_count=prod(k_dims),
               **{f: t[f] for f in ("mode", "kind", "ln", "ta", "kc", "nr",
                                    "a_blk", "grid", "flags")})
    for i, d in enumerate(a_list):
        c.a_size[i], c.a_x[i], c.a_t[i], c.a_o[i] = d
    for i, d in enumerate(g_list):
        c.g_size[i], c.g_x[i], c.g_t[i], c.g_o[i] = d
    for i, d in enumerate(n_dims):
        c.n_size[i], c.n_t[i], c.n_o[i] = d[0], d[2], d[3]
    for i, d in enumerate(k_dims):
        c.k_size[i], c.k_x[i], c.k_t[i] = d
    for li, dims in enumerate((a_list, g_list, n_dims, k_dims,
                               [(c.a_count,)])):
        for i, d in enumerate(dims):
            c.mul[li][i], c.shr[li][i] = magic(d[0])
    c.w32 = int(max(c.a_count * t["B"], c.g_count, c.n_count, c.k_count,
                    t["nr"] * c.a_count) < 2 ** 31)
    return c


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])
_GENERIC = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
_TC = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
_SIGNATURES = {"gather_einsum_f32": (_ARGTYPES, ctypes.c_int),
               "gather_einsum_bf16": (_ARGTYPES, ctypes.c_int),
               "gather_einsum_q_t_work_bytes": ([ctypes.c_int] * 3,
                                                ctypes.c_long),
               "gather_einsum_q_t_tc_f32": (_TC, ctypes.c_int),
               "gather_einsum_generic_f32": (_GENERIC, ctypes.c_int),
               "gather_einsum_generic_bf16": (_GENERIC, ctypes.c_int),
               "gather_einsum_generic_work_bytes": (
                   [ctypes.c_int] * 2 + [ctypes.c_void_p], ctypes.c_long)}


def _lib(defines=()) -> ctypes.CDLL:
    """The kernel's library; ``defines`` name a variant build (``build``)."""
    return build.load("gather_einsum", defines, _SIGNATURES)


def _launch(spec: str, x: Tensor, table: Tensor, user_index: Tensor,
            shape: tuple[int, ...]) -> Tensor:
    build.refuse_autograd(f"gather_einsum {spec!r}", x, table)
    for name, t in (("table", table), ("user_index", user_index)):
        if t.device != x.device:
            raise ValueError(f"gather_einsum: {name} on {t.device}, x on "
                             f"{x.device}")
    dtype = build.one_dtype("gather_einsum", x=x, table=table)
    x, table = x.contiguous(), table.contiguous()
    idx = user_index.to(torch.int32).contiguous()
    out = torch.empty(shape, dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out                        # nothing to launch
    lib = _lib()
    bf16 = dtype == torch.bfloat16
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if spec not in KERNEL_SPECS:
        tile, _ = generic_tile(spec, tuple(x.shape), tuple(table.shape),
                               x.element_size(), _sms(x.device.index))
        B, U = x.shape[0], table.shape[0]
        nwork = lib.gather_einsum_generic_work_bytes(B, U,
                                                     ctypes.byref(tile))
        work = (torch.empty(nwork, dtype=torch.uint8, device=x.device)
                if nwork > 0 else None)
        entry = (lib.gather_einsum_generic_bf16 if bf16
                 else lib.gather_einsum_generic_f32)
        with torch.cuda.device(x.device):
            rc = entry(x.data_ptr(), table.data_ptr(), idx.data_ptr(),
                       out.data_ptr(), B, U, ctypes.byref(tile),
                       None if work is None else work.data_ptr(), stream)
        build.check(lib, rc, f"gather_einsum {spec!r}")
        build.count_launch(LAUNCHES, "generic/bf16" if bf16 else "generic")
        return out
    if spec == "bd,uldh->blh" and not bf16:
        U, L, D, H = table.shape
        nwork = lib.gather_einsum_q_t_work_bytes(x.shape[0], U, D)
        if nwork > 0:                     # past D = 40: the tensor cores
            work = torch.empty(nwork, dtype=torch.uint8, device=x.device)
            with torch.cuda.device(x.device):
                rc = lib.gather_einsum_q_t_tc_f32(
                    x.data_ptr(), table.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), x.shape[0], U, L, D, H, work.data_ptr(),
                    stream)
            build.check(lib, rc, f"gather_einsum {spec!r}")
            build.count_launch(LAUNCHES, TC_KEY)
            return out
    dims = list(table.shape[1:]) + [0] * (4 - table.ndim)
    if spec == "blh,uh->bl":
        dims[1] = x.shape[1]            # the kernel also needs L
    entry = lib.gather_einsum_bf16 if bf16 else lib.gather_einsum_f32
    with torch.cuda.device(x.device):    # launch in the tensors' context
        rc = entry(KERNEL_SPECS.index(spec), x.data_ptr(), table.data_ptr(),
                   idx.data_ptr(), out.data_ptr(), x.shape[0], table.shape[0],
                   *dims, stream)
    build.check(lib, rc, f"gather_einsum {spec!r}")
    build.count_launch(LAUNCHES, f"{spec}/bf16" if bf16 else spec)
    return out


@shard_local("gather_einsum", rows=("x", "user_index"))
def gather_einsum(spec: str, x: Tensor, table: Tensor,
                  user_index: Tensor) -> Tensor:
    """``einsum(spec, x, table[clamp(user_index)])``, gather fused into the
    kernel on CUDA."""
    shape = out_shape(spec, x, table, user_index)
    if x.device.type == "cpu":
        return gather_einsum_plain(spec, x, table, user_index)
    if x.device.type != "cuda":
        raise ValueError(f"gather_einsum: unsupported device {x.device}")
    return _launch(spec, x, table, user_index, shape)
