"""Gather-aware einsum: the CUDA kernel's wrapper, its plain PyTorch
version, and ``parse_spec`` (port of ``repro.kernels.gather_einsum``).

``gather_einsum(spec, x, table, user_index)`` computes
``einsum(spec, x, table[clamp(user_index)])`` for specs of the form
``"b...,u...->b..."``. A CPU tensor goes to ``gather_einsum_plain`` (any
spec ``parse_spec`` accepts). A CUDA tensor launches
``csrc/gather_einsum.cu`` — the gathered ``(B, ...)`` operand never
materializes — in fp32 or bf16 (f32 products and sums, the output in
bf16): the three ``KERNEL_SPECS`` on their own routes, and every other
spec on the generic route, which walks the ``generic_plan`` of the spec
and the shapes (one thread an output element). In bf16, ``bl,uld->bd``,
``blh,uh->bl`` and the generic route give the fp32 kernel's result on
the widened operands, rounded once; ``bd,uldh->blh`` runs on the bf16
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
    shapes (the kernel's index arithmetic, ``csrc`` ``GePlan``): ``out``
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
    """``csrc/gather_einsum.cu``'s ``GePlan``, field for field."""
    _fields_ = [("n_out", ctypes.c_int), ("n_sum", ctypes.c_int),
                ("x_row", ctypes.c_longlong), ("t_row", ctypes.c_longlong),
                ("out_row", ctypes.c_longlong),
                ("out_count", ctypes.c_longlong),
                ("sum_count", ctypes.c_longlong),
                ("out_size", _DIMS), ("out_x", _DIMS), ("out_t", _DIMS),
                ("out_o", _DIMS), ("sum_size", _DIMS), ("sum_x", _DIMS),
                ("sum_t", _DIMS)]


def _c_plan(plan: dict) -> GePlan:
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


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])
_GENERIC = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
_TC = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
_SIGNATURES = {"gather_einsum_f32": (_ARGTYPES, ctypes.c_int),
               "gather_einsum_bf16": (_ARGTYPES, ctypes.c_int),
               "gather_einsum_q_t_work_bytes": ([ctypes.c_int] * 3,
                                                ctypes.c_long),
               "gather_einsum_q_t_tc_f32": (_TC, ctypes.c_int),
               "gather_einsum_generic_f32": (_GENERIC, ctypes.c_int),
               "gather_einsum_generic_bf16": (_GENERIC, ctypes.c_int)}


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
        plan = _c_plan(generic_plan(spec, x.shape, table.shape))
        entry = (lib.gather_einsum_generic_bf16 if bf16
                 else lib.gather_einsum_generic_f32)
        with torch.cuda.device(x.device):
            rc = entry(x.data_ptr(), table.data_ptr(), idx.data_ptr(),
                       out.data_ptr(), x.shape[0], table.shape[0],
                       ctypes.byref(plan), stream)
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
