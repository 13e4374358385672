"""Gather-aware einsum: the CUDA kernel's wrapper, its plain PyTorch
version, and ``parse_spec`` (port of ``repro.kernels.gather_einsum``).

``gather_einsum(spec, x, table, user_index)`` computes
``einsum(spec, x, table[clamp(user_index)])`` for specs of the form
``"b...,u...->b..."``. A CPU tensor goes to ``gather_einsum_plain`` (any
spec ``parse_spec`` accepts). A CUDA tensor launches
``csrc/gather_einsum.cu`` for the three ``KERNEL_SPECS`` — the gathered
``(B, ...)`` operand never materializes — in fp32 or bf16 (f32 products
and sums, the output in bf16), and raises ``NotImplementedError`` for any
other spec. In bf16, ``bl,uld->bd`` and ``blh,uh->bl`` give the fp32
kernel's result on the widened operands, rounded once; ``bd,uldh->blh``
runs on the bf16 tensor cores, its f32 sums in the ``mma``'s order.
``LAUNCHES`` counts kernel launches per spec, fp32 under the spec and bf16
under ``<spec>/bf16``.

Index contract (shared with ``mari_matmul``'s gather init): ``user_index``
is ``(B,)`` integer, row ``b`` reads ``table[user_index[b]]``, and
out-of-range values clamp to ``[0, U-1]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common import take_clip
from repro_torch.dist.sharding import shard_local
from repro_torch.kernels import build

Tensor = torch.Tensor

# the decomposed-attention contractions, in csrc Spec enum order
KERNEL_SPECS = ("bd,uldh->blh", "bl,uld->bd", "blh,uh->bl")

# kernel launches per spec (one per launch, counted nowhere else)
LAUNCHES = dict.fromkeys(KERNEL_SPECS
                         + tuple(f"{s}/bf16" for s in KERNEL_SPECS), 0)


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


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])
_SIGNATURES = {"gather_einsum_f32": (_ARGTYPES, ctypes.c_int),
               "gather_einsum_bf16": (_ARGTYPES, ctypes.c_int)}


def _lib(defines=()) -> ctypes.CDLL:
    """The kernel's library; ``defines`` name a variant build (``build``)."""
    return build.load("gather_einsum", defines, _SIGNATURES)


def _launch(spec: str, x: Tensor, table: Tensor, user_index: Tensor,
            shape: tuple[int, ...]) -> Tensor:
    build.refuse_autograd(f"gather_einsum {spec!r}", x, table)
    if spec not in KERNEL_SPECS:
        raise NotImplementedError(
            f"gather_einsum: the CUDA kernel covers {KERNEL_SPECS}, not "
            f"{spec!r}")
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
    dims = list(table.shape[1:]) + [0] * (4 - table.ndim)
    if spec == "blh,uh->bl":
        dims[1] = x.shape[1]            # the kernel also needs L
    lib = _lib()
    bf16 = dtype == torch.bfloat16
    entry = lib.gather_einsum_bf16 if bf16 else lib.gather_einsum_f32
    with torch.cuda.device(x.device):    # launch in the tensors' context
        rc = entry(KERNEL_SPECS.index(spec), x.data_ptr(), table.data_ptr(),
                   idx.data_ptr(), out.data_ptr(), x.shape[0], table.shape[0],
                   *dims, torch.cuda.current_stream(x.device).cuda_stream)
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
