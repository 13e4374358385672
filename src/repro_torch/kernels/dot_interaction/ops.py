"""DLRM dot interaction: the CUDA kernel's wrapper and its plain PyTorch
version (port of ``repro.kernels.dot_interaction``).

``dot_interaction(x, keep_self=False)`` maps x (B, F, D) to the (B, P)
upper triangle of each row's F x F gram, in ``torch.triu_indices`` order
(offset 1, or 0 with ``keep_self``). A CPU tensor goes to
``dot_interaction_plain``; a CUDA tensor launches
``csrc/dot_interaction.cu`` or raises. The reference's batch padding to a
multiple of its tile is gone: persistent blocks walk the rows, a producer
warp copying them into shared-memory slots while consumer warps compute
earlier ones: in fp32 a lane per 4 x 4 tile of the gram, in bf16 (exact
products and f32 sums, the output in bf16) ``mma.sync`` on the bf16
tensor cores over the m16 x n8 tiles that touch the triangle.
``copy_route`` picks the kernel's instance: one TMA copy per row where x
is 16-byte aligned, F <= 256 and D % 32 == 0 (fp32) or D % 64 == 0
(bf16); ``cp.async`` otherwise (bf16: where D is even and x 4-byte
aligned); for the bf16 rows left, the producer's own 2-byte copies.
``LAUNCHES`` counts kernel launches per triangle variant in fp32, and
every bf16 launch under ``bf16``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.dist.sharding import shard_local
from repro_torch.kernels import build

Tensor = torch.Tensor

VARIANTS = ("triu", "triu_keep_self")
# kernel launches per variant (one per launch, counted nowhere else)
LAUNCHES = dict.fromkeys(VARIANTS + ("bf16",), 0)

MAX_SMEM_BYTES = 232448          # a Hopper block's dynamic shared memory


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def n_pairs(f: int, keep_self: bool = False) -> int:
    return f * (f + 1) // 2 if keep_self else f * (f - 1) // 2


def smem_bytes(f: int, d: int, keep_self: bool = False, consumers: int = 1,
               slots_per_warp: int = 1,
               dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one block (``csrc/dot_interaction.cu`` ``Plan``):
    two mbarriers per slot and a staging row of P elements per consumer
    warp, rounded up to 16 bytes (together rounded up to 1024 bytes), the
    1024-byte aligned slots of ceil(D / (128 / esize)) chunks of F rows of
    128 bytes (fp32 adds 3 rows that padding features read; bf16 clamps
    its padding rows), and up to 1008 bytes to align them. The kernel's
    plans take, as many as fit, 7 consumers of 2 slots or 11 of 1 (fp32),
    or a consumer per row of the block up to 15, of 2 slots past 15 rows
    (bf16); one consumer of one slot is the smallest plan, which decides
    what it refuses."""
    def up(n, k):
        return -(-n // k) * k
    esize = 2 if dtype == torch.bfloat16 else 4
    slots = consumers * slots_per_warp
    stage = esize * up(n_pairs(f, keep_self), 16 // esize)
    head = up(16 * slots + consumers * stage, 1024)
    rows = -(-d // (128 // esize)) * f + (3 if esize == 4 else 0)
    return head + slots * up(rows * 128, 1024) + 1008


ROUTES = ("tma", "cp.async", "sync")     # the C entries' route numbers


def copy_route(x: Tensor) -> str:
    """The kernel instance x takes: ``"tma"`` (one TMA copy per row, with
    the 128-byte swizzle) where F <= 256, x starts 16-byte aligned and
    D % 32 == 0 (fp32) or D % 64 == 0 (bf16); else ``"cp.async"`` into the
    same layout (fp32: 4-byte copies, any view; bf16: 16- or 4-byte copies,
    where D is even and x 4-byte aligned); else (bf16: an odd D, a view 2
    bytes past alignment) ``"sync"``, the producer warp's own 2-byte loads
    and shared-memory stores."""
    _, f, d = x.shape
    ptr = x.data_ptr()
    bf16 = x.dtype == torch.bfloat16
    if d % (64 if bf16 else 32) == 0 and f <= 256 and ptr % 16 == 0:
        return "tma"
    if not bf16 or (d % 2 == 0 and ptr % 4 == 0):
        return "cp.async"
    return "sync"


def dot_interaction_plain(x: Tensor, keep_self: bool = False) -> Tensor:
    """Plain PyTorch version: x (..., F, D) -> (..., P) triangle dots."""
    f = x.shape[-2]
    z = torch.einsum("...fd,...gd->...fg", x, x)
    iu, ju = torch.triu_indices(f, f, offset=0 if keep_self else 1,
                                device=x.device)
    return z[..., iu, ju]


_SIGNATURES = {
    "dot_interaction_f32": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                            + [ctypes.c_void_p], ctypes.c_int),
    "dot_interaction_bf16": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                             + [ctypes.c_void_p], ctypes.c_int),
}


def _lib(defines=()) -> ctypes.CDLL:
    return build.load("dot_interaction", defines, _SIGNATURES)


def _launch(x: Tensor, keep_self: bool) -> Tensor:
    build.refuse_autograd("dot_interaction", x)
    dtype = build.one_dtype("dot_interaction", x=x)
    B, F, D = x.shape
    need = smem_bytes(F, D, keep_self, dtype=dtype)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"dot_interaction: one row of x (F={F}, D={D}) "
                         f"needs {need} bytes of shared memory, more than "
                         f"a block's {MAX_SMEM_BYTES}")
    P = n_pairs(F, keep_self)
    out = torch.empty((B, P), dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out                        # nothing to launch
    if D == 0:
        return out.zero_()
    # stack_features' output may be a view over expanded inputs
    x = x.contiguous()
    lib = _lib()
    route = ROUTES.index(copy_route(x))
    entry = (lib.dot_interaction_f32 if dtype == torch.float32
             else lib.dot_interaction_bf16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):    # launch in the tensor's context
        # fp32's flag is tma = 1 / 0: route 0 / 1
        rc = entry(x.data_ptr(), out.data_ptr(), B, F, D, int(keep_self),
                   int(route == 0) if dtype == torch.float32 else route,
                   stream)
    build.check(lib, rc, "dot_interaction")
    build.count_launch(LAUNCHES, VARIANTS[int(keep_self)]
                       if dtype == torch.float32 else "bf16")
    return out


@shard_local("dot_interaction", rows=("x",))
def dot_interaction(x: Tensor, keep_self: bool = False) -> Tensor:
    """x (B, F, D) -> (B, P) upper-triangle pairwise dots (DLRM)."""
    if x.ndim != 3:
        raise ValueError(f"dot_interaction takes (B, F, D), got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return dot_interaction_plain(x, keep_self)
    if x.device.type != "cuda":
        raise ValueError(f"dot_interaction: unsupported device {x.device}")
    return _launch(x, keep_self)
