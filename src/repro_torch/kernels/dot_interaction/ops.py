"""DLRM dot interaction: the CUDA kernel's wrapper and its plain PyTorch
version (port of ``repro.kernels.dot_interaction``).

``dot_interaction(x, keep_self=False)`` maps x (B, F, D) to the (B, P)
upper triangle of each row's F x F gram, in ``torch.triu_indices`` order
(offset 1, or 0 with ``keep_self``). A CPU tensor goes to
``dot_interaction_plain``; a CUDA tensor launches
``csrc/dot_interaction.cu`` or raises. The reference's batch padding to a
multiple of its tile is gone: persistent blocks walk the rows, a producer
warp copying them into shared-memory slots while consumer warps compute
earlier ones, a lane per 4 x 4 tile of the gram. ``copy_route`` picks the
kernel's instance: for fp32 one TMA copy per row where x is 16-byte
aligned, D % 32 == 0 and F <= 256, 4-byte ``cp.async`` otherwise; bf16 x
(f32 products and sums, the output in bf16) is widened to fp32 by the
producer as it copies. ``LAUNCHES`` counts kernel launches per triangle
variant in fp32, and every bf16 launch under ``bf16``.
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
               slots_per_warp: int = 1) -> int:
    """Shared memory of one block (``csrc/dot_interaction.cu`` ``Plan``):
    two mbarriers per slot and a staging row of ceil4(P) floats per
    consumer warp (together rounded up to 1024 bytes), the 1024-byte
    aligned slots of ceil(D / 32) chunks of F rows of 128 bytes (and 3
    rows that padding features read), and up to 1008 bytes to align them.
    The kernel's plans take 7 consumers of 2 slots or 11 of 1, as many as
    fit; one consumer of one slot is the smallest plan, which decides what
    it refuses."""
    def up(n, k):
        return -(-n // k) * k
    slots = consumers * slots_per_warp
    head = up(16 * slots + 4 * consumers * up(n_pairs(f, keep_self), 4),
              1024)
    return head + slots * up((-(-d // 32) * f + 3) * 128, 1024) + 1008


def copy_route(x: Tensor) -> str:
    """The kernel instance x takes: for fp32 ``"tma"`` (one TMA copy per
    row, with the 128-byte swizzle) where D % 32 == 0, F <= 256 and x
    starts 16-byte aligned, else ``"cp.async"`` (4-byte copies into the
    same layout); for bf16 ``"widen"`` (the producer's loads, widened)."""
    _, f, d = x.shape
    if x.dtype == torch.bfloat16:
        return "widen"
    aligned = d % 32 == 0 and f <= 256 and x.data_ptr() % 16 == 0
    return "tma" if aligned else "cp.async"


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
    "dot_interaction_bf16": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                             + [ctypes.c_void_p], ctypes.c_int),
}


def _lib(defines=()) -> ctypes.CDLL:
    return build.load("dot_interaction", defines, _SIGNATURES)


def _launch(x: Tensor, keep_self: bool) -> Tensor:
    build.refuse_autograd("dot_interaction", x)
    dtype = build.one_dtype("dot_interaction", x=x)
    B, F, D = x.shape
    need = smem_bytes(F, D, keep_self)
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):    # launch in the tensor's context
        if dtype == torch.float32:
            rc = lib.dot_interaction_f32(
                x.data_ptr(), out.data_ptr(), B, F, D, int(keep_self),
                int(copy_route(x) == "tma"), stream)
        else:
            rc = lib.dot_interaction_bf16(x.data_ptr(), out.data_ptr(), B, F,
                                          D, int(keep_self), stream)
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
