"""DIN target attention over one shared key block: the CUDA kernel's
wrapper and its plain PyTorch version (port of
``repro.kernels.din_attention``).

``din_attention(query, keys, mask, w1, b1, w2, b2, w3, b3)`` takes query
(B, D), keys (L, D) shared by every row, mask (L,) and the unit's MLP
4D -> h1 -> h2 -> 1, and returns the (B, D) pooled interest. A CPU tensor
goes to ``din_attention_plain``; a CUDA tensor launches
``csrc/din_attention.cu`` or raises. The reference's batch padding to a
multiple of its tile is gone: the kernel guards its last rows.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.dist.sharding import shard_local
from repro_torch.kernels import build
from repro_torch.nn.attention import NEG_INF

Tensor = torch.Tensor

# kernel launches (one per launch, counted nowhere else)
LAUNCHES = {"shared_keys": 0}

MAX_SMEM_BYTES = 232448          # a Hopper block's dynamic shared memory


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _shape_error(query, keys, mask, w1, b1, w2, b2, w3, b3) -> str | None:
    """Why the tensors do not form one unit over a shared key block, or
    None when they do."""
    if (query.ndim == 2 and keys.ndim == 2 and w1.ndim == 2 and w2.ndim == 2
            and keys.shape[1] == query.shape[1]
            and mask.shape == (keys.shape[0],)
            and w1.shape[0] == 4 * query.shape[1]
            and w2.shape[0] == w1.shape[1] and w3.shape == (w2.shape[1], 1)
            and b1.shape == (w1.shape[1],) and b2.shape == (w2.shape[1],)
            and b3.shape == (1,)):
        return None
    return (f"din_attention: shapes query {tuple(query.shape)}, keys "
            f"{tuple(keys.shape)}, mask {tuple(mask.shape)}, w1/b1/w2/b2/w3/"
            f"b3 {[tuple(t.shape) for t in (w1, b1, w2, b2, w3, b3)]} do not "
            f"form a 4D -> h1 -> h2 -> 1 unit")


def _limit_error(L: int, D: int, h1: int, h2: int) -> str | None:
    """Why the kernel cannot take a unit of these widths, or None. The
    kernel's source decides its shared-memory layout and register tiles."""
    need = _lib().din_attention_smem_bytes(L, D, h1, h2)
    if 0 < need <= MAX_SMEM_BYTES:
        return None
    why = ("L, D, h1, h2 must be positive and D, h1, h2 within its "
           "register tiles (D <= 64, h1 <= 128, h2 <= 64)" if need < 0 else
           f"it would stage {need} bytes of shared memory, a block holds "
           f"{MAX_SMEM_BYTES}")
    return (f"din_attention kernel cannot take h1={h1}, h2={h2}, L={L}, "
            f"D={D}: {why}")


def fits(query: Tensor, keys: Tensor, mask: Tensor, w1: Tensor, b1: Tensor,
         w2: Tensor, b2: Tensor, w3: Tensor, b3: Tensor) -> bool:
    """Whether ``din_attention`` takes these arguments: one 4D -> h1 -> h2
    -> 1 unit over a shared (L, D) key block and, on CUDA tensors, within
    the kernel's register tiles and a block's shared memory (the plain
    version, which CPU tensors take, has no limits)."""
    args = (query, keys, mask, w1, b1, w2, b2, w3, b3)
    if _shape_error(*args) is not None:
        return False
    return query.device.type != "cuda" or _limit_error(
        keys.shape[0], keys.shape[1], w1.shape[1], w2.shape[1]) is None


def din_attention_plain(query: Tensor, keys: Tensor, mask: Tensor,
                        w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
                        w3: Tensor, b3: Tensor) -> Tensor:
    """Plain PyTorch version (the reference's ``din_attention_ref``): it
    materializes the (B, L, 4D) feature block."""
    B, D = query.shape
    L = keys.shape[0]
    k = keys[None].expand(B, L, D)
    q = query[:, None, :].expand(B, L, D)
    feats = torch.cat([k, q, k - q, k * q], dim=-1)
    h = torch.relu(feats @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    scores = (h @ w3 + b3)[..., 0]
    scores = torch.where(mask[None, :].bool(), scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bl,ld->bd", w, keys)


def _lib(defines=()) -> ctypes.CDLL:
    """The kernel's library; ``defines`` name a variant build (``build``)."""
    lib = build.load("din_attention", defines)
    if lib.din_attention_f32.argtypes is None:
        lib.din_attention_f32.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.din_attention_f32.restype = ctypes.c_int
        lib.din_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.din_attention_smem_bytes.restype = ctypes.c_long
    return lib


def _launch(query, keys, mask, w1, b1, w2, b2, w3, b3) -> Tensor:
    weights = (w1, b1, w2, b2, w3, b3)
    build.refuse_autograd("din_attention", query, keys, *weights)
    for t in (keys, mask) + weights:
        if t.device != query.device:
            raise ValueError(f"din_attention: an input on {t.device}, query "
                             f"on {query.device}")
    for t in (query, keys) + weights:
        if t.dtype != torch.float32:
            raise TypeError(f"din_attention CUDA kernel takes float32 only, "
                            f"got {t.dtype} (bf16 is not ported yet)")
    B, D = query.shape
    L = keys.shape[0]
    h1, h2 = w1.shape[1], w2.shape[1]
    err = _limit_error(L, D, h1, h2)
    if err:
        raise ValueError(err)
    out = torch.empty((B, D), dtype=torch.float32, device=query.device)
    if B == 0:
        return out                        # nothing to launch
    query, keys = query.contiguous(), keys.contiguous()
    weights = tuple(t.contiguous() for t in weights)
    mask_i = mask.to(torch.int32).contiguous()
    lib = _lib()
    with torch.cuda.device(query.device):    # launch in the tensors' context
        rc = lib.din_attention_f32(
            query.data_ptr(), keys.data_ptr(), mask_i.data_ptr(),
            *(t.data_ptr() for t in weights), out.data_ptr(),
            B, L, D, h1, h2,
            torch.cuda.current_stream(query.device).cuda_stream)
    build.check(lib, rc, "din_attention")
    build.count_launch(LAUNCHES, "shared_keys")
    return out


@shard_local("din_attention", rows=("query",))
def din_attention(query: Tensor, keys: Tensor, mask: Tensor, w1: Tensor,
                  b1: Tensor, w2: Tensor, b2: Tensor, w3: Tensor,
                  b3: Tensor) -> Tensor:
    """query (B, D); keys (L, D); mask (L,). Returns (B, D)."""
    err = _shape_error(query, keys, mask, w1, b1, w2, b2, w3, b3)
    if err:
        raise ValueError(err)
    if query.device.type == "cpu":
        return din_attention_plain(query, keys, mask, w1, b1, w2, b2, w3, b3)
    if query.device.type != "cuda":
        raise ValueError(f"din_attention: unsupported device {query.device}")
    return _launch(query, keys, mask, w1, b1, w2, b2, w3, b3)
