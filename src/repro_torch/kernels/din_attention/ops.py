"""DIN target attention over one shared key block: the CUDA kernel's
wrapper and its plain PyTorch version (port of
``repro.kernels.din_attention``).

``din_attention(query, keys, mask, w1, b1, w2, b2, w3, b3)`` takes query
(B, D), keys (L, D) shared by every row, mask (L,) and the unit's MLP
4D -> h1 -> h2 -> 1, and returns the (B, D) pooled interest. A CPU tensor
goes to ``din_attention_plain``; a CUDA tensor launches
``csrc/din_attention.cu`` at any history length L and any width: within
the kernel's register tiles (D <= 64, h1 <= 128, h2 <= 64) its narrow
pipelines, past them its wide route, which takes a workspace the wrapper
allocates (``din_attention_work_bytes``). Only shared memory bounds the
width (D <= 1200 in fp32, 1800 in bf16, as ``din_attention_max_dim``
reports): a wider D raises, and no width is ever sent to the plain
version. fp32 runs the two per-pair products as 3xTF32 on the tensor
cores; bf16 on the bf16 tensor cores (exact bf16 products, f32 sums, h1
split into two bf16 halves for the second layer). The reference's batch
padding to a multiple of its tile is gone: the kernel guards its last
rows. ``LAUNCHES`` counts kernel launches (fp32 under ``shared_keys``,
bf16 under ``bf16``; the wide route under ``wide`` and ``wide/bf16``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.dist.sharding import shard_local
from repro_torch.kernels import build
from repro_torch.nn.attention import NEG_INF

Tensor = torch.Tensor

# kernel launches (one per launch, counted nowhere else)
LAUNCHES = {"shared_keys": 0, "bf16": 0, "wide": 0, "wide/bf16": 0}


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


def din_attention_plain(query: Tensor, keys: Tensor, mask: Tensor,
                        w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
                        w3: Tensor, b3: Tensor) -> Tensor:
    """Plain PyTorch version (the reference's ``din_attention_ref``): it
    materializes the (B, L, 4D) feature block. In bf16 it keeps the TPU
    kernel's numerics: the features formed in bf16, every product of bf16
    operands accumulated and kept in f32, p rounded to bf16 for the pool,
    the output rounded once (fp32 inputs: plain fp32 throughout)."""
    B, D = query.shape
    L = keys.shape[0]
    k = keys[None].expand(B, L, D)
    q = query[:, None, :].expand(B, L, D)
    feats = torch.cat([k, q, k - q, k * q], dim=-1)
    h = torch.relu(feats.float() @ w1.float() + b1.float())
    h = torch.relu(h @ w2.float() + b2.float())
    scores = (h @ w3.float() + b3.float())[..., 0]
    scores = torch.where(mask[None, :].bool(), scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1).to(keys.dtype)
    return torch.einsum("bl,ld->bd", w.float(), keys.float()).to(query.dtype)


_UNIT = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_WIDE = _UNIT[:-1] + [ctypes.c_void_p] * 2     # ..., work, stream
_SIGNATURES = {
    "din_attention_f32": (_UNIT, ctypes.c_int),
    "din_attention_bf16": (_UNIT, ctypes.c_int),
    "din_attention_wide_f32": (_WIDE, ctypes.c_int),
    "din_attention_wide_bf16": (_WIDE, ctypes.c_int),
    "din_attention_work_bytes": ([ctypes.c_int] * 6, ctypes.c_long),
    "din_attention_smem_bytes": ([ctypes.c_int] * 4, ctypes.c_long),
    "din_attention_chunk_keys": ([ctypes.c_int] * 3, ctypes.c_int),
    "din_attention_bf16_smem_bytes": ([ctypes.c_int] * 4, ctypes.c_long),
    "din_attention_bf16_chunk_keys": ([ctypes.c_int] * 3, ctypes.c_int),
    "din_attention_max_dim": ([ctypes.c_int], ctypes.c_int),
}


def _lib(defines=()) -> ctypes.CDLL:
    """The kernel's library; ``defines`` name a variant build (``build``)."""
    return build.load("din_attention", defines, _SIGNATURES)


def _launch(query, keys, mask, w1, b1, w2, b2, w3, b3) -> Tensor:
    weights = (w1, b1, w2, b2, w3, b3)
    build.refuse_autograd("din_attention", query, keys, *weights)
    for t in (keys, mask) + weights:
        if t.device != query.device:
            raise ValueError(f"din_attention: an input on {t.device}, query "
                             f"on {query.device}")
    dtype = build.one_dtype("din_attention", query=query, keys=keys, w1=w1,
                            b1=b1, w2=w2, b2=b2, w3=w3, b3=b3)
    B, D = query.shape
    L = keys.shape[0]
    h1, h2 = w1.shape[1], w2.shape[1]
    bf16 = dtype == torch.bfloat16
    lib = _lib()
    most = lib.din_attention_max_dim(int(bf16))
    if D > most:
        raise ValueError(f"din_attention kernel cannot take D={D}: 16 keys, "
                         f"16 query rows and their pooled sums fill a block's "
                         f"shared memory past D = {most} "
                         f"({str(dtype).removeprefix('torch.')})")
    out = torch.empty((B, D), dtype=dtype, device=query.device)
    if B == 0:
        return out                        # nothing to launch
    if L == 0 or D == 0:
        raise ValueError(f"din_attention: an empty unit (L={L}, D={D})")
    query, keys = query.contiguous(), keys.contiguous()
    weights = tuple(t.contiguous() for t in weights)
    mask_i = mask.to(torch.int32).contiguous()
    nwork = lib.din_attention_work_bytes(B, L, D, h1, h2, int(bf16))
    if nwork < 0:
        raise ValueError(f"din_attention: no route for B={B}, L={L}, D={D}, "
                         f"h1={h1}, h2={h2}")
    args = [query.data_ptr(), keys.data_ptr(), mask_i.data_ptr(),
            *(t.data_ptr() for t in weights), out.data_ptr(),
            B, L, D, h1, h2]
    if nwork:                             # past the register tiles
        work = torch.empty(nwork, dtype=torch.uint8, device=query.device)
        entry = (lib.din_attention_wide_bf16 if bf16
                 else lib.din_attention_wide_f32)
        args.append(work.data_ptr())
        key = "wide/bf16" if bf16 else "wide"
    else:
        entry = lib.din_attention_bf16 if bf16 else lib.din_attention_f32
        key = "bf16" if bf16 else "shared_keys"
    with torch.cuda.device(query.device):    # launch in the tensors' context
        rc = entry(*args,
                   torch.cuda.current_stream(query.device).cuda_stream)
    build.check(lib, rc, "din_attention")
    build.count_launch(LAUNCHES, key)
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
