"""DIN target attention over one shared key block: the CUDA kernel's
wrapper and its plain PyTorch version (port of
``repro.kernels.din_attention``).

``din_attention(query, keys, mask, w1, b1, w2, b2, w3, b3)`` takes query
(B, D), keys (L, D) shared by every row, mask (L,) and the unit's MLP
4D -> h1 -> h2 -> 1, and returns the (B, D) pooled interest. A CPU tensor
goes to ``din_attention_plain``; a CUDA tensor launches
``csrc/din_attention.cu`` at any history length L and any width: within
the kernel's register tiles (D <= 64, h1 <= 128, h2 <= 64) its narrow
pipelines, past them its wide route on ``wgmma``, which reads the unit's
weights prepared once (``prepare_din_weights``: W1d^T and W2^T in the
tiles the kernel stages, fp32 as tf32 hi / lo) and takes a workspace the
wrapper allocates (``din_attention_work_bytes``). Only shared memory
bounds the width (``din_attention_max_dim``): a wider D raises, and no
width is ever sent to the plain version. fp32 runs the two per-pair
products as 3xTF32 on the tensor cores; bf16 on the bf16 tensor cores
(exact bf16 products, f32 sums, h1 split into two bf16 halves for the
second layer). The reference's batch padding to a multiple of its tile
is gone: the kernel guards its last rows. ``LAUNCHES`` counts kernel
launches (fp32 under ``shared_keys``, bf16 under ``bf16``; the wide route
under ``wide`` and ``wide/bf16``); ``PREPARES`` counts wide calls that
had to prepare their weights on the spot (``prepare_din_params`` does it
once per set of weights, at load, as ``prepare_mari_params`` does for
``mari_matmul``).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.dist.sharding import shard_local
from repro_torch.kernels import build
from repro_torch.kernels.mari_matmul.ops import split_tf32
from repro_torch.nn.attention import NEG_INF

Tensor = torch.Tensor

# kernel launches (one per launch, counted nowhere else)
LAUNCHES = {"shared_keys": 0, "bf16": 0, "wide": 0, "wide/bf16": 0}
# wide-route calls whose weights were prepared inside the call, by dtype
PREPARES = dict.fromkeys(("float32", "bfloat16"), 0)

# the narrow pipelines' register tiles (csrc kKT1Max * 8, kNT1Max * 8,
# kNT2Max * 8): a wider unit takes the wide route
TILE_D, TILE_H1, TILE_H2 = 64, 128, 64


def reset_launches() -> None:
    for counts in (LAUNCHES, PREPARES):
        for k in counts:
            counts[k] = 0


def within_tiles(D: int, h1: int, h2: int) -> bool:
    """Whether the narrow pipelines take a unit of these widths."""
    return D <= TILE_D and h1 <= TILE_H1 and h2 <= TILE_H2


# ---- the wide route's prepared weights ------------------------------------
def din_plan(D: int, h1: int, h2: int, bf16: bool) -> dict:
    """The tile plan of the prepared weights (csrc ``wide_plan``): h1 in
    ``ng`` groups of ``n1`` (GEMM 1's N), h2 in ``ns`` slices of ``n2``
    (GEMM 2's N): 80 and 40 at DIN's 73..80 x 33..40, else 64 and 64;
    ``kk`` values a 128-byte row (32 fp32, 64 bf16), ``kt1`` / ``kt2`` k
    tiles of W1d a group (even: the kernel takes two at a time; zero past
    D) and of W2 a (slice, group), ``parts`` 2 (tf32 hi,
    lo) or 1, ``t1`` / ``t2`` bytes of a tile, ``w2_off`` where the W2
    tiles start, ``total`` bytes, ``per_round`` tiles an m64 tile walks."""
    din = 72 < h1 <= 80 and 32 < h2 <= 40
    n1, n2 = (80, 40) if din else (64, 64)
    kk, parts = (64, 1) if bf16 else (32, 2)
    ng, ns = -(-h1 // n1), -(-h2 // n2)
    kt1, kt2 = -(-D // kk) + (-(-D // kk)) % 2, -(-n1 // kk)
    t1, t2 = n1 * 128 * parts, n2 * 128 * parts
    w2_off = t1 * ng * kt1
    return dict(n1=n1, n2=n2, ng=ng, ns=ns, kk=kk, kt1=kt1, kt2=kt2,
                parts=parts, per_round=ns * ng * (kt1 + kt2), t1=t1, t2=t2,
                w2_off=w2_off, total=w2_off + t2 * ns * ng * kt2)


def swizzle_128(rows: Tensor) -> Tensor:
    """(..., n, kk) rows of 128 bytes in wgmma's 128-byte swizzle: the
    16-byte chunk c of row n lands at chunk c ^ (n % 8)."""
    *lead, n, kk = rows.shape
    per = kk // 8
    ch = rows.reshape(*lead, n, 8, per)
    dev = rows.device
    src = (torch.arange(8, device=dev)[None, :]
           ^ (torch.arange(n, device=dev) % 8)[:, None])
    src = src[:, :, None].expand(n, 8, per).expand(*lead, n, 8, per)
    return torch.gather(ch, -2, src).reshape(*lead, n, kk)


def w2_k_rows(n1: int, kk: int, kt2: int, bf16: bool) -> Tensor:
    """The h1 index (within a group) that k column k of a group's W2 tiles
    holds, -1 past the group: fp32 permutes each 8 (k t <- 2t, k t + 4 <-
    2t + 1, so that GEMM 1's accumulator is GEMM 2's A fragment as it
    lies), bf16 keeps the order."""
    k = torch.arange(kt2 * kk)
    if not bf16:
        j = k % 8
        k = k - j + torch.where(j < 4, 2 * j, 2 * (j - 4) + 1)
    return torch.where(torch.arange(kt2 * kk) < n1, k, -1)


def _parts(a: Tensor, bf16: bool) -> Tensor:
    """(...) values -> (..., parts, ...) at dim -3: tf32 hi and lo in fp32,
    the values in bf16."""
    if bf16:
        return a.unsqueeze(-3)
    hi, lo = split_tf32(a)
    return torch.stack([hi, lo], dim=-3)


@dataclasses.dataclass(eq=False)
class DinWeights:
    """A wide unit's W1d and W2 in the layout the wide route stages
    (``din_plan``): ``buf`` holds W1d^T's tiles [group][k tile] then W2^T's
    [slice][group][k tile], each (parts, n rows, 128 bytes) swizzled.
    ``w1`` / ``w2`` are the weights as given."""
    w1: Tensor
    w2: Tensor
    buf: Tensor
    plan: dict


def prepare_din_weights(w1: Tensor, w2: Tensor) -> DinWeights:
    """The wide route's operand for a unit's (4D, h1) and (h1, h2) weights
    (fp32 or bf16, one dtype), on their device."""
    if (w1.ndim != 2 or w2.ndim != 2 or w1.shape[0] % 4
            or w2.shape[0] != w1.shape[1] or w1.dtype != w2.dtype
            or w1.dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError(f"prepare_din_weights takes (4D, h1) and (h1, h2) "
                        f"float32 or bfloat16 weights of one dtype, got "
                        f"{tuple(w1.shape)} {w1.dtype} and {tuple(w2.shape)}"
                        f" {w2.dtype}")
    w1, w2 = w1.detach(), w2.detach()
    bf16 = w1.dtype == torch.bfloat16
    D, h1, h2 = w1.shape[0] // 4, w1.shape[1], w2.shape[1]
    p = din_plan(D, h1, h2, bf16)
    n1, n2, ng, ns, kk = p["n1"], p["n2"], p["ng"], p["ns"], p["kk"]
    kt1, kt2 = p["kt1"], p["kt2"]
    # W1d^T (ng n1, kt1 kk), zero padded -> tiles (ng, kt1, parts, n1, kk)
    w1t = w1.new_zeros((ng * n1, kt1 * kk))
    w1t[:h1, :D] = w1[3 * D:].t()
    t1 = w1t.reshape(ng, n1, kt1, kk).permute(0, 2, 1, 3)
    t1 = _parts(swizzle_128(t1.contiguous()), bf16)
    # W2^T tiles (ns, ng, kt2, parts, n2, kk): row j = s n2 + n, column k
    # of group g = W2[g n1 + w2_k_rows[k]] (zero past h1, h2)
    w2p = w2.new_zeros((ng * n1 + 1, ns * n2))     # the last row: zeros
    w2p[:h1, :h2] = w2
    kr = w2_k_rows(n1, kk, kt2, bf16).to(w1.device)
    rows = torch.arange(ng, device=w1.device)[:, None] * n1 + kr[None]
    rows = torch.where((kr[None] >= 0) & (rows < h1), rows, ng * n1)
    t2 = w2p[rows.reshape(-1)].reshape(ng, kt2, kk, ns, n2)
    t2 = _parts(swizzle_128(t2.permute(3, 0, 1, 4, 2).contiguous()), bf16)
    buf = torch.cat([t1.reshape(-1), t2.reshape(-1)]).view(torch.uint8)
    if buf.numel() != p["total"]:
        raise AssertionError(f"din weights: {buf.numel()} bytes laid out, "
                             f"the plan has {p['total']}")
    return DinWeights(w1, w2, buf, p)


def _prepared_for(prepared, w1: Tensor, w2: Tensor) -> bool:
    return (isinstance(prepared, DinWeights)
            and prepared.w1.shape == w1.shape and prepared.w2.shape == w2.shape
            and prepared.w1.dtype == w1.dtype
            and prepared.buf.device == w1.device)


def prepare_din_params(graph, params: dict) -> dict:
    """A copy of ``params`` where each three-layer ``target_attention`` unit
    with biases that the wide route takes (past the register tiles) carries
    its weights prepared (``din_prep``). Call once per set of weights: the
    executor's kernel path hands ``din_prep`` to every call."""
    out = dict(params)
    for n in graph.nodes.values():
        if n.op != "target_attention" or n.attrs.get("decomposed"):
            continue
        p = params.get(n.name) or {}
        layers = [k for k in p if k.startswith("layer_")]
        if len(layers) != 3 or not all("b" in p[k] for k in layers):
            continue
        w1, w2 = p["layer_0"]["w"], p["layer_1"]["w"]
        if (w1.dtype != w2.dtype
                or w1.dtype not in (torch.float32, torch.bfloat16)
                or within_tiles(w1.shape[0] // 4, w1.shape[1], w2.shape[1])
                or _prepared_for(p.get("din_prep"), w1, w2)):
            continue
        out[n.name] = dict(p, din_prep=prepare_din_weights(w1, w2))
    return out


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
_WIDE = _UNIT[:-1] + [ctypes.c_void_p] * 3     # ..., wprep, work, stream
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
    "din_attention_prep_bytes": ([ctypes.c_int] * 4, ctypes.c_long),
}


def _lib(defines=()) -> ctypes.CDLL:
    """The kernel's library; ``defines`` name a variant build (``build``)."""
    return build.load("din_attention", defines, _SIGNATURES)


def _launch(query, keys, mask, w1, b1, w2, b2, w3, b3,
            prepared=None) -> Tensor:
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
                         f"a block's query rows and pooled sums and two "
                         f"weight tiles fill its shared memory past D = "
                         f"{most} "
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
        if not _prepared_for(prepared, w1, w2):
            prepared = prepare_din_weights(w1, w2)
            build.count_launch(PREPARES, str(dtype).removeprefix("torch."))
        if prepared.buf.numel() != lib.din_attention_prep_bytes(
                D, h1, h2, int(bf16)):
            raise ValueError("din_attention: prepared weights laid out for "
                             "another plan than the kernel's")
        work = torch.empty(nwork, dtype=torch.uint8, device=query.device)
        entry = (lib.din_attention_wide_bf16 if bf16
                 else lib.din_attention_wide_f32)
        args += [prepared.buf.data_ptr(), work.data_ptr()]
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
                  b3: Tensor, prepared: DinWeights | None = None) -> Tensor:
    """query (B, D); keys (L, D); mask (L,). Returns (B, D). ``prepared``:
    ``prepare_din_weights(w1, w2)``, which the wide route reads (made on
    the spot, and counted in ``PREPARES``, when it is missing)."""
    err = _shape_error(query, keys, mask, w1, b1, w2, b2, w3, b3)
    if err:
        raise ValueError(err)
    if query.device.type == "cpu":
        return din_attention_plain(query, keys, mask, w1, b1, w2, b2, w3, b3)
    if query.device.type != "cuda":
        raise ValueError(f"din_attention: unsupported device {query.device}")
    return _launch(query, keys, mask, w1, b1, w2, b2, w3, b3, prepared)
