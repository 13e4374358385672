"""Fused MaRI matmul (Eq. 7): the CUDA kernel's wrapper, its plain PyTorch
version, the weight preparation the kernel reads, and the group-folding op
the executor calls.

``mari_matmul(x, w, u, user_index=None, activation=...)`` computes
``act(u_init + x @ w)`` where the accumulator starts from ``u``: a (1, N)
broadcast row, a row-wise (B, N) block, or — with ``user_index`` — row
``clamp(user_index[b])`` of a stacked (U, N) table. A CPU tensor goes to
``mari_matmul_plain``; a CUDA tensor launches ``csrc/mari_matmul.cu`` or
raises. ``LAUNCHES`` counts kernel launches per init mode (fp32) and under
``bf16`` for bf16 operands.

The kernel runs on the tensor cores (wgmma) and keeps fp32 accuracy by
3xTF32: it reads ``w`` as a ``MariWeight`` from ``prepare_mari_weight``
(w_hi = tf32(w)^T and w_lo = tf32(w - tf32(w))^T, (N, K_pad), with their
TMA descriptors). bf16 operands run a pipeline of their own
(``bf16_plan``): K in chunks of ``CHUNK_K``, each chained on the tensor
cores from zero and added to the f32 init in chunk order
(``bf16_chunks``), so the sums' association depends on K alone; its
weight rows and the serving path's bf16 streams (``stream_ld``) lie on
128-byte L2 lines. Prepare once per weight — ``prepare_mari_params`` does
every ``mari_dense`` of a graph — because a raw ``w`` on a CUDA call is
prepared on the spot and counted in ``PREPARES``. x is read through TMA,
which needs a 16-byte-aligned base and row stride: an x without one is
copied into a padded-stride buffer and counted in ``STRIDE_COPIES``
(``empty_stream`` gives a producer such a buffer to write into).

``mari_matmul_fused_groups`` is the port of ``repro.kernels.mari_matmul.ops``:
the batch-1 user products, ``acc0`` and the bias fold into the f32 ``u``
(that small product stays ``torch.matmul``, as it stayed jnp outside the
Pallas kernel), and the batched streams concatenate into one ``x @ w``,
which is the kernel's. The TPU's 8x128 padding is gone: TMA zero-fills the
ragged edges and the kernel masks its stores.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.common import take_clip
from repro_torch.dist.sharding import shard_local
from repro_torch.kernels import build
from repro_torch.nn.layers import ACTIVATIONS

Tensor = torch.Tensor

INIT_MODES = ("broadcast", "rowwise", "gather")       # csrc Init enum order
EPILOGUES = ("identity", "relu", "gelu", "silu", "sigmoid", "tanh")  # Act enum
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}       # csrc DType enum
_BK = {torch.float32: 32, torch.bfloat16: 64}         # one 128-byte row

# kernel launches per init mode (fp32) and of the bf16 entry (one per
# launch, counted nowhere else)
LAUNCHES = dict.fromkeys(INIT_MODES + ("bf16",), 0)
# weights prepared inside a CUDA call (a raw w), and x operands copied into
# a padded-stride buffer, per operand dtype
PREPARES = dict.fromkeys(("float32", "bfloat16"), 0)
STRIDE_COPIES = dict.fromkeys(("float32", "bfloat16"), 0)


def reset_launches() -> None:
    for counts in (LAUNCHES, PREPARES, STRIDE_COPIES):
        for k in counts:
            counts[k] = 0


def init_mode(B: int, u: Tensor, user_index: Tensor | None) -> str:
    """Which accumulator-init layout ``u`` has for a (B, ...) stream."""
    if user_index is not None:
        if tuple(user_index.shape) != (B,):
            raise ValueError(f"user_index must be ({B},), got "
                             f"{tuple(user_index.shape)}")
        return "gather"
    if u.shape[0] == 1:
        return "broadcast"
    if u.shape[0] == B:
        return "rowwise"
    raise ValueError(f"u rows must be 1 or B={B} (or a table with "
                     f"user_index), got {tuple(u.shape)}")


def tile_config(B: int, N: int) -> tuple[int, int]:
    """(BM, BN) of the kernel's output tile, from (B, N) alone: BN is the
    narrowest of 8 / 32 / 64 / 128 that covers N (128 above), BM 128 (two
    consumer warpgroups) unless that leaves most of the 132 SMs idle. BK
    and the k order never change, so a row's result does not depend on the
    choice."""
    bn = next((b for b in (8, 32, 64) if N <= b), 128)
    tiles = -(-B // 128) * -(-N // bn)
    return (128 if tiles >= 100 else 64), bn


# ---- the bf16 entry's plan ----------------------------------------------------
CHUNK_K = 256          # csrc CHUNK_TILES x 64: the bf16 entry's k chunk


def bf16_chunks(K: int) -> list[tuple[int, int]]:
    """The bf16 entry's k chunks ``[(k0, k1), ...]``: each chains on the
    tensor cores from zero, and ``u + c0 + c1 + ...`` is summed in this
    order with ordinary f32 adds. A function of K alone."""
    return [(k, min(k + CHUNK_K, K)) for k in range(0, K, CHUNK_K)]


@dataclasses.dataclass(frozen=True)
class Bf16Plan:
    """How the bf16 entry runs a (B, K) x (K, N) call: (bm, bn) output
    tiles (bm / 64 consumer warpgroups), walked by ``grid`` persistent CTAs
    (one per SM, at most one per tile), each with a ring of ``stages``
    stages of ``stage_bytes`` (64 bf16 of bm x rows and bn w rows) and the
    output tile staged beside it (``staged_bytes``: bm rows of 2 bn + 16
    bytes); ``smem_bytes`` of dynamic shared memory in all, and
    ``accumulators`` floats a consumer thread holds (the accumulator and
    two chunk partials, bn / 2 each)."""
    bm: int
    bn: int
    grid: int
    stages: int
    stage_bytes: int
    staged_bytes: int
    smem_bytes: int
    accumulators: int


def bf16_plan(B: int, N: int, sms: int = 132) -> Bf16Plan:
    """The bf16 entry's tiles and budgets on a card of ``sms`` SMs, from
    (B, N) alone (nothing here changes a row's bits: K's chunks and their
    order do not move). bn is fp32's (``tile_config``: from N alone); bm as
    ``tile_config``'s. The ring takes as many stages as ~200 KB holds
    beside the staged tile (2 .. 8), as csrc ``bf16_stages``."""
    bm, bn = tile_config(B, N)
    stage, staged = (bm + bn) * 128, bm * (2 * bn + 16)
    stages = min(max((200 * 1024 - staged) // stage, 2), 8)
    tiles = -(-B // bm) * -(-N // bn)
    return Bf16Plan(bm=bm, bn=bn, grid=min(tiles, sms), stages=stages,
                    stage_bytes=stage, staged_bytes=staged,
                    smem_bytes=stages * stage + staged + 1024,
                    accumulators=3 * bn // 2)


# ---- tf32 arithmetic, as the card does it ----------------------------------
def tf32_round(x: Tensor) -> Tensor:
    """Round fp32 to tf32 (10-bit mantissa), to nearest with ties away from
    zero: the bits of ``cvt.rna.tf32.f32``, kept as fp32."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: Tensor) -> tuple[Tensor, Tensor]:
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi); hi + lo is x to ~2^-22."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


# ---- prepared weights -------------------------------------------------------
def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _padded_t(a: Tensor, align: int) -> Tensor:
    """a (K, N) -> its (N, K_pad) transpose, K_pad = round_up(K, align),
    zero tail (a 16-byte row stride for TMA)."""
    K, N = a.shape
    out = a.new_zeros((N, _round_up(max(K, 1), align)))
    out[:, :K] = a.t()
    return out


@dataclasses.dataclass(eq=False)
class MariWeight:
    """A weight in the layout the kernel reads. fp32: ``hi`` / ``lo`` are
    tf32(w)^T and tf32(w - tf32(w))^T; bf16: ``hi`` is w^T and ``lo`` None.
    Both (N, K_pad). ``maps`` holds their TMA descriptors (CUDA only) for
    output tiles ``bn`` wide; ``w`` is the weight as given, which the plain
    path uses."""
    w: Tensor
    hi: Tensor
    lo: Tensor | None
    bn: int
    maps: ctypes.Array | None = None

    @property
    def shape(self) -> torch.Size:
        return self.w.shape

    @property
    def device(self) -> torch.device:
        return self.w.device


def prepare_mari_weight(w: Tensor | MariWeight) -> MariWeight:
    """The kernel's operand for a (K, N) fp32 or bf16 weight (returned as
    is when already prepared). On a CUDA weight the TMA descriptors are
    encoded here, once."""
    if isinstance(w, MariWeight):
        return w
    if w.ndim != 2 or w.dtype not in _DTYPES:
        raise TypeError(f"prepare_mari_weight takes a 2-D float32 or "
                        f"bfloat16 weight, got {tuple(w.shape)} {w.dtype}")
    w = w.detach()
    bn = tile_config(1, w.shape[1])[1]
    if w.dtype == torch.float32:
        hi, lo = (_padded_t(p, 4) for p in split_tf32(w))
    else:
        # rows padded to 128 bytes: each 64-deep k tile of a row is one
        # L2 line
        hi, lo = _padded_t(w, 64), None
    mw = MariWeight(w, hi, lo, bn)
    if w.is_cuda:
        mw.maps = _encode_weight_maps(mw)
    return mw


def fragment_stream_idx(attrs: dict) -> list[int]:
    """The ``w_seg`` indices, in stream order, of a fragment ``mari_dense``'s
    batched stream: its rest segments when stage 1 precomputed the user
    partial, else every non-user segment."""
    if attrs.get("precomputed_user"):
        return list(attrs["seg_param_idx"])
    return [i for i, g in enumerate(attrs["seg_groups"]) if g != "user"]


def stream_weight_blocks(graph, params: dict) -> dict[str, list[Tensor]]:
    """Each ``mari_dense`` node's batched-group weight blocks, in the order
    the executor's kernel path streams them (one ``x @ w`` per node): the
    node set that ``serve.engine._precat_mari_weights`` concatenates over
    and ``prepare_mari_params`` prepares."""
    out = {}
    for n in graph.nodes.values():
        if n.op != "mari_dense":
            continue
        p = params[n.name]
        if n.attrs.get("fragment"):
            ws = [p[f"w_seg{i}"] for i in fragment_stream_idx(n.attrs)]
        else:
            ws = [p[f"w_{lab}"] for lab, _ in n.attrs["groups"]
                  if lab != "user"]
        if ws:
            out[n.name] = ws
    return out


def prepare_mari_params(graph, params: dict) -> dict:
    """A copy of ``params`` where each kernel-eligible ``mari_dense`` (see
    ``stream_weight_blocks``; mixed-precision ``cast_dtype`` nodes run plain
    torch and are skipped) carries its batched-group weight, concatenated
    (``w_cat``, when there are several blocks) and prepared (``w_prep``).
    Call once per set of weights: the executor's kernel path then hands
    ``w_prep`` to every call."""
    out = dict(params)
    for name, ws in stream_weight_blocks(graph, params).items():
        if graph.nodes[name].attrs.get("cast_dtype"):
            continue
        p = params[name]
        w = p.get("w_cat")
        extra = {}
        if w is None:
            w = ws[0] if len(ws) == 1 else torch.cat(ws, dim=0)
            if len(ws) > 1:
                extra["w_cat"] = w
        out[name] = dict(p, **extra, w_prep=prepare_mari_weight(w))
    return out


# ---- x's row stride ---------------------------------------------------------
def aligned_ld(K: int, dtype: torch.dtype) -> int:
    """The least row stride >= K whose bytes are a multiple of 16."""
    return _round_up(max(K, 1), 16 // dtype.itemsize)


def stream_ld(K: int, dtype: torch.dtype) -> int:
    """The row stride a producer writes a (B, K) stream at: fp32
    ``aligned_ld``; bf16 a multiple of 128 bytes, so that every 64-deep k
    tile the bf16 entry loads of a row is one L2 line (rows 2,128 bytes
    apart, K = 1064, straddle two lines each)."""
    if dtype == torch.bfloat16:
        return _round_up(max(K, 1), 64)
    return aligned_ld(K, dtype)


def empty_stream(B: int, K: int, dtype: torch.dtype,
                 device: torch.device) -> Tensor:
    """An uninitialised (B, K) view of a (B, stream_ld(K)) buffer: a row
    stride TMA can read, for a producer to write a stream into."""
    buf = torch.empty((B, stream_ld(K, dtype)), dtype=dtype, device=device)
    return buf[:, :K]


def tma_ready(x: Tensor) -> bool:
    """Whether TMA can read x as it lies: unit column stride, a row stride
    of at least K whose bytes are a multiple of 16, a 16-byte-aligned base."""
    es = x.element_size()
    return (x.stride(1) == 1 and x.stride(0) >= x.shape[1]
            and (x.stride(0) * es) % 16 == 0 and x.data_ptr() % 16 == 0)


def stream_operand(x: Tensor) -> tuple[Tensor, bool]:
    """(x as the kernel reads it, whether that took a copy into a padded-
    stride buffer)."""
    if tma_ready(x):
        return x, False
    buf = empty_stream(x.shape[0], x.shape[1], x.dtype, x.device)
    buf.copy_(x)
    return buf, True


# ---- plain version and kernel -----------------------------------------------
def mari_matmul_plain(x: Tensor, w: Tensor | MariWeight, u: Tensor,
                      user_index: Tensor | None = None,
                      activation: str = "identity") -> Tensor:
    """Plain PyTorch version: act(u[clamp(user_index)] or u + x @ w), f32."""
    if isinstance(w, MariWeight):
        w = w.w
    if user_index is not None:
        u = take_clip(u, user_index)
    acc = u.float() + x.float() @ w.float()
    return ACTIVATIONS[activation](acc).to(x.dtype)


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 8 + [ctypes.c_void_p])
_ENCODE_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                    + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2)


_SIGNATURES = {"mari_matmul_f32": (_ARGTYPES, ctypes.c_int),
               "mari_matmul_bf16": (_ARGTYPES, ctypes.c_int),
               "mari_encode_map": (_ENCODE_ARGTYPES, ctypes.c_int),
               "mari_bf16_smem_bytes": ([ctypes.c_int] * 2, ctypes.c_int)}


def _lib() -> ctypes.CDLL:
    return build.load("mari_matmul", (), _SIGNATURES)


def encode_map(out_addr: int, t: Tensor, box_inner: int,
               box_outer: int) -> None:
    """Encode the TMA descriptor of a 2-D row-major CUDA tensor (unit
    column stride) into the 128 bytes at ``out_addr``."""
    lib = _lib()
    rc = lib.mari_encode_map(out_addr, t.data_ptr(), _DTYPES[t.dtype],
                             t.shape[1], t.shape[0], t.stride(0), box_inner,
                             box_outer)
    build.check(lib, rc, "mari_matmul: tensor map")


def _encode_weight_maps(mw: MariWeight) -> ctypes.Array:
    parts = [mw.hi] if mw.lo is None else [mw.hi, mw.lo]
    maps = ctypes.create_string_buffer(128 * len(parts))
    for i, t in enumerate(parts):
        encode_map(ctypes.addressof(maps) + 128 * i, t, _BK[t.dtype], mw.bn)
    return maps


def _launch(x: Tensor, w: Tensor | MariWeight, u: Tensor,
            user_index: Tensor | None, mode: str, activation: str) -> Tensor:
    raw = w.w if isinstance(w, MariWeight) else w
    build.refuse_autograd("mari_matmul", x, raw, u)
    if x.dtype not in _DTYPES or raw.dtype != x.dtype:
        raise TypeError(f"mari_matmul CUDA kernel takes float32 or bfloat16 "
                        f"x and w of one dtype, got {x.dtype} and "
                        f"{raw.dtype}")
    for name, t in (("w", raw), ("u", u)):
        if t.device != x.device:
            raise ValueError(f"mari_matmul: {name} on {t.device}, x on "
                             f"{x.device}")
    B, K = x.shape
    if raw.shape[0] != K or u.ndim != 2 or u.shape[1] != raw.shape[1]:
        raise ValueError(f"mari_matmul: shapes x {tuple(x.shape)}, w "
                         f"{tuple(raw.shape)}, u {tuple(u.shape)} do not "
                         f"agree")
    N = raw.shape[1]
    dname = str(x.dtype).removeprefix("torch.")
    if not isinstance(w, MariWeight):
        w = prepare_mari_weight(raw)
        build.count_launch(PREPARES, dname)
    elif w.hi.device != x.device or w.maps is None:
        raise ValueError(f"mari_matmul: weight prepared on {w.hi.device}, "
                         f"x on {x.device}")
    u = u.float().contiguous()
    idx = None
    if mode == "gather":
        if user_index.device != x.device:
            raise ValueError("mari_matmul: user_index on another device")
        idx = user_index.to(torch.int32).contiguous()
    out = torch.empty((B, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out                        # nothing to launch
    x, copied = stream_operand(x)
    if copied:
        build.count_launch(STRIDE_COPIES, dname)
    lib = _lib()
    entry = (lib.mari_matmul_f32 if x.dtype == torch.float32
             else lib.mari_matmul_bf16)
    bm = tile_config(B, N)[0]               # bf16_plan's too
    with torch.cuda.device(x.device):    # launch in the tensors' context
        rc = entry(x.data_ptr(), x.stride(0), ctypes.addressof(w.maps),
                   u.data_ptr(), None if idx is None else idx.data_ptr(),
                   out.data_ptr(), B, K, N, u.shape[0],
                   INIT_MODES.index(mode), EPILOGUES.index(activation), bm,
                   w.bn, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "mari_matmul")
    build.count_launch(LAUNCHES,
                       mode if x.dtype == torch.float32 else "bf16")
    return out


@shard_local("mari_matmul", rows=("x", "u", "user_index"))
def mari_matmul(x: Tensor, w: Tensor | MariWeight, u: Tensor,
                user_index: Tensor | None = None,
                activation: str = "identity") -> Tensor:
    """act(u_init + x (B, K) @ w (K, N)); see the module docstring. ``w``
    is a tensor or a ``MariWeight``."""
    if activation not in EPILOGUES:
        raise ValueError(f"unsupported epilogue activation {activation!r}")
    if x.ndim != 2 or len(w.shape) != 2:
        raise ValueError(f"mari_matmul takes 2-D x and w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    mode = init_mode(x.shape[0], u, user_index)
    if x.device.type == "cpu":
        return mari_matmul_plain(x, w, u, user_index, activation)
    if x.device.type != "cuda":
        raise ValueError(f"mari_matmul: unsupported device {x.device}")
    return _launch(x, w, u, user_index, mode, activation)


def mari_matmul_fused_groups(parts, b=None, *, acc0=None, user_index=None,
                             activation="identity") -> Tensor:
    """act(Σ_g Tile-or-stream(x_g @ w_g) + acc0 + b) for (x, w) pairs.

    Each x is (1, D_g) (user side — folded into the accumulator-init row)
    or (B, D_g) (batched side — one concatenated stream through the
    kernel). A prepared ``MariWeight`` is the stream on its own: the other
    batched parts (a single-stage pack's row-wise user features) seed a
    row-wise init block.
    ``acc0`` is an optional precomputed partial: a (1, d) row, a row-wise
    (B, d) block, or — with ``user_index`` (B,) — the stacked (U, d)
    per-user table the kernel gathers at accumulator-init load.
    """
    d = parts[0][1].shape[1]
    user = [(x, w) for x, w in parts if x.shape[0] == 1]
    rest = [(x, w) for x, w in parts if x.shape[0] != 1]
    dev = parts[0][1].device

    # the user row stays f32: it seeds the f32 accumulator
    u = torch.zeros((1, d), dtype=torch.float32, device=dev)
    for x, w in user:
        u = u + x.float() @ w.float()
    if acc0 is not None:
        u = u + acc0.float()
    if b is not None:
        u = u + b.float()

    if not rest:  # no batched stream left: the acc-init row IS the output
        out = ACTIVATIONS[activation](u)
        if user_index is not None and acc0 is not None:
            out = take_clip(out, user_index)
        return out.to(parts[0][0].dtype)

    B = max(x.shape[0] for x, _ in rest)
    gather = user_index if (user_index is not None and acc0 is not None) \
        else None
    prepared = [(x, w) for x, w in rest if isinstance(w, MariWeight)]
    if len(rest) == 1:
        # single pre-concatenated stream: no per-call operand copies
        x_rest, w_rest = rest[0]
    elif prepared:
        if len(prepared) > 1 or gather is not None:
            raise ValueError("a prepared weight among several batched "
                             "streams: at most one, and no gathered init")
        x_rest, w_rest = prepared[0]
        for x, w in rest:
            if w is not w_rest:
                u = u + x.float() @ w.float()
    else:
        x_rest = torch.cat([x.expand((B,) + tuple(x.shape[1:]))
                            for x, _ in rest], dim=-1)
        w_rest = torch.cat([w for _, w in rest], dim=0)
    return mari_matmul(x_rest, w_rest, u, gather, activation)
