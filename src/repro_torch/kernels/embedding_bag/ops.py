"""EmbeddingBag: the CUDA kernel's wrappers and their plain PyTorch versions
(port of ``repro.kernels.embedding_bag``: ``ops.py`` and ``ref.py``).

Two entries, one kernel (``csrc/embedding_bag.cu``, a CSR-offset segmented
reduction, one warp per bag):

* ``embedding_bag(table, ids, segment_ids, num_segments, combiner,
  weights=None)`` — the reference's ``ops.py`` contract: flat ``(nnz,)``
  ids with the bag (segment) each belongs to, sorted or not; returns
  ``(num_segments, D)``. On the card the CSR offsets and the ids (and
  weights) in bag order come from a stable counting sort by segment in
  one hand-written cooperative launch (``embedding_bag_csr_prep``, tiled
  by ``csr_plan``; no host sync): where the segment ids never decrease it
  writes the bag boundaries and a flag on the device, and the bag kernel
  reads the caller's ids in place; otherwise tile histograms, a scan over
  (segment, tile) and a stable scatter follow in the same launch.
  ``csr_prep_plain`` is the sort-based preparation, kept as its plain
  version. An empty bag is 0 and ``mean`` is ``sum / max(count, 1)``.
* ``embedding_bag_fixed(table, ids, combiner, weights=None)`` — a fixed
  hotness: ids ``(B, H)``, bag ``b`` is row ``b`` (implicit offsets
  ``b * H``), so nothing is sorted. This is the executor's pooled
  ``embedding`` op.

A CPU tensor goes to the plain version (``index_select`` + ``index_add_``
/ ``sum``); a CUDA tensor launches the kernel or raises. Index contract,
the same in the kernel and the plain versions: ids outside ``[0, V)``
clamp to ``[0, V - 1]`` (no id ever reads outside the table), and
segment ids outside ``[0, num_segments)`` are dropped, as
``jax.ops.segment_sum`` drops them. Ids may be int32 (the reference's
type) or int64. The table (and the output) may be fp32 or bf16 (summed
in f32, each bag rounded once); per-id weights stay fp32. ``LAUNCHES``
counts kernel launches per entry, bf16 under ``<entry>/bf16``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.dist.sharding import shard_local
from repro_torch.kernels import build

Tensor = torch.Tensor

VARIANTS = ("csr", "fixed")
COMBINERS = ("sum", "mean")
# kernel launches per entry (one per launch, counted nowhere else)
LAUNCHES = dict.fromkeys(VARIANTS + tuple(f"{v}/bf16" for v in VARIANTS), 0)
CSR_TILE = 4096                 # most segment ids a tile, where counts allow
CSR_MAX_SCRATCH = 1 << 22       # bound on tiles * (S + 1) int32 counts


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_combiner(combiner: str) -> None:
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}; known: "
                         f"{list(COMBINERS)}")


def _clamp_ids(ids: Tensor, vocab: int) -> Tensor:
    return ids.long().clamp(0, vocab - 1)


def embedding_bag_plain(table: Tensor, ids: Tensor, segment_ids: Tensor,
                        num_segments: int, combiner: str = "sum",
                        weights: Tensor | None = None) -> Tensor:
    """Plain PyTorch version: gather the rows, weight them, ``index_add_``
    them into their segments, in f32 (a bf16 table's bags rounded once,
    as the kernel's)."""
    _check_combiner(combiner)
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    seg = segment_ids[keep].long()
    rows = torch.index_select(table, 0,
                              _clamp_ids(ids[keep], table.shape[0])).float()
    if weights is not None:
        rows = rows * weights[keep][:, None]
    out = rows.new_zeros((num_segments, table.shape[1]))
    out.index_add_(0, seg, rows)
    if combiner == "mean":
        counts = rows.new_zeros((num_segments,)).index_add_(
            0, seg, rows.new_ones(seg.shape))
        out = out / counts.clamp(min=1.0)[:, None]
    return out.to(table.dtype)


def embedding_bag_fixed_plain(table: Tensor, ids: Tensor,
                              combiner: str = "sum",
                              weights: Tensor | None = None) -> Tensor:
    """Plain PyTorch version of the fixed-hotness entry: ids (B, H) ->
    (B, D), the H rows of each bag summed (or averaged) in f32 (a bf16
    table's bags rounded once, as the kernel's)."""
    _check_combiner(combiner)
    B, H = ids.shape
    rows = torch.index_select(table, 0, _clamp_ids(ids, table.shape[0])
                              .reshape(-1)).reshape(B, H, table.shape[1])
    rows = rows.float()
    if weights is not None:
        rows = rows * weights[..., None]
    out = rows.sum(dim=1)
    out = out / max(H, 1) if combiner == "mean" else out
    return out.to(table.dtype)


def csr_plan(nnz: int, num_segments: int, blocks: int) -> tuple[int, int]:
    """(tile, n_tiles) of the counting sort launched as ``blocks`` blocks
    (one an SM): a tile each where nnz allows (a multiple of 32, at most
    ``CSR_TILE``, so small inputs still fill the card), larger where
    (n_tiles * (S + 1)) counts would pass ``CSR_MAX_SCRATCH``; at least
    one tile, so an empty input still writes its offsets."""
    keys = num_segments + 1
    tile = min(CSR_TILE, -(-nnz // blocks))
    tile = max(tile, -(-nnz // max(1, CSR_MAX_SCRATCH // keys)))
    tile = max(32, -(-tile // 32) * 32)
    return tile, max(1, -(-nnz // tile))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def csr_prep_plain(segment_ids: Tensor, num_segments: int
                   ) -> tuple[Tensor, Tensor]:
    """The sort-based CSR preparation: ``(order, offsets)`` with ``order``
    the stable sort of the segments (dropped ones, outside
    ``[0, num_segments)``, sort last, past ``offsets[S]``) and ``offsets``
    (S + 1,) int64 the bag boundaries. ``ids[order]`` is what the
    counting sort writes."""
    S = int(num_segments)
    seg = torch.where((segment_ids >= 0) & (segment_ids < S),
                      segment_ids.long(), S)
    seg_sorted, order = torch.sort(seg, stable=True)
    offsets = torch.searchsorted(
        seg_sorted, torch.arange(S + 1, device=seg.device))
    return order, offsets


_BAG = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
        + [ctypes.c_int64] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_SIGNATURES = {
    "embedding_bag_f32": (_BAG, ctypes.c_int),
    "embedding_bag_bf16": (_BAG, ctypes.c_int),
    "embedding_bag_csr_prep": (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_int] * 4
        + [ctypes.c_void_p] * 5, ctypes.c_int),
}


def _lib() -> ctypes.CDLL:
    return build.load("embedding_bag", (), _SIGNATURES)


def csr_prep(segment_ids: Tensor, ids: Tensor, weights: Tensor | None,
             S: int) -> tuple[Tensor, Tensor, Tensor | None, Tensor]:
    """The CUDA preparation alone, one launch: ``(offsets, ids_bag,
    w_bag, in_order)``. ``in_order`` (one int32 on the card) is 1 where
    the segment ids never decrease: then ``ids`` and ``weights`` are
    already in bag order and ``ids_bag`` / ``w_bag`` are left unwritten;
    where it is 0 they hold the ids (and weights) in bag order. Every size
    comes from the host, so nothing synchronises."""
    dev = ids.device
    if segment_ids.device != dev:
        raise ValueError(f"embedding_bag: segment_ids on "
                         f"{segment_ids.device}, ids on {dev}")
    if segment_ids.dtype not in (torch.int32, torch.int64):
        segment_ids = segment_ids.long()
    nnz = ids.numel()
    if nnz >= 2 ** 31:
        raise ValueError(f"embedding_bag: {nnz} ids, the CSR entry takes "
                         f"fewer than 2**31")
    blocks = _sm_count(dev.index if dev.index is not None
                       else torch.cuda.current_device())
    tile, n_tiles = csr_plan(nnz, S, blocks)
    seg = segment_ids.contiguous()
    ids = ids.contiguous()
    weights = weights.contiguous() if weights is not None else None
    scratch = torch.empty(1 + n_tiles + blocks + n_tiles * (S + 1),
                          dtype=torch.int32, device=dev)
    offsets = torch.empty(S + 1, dtype=torch.int64, device=dev)
    ids_out = torch.empty_like(ids)
    w_out = torch.empty_like(weights) if weights is not None else None
    lib = _lib()
    with torch.cuda.device(dev):           # launch in the tensor's context
        rc = lib.embedding_bag_csr_prep(
            seg.data_ptr(), int(seg.dtype == torch.int64), ids.data_ptr(),
            int(ids.dtype == torch.int64),
            weights.data_ptr() if weights is not None else None, nnz, S,
            tile, n_tiles, blocks, scratch.data_ptr(), offsets.data_ptr(),
            ids_out.data_ptr(),
            w_out.data_ptr() if w_out is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "embedding_bag CSR preparation")
    return offsets, ids_out, w_out, scratch[:1]


def _check_launch(table: Tensor, ids: Tensor, weights: Tensor | None,
                  offsets: Tensor | None = None) -> None:
    build.refuse_autograd("embedding_bag", table, weights)
    build.one_dtype("embedding_bag", table=table)
    if weights is not None and weights.dtype != torch.float32:
        raise TypeError(f"embedding_bag CUDA kernel takes float32 weights, "
                        f"got {weights.dtype}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"embedding_bag ids must be int32 or int64, got "
                        f"{ids.dtype}")
    for name, t in (("ids", ids), ("offsets", offsets),
                    ("weights", weights)):
        if t is not None and t.device != table.device:
            raise ValueError(f"embedding_bag: {name} on {t.device}, table "
                             f"on {table.device}")


def _launch(variant: str, table: Tensor, ids: Tensor,
            offsets: Tensor | None, weights: Tensor | None, S: int,
            H: int, combiner: str, bag: tuple | None = None) -> Tensor:
    """One bag-kernel launch. ``bag``: ``csr_prep``'s ``(ids_bag, w_bag,
    in_order)``, read in place of ``ids`` / ``weights`` where its flag
    is 0."""
    _check_launch(table, ids, weights, offsets)
    ids_bag, w_bag, in_order = bag if bag is not None else (None,) * 3
    V, D = table.shape
    out = torch.empty((S, D), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out                        # nothing to launch
    if V == 0:
        raise ValueError("embedding_bag: the table has no rows")
    table = table.contiguous()
    ids = ids.contiguous()
    weights = weights.contiguous() if weights is not None else None
    lib = _lib()
    bf16 = table.dtype == torch.bfloat16
    entry = lib.embedding_bag_bf16 if bf16 else lib.embedding_bag_f32
    with torch.cuda.device(table.device):   # launch in the tensor's context
        rc = entry(
            table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
            offsets.data_ptr() if offsets is not None else None,
            weights.data_ptr() if weights is not None else None,
            *(t.data_ptr() if t is not None else None
              for t in (ids_bag, w_bag, in_order)),
            out.data_ptr(), S, D, V, H, int(combiner == "mean"),
            torch.cuda.current_stream(table.device).cuda_stream)
    build.check(lib, rc, "embedding_bag")
    build.count_launch(LAUNCHES, f"{variant}/bf16" if bf16 else variant)
    return out


def _device_of(table: Tensor) -> str:
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"embedding_bag: unsupported device {table.device}")
    return table.device.type


@shard_local("embedding_bag")
def embedding_bag(table: Tensor, ids: Tensor, segment_ids: Tensor,
                  num_segments: int, combiner: str = "sum",
                  weights: Tensor | None = None) -> Tensor:
    """Pooled multi-hot lookup: ``out[s] = pool_{i: seg[i]==s}
    w[i] * table[ids[i]]``; table (V, D), ids / segment_ids / weights
    (nnz,); returns (num_segments, D)."""
    _check_combiner(combiner)
    if table.ndim != 2 or ids.ndim != 1 or segment_ids.shape != ids.shape:
        raise ValueError(f"embedding_bag takes table (V, D) and flat ids / "
                         f"segment_ids of one shape, got "
                         f"{tuple(table.shape)}, {tuple(ids.shape)}, "
                         f"{tuple(segment_ids.shape)}")
    if weights is not None and weights.shape != ids.shape:
        raise ValueError(f"weights must be {tuple(ids.shape)}, got "
                         f"{tuple(weights.shape)}")
    if _device_of(table) == "cpu":
        return embedding_bag_plain(table, ids, segment_ids, num_segments,
                                   combiner, weights)
    S = int(num_segments)
    if S * table.shape[1] == 0:           # nothing to prepare or launch
        return _launch("csr", table, ids, None, weights, S, 0, combiner)
    _check_launch(table, ids, weights)
    # ids of dropped segments land past the last bag: they sit beyond
    # offsets[S] and the kernel never reads them
    offsets, *bag = csr_prep(segment_ids, ids, weights, S)
    return _launch("csr", table, ids, offsets, weights, S, 0, combiner,
                   bag=tuple(bag))


@shard_local("embedding_bag_fixed", rows=("ids", "weights"))
def embedding_bag_fixed(table: Tensor, ids: Tensor, combiner: str = "sum",
                        weights: Tensor | None = None) -> Tensor:
    """Fixed-hotness pooled lookup: ids (B, H) -> (B, D), bag b = row b."""
    _check_combiner(combiner)
    if table.ndim != 2 or ids.ndim != 2:
        raise ValueError(f"embedding_bag_fixed takes table (V, D) and ids "
                         f"(B, H), got {tuple(table.shape)}, "
                         f"{tuple(ids.shape)}")
    if weights is not None and weights.shape != ids.shape:
        raise ValueError(f"weights must be {tuple(ids.shape)}, got "
                         f"{tuple(weights.shape)}")
    if _device_of(table) == "cpu":
        return embedding_bag_fixed_plain(table, ids, combiner, weights)
    B, H = ids.shape
    return _launch("fixed", table, ids, None, weights, B, H, combiner)
