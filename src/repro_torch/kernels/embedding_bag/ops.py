"""EmbeddingBag: the CUDA kernel's wrappers and their plain PyTorch versions
(port of ``repro.kernels.embedding_bag``: ``ops.py`` and ``ref.py``).

Two entries, one kernel (``csrc/embedding_bag.cu``, a CSR-offset segmented
reduction, one warp per bag):

* ``embedding_bag(table, ids, segment_ids, num_segments, combiner,
  weights=None)`` — the reference's ``ops.py`` contract: flat ``(nnz,)``
  ids with the bag (segment) each belongs to, sorted or not; returns
  ``(num_segments, D)``. The wrapper stable-sorts by segment and builds
  CSR offsets (the cumulative bincount of the segments, read off the
  sorted segments with ``searchsorted``, so no host sync); an empty bag is
  0 and ``mean`` is ``sum / max(count, 1)``.
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
type) or int64. ``LAUNCHES`` counts kernel launches per entry.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

VARIANTS = ("csr", "fixed")
COMBINERS = ("sum", "mean")
# kernel launches per entry (one per launch, counted nowhere else)
LAUNCHES = dict.fromkeys(VARIANTS, 0)


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
    them into their segments."""
    _check_combiner(combiner)
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    seg = segment_ids[keep].long()
    rows = torch.index_select(table, 0,
                              _clamp_ids(ids[keep], table.shape[0]))
    if weights is not None:
        rows = rows * weights[keep][:, None]
    out = table.new_zeros((num_segments, table.shape[1]))
    out.index_add_(0, seg, rows)
    if combiner == "mean":
        counts = table.new_zeros((num_segments,)).index_add_(
            0, seg, table.new_ones(seg.shape))
        out = out / counts.clamp(min=1.0)[:, None]
    return out


def embedding_bag_fixed_plain(table: Tensor, ids: Tensor,
                              combiner: str = "sum",
                              weights: Tensor | None = None) -> Tensor:
    """Plain PyTorch version of the fixed-hotness entry: ids (B, H) ->
    (B, D), the H rows of each bag summed (or averaged)."""
    _check_combiner(combiner)
    B, H = ids.shape
    rows = torch.index_select(table, 0, _clamp_ids(ids, table.shape[0])
                              .reshape(-1)).reshape(B, H, table.shape[1])
    if weights is not None:
        rows = rows * weights[..., None]
    out = rows.sum(dim=1)
    return out / max(H, 1) if combiner == "mean" else out


def _lib() -> ctypes.CDLL:
    lib = build.load("embedding_bag")
    if lib.embedding_bag_f32.argtypes is None:
        lib.embedding_bag_f32.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
            + [ctypes.c_int64] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.embedding_bag_f32.restype = ctypes.c_int
    return lib


def _launch(variant: str, table: Tensor, ids: Tensor,
            offsets: Tensor | None, weights: Tensor | None, S: int,
            H: int, combiner: str) -> Tensor:
    build.refuse_autograd("embedding_bag", table, weights)
    if table.dtype != torch.float32 or (
            weights is not None and weights.dtype != torch.float32):
        raise TypeError(f"embedding_bag CUDA kernel takes float32 only, "
                        f"table is {table.dtype}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"embedding_bag ids must be int32 or int64, got "
                        f"{ids.dtype}")
    for name, t in (("ids", ids), ("offsets", offsets),
                    ("weights", weights)):
        if t is not None and t.device != table.device:
            raise ValueError(f"embedding_bag: {name} on {t.device}, table "
                             f"on {table.device}")
    V, D = table.shape
    out = torch.empty((S, D), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out                        # nothing to launch
    if V == 0:
        raise ValueError("embedding_bag: the table has no rows")
    table = table.contiguous()
    ids = ids.contiguous()
    weights = weights.contiguous() if weights is not None else None
    lib = _lib()
    with torch.cuda.device(table.device):   # launch in the tensor's context
        rc = lib.embedding_bag_f32(
            table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
            offsets.data_ptr() if offsets is not None else None,
            weights.data_ptr() if weights is not None else None,
            out.data_ptr(), S, D, V, H, int(combiner == "mean"),
            torch.cuda.current_stream(table.device).cuda_stream)
    build.check(lib, rc, "embedding_bag")
    build.count_launch(LAUNCHES, variant)
    return out


def _device_of(table: Tensor) -> str:
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"embedding_bag: unsupported device {table.device}")
    return table.device.type


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
    # ids of dropped segments sort past the last bag: they sit beyond
    # offsets[S] and the kernel never reads them
    seg = torch.where((segment_ids >= 0) & (segment_ids < S),
                      segment_ids.long(), S)
    seg_sorted, order = torch.sort(seg, stable=True)
    offsets = torch.searchsorted(
        seg_sorted, torch.arange(S + 1, device=seg.device))
    return _launch("csr", table, ids[order], offsets,
                   weights[order] if weights is not None else None, S,
                   0, combiner)


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
