"""Candidate-axis sharding of serving stage 2 (the serving API of
``repro.dist.sharding``).

Stage 2 is row-parallel over candidates: ``fn(params, rep_table,
user_index, candidate_feeds) -> outs``. Params and the stacked ``(U, ...)``
rep tables replicate (every shard scores rows of every user), the per-row
user index and the candidate rows split over rows, one block per shard, and
the closing all-gather — the serving step's one collective — hands every
rank the full score vector. ``candidate_pspecs`` states that with
``torch.distributed.tensor`` placements as plain data (no DTensor runs on
the path); ``gather_rows`` is the gather.

The reference's LM / ZeRO / GNN / ``recsys_param_pspecs`` rule sets serve
its training launchers, which the port does not have.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def candidate_pspecs(*, replicate_out: bool = True) -> tuple[tuple, object]:
    """(argument placements, output placement) of the row-wise stage 2
    ``fn(params, rep_table, user_index, candidate_feeds)``: params and rep
    tables ``Replicate()``, user index and candidate rows ``Shard(0)``;
    the output ``Replicate()`` after the closing all-gather, or
    ``Shard(0)`` with ``replicate_out=False`` (each rank keeps its block).
    Per-entry rep-table placements: ``core.split.rep_table_pspecs``."""
    from torch.distributed.tensor import Replicate, Shard
    repl, rows = Replicate(), Shard(0)
    return (repl, repl, rows, rows), (repl if replicate_out else rows)


def group_ready() -> bool:
    """True once this process has joined a default process group."""
    return dist.is_available() and dist.is_initialized()


def world(group=None) -> tuple[int, int]:
    """(size, this process's rank) of ``group`` (the default group for
    None); (1, 0) without a process group."""
    if not group_ready():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def gather_rows(x: Tensor, group=None) -> Tensor:
    """All-gather ``x`` over its leading dim: ``(world * rows, ...)``, block
    i from rank i.

    * NCCL: ``all_gather_into_tensor`` on the card, enqueued on the current
      stream (the caller records its event after this returns);
    * gloo: ``all_gather`` on the tensors where they lie. A CUDA block is
      staged through the host by gloo itself, behind the current stream's
      work; the call returns once the host side of the collective is
      done, and the result lies on the block's device;
    * no process group: ``x`` itself, no collective (a one-rank group
      still runs its collective).
    """
    if not group_ready():
        return x
    n = world(group)[0]
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather(list(out.chunk(n)), x, group=group)
    return out
