"""Process topology for multi-process serving (port of
``repro.dist.topology``).

``Topology`` describes one worker's place in the serving fleet and owns the
``torch.distributed`` handshake; ``candidate_shards`` is the counterpart of
the reference's ``candidate_mesh``: one shard per rank (PyTorch's idiom, one
process per card) over the largest power-of-two prefix of the ranks. The
bucket planner rounds candidate buckets so **no shard ever receives a ragged
tail**: every stage-2 bucket divides evenly over the shards, which keeps a
sharded dispatch collective-free until the closing score all-gather.

Bucket invariants (``tests/test_torch_dist.py`` holds them to the
reference's planner):

* every bucket is a power of two and a multiple of the shard count;
* per-shard work (bucket / shards) is itself a power of two;
* total padding over a pool never exceeds one bucket.

Backend: ``nccl`` when every rank has a CUDA device of its own (world size
<= ``torch.cuda.device_count()``), ``gloo`` otherwise (the CPU, or several
ranks sharing one card). Rank r serves on ``cuda:{r % device_count}``
unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from repro_torch.common import next_pow2, prev_pow2, resolve_device


# ---------------------------------------------------------------------------
# Process topology
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Topology:
    """One worker's view of the serving fleet.

    ``coordinator`` is ``host:port`` of rank 0's rendezvous store (a
    ``tcp://`` init method), or a ``file://`` path shared by every rank.
    A single-process topology does no handshake: ``initialize`` gives it a
    one-rank group over an in-process store, so the engine's collective
    path (a one-rank NCCL group on a card) runs without a coordinator.
    """
    num_processes: int = 1
    process_id: int = 0
    coordinator: str = "localhost:12421"

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1

    def device(self, device: str | torch.device = "cuda") -> torch.device:
        """This rank's device: ``cuda:{rank % device_count}`` for a bare
        ``"cuda"``, else ``device`` as given (raises without a card)."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda",
                               self.process_id % torch.cuda.device_count())
        return dev

    def backend(self, device: str | torch.device = "cuda") -> str:
        """``nccl`` when every rank has a card of its own, else ``gloo``
        (NCCL refuses two ranks on one GPU)."""
        dev = torch.device(device)
        if (dev.type == "cuda" and dist.is_nccl_available()
                and self.num_processes <= torch.cuda.device_count()):
            return "nccl"
        return "gloo"

    def initialize(self, device: str | torch.device = "cuda", *,
                   timeout_s: float = 300.0) -> "Topology":
        """Join the default process group (idempotent). ``timeout_s`` bounds
        the rendezvous and every collective, so a dead rank fails the run
        instead of hanging it."""
        if dist.is_initialized():
            return self
        dev = self.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        timeout = datetime.timedelta(seconds=timeout_s)
        backend = self.backend(dev)
        if not self.is_distributed:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0, timeout=timeout)
            return self
        init = (self.coordinator if self.coordinator.startswith("file://")
                else f"tcp://{self.coordinator}")
        dist.init_process_group(backend, init_method=init,
                                world_size=self.num_processes,
                                rank=self.process_id, timeout=timeout)
        return self

    @staticmethod
    def shutdown() -> None:
        """Leave the default process group (no-op when there is none)."""
        if dist.is_initialized():
            dist.destroy_process_group()

    @classmethod
    def from_env(cls) -> "Topology":
        """Read REPRO_NUM_PROCESSES / REPRO_PROCESS_ID / REPRO_COORDINATOR
        (the runner CLI sets them for its spawned workers)."""
        return cls(
            num_processes=int(os.environ.get("REPRO_NUM_PROCESSES", "1")),
            process_id=int(os.environ.get("REPRO_PROCESS_ID", "0")),
            coordinator=os.environ.get("REPRO_COORDINATOR",
                                       "localhost:12421"))


def candidate_shards(n_ranks: int, n_shards: int | None = None) -> int:
    """Shard count over ``n_ranks`` ranks, one shard per rank: the largest
    power of two <= ``n_ranks``, clamped by ``n_shards`` (a power of two).
    Ranks past the count serve no rows but still receive the scores."""
    n = prev_pow2(max(1, n_ranks))
    if n_shards is not None:
        if n_shards & (n_shards - 1):
            raise ValueError(f"n_shards must be a power of two: {n_shards}")
        n = min(n, n_shards)
    return n


# ---------------------------------------------------------------------------
# Collective-aware bucket planner
# ---------------------------------------------------------------------------

def bucket_for(n: int, shards: int, *, min_bucket: int = 128,
               max_batch: int = 4096) -> int:
    """Smallest valid bucket holding ``n`` rows: a power of two, at least
    ``max(min_bucket, shards)``, at most ``max_batch`` — so bucket % shards
    == 0 and per-shard work is a power of two.

    With ``shards > 1`` a non-power-of-two ``max_batch`` cap is rounded
    DOWN to the nearest power of two (never below ``shards``): a cap-sized
    bucket must itself divide evenly over the shards. Unsharded callers
    keep the raw cap (a cap-sized bucket needs no alignment).
    """
    if shards & (shards - 1):
        raise ValueError(f"shard count must be a power of two: {shards}")
    hi = max_batch if shards == 1 else max(prev_pow2(max_batch), shards)
    lo = max(min(min_bucket, hi), shards)
    return min(hi, next_pow2(max(n, lo)))


def plan_buckets(pool: int, shards: int, *, min_bucket: int = 128,
                 max_batch: int = 4096) -> list[int]:
    """Decompose a candidate pool into shard-aligned buckets.

    Greedy: full ``max_batch`` buckets while the remainder overflows one,
    then a single tail bucket sized to the remainder — so total padding is
    strictly less than the tail bucket and every bucket divides evenly
    over ``shards``.
    """
    if pool <= 0:
        return []
    out: list[int] = []
    rem = pool
    while rem > 0:
        b = bucket_for(rem, shards, min_bucket=min_bucket,
                       max_batch=max_batch)
        out.append(b)
        rem -= b
    return out
