"""Compiled execution: one captured CUDA graph per call signature (the
port's counterpart of ``jax.jit(Executor(g, mode).run)``).

``CompiledRun(fn)`` wraps a function ``fn(params, feeds) -> {name:
tensor}``. Like jit's cache it keeps one *entry* per signature: the feeds'
names, shapes and dtypes, plus the address (``data_ptr``) of every tensor
the body reads by reference — the params, and the ``refs`` a caller passes
(the device tier's persistent rep tables). An entry owns static input
buffers, one per feed. On CUDA it is built by copying the first call's
feeds in, running ``fn`` once on a side stream (kernels build,
``cudaFuncSetAttribute`` runs, cuBLAS picks its algorithms) and capturing
one more run into a ``torch.cuda.CUDAGraph``. A call then does three things
under its pool's lock, all on the caller's current stream:

1. copy the feeds into the static inputs (a host tensor — pinned, for a
   non-blocking copy — goes straight to the card; a list of tensors is
   stacked into its buffer with ``torch.cat(..., out=...)``);
2. ``replay()``;
3. copy the outputs out into fresh tensors.

On the CPU the same static-buffer discipline runs ``fn`` eagerly in place
of the replay, so the CPU tests cover the copy-in / copy-out logic.
``compilations`` counts the entries built. On CUDA a failed capture or
replay raises (``GraphCaptureError`` for a capture): nothing runs the
eager body on the card in a graph's place.

Traps, and what this module does about each:

* **Static outputs are overwritten by the next replay.** The engine keeps
  several calls in flight (``begin_coalesced`` launches pack k + 1 before
  pack k is collected; the batcher holds groups in flight), so outputs are
  copied out inside the locked section, behind the replay on the same
  stream; the caller only ever sees the copies.
* **Python-side counters do not run on replay.** The kernel wrappers count
  launches in ``LAUNCHES`` / ``PREPARES`` / ``STRIDE_COPIES``
  (``kernels.build.count_launch``). A capture runs no kernel on the card,
  so its counts are recorded (``build.recording_launches``, per thread)
  instead of counted, and added once per replay: the counts keep meaning
  "launches the card ran". Warm-up runs did run, and count.
* **Addresses are frozen into the graph.** ``mari_matmul`` encodes x's TMA
  descriptor per call from x's address, and ``dot_interaction`` encodes a
  3-D tensor map of x and picks its copy route from ``x.data_ptr() % 16``;
  capture freezes both. That is sound because every tensor a graph reads
  keeps its address for the entry's life: feeds live in the entry's static
  buffers, intermediates in the graph's pool, and the params and refs are
  held by the entry and part of its signature (a new address is a new
  entry, never a stale read).
* **Other threads.** ``RankingService`` runs one batcher thread per
  scenario; they keep launching, pinning host memory and synchronising
  while one engine captures. Capture runs with
  ``capture_error_mode="thread_local"`` on the pool's own capture stream,
  so only the capturing thread's calls are checked. ``torch.cuda.Stream()``
  hands out 32 pool streams per priority round-robin, so after 32 pools
  two engines' capture streams can be one CUDA stream, and one engine's
  warm-up or capture would join the other's capture: a process-wide lock
  (``_CAPTURE_LOCK``) serialises every warm-up and capture, which happen
  once per signature.
* **Garbage collection during a capture.** Engines hold reference cycles
  (bound methods of their own), so a dropped engine's graphs are freed
  by Python's cyclic collector, which runs at any allocation in any
  thread. Freeing a graph calls ``cudaGraphExecDestroy``, which a capture
  in progress in that thread forbids: the call fails and the capture is
  invalidated. The automatic collector is paused for each capture
  (``_gc_paused``), as ``torch.cuda.graph`` collects before its capture.
* **Memory.** One graph memory pool per engine (``GraphPool``:
  ``torch.cuda.graph_pool_handle()``), shared by its stage-1 and stage-2
  graphs. Graphs of one pool reuse each other's intermediate memory, which
  is safe because every replay of the pool runs under the pool's lock on
  one stream and copies its outputs out before the lock is released; the
  static inputs are allocated outside the pool. ``GraphPool.
  reserved_bytes`` adds up ``torch.cuda.memory_reserved()`` growth over
  the pool's captures.

Params are keyed by object identity: the addresses of a params tree's
tensors are read once per params object (an engine's params never change
in place), and the entry keeps the object alive.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.common import resolve_device, tree_leaves
from repro_torch.kernels import build

Tensor = torch.Tensor
Feed = Any          # Tensor | np.ndarray | sequence of Tensors (stacked)

# taken inside a pool's lock, never the other way round
_CAPTURE_LOCK = threading.Lock()


@contextlib.contextmanager
def _gc_paused():
    """No automatic cyclic collection while a capture runs (captures are
    serialised by ``_CAPTURE_LOCK``, so the pauses never nest)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class GraphCaptureError(RuntimeError):
    """A CUDA graph capture failed; there is no eager fallback on the card."""


class GraphPool:
    """One graph memory pool, the capture stream and the lock that
    serialises every replay and capture drawing on the pool."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.lock = threading.Lock()
        self.reserved_bytes = 0    # memory_reserved() growth over captures
        self.captures = 0
        if self.device.type == "cuda":
            self.handle = torch.cuda.graph_pool_handle()
            self.capture_stream = torch.cuda.Stream(self.device)
        else:
            self.handle = self.capture_stream = None


@dataclasses.dataclass(eq=False)
class _Entry:
    static: dict[str, Tensor]     # one input buffer per copied feed
    refs: dict[str, Tensor]       # read in place (held: address in the key)
    params: Any                   # held: its addresses are in the key
    graph: Any = None             # torch.cuda.CUDAGraph (None on the CPU)
    out: dict[str, Tensor] | None = None   # the graph's static outputs
    launches: list = dataclasses.field(default_factory=list)


def _feed_spec(v: Feed) -> tuple[tuple[int, ...], torch.dtype]:
    """The static buffer's (shape, dtype) for one feed."""
    if isinstance(v, Tensor):
        return v.shape, v.dtype
    if isinstance(v, (list, tuple)):
        first = v[0]
        rows = sum(t.shape[0] for t in v)
        return (rows,) + tuple(first.shape[1:]), first.dtype
    a = np.asarray(v)
    return a.shape, torch.from_numpy(a[:0].copy()).dtype


def _copy_in(buf: Tensor, v: Feed) -> None:
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            buf.copy_(v[0], non_blocking=True)
        else:
            torch.cat(list(v), dim=0, out=buf)
        return
    if not isinstance(v, Tensor):
        v = torch.from_numpy(np.ascontiguousarray(v))
    buf.copy_(v, non_blocking=True)


def _leaf_key(x) -> int:
    return x.data_ptr() if isinstance(x, Tensor) else id(x)


class CompiledRun:
    """``fn(params, feeds)`` behind one captured graph per signature."""

    def __init__(self, fn: Callable[[Any, dict], Mapping[str, Tensor]], *,
                 device: str | torch.device = "cuda",
                 pool: GraphPool | None = None):
        self.fn = fn
        self.device = resolve_device(device)
        self.pool = pool if pool is not None else GraphPool(self.device)
        if self.pool.device.type != self.device.type:
            raise ValueError(f"pool on {self.pool.device}, run on "
                             f"{self.device}")
        self._entries: dict[tuple, _Entry] = {}
        self._param_keys: dict[int, tuple[Any, tuple]] = {}
        self._build_lock = threading.Lock()

    @property
    def compilations(self) -> int:
        """Entries built (graphs captured on CUDA; static-buffer sets on
        the CPU): jit's cache size."""
        return len(self._entries)

    def _params_key(self, params) -> tuple:
        hit = self._param_keys.get(id(params))
        if hit is None or hit[0] is not params:
            hit = (params, tuple(_leaf_key(x) for x in tree_leaves(params)))
            self._param_keys[id(params)] = hit
        return hit[1]

    def signature(self, params, feeds: Mapping[str, Feed],
                  refs: Mapping[str, Tensor] | None = None) -> tuple:
        """The cache key of a call: feed names / shapes / dtypes, the refs'
        addresses, shapes and dtypes, and the params' addresses (in the
        callers' dict order: another order is another entry, never a
        wrong one)."""
        fk = tuple((k,) + _feed_spec(v) for k, v in feeds.items())
        rk = tuple((k, t.data_ptr(), t.shape, t.dtype)
                   for k, t in (refs or {}).items())
        return fk, rk, self._params_key(params)

    def __call__(self, params, feeds: Mapping[str, Feed],
                 refs: Mapping[str, Tensor] | None = None
                 ) -> dict[str, Tensor]:
        """Run ``fn(params, {**feeds, **refs})`` through the entry of this
        call's signature (built on first use), under
        ``torch.inference_mode``; returns fresh output tensors, enqueued on
        the current stream."""
        with torch.inference_mode():
            return self._call(params, feeds, dict(refs or {}))

    def _call(self, params, feeds: Mapping[str, Feed],
              refs: dict[str, Tensor]) -> dict[str, Tensor]:
        key = self.signature(params, feeds, refs)
        entry = self._entries.get(key)
        if entry is None:
            with self._build_lock:
                entry = self._entries.get(key)
                if entry is None:
                    entry = self._build(params, feeds, refs)
                    self._entries[key] = entry
        pool = self.pool
        with pool.lock:
            for k, v in feeds.items():
                _copy_in(entry.static[k], v)
            if entry.graph is not None:
                entry.graph.replay()
                out = entry.out
            else:
                out = self.fn(params, {**entry.static, **entry.refs})
            out = {k: v.clone() for k, v in out.items()}
        build.add_launches(entry.launches)
        return out

    def _build(self, params, feeds: Mapping[str, Feed],
               refs: dict[str, Tensor]) -> _Entry:
        static = {}
        for k, v in feeds.items():
            shape, dtype = _feed_spec(v)
            static[k] = torch.empty(shape, dtype=dtype, device=self.device)
        entry = _Entry(static=static, refs=refs, params=params)
        if self.device.type != "cuda":
            return entry
        pool = self.pool
        with pool.lock, _CAPTURE_LOCK:
            for k, v in feeds.items():
                _copy_in(static[k], v)
            args = {**static, **refs}
            cur = torch.cuda.current_stream(self.device)
            side = pool.capture_stream
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self.fn(params, args)
            cur.wait_stream(side)
            reserved0 = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            # capture_begin / capture_end directly: torch.cuda.graph's
            # context manager synchronises the whole device and empties
            # the allocator's cache, under other engines' threads
            with torch.cuda.stream(side), _gc_paused(), \
                    build.recording_launches() as rec:
                graph.capture_begin(pool=pool.handle,
                                    capture_error_mode="thread_local")
                try:
                    out = dict(self.fn(params, args))
                except BaseException as e:
                    try:
                        graph.capture_end()
                    except Exception:
                        pass            # the capture is already invalid
                    raise GraphCaptureError(
                        f"CUDA graph capture failed ({type(e).__name__}: "
                        f"{e}); compiled stages do not fall back to eager "
                        f"on the card") from e
                try:
                    graph.capture_end()
                except Exception as e:
                    raise GraphCaptureError(
                        f"CUDA graph capture failed at its end "
                        f"({type(e).__name__}: {e}); compiled stages do "
                        f"not fall back to eager on the card") from e
            cur.wait_stream(side)
            pool.reserved_bytes += (torch.cuda.memory_reserved(self.device)
                                    - reserved0)
            pool.captures += 1
        entry.graph, entry.out, entry.launches = graph, out, list(rec)
        return entry
