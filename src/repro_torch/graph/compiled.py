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

Tracing (``set_tracer``; the engine names its runs ``stage1`` and
``stage2``): each call records the three steps as spans ``<name>.copy_in``,
``<name>.replay`` and ``<name>.copy_out`` with ``graph=`` the entry's
ordinal (one ``Tracer.steps`` entry), and ``<name>.lock`` when it had to
wait for the pool's lock. An entry built on the card while a tracer is
attached, and no profiler is running, also gets a *kernel map*: one
profiled run of its steps in set-up (the body eagerly inside the caller's
``node_ranges``, then one replay) names each device op a step launches
and, per kernel of the graph, the executor node and host op that launched
it in the eager run (``obs.kernel_map``). The map is pinned in the tracer
as a ``<name>.graph`` event; what is captured is the same with tracing on
or off. With no tracer a call reads no clock.

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

**Training steps** (``CompiledStep``, over ``CompiledRun(fn, grad=True)``).
The body ``fn(state, batch)`` computes a loss and its gradients by
autograd and updates the state (params and optimizer state) in place: the
state is passed where an engine passes its params (its addresses are the
key, as the reference donates it), the batch as feeds. Grad mode stays on
for the warm-up and the capture (autograd runs the backward on the
capture stream, where the forward ran). Three traps:

* **The warm-up mutates the state.** The warm-up run on the side stream
  is a real step, so it *is* the first call's step: the first call returns
  the warm-up's outputs and skips the replay; every later call replays.
  After N calls the state has taken exactly N steps.
* **Memory.** The warm-up's activations go back to the allocator's cache,
  which the graph's private pool cannot reuse, so the cache is emptied
  before a training capture: at full size the two would not fit together.
* **A restored state** (``CheckpointManager.restore`` returns new tensors)
  is copied into the captured state with ``copy_``; it never starts a
  second graph over a second copy of the state (``CompiledStep.adopt``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.common import resolve_device, tree_leaves
from repro_torch.kernels import build
from repro_torch.obs import kernel_map as kmaps

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
    # a training entry's warm-up outputs: the first call's step
    first: dict[str, Tensor] | None = None
    gid: int = 0                  # the entry's ordinal (trace ``graph=``)
    kmap: dict | None = None      # kernel map (``obs.kernel_map``), traced


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
                 pool: GraphPool | None = None, grad: bool = False,
                 name: str = "run",
                 node_ranges: Callable[[], Any] = contextlib.nullcontext):
        self.fn = fn
        self.grad = grad
        self.tracer = None
        self.name = name
        # the context a kernel map's eager run is made in: one profiler
        # range per node of ``fn`` (``graph.executor.node_ranges``)
        self.node_ranges = node_ranges
        self._steps = tuple(f"{name}.{k}"
                            for k in ("copy_in", "replay", "copy_out"))
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

    def set_tracer(self, tracer) -> None:
        """Attach a ``Tracer`` (None detaches it). Each call then records
        ``<name>.copy_in``, ``<name>.replay`` and ``<name>.copy_out`` spans
        (``graph=`` the entry's ordinal), and ``<name>.lock`` when another
        thread held the pool's lock. An entry built on the card while one
        is attached also gets a kernel map (``obs.kernel_map``), pinned in
        it as a ``<name>.graph`` event; the maps built so far are pinned in
        a newly attached tracer."""
        self.tracer = tracer
        if tracer is not None:
            for entry in self._entries.values():
                self._pin(tracer, entry)

    def _pin(self, tracer, entry: _Entry) -> None:
        if entry.kmap is not None:
            tracer.pin(f"{self.name}.graph", entry.gid, graph=entry.gid,
                       **entry.kmap)

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
        ``torch.inference_mode`` (grad mode for a training step); returns
        fresh output tensors, enqueued on the current stream."""
        mode = torch.enable_grad() if self.grad else torch.inference_mode()
        with mode:
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
        trc, lock = self.tracer, self.pool.lock
        if trc is None:
            lock.acquire()
        else:
            t0 = time.perf_counter()
            if not lock.acquire(blocking=False):
                lock.acquire()
                t1 = time.perf_counter()
                trc.complete(f"{self.name}.lock", t0, t1 - t0)
                t0 = t1
        try:
            if entry.first is not None:      # the warm-up was this step
                out, entry.first = entry.first, None
                return out
            for k, v in feeds.items():
                _copy_in(entry.static[k], v)
            if trc is not None:
                t1 = time.perf_counter()
            if entry.graph is not None:
                entry.graph.replay()
                out = entry.out
            else:
                out = self.fn(params, {**entry.static, **entry.refs})
            if trc is not None:
                t2 = time.perf_counter()
            out = {k: v.clone() for k, v in out.items()}
            if trc is not None:
                trc.steps(self._steps, (t0, t1, t2, time.perf_counter()),
                          graph=entry.gid)
        finally:
            lock.release()
        build.add_launches(entry.launches)
        return out

    def _kernel_map(self, entry: _Entry, params, feeds: Mapping[str, Feed],
                    args: dict) -> dict:
        """Profile one run of a built entry's steps (the feeds copied in,
        the body run eagerly inside ``node_ranges`` on the capture stream,
        one replay, the outputs copied out) and read its kernel map. Under
        the pool's lock and the capture lock, in set-up; its launches are
        not counted."""
        from torch.profiler import ProfilerActivity, profile, record_function
        cur = torch.cuda.current_stream(self.device)
        side = self.pool.capture_stream
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(kmaps.STEP_RANGE + "copy_in"):
                for k, v in feeds.items():
                    _copy_in(entry.static[k], v)
            side.wait_stream(cur)
            with torch.cuda.stream(side), \
                    record_function(kmaps.STEP_RANGE + "eager"), \
                    self.node_ranges(), build.recording_launches():
                self.fn(params, args)
            cur.wait_stream(side)
            with record_function(kmaps.STEP_RANGE + "replay"):
                entry.graph.replay()
            with record_function(kmaps.STEP_RANGE + "copy_out"):
                _ = [v.clone() for v in entry.out.values()]
            cur.synchronize()
        return kmaps.kernel_map(*kmaps.profile_events(prof))

    def _build(self, params, feeds: Mapping[str, Feed],
               refs: dict[str, Tensor]) -> _Entry:
        static = {}
        for k, v in feeds.items():
            shape, dtype = _feed_spec(v)
            static[k] = torch.empty(shape, dtype=dtype, device=self.device)
        entry = _Entry(static=static, refs=refs, params=params,
                       gid=len(self._entries))
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
                warm = self.fn(params, args)
                if self.grad:
                    warm = {k: v.clone() for k, v in warm.items()}
            cur.wait_stream(side)
            if self.grad:
                entry.first = warm
                torch.cuda.empty_cache()
            del warm
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
            # traced only, and never inside an operator's own profiler
            trc = self.tracer
            if (trc is not None and not self.grad
                    and not kmaps.profiler_running()):
                entry.kmap = self._kernel_map(entry, params, feeds, args)
                self._pin(trc, entry)
        return entry


class CompiledStep:
    """``step(state, *batch) -> (state, metrics)``: a training step
    ``body(state, feeds) -> {name: tensor}`` that updates ``state`` in
    place, behind one captured graph (``CompiledRun(body, grad=True)``).

    ``pack(*batch)`` turns the caller's batch into the flat feed mapping
    the body reads (default: the batch is that mapping). The first state
    passed becomes the captured state and is the one returned; a state
    with other tensors (a restored checkpoint) is copied into it first.
    On the CPU the body runs eagerly over the same static buffers."""

    def __init__(self, body: Callable[[Any, dict], Mapping[str, Tensor]], *,
                 device: str | torch.device = "cuda",
                 pack: Callable[..., Mapping[str, Feed]] | None = None):
        self.run = CompiledRun(body, device=device, grad=True)
        self.pack = pack
        self.state = None

    @property
    def compilations(self) -> int:
        return self.run.compilations

    def adopt(self, state) -> Any:
        """The captured state, holding ``state``'s values."""
        if self.state is None:
            self.state = state
        elif state is not self.state:
            mine, theirs = tree_leaves(self.state), tree_leaves(state)
            if len(mine) != len(theirs):
                raise ValueError(f"state has {len(theirs)} leaves, the "
                                 f"captured one {len(mine)}")
            with torch.no_grad():
                for dst, src in zip(mine, theirs):
                    if dst.data_ptr() != src.data_ptr():
                        dst.copy_(src)
        return self.state

    def _feeds(self, batch: tuple) -> Mapping[str, Feed]:
        return self.pack(*batch) if self.pack is not None else batch[0]

    def __call__(self, state, *batch) -> tuple[Any, dict[str, Tensor]]:
        state = self.adopt(state)
        return state, self.run(state, self._feeds(batch))

    def eager(self, state, *batch) -> tuple[Any, dict[str, Tensor]]:
        """The same step run eagerly on ``state`` (in place, uncaptured):
        what the graph is held against."""
        with torch.enable_grad():
            return state, dict(self.run.fn(state, self._feeds(batch)))
