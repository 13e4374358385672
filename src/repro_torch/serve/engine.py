"""Per-request orchestration for two-stage serving (port of
``repro.serve.engine``: graph, split, cache, bucketing, coalescing, the
two-phase dispatch, the device-resident rep tier, hedging, fault injection,
quarantine and the circuit breaker; sharding, tracing and the memory tier
are not ported yet).

``ServingEngine`` rewrites a ranking graph per its ``ServePlan``, splits it
into the two stages of ``repro_torch.core.split`` and scores candidate
pools against cached user representations:

  stage2(params, rep_table (U, ...), user_index (B,), candidate_feeds (B, ...))
      = residual_graph(params, {reps[clamp(user_index)], candidates})

* a single request is the degenerate case U = 1 (``user_index`` all zero);
* a cross-user coalesced batch stacks the U users' cached stage-1 outputs
  into a rep table and lets each candidate row gather its own user's reps.

Both paths run the same row-wise graph, so coalesced scores equal
per-request scores up to the float summation order the libraries choose
per batch size: stage 2's plain ``dense`` layers go to cuBLAS, which may
pick another algorithm per bucket. The port therefore holds the two to an
fp32 tolerance, not to bit-equality; the kernels themselves sum every
row in one fixed order.

Numerics: the engine sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False — the reference is fp32 and
TF32 keeps only ~3 decimal digits.

Dispatch: ``begin_coalesced`` runs stage 1, packs chunks into pow2 buckets
and enqueues every pack on the current CUDA stream without waiting, then
records a ``torch.cuda.Event`` per pack; ``poll`` queries those events and
``collect`` waits on them, copies scores to the host and slices
per-request results. ``score_coalesced`` is ``collect(begin_coalesced())``
and ``score`` is its one-request case. Candidate rows are filled into
pinned host buffers PRIVATE to each pack and copied ``non_blocking``: the
copy runs later on the stream, so a buffer shared between packs could be
refilled by the next pack before its pending copy has read it.

Device-resident tier (``plan.cache.device_resident``): cached stage-1 reps
also live in a ``DeviceRepStore`` — ONE persistent ``(capacity, ...)``
CUDA tensor per boundary, a new user written as one ``index_copy_`` row,
an evicted user only recycling its slot integer. A pack then passes the
persistent tables plus per-row *slot indices* instead of re-stacking a
fresh ``(U, ...)`` table; ``mari_matmul``'s gather init and
``gather_einsum`` index the ``(capacity, ...)`` tables directly. Packs fall
back to re-stacking when the tier overflows, when one call carries a user
under two feature versions, and while the circuit breaker is open. Every
row write of a call is enqueued before any of its launches, on the same
stream, so stream order alone keeps rows and reads consistent: a write
enqueued after an in-flight launch cannot change what that launch reads.
A call that writes while earlier calls are still in flight also arms the
store's copy-on-write fork (``pipeline_forks``), as the reference does.

Fault tolerance (``plan.ft``): a seeded ``FaultInjector`` pokes the
engine's sites (stage1, pack, transfer_copy, stage2_dispatch, collect;
slot_write and table_fork in the store). A failed row write quarantines
the tier and every pack of the call re-stacks; NaN scores found at
collect (the detectable-corruption contract) raise ``FaultInjected``
instead of being served and, on the slot path, quarantine the tier. Each
failure counts toward the ``CircuitBreaker``, which routes every pack
through re-stacking while open.

Hedging (``plan.batch.hedging``, forced off by the device tier): a pack
at an already-seen shape is dispatched through a ``HedgedRunner`` — stage
2 runs on a worker thread, which enters ``torch.inference_mode`` and the
caller's CUDA stream itself, and synchronises; if it straggles past the
policy deadline a duplicate runs and the first result wins.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Hashable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.common import next_pow2, resolve_device, take_clip, tree_map
from repro_torch.core.mari import convert_params, mari_rewrite
from repro_torch.core.split import split_two_stage
from repro_torch.ft.faults import CORRUPT, FaultInjector
from repro_torch.ft.recovery import CircuitBreaker
from repro_torch.graph.executor import USER_INDEX_FEED, Executor
from repro_torch.graph.ir import Graph
from repro_torch.serve.cache import DeviceRepStore, UserRepCache
from repro_torch.serve.errors import FaultInjected
from repro_torch.serve.hedging import HedgedRunner, HedgePolicy
from repro_torch.serve.plan import ServePlan
from repro_torch.serve.profile import StageProfiler

Tensor = torch.Tensor


def bucket_for(n: int, *, min_bucket: int = 128, max_batch: int = 4096) -> int:
    """Smallest power-of-two bucket holding ``n`` rows, at least
    ``min_bucket`` and at most ``max_batch`` (``repro.dist.topology.
    bucket_for`` with one shard: a cap-sized bucket needs no alignment)."""
    lo = min(min_bucket, max_batch)
    return min(max_batch, next_pow2(max(n, lo)))


@dataclasses.dataclass
class ServeRequest:
    user_id: int
    user_feeds: Mapping[str, np.ndarray]      # leading dim 1
    candidate_feeds: Mapping[str, np.ndarray]  # leading dim = n_candidates
    feature_version: int = 0                  # bump to invalidate cached reps


@dataclasses.dataclass
class ServeResult:
    scores: np.ndarray
    latency_ms: float            # wall time of the (possibly shared) batch
    n_batches: int               # stage-2 dispatches this request took part in
    user_cache_hit: bool
    hedged: int = 0              # dispatches that launched a duplicate
    stage1_ms: float = 0.0       # 0 when cached / single-stage
    coalesced: bool = False      # scored inside a cross-user batch
    degraded: bool = False       # candidate pool truncated under overload


def _precat_mari_weights(graph: Graph, params: dict) -> dict:
    """Pre-concatenate each ``mari_dense``'s batched-group weight blocks
    (stored as ``w_cat`` beside the blocks), so the per-call weight concat
    leaves the hot path. The streamed operand values are unchanged."""
    out = dict(params)
    for n in graph.nodes.values():
        if n.op != "mari_dense":
            continue
        p = params[n.name]
        if n.attrs.get("fragment"):
            if not n.attrs.get("precomputed_user"):
                continue          # batch-1-ness varies per segment: no fusion
            ws = [p[f"w_seg{i}"] for i in n.attrs["seg_param_idx"]]
        else:
            labels = [lab for lab, _ in n.attrs["groups"] if lab != "user"]
            ws = [p[f"w_{lab}"] for lab in labels]
        if len(ws) < 2:
            continue              # single block: nothing to concatenate
        out[n.name] = dict(p, w_cat=torch.cat(ws, dim=0))
    return out


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


def _host_array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@dataclasses.dataclass
class _ReqInfo:                   # per-request working state inside a batch
    reps: Mapping[str, Tensor]
    hit: bool
    stage1_ms: float
    chunks: list[tuple[dict, int]]
    slot_key: object


@dataclasses.dataclass(eq=False)
class _InFlight:
    """Opaque handle for a launched-but-uncollected ``begin_coalesced``
    call (identity semantics: two handles never compare equal)."""
    reqs: Sequence[ServeRequest]
    infos: list
    packs: list
    launched: list                # per pack: (outs, event | None, host
    #                               bufs, hedged); event None = blocked
    t0: float
    slots_mask: list = dataclasses.field(default_factory=list)
    #                               per pack: True = device-slot path
    #                               (breaker accounting at collect)


class ServingEngine:
    def __init__(self, graph: Graph, params: dict,
                 plan: ServePlan | str | None = None, *,
                 hedge_policy: HedgePolicy | None = None,
                 cache: UserRepCache | None = None,
                 cache_scope: Hashable | None = None,
                 device: str | torch.device = "cuda"):
        """Build ``graph`` for two-stage serving per ``plan`` (a
        ``ServePlan``, a preset name, or None for the ``paper`` preset) on
        ``device``. ``params`` is a nested dict of tensors (or numpy
        arrays); it is moved to ``device``. ``cache`` / ``cache_scope`` let
        a host (``RankingService``) inject a SHARED ``UserRepCache``: keys
        are namespaced by ``cache_scope`` so several scenario engines split
        one LRU budget without key collisions. ``hedge_policy`` is a live
        object, not plan material (default ``HedgePolicy()``)."""
        if isinstance(plan, str):
            plan = ServePlan.preset(plan)
        self.plan = plan = plan if plan is not None else ServePlan()
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the reference is fp32: no TF32 in cuBLAS or cuDNN
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        params = tree_map(lambda t: torch.as_tensor(t, device=self.device),
                          params)

        mode = plan.graph.mode
        self.mode = mode
        self.max_batch = plan.batch.max_batch
        self.min_bucket = plan.batch.min_bucket
        self.max_users_per_batch = plan.batch.max_users_per_batch
        if mode == "mari":
            conv = mari_rewrite(graph,
                                reparam_attention=plan.graph.reparam_attention,
                                fragment=plan.graph.fragment,
                                group_by_domain=plan.graph.group_by_domain)
            self.graph = conv.graph
            self.params = convert_params(conv, params)
            self.conversion = conv
            exec_mode = "uoi"
        else:
            self.graph = graph
            self.params = params
            self.conversion = None
            exec_mode = mode
        two_stage = plan.graph.two_stage
        # vani tiles user feeds into the batch: no user-only subgraph to peel
        self.two_stage = (exec_mode == "uoi") if two_stage is None else two_stage
        self.outputs = list(self.graph.outputs)

        self.split = None
        if self.two_stage:
            split = split_two_stage(self.graph)
            # user_feeds carries exactly the domain=="user" inputs: a
            # stage-1 input outside that set could never be fed
            unservable = [n.name for n in split.stage1.input_nodes()
                          if n.attrs.get("domain") != "user"]
            if unservable and two_stage:
                raise ValueError(
                    f"two_stage=True but stage-1 needs non-user feeds "
                    f"{unservable}; give these inputs domain='user' or "
                    f"serve single-stage")
            if unservable:
                self.two_stage = False
            else:
                self.split = split
        if self.two_stage:
            s2_user = {n.name for n in self.split.stage2.input_nodes()
                       if n.attrs.get("domain") == "user"}
            missing = s2_user - set(self.split.boundary_specs)
            if missing:
                raise ValueError(
                    f"stage-2 user inputs {sorted(missing)} are not in the "
                    f"split's boundary_specs — stage 1 cannot supply them")
            # the kernels serve stage 1 too (its pooled multi-hot lookups)
            self._stage1 = Executor(self.split.stage1, "uoi",
                                    use_pallas=plan.kernel.use_pallas,
                                    device=self.device)
            self._stage1_inputs = {
                n.name for n in self.split.stage1.input_nodes()}
            batched_graph = self.split.stage2
        else:
            self._stage1 = None
            self._stage1_inputs = None
            batched_graph = self.graph
        if plan.kernel.precat_weights:
            self.params = _precat_mari_weights(batched_graph, self.params)
        self.use_pallas = plan.kernel.use_pallas
        self.kernel_gather = plan.kernel.kernel_gather
        self.gather_attention = plan.kernel.gather_attention

        # single-stage serving has no stage-1 outputs to reuse, so caching
        # there would be pure bookkeeping
        self.cache_user_reps = plan.cache.cache_user_reps and self.two_stage
        # an injected cache is SHARED (RankingService budget); cache_scope
        # namespaces this engine's keys inside it so same-valued user ids
        # from different scenarios cannot collide on wrong-shaped reps
        self.cache = cache if cache is not None else UserRepCache(
            max_users=plan.cache.max_cached_users)
        self._cache_scope = cache_scope

        self._stage2_ex = Executor(batched_graph, exec_mode,
                                   use_pallas=self.use_pallas,
                                   kernel_gather=self.kernel_gather,
                                   gather_attention=self.gather_attention,
                                   device=self.device)
        self.lazy_gather_inputs = self._stage2_ex.lazy_gather_inputs

        # -- device-resident tier: persistent slot tables beside the LRU --
        self.device_resident = (plan.cache.device_resident
                                and self.cache_user_reps)
        self._device_store: DeviceRepStore | None = None
        if self.device_resident:
            capacity = (plan.cache.device_slots
                        if plan.cache.device_slots is not None
                        else (plan.cache.max_cached_users or 64))
            self._device_store = DeviceRepStore(
                capacity, boundary_specs=self.split.boundary_specs)
            # recycle device slots in lockstep with the host tier: any
            # removal (LRU eviction, version supersede, invalidate, clear)
            # frees the user's slot for the next resident user
            self.cache.subscribe(self._device_store.drop)

        self.stage1_calls = 0                 # stage-1 executions (misses)
        self.stage2_calls = 0                 # total row-wise dispatches
        self.coalesced_calls = 0              # dispatches mixing >1 user slot
        self.pipeline_forks = 0               # copy-on-write table forks (a
        #                                       row write under in-flight
        #                                       launches)
        self._inflight: list[_InFlight] = []  # launched, not yet collected
        self._batch_shapes: set[tuple[int, int]] = set()  # (U_dim, bucket)
        # first-seen candidate-feed signature {name: (dtype, row shape)}:
        # pack buffers are shaped from it, so drift must fail fast
        self._feed_sig: dict[str, tuple] | None = None
        self.profiler = StageProfiler()

        # -- hedging: duplicate straggling dispatches (never with the
        # device tier, which the plan already resolves; enforced here too)
        self.hedge_policy = hedge_policy or HedgePolicy()
        self.hedging = plan.batch.hedging and not self.device_resident
        self._hedged = (HedgedRunner(self._dispatch, self.hedge_policy)
                        if self.hedging else None)

        # -- fault tolerance (plan.ft): injection, breaker, quarantine --
        ftp = plan.ft
        self.fault_injector: FaultInjector | None = None
        if ftp.inject and ftp.sites:
            self.fault_injector = FaultInjector(ftp.sites, seed=ftp.seed)
            if self._device_store is not None:
                self._device_store.set_fault_injector(self.fault_injector)
        self.breaker: CircuitBreaker | None = None
        if ftp.breaker_failures > 0 and self._device_store is not None:
            self.breaker = CircuitBreaker(
                failures=ftp.breaker_failures,
                cooldown_ms=ftp.breaker_cooldown_ms,
                probes=ftp.breaker_probes)
        self.fallback_packs = 0       # packs the open breaker re-routed
        self.corruptions_detected = 0  # NaN scores caught at collect

    @property
    def device_store(self) -> DeviceRepStore | None:
        """The device rep tier (None unless ``device_resident`` is live)."""
        return self._device_store

    def ft_stats(self) -> dict:
        """The device-tier, hedging and fault counters in one snapshot."""
        h, inj, st = self._hedged, self.fault_injector, self._device_store
        return {
            "device_resident": self.device_resident,
            "device_store": st.stats() if st is not None else None,
            "pipeline_forks": self.pipeline_forks,
            "hedging": self.hedging,
            "hedges_launched": h.hedges_launched if h else 0,
            "hedge_wins": h.hedge_wins if h else 0,
            "hedge_pool_exhausted": h.pool_exhausted if h else 0,
            "faults_fired": inj.total_fired if inj is not None else 0,
            "faults": inj.stats() if inj is not None else None,
            "quarantines": st.quarantines if st is not None else 0,
            "corruptions_detected": self.corruptions_detected,
            "fallback_packs": self.fallback_packs,
            "breaker": (self.breaker.stats()
                        if self.breaker is not None else None),
        }

    def _poke(self, site: str, **ctx):
        """Fault-injection hook: no-op unless the plan armed an injector."""
        inj = self.fault_injector
        return None if inj is None else inj.poke(site, **ctx)

    def _quarantine_device_tier(self) -> None:
        """A failed row write (or corruption detected on the slot path)
        poisons the current table generation: invalidate it wholesale so
        a stale row is never served (tables rebuild lazily from the host
        LRU). Counts as one device-tier failure toward the breaker."""
        if self._device_store is not None:
            self._device_store.quarantine()
        if self.breaker is not None:
            self.breaker.record_failure()

    # -- stage 2 ---------------------------------------------------------
    def _stage2(self, params: dict, table: Mapping[str, Tensor],
                user_index: Tensor, cand: Mapping[str, Tensor]
                ) -> dict[str, Tensor]:
        """The row-wise batched stage: every rep-table entry is gathered per
        candidate row (clamped), except the entries a kernel gathers itself
        at load time (``lazy_gather_inputs``: the mari_matmul accumulator
        init under ``kernel_gather``, the decomposed-attention tables under
        ``gather_attention``), which are fed stacked with the row index."""
        lazy = self.lazy_gather_inputs
        feeds = {k: (v if k in lazy else take_clip(v, user_index))
                 for k, v in table.items()}
        feeds.update(cand)
        if lazy:
            feeds[USER_INDEX_FEED] = user_index
        with torch.inference_mode():
            return self._stage2_ex.run(params, feeds)

    def _dispatch(self, stream, params, table, uidx, cand):
        """Blocking stage 2 for the hedged runner: runs on a worker thread,
        so it enters the caller's CUDA stream itself (``_stage2`` enters
        inference mode), then waits for the device. Its arguments stay
        referenced by this frame until the call returns, so an abandoned
        loser never reads freed memory."""
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            out = self._stage2(params, table, uidx, cand)
            self._sync()
        return out

    # -- candidate mini-batching -----------------------------------------
    def _bucket(self, n: int) -> int:
        """Smallest power-of-two bucket >= n, clamped to
        [min_bucket, max_batch]: every pool size maps onto a small, fixed
        set of stage-2 shapes."""
        return bucket_for(n, min_bucket=self.min_bucket,
                          max_batch=self.max_batch)

    def _chunk(self, feeds: Mapping[str, np.ndarray]
               ) -> list[tuple[dict, int]]:
        """Split a candidate pool into host (chunk, n_valid) pieces of at
        most ``max_batch`` rows. The candidate-feed signature (names, row
        shapes, dtypes) is pinned by the first request: pack buffers are
        shaped from it, and a drifting request is rejected here, before any
        pack of the call launches."""
        arrs = {k: _host_array(v) for k, v in feeds.items()}
        sig = {k: (v.dtype, tuple(v.shape[1:])) for k, v in arrs.items()}
        if self._feed_sig is None:
            self._feed_sig = sig
        elif sig != self._feed_sig:
            drift = sorted(k for k in sig.keys() | self._feed_sig.keys()
                           if sig.get(k) != self._feed_sig.get(k))
            raise ValueError(
                f"candidate feed signature drifted from the engine's "
                f"first request on {drift}: expected "
                f"{ {k: self._feed_sig.get(k) for k in drift} }, got "
                f"{ {k: sig.get(k) for k in drift} } — per-engine "
                f"candidate feeds must keep stable names, row shapes "
                f"and dtypes")
        n = next(iter(arrs.values())).shape[0]
        out = []
        for lo in range(0, n, self.max_batch):
            hi = min(lo + self.max_batch, n)
            out.append(({k: v[lo:hi] for k, v in arrs.items()}, hi - lo))
        return out

    @property
    def stage2_shapes(self) -> int:
        """Distinct (rep-table rows, bucket) shapes stage 2 has run at."""
        return len(self._batch_shapes)

    # -- stage 1 ---------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _scoped_uid(self, user_id: Hashable) -> Hashable:
        """Namespace a user id for the (possibly shared) rep cache."""
        return (user_id if self._cache_scope is None
                else (self._cache_scope, user_id))

    def invalidate_user(self, user_id: Hashable) -> None:
        """Drop this engine's cached reps of ``user_id`` (scoped, so a
        shared cache keeps the other scenarios' entries)."""
        self.cache.invalidate_user(self._scoped_uid(user_id))

    def _user_reps(self, req: ServeRequest
                   ) -> tuple[Mapping[str, Tensor], bool, float]:
        key = (self._scoped_uid(req.user_id), req.feature_version)
        if self.cache_user_reps:
            reps = self.cache.get(key)
            if reps is not None:
                return reps, True, 0.0
        if self.two_stage:
            self._poke("stage1", user=req.user_id)
            t0 = time.perf_counter()
            feeds = {k: v for k, v in req.user_feeds.items()
                     if k in self._stage1_inputs}
            with torch.inference_mode():
                reps = self._stage1.run(self.params, feeds)
            self._sync()
            self.stage1_calls += 1
            s = time.perf_counter() - t0
            self.profiler.add("stage1", s)
            ms = s * 1e3
        else:
            # single-stage: the "representation" is the raw user feed dict
            reps = {k: torch.as_tensor(_host_array(v), device=self.device)
                    for k, v in req.user_feeds.items()}
            ms = 0.0
        if self.cache_user_reps:
            self.cache.put(key, reps)
        return reps, False, ms

    # -- scoring -----------------------------------------------------------
    def score(self, req: ServeRequest) -> ServeResult:
        """Score one request — the U=1 case of the coalesced path."""
        return self.score_coalesced([req])[0]

    def score_coalesced(self, reqs: Sequence[ServeRequest]
                        ) -> list[ServeResult]:
        """Score several users' requests, coalescing candidate chunks into
        shared cross-user stage-2 calls: ``collect(begin_coalesced(reqs))``."""
        return self.collect(self.begin_coalesced(reqs))

    def begin_coalesced(self, reqs: Sequence[ServeRequest]) -> _InFlight:
        """Phase 1 of the two-phase dispatch: stage 1, packing and every
        device-table row write of the call, then enqueue every pack on the
        device stream without waiting."""
        t0 = time.perf_counter()
        infos: list[_ReqInfo] = []
        for ri, req in enumerate(reqs):
            reps, hit, s1ms = self._user_reps(req)
            infos.append(_ReqInfo(
                reps=reps, hit=hit, stage1_ms=s1ms,
                chunks=self._chunk(req.candidate_feeds),
                # with the cache on, one (user, version) key resolves to the
                # same cached reps, so such requests share a rep-table slot
                slot_key=((req.user_id, req.feature_version)
                          if self.cache_user_reps else ri)))

        # greedy packing in arrival order: a pack holds chunks from as many
        # requests as fit the row budget and the slot budget
        packs: list[tuple[list, list, list]] = []  # (items, reps, keys)
        cur: list = []
        cur_rows = 0
        cur_slots: dict = {}                   # slot_key -> slot index
        cur_reps: list = []                    # slot index -> reps
        cur_keys: list = []                    # slot index -> slot_key
        for ri, info in enumerate(infos):
            key = info.slot_key
            for chunk, n in info.chunks:
                full = cur and (
                    cur_rows + n > self.max_batch
                    or (key not in cur_slots
                        and len(cur_slots) >= self.max_users_per_batch))
                if full:
                    packs.append((cur, cur_reps, cur_keys))
                    cur, cur_rows, cur_slots = [], 0, {}
                    cur_reps, cur_keys = [], []
                if key not in cur_slots:
                    cur_slots[key] = len(cur_reps)
                    cur_reps.append(info.reps)
                    cur_keys.append(key)
                cur.append((ri, cur_slots[key], chunk, n))
                cur_rows += n
        if cur:
            packs.append((cur, cur_reps, cur_keys))

        # a row write while earlier calls are in flight forks the tables
        # (copy-on-write, as the reference does); all-resident calls read
        # the current generation freely
        forked = False
        store = self._device_store
        if store is not None and self._inflight:
            keys = {info.slot_key for info in infos}
            if any(not store.is_live(self._scoped_uid(u), v)
                   for u, v in keys):
                self.pipeline_forks += 1
                store.fork_next_write()
                forked = True

        # write barrier: every row write of the call is enqueued before
        # any of its launches; timed as its own phase so ``pack`` stays
        # one entry per pack
        if store is None:
            dslots = [None] * len(packs)
        else:
            with self.profiler.phase("slots"):
                dslots = self._resolve_device_slots(packs)
        if forked:
            store.clear_fork_mark()

        # prepare + launch each pack in turn: launches do not wait, so the
        # host fills pack k+1 while the device computes pack k
        launched = []
        try:
            for (pack_items, slot_reps, _), ds in zip(packs, dslots):
                with self.profiler.phase("pack"):
                    prep = self._prepare_pack(pack_items, slot_reps, ds)
                launched.append(self._launch_pack(prep,
                                                  on_slots=ds is not None))
        except BaseException:
            # leave no untracked launch behind
            self._sync()
            raise
        handle = _InFlight(reqs=reqs, infos=infos, packs=packs,
                           launched=launched, t0=t0,
                           slots_mask=[ds is not None for ds in dslots])
        self._inflight.append(handle)
        return handle

    def poll(self, handle: _InFlight) -> bool:
        """Non-blocking: True when ``collect(handle)`` would not wait on the
        device (every pack's event has completed)."""
        return all(ev is None or ev.query()
                   for _, ev, _, _ in handle.launched)

    def collect(self, handle: _InFlight) -> list[ServeResult]:
        """Phase 2: wait on the handle's packs, copy scores to the host and
        slice per-request results. Each handle is collected exactly once."""
        try:
            self._inflight.remove(handle)
        except ValueError:
            raise RuntimeError(
                "collect() on a handle that is not in flight (already "
                "collected, or from another engine)") from None
        try:
            return self._collect_body(handle)
        except BaseException:
            # a mid-sweep failure (injected fault, detected corruption)
            # leaves no untracked launch behind
            self._sync()
            raise

    def _collect_body(self, handle: _InFlight) -> list[ServeResult]:
        prof = self.profiler
        reqs, infos = handle.reqs, handle.infos
        slots_mask = handle.slots_mask or [False] * len(handle.packs)
        detect = self.fault_injector is not None
        per_req_scores: list[list[np.ndarray]] = [[] for _ in reqs]
        per_req_packs = [0] * len(reqs)
        per_req_hedged = [0] * len(reqs)
        for (pack_items, _, _), (out, ev, _, hedged), on_slots in zip(
                handle.packs, handle.launched, slots_mask):
            total = sum(n for _, _, _, n in pack_items)
            if ev is not None:
                with prof.phase("device"):
                    ev.synchronize()
            act = self._poke("collect")
            with prof.phase("unpack"):
                scores = np.concatenate(
                    [out[o].cpu().numpy() for o in self.outputs],
                    axis=-1)[:total]
            if act is CORRUPT:
                scores = np.full_like(scores, np.nan)
            if detect and not np.isfinite(scores).all():
                # detectable corruption: a NaN-poisoned payload is failed
                # typed, never served
                self.corruptions_detected += 1
                if on_slots:
                    # the device tier may hold the poisoned row: wipe the
                    # generation so a retry rebuilds from the host LRU
                    self._quarantine_device_tier()
                raise FaultInjected(
                    "corrupted stage-2 scores detected at collect",
                    site="collect")
            if on_slots and self.breaker is not None:
                self.breaker.record_success()
            offset = 0
            for ri, _, _, n in pack_items:
                per_req_scores[ri].append(scores[offset:offset + n])
                offset += n
            for ri in {ri for ri, _, _, _ in pack_items}:
                per_req_packs[ri] += 1
                per_req_hedged[ri] += hedged
        wall_ms = (time.perf_counter() - handle.t0) * 1e3
        return [ServeResult(
            scores=np.concatenate(per_req_scores[ri], axis=0),
            latency_ms=wall_ms, n_batches=per_req_packs[ri],
            user_cache_hit=infos[ri].hit, hedged=per_req_hedged[ri],
            stage1_ms=infos[ri].stage1_ms, coalesced=len(reqs) > 1)
            for ri in range(len(reqs))]

    # -- pack preparation ----------------------------------------------------
    def _resolve_device_slots(self, packs: list) -> list[list[int] | None]:
        """Map every pack's slot keys to device-table slots (one row write
        per user not already resident); called only with the device tier
        on. ``None`` per pack when that pack falls back to re-stacking: it
        overflowed capacity, the breaker is open, or it carries a user that
        appears under two feature versions in this call (the store keeps
        one slot per user, so resolving the second version would rewrite
        the row the first version's rows read). Every device-resolved user
        of the call is protected while resolving: a later pack's write may
        never steal a slot an earlier pack references."""
        store = self._device_store
        if self.breaker is not None and not self.breaker.allow():
            # open: every pack re-stacks; after the cooldown allow() turns
            # half-open and lets probe traffic back onto the slot path
            self.fallback_packs += len(packs)
            return [None] * len(packs)
        ver_of: dict = {}
        conflicted = set()
        for _, _, slot_keys in packs:
            # with the device tier live, cache_user_reps is on, so every
            # slot key is a (user_id, feature_version) cache key
            for uid, ver in slot_keys:
                if ver_of.setdefault(uid, ver) != ver:
                    conflicted.add(uid)
        per_pack = []
        protect: list = []
        for _, slot_reps, slot_keys in packs:
            if any(uid in conflicted for uid, _ in slot_keys):
                per_pack.append(None)
                continue
            triples = [(self._scoped_uid(uid), ver, reps)
                       for (uid, ver), reps in zip(slot_keys, slot_reps)]
            per_pack.append(triples)
            protect.extend(u for u, _, _ in triples)
        out = []
        for triples in per_pack:
            if triples is None:
                out.append(None)
                continue
            try:
                slots = store.ensure_rows(triples, protect=protect)
            except Exception:
                # a failed write leaves the generation suspect: quarantine
                # it and re-stack EVERY pack of the call (the quarantine
                # freed the slots earlier packs resolved) — the request
                # still succeeds while the breaker counts the failure
                self._quarantine_device_tier()
                return [None] * len(packs)
            out.append(slots if all(s is not None for s in slots) else None)
        return out

    def _prepare_pack(self, pack_items: list, slot_reps: list,
                      dslots: list[int] | None = None):
        """Assemble one stage-2 call's arguments.

        ``pack_items`` is a list of (req idx, slot idx, cand chunk, n_valid);
        ``slot_reps`` maps slot idx -> that user's rep dict; ``dslots`` maps
        slot idx -> persistent device-table slot, or None to re-stack one
        row-block per slot, padded to a pow2 slot count. Candidate rows and
        the user index are filled into host buffers PRIVATE to this pack
        (pinned on CUDA) and copied ``non_blocking`` on the current stream;
        nothing may write them afterwards."""
        self._poke("pack")
        total = sum(n for _, _, _, n in pack_items)
        bucket = self._bucket(total)
        n_slots = len(slot_reps)
        if dslots is not None:
            # device-resident: the persistent (capacity, ...) tables; rows
            # address their user's live slot directly
            table = self._device_store.tables
            u_dim = self._device_store.capacity
            slot_ids = dslots
        else:
            u_dim = next_pow2(n_slots)
            if u_dim == 1:
                table = dict(slot_reps[0])
            else:
                padded = slot_reps + [slot_reps[0]] * (u_dim - n_slots)
                table = {k: torch.cat([r[k] for r in padded], dim=0)
                         for k in slot_reps[0]}
            slot_ids = list(range(n_slots))

        pin = self.device.type == "cuda"
        uidx_buf = torch.empty((bucket,), dtype=torch.int32, pin_memory=pin)
        cand_bufs = {k: torch.empty((bucket,) + tuple(v.shape[1:]),
                                    dtype=_torch_dtype(v.dtype),
                                    pin_memory=pin)
                     for k, v in pack_items[0][2].items()}
        uidx_np = uidx_buf.numpy()
        cand_np = {k: b.numpy() for k, b in cand_bufs.items()}
        offset = 0
        for _, slot, chunk, n in pack_items:
            uidx_np[offset:offset + n] = slot_ids[slot]
            for k, buf in cand_np.items():
                buf[offset:offset + n] = chunk[k]
            offset += n
        if offset < bucket:
            # padding rows repeat the LAST real row (user slot and candidate
            # row), so pad scores are copies of a real score
            uidx_np[offset:] = uidx_np[offset - 1]
            for buf in cand_np.values():
                buf[offset:] = buf[offset - 1]
        if self._poke("transfer_copy") is CORRUPT:
            # detectable corruption: NaN-poison the float candidate rows;
            # NaN reaches the scores and is caught at collect
            for buf in cand_np.values():
                if np.issubdtype(buf.dtype, np.floating):
                    buf.fill(np.nan)
        uidx = uidx_buf.to(self.device, non_blocking=True)
        cand = {k: b.to(self.device, non_blocking=True)
                for k, b in cand_bufs.items()}
        # the first call at a new (rep-table, bucket) shape is not a
        # straggler (first launches build kernels, pick cuBLAS algorithms):
        # it is never hedged
        first_shape = (u_dim, bucket) not in self._batch_shapes
        self._batch_shapes.add((u_dim, bucket))
        host_bufs = (uidx_buf, cand_bufs)
        return table, uidx, cand, n_slots, host_bufs, first_shape

    def _launch_pack(self, prep, on_slots: bool = False
                     ) -> tuple[dict, object, tuple, int]:
        """Enqueue one prepared pack; returns (outputs, CUDA event recorded
        after its launches — None on the CPU or when hedging already
        waited for the result —, the pack's host buffers, held until
        collect, and 1 if a duplicate was launched). ``on_slots`` marks
        the device-slot path: a failed launch there counts toward the
        breaker."""
        table, uidx, cand, n_slots, host_bufs, first_shape = prep
        self.stage2_calls += 1
        if n_slots > 1:
            self.coalesced_calls += 1
        try:
            self._poke("stage2_dispatch")
        except Exception:
            if on_slots and self.breaker is not None:
                self.breaker.record_failure()
            raise
        cuda = self.device.type == "cuda"
        if self._hedged is not None and not first_shape:
            stream = torch.cuda.current_stream(self.device) if cuda else None
            with self.profiler.phase("dispatch"):
                out, outcome = self._hedged.run(stream, self.params, table,
                                                uidx, cand)
            return out, None, host_bufs, int(outcome.hedged)
        with self.profiler.phase("dispatch"):
            try:
                out = self._stage2(self.params, table, uidx, cand)
            except Exception:
                if on_slots and self.breaker is not None:
                    self.breaker.record_failure()
                raise
            ev = None
            if cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
        return out, ev, host_bufs, 0

    def close(self) -> None:
        """Wait for uncollected launches and stop the hedging pool."""
        self._sync()
        self._inflight.clear()
        if self._hedged is not None:
            self._hedged.close()
