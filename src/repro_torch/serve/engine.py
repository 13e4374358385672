"""Per-request orchestration for two-stage serving (port of
``repro.serve.engine``: graph, split, cache, bucketing, coalescing, the
two-phase dispatch, compiled stages, the device-resident rep tier,
hedging, fault injection, quarantine, the circuit breaker, request
tracing, the memory tier and candidate-axis sharding).

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

Compiled stages (the reference's ``jax.jit``): stage 1 and stage 2 run
through ``repro_torch.graph.compiled.CompiledRun`` — on CUDA one captured
``torch.cuda.CUDAGraph`` per signature, replayed; on the CPU the same
static buffers with the body run eagerly. Stage 2 has one graph per
(rep-table rows, bucket) shape and table route: a re-stacked pack copies
its users' rows into the graph's static table (``torch.cat(...,
out=...)``), a device-tier pack reads the persistent tables in place.
``stage2_compilations`` counts the graphs (the reference's name and
contract), ``stage2_shapes`` the (rows, bucket) shapes. All graphs of an
engine share one memory pool (``GraphPool``).

Dispatch: ``begin_coalesced`` runs stage 1, packs chunks into pow2 buckets
and enqueues every pack on the current CUDA stream without waiting, then
records a ``torch.cuda.Event`` per pack; ``poll`` queries those events and
``collect`` waits on them, copies scores to the host and slices
per-request results. ``score_coalesced`` is ``collect(begin_coalesced())``
and ``score`` is its one-request case. Candidate rows are filled into
pinned host buffers PRIVATE to each pack and copied ``non_blocking`` into
the graph's static inputs at dispatch: the copy runs later on the stream,
so a buffer shared between packs could be refilled by the next pack
before its pending copy has read it.

Tracing (``plan.obs.trace``): a ``Tracer`` records the reference's events
at the same places — a ``group`` begin/end per call on its own track,
``stage1``, ``pack``, ``dispatch``, ``begin_coalesced`` and ``collect``
spans (and a sharded engine's ``gather``), ``cache_hit`` /
``cache_miss``, ``fork_armed``, ``corruption_detected``, ``breaker_*``
and ``breaker_fallback`` instants; the caches, the fault injector and the
batcher add theirs. Beneath those spans the port records its own
(``obs.PORT_SPANS``): stage 1's ``stage1.copy_in`` / ``.replay`` /
``.copy_out`` (its compiled run) and ``stage1.sync``; ``pack.alloc`` (the
pinned buffers) and ``pack.fill``; stage 2's ``stage2.copy_in`` /
``.replay`` / ``.copy_out`` inside ``dispatch``; ``collect.wait`` (the
pack's event, on the card) and ``collect.unpack`` — the ``device`` and
``unpack`` phases' intervals — and each captured graph's kernel map
(``graph.compiled``).

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

Memory tier (``plan.mem.cold_tier``, ``repro_torch.mem``): a host-RAM
``ColdRepStore`` under the hot LRU. The tier walk in ``_user_reps`` is hot
LRU -> cold arena -> stage 1: a hot-LRU eviction demotes the user's reps
into the arena (one synchronous device-to-host copy per boundary), a hot
miss that finds the user there is served from the arena read copied back
onto the card (``cold_hit``; no stage 1, no hot put), and a
``PromotionWorker`` thread moves users touched often enough back into the
hot LRU, as device tensors. ``warm`` fills the arena offline through the
engine's own compiled stage 1 (``RepWarmer``). A pack carrying a
cold-served user takes the re-stacking route, never a device slot. Every
copy of the tier runs on a CUDA stream of the engine's own
(``_mem_stream``, from the high-priority pool, which no capture stream
comes from) and waits on that stream alone, whatever thread fires
it (a batcher thread, or the promotion thread whose ``cache.put`` can
evict): nothing of the tier synchronises the device or touches the legacy
default stream while another engine captures. Tensors enter the hot cache
only once complete (stage 1 is synchronised before its put, a promotion's
copy is synchronous), so a demotion needs no wait on the stream that made
them; and a tensor of the tier is released only with the request handle
that read it, after its packs' events have been waited on.

Candidate-axis sharding (``plan.shard``, ``repro_torch.dist``): with
``shard_candidates`` and a ``torch.distributed`` process group, stage 2
splits every pack's rows over the ranks, one shard per rank (the largest
power of two <= the world size, clamped by an integer ``shard_candidates``
and by ``max_batch``). Every rank runs the same program in lockstep (SPMD):
stage 1 for every user (replicated reps), the same packs with the same
layout and padding (buckets stay multiples of the shard count), and then
fills, copies and replays only its own ``bucket / shards`` rows. The
closing all-gather runs after the replay, outside any captured graph:
``all_gather_into_tensor`` on the card under NCCL, ``all_gather`` under
gloo (which stages a card's block through the host itself and blocks
until the other ranks' blocks are in). The pack's event is recorded after
the gather. With
``compress_scores`` the gather moves int8 codes and one fp32 scale per
shard and output (``dist.compress.compressed_all_gather``). Ranks past the
shard count serve no rows and send zeros, but receive the scores. A
multi-process engine turns hedging off and keeps the device tier off (a
per-process duplicate or an asynchronous table write would desynchronize
the collective schedule); the cold tier stays on, as in the reference: a
promotion moves reps between this process's tiers and changes no pack,
so no collective depends on it.

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
policy deadline a duplicate runs and the first result wins. Primary and
duplicate each copy the pack in, replay and copy their own outputs out
under the graph pool's lock. The first call at a new shape captures and
is never hedged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Hashable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.common import (next_pow2, prev_pow2, resolve_device,
                                take_clip, tree_map)
from repro_torch.core.mari import convert_params, mari_rewrite
from repro_torch.core.split import split_two_stage
from repro_torch.dist.compress import compressed_all_gather
from repro_torch.dist.sharding import gather_rows, group_ready, world
from repro_torch.dist.topology import bucket_for as _bucket_for
from repro_torch.dist.topology import candidate_shards
from repro_torch.ft.faults import CORRUPT, FaultInjector
from repro_torch.ft.recovery import CircuitBreaker
from repro_torch.graph.compiled import CompiledRun, GraphPool
from repro_torch.graph.executor import (USER_INDEX_FEED, Executor,
                                        node_ranges)
from repro_torch.graph.ir import Graph, infer_shapes
from repro_torch.kernels.din_attention import prepare_din_params
from repro_torch.kernels.mari_matmul.ops import (prepare_mari_params,
                                                 stream_weight_blocks)
from repro_torch.mem import ColdRepStore, PromotionWorker, RepWarmer
from repro_torch.obs import DEFAULT_CAPACITY, MetricsRegistry, Tracer
from repro_torch.serve.cache import EVICT, DeviceRepStore, UserRepCache
from repro_torch.serve.errors import FaultInjected
from repro_torch.serve.hedging import HedgedRunner, HedgePolicy
from repro_torch.serve.plan import ServePlan
from repro_torch.serve.profile import StageProfiler

Tensor = torch.Tensor

# stage 2's compiled feed names: rep-table entries, candidate feeds and the
# per-row user index (prefixed: a boundary may share a candidate's name)
_TABLE, _CAND, _UIDX = "t:", "c:", "uidx"


def bucket_for(n: int, *, min_bucket: int = 128, max_batch: int = 4096) -> int:
    """Smallest power-of-two bucket holding ``n`` rows, at least
    ``min_bucket`` and at most ``max_batch``: ``dist.topology.bucket_for``
    with one shard (a cap-sized bucket needs no alignment)."""
    return _bucket_for(n, 1, min_bucket=min_bucket, max_batch=max_batch)


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
    cold_hit: bool = False       # served from the host-RAM cold tier (no
    #                              stage-1 recompute, no hot/device slot)


def _precat_mari_weights(graph: Graph, params: dict) -> dict:
    """Pre-concatenate each ``mari_dense``'s batched-group weight blocks
    (stored as ``w_cat`` beside the blocks), so the per-call weight concat
    leaves the hot path. The streamed operand values are unchanged."""
    out = dict(params)
    for name, ws in stream_weight_blocks(graph, params).items():
        if len(ws) > 1:           # a single block: nothing to concatenate
            out[name] = dict(params[name], w_cat=torch.cat(ws, dim=0))
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
    cold_hit: bool = False        # reps came from the cold arena read


@dataclasses.dataclass(eq=False)
class _Pack:
    """One prepared stage-2 call."""
    table: dict                   # name -> rep tensor / per-slot rows
    table_refs: dict              # name -> persistent table (device tier)
    uidx: Tensor | None           # (rows,) int32, host (pinned on CUDA);
    #                               None on a rank that serves no rows
    cand: dict                    # name -> (rows, ...) host buffer
    n_slots: int
    first_shape: bool             # first call at its graph signature
    bucket: int                   # the pack's rows over all shards


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
    gid: int = 0                  # engine group id (trace linkage)
    track: str | None = None      # synthetic trace track ("group:k")
    slot: int = -1                # its slot, released at collect


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
        # one graph memory pool for every compiled stage of this engine
        self.graph_pool = GraphPool(self.device)
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
            # stage 1 at batch 1: one graph per user-feed signature
            self._stage1_run = CompiledRun(self._stage1.run,
                                           device=self.device,
                                           pool=self.graph_pool,
                                           name="stage1",
                                           node_ranges=node_ranges)
            # a list, not a set: its order is the stage-1 graphs' feed order
            self._stage1_inputs = [
                n.name for n in self.split.stage1.input_nodes()]
            batched_graph = self.split.stage2
        else:
            self._stage1 = self._stage1_run = None
            self._stage1_inputs = None
            batched_graph = self.graph
        # -- candidate-axis sharding (stage 2): this rank's block of every
        # pack's rows; the layout is the same on every rank --
        self.shard_candidates = bool(plan.shard.shard_candidates)
        self.compress_scores = plan.shard.compress_scores
        self._n_shards, self._shard_rank, n_ranks = 1, 0, 1
        self._collective = False      # a process group gathers the scores
        if self.shard_candidates:
            n_ranks, rank = world()
            sc = plan.shard.shard_candidates
            # never shard wider than the row budget: every shard gets >= 1
            # row of a max_batch dispatch
            cap = prev_pow2(self.max_batch)
            self._n_shards = candidate_shards(
                n_ranks, cap if sc is True else min(int(sc), cap))
            self._shard_rank = rank if rank < self._n_shards else None
            self._collective = group_ready()
            # buckets stay multiples of the shard count, and so does the
            # cap: a non-pow2 max_batch rounds DOWN to a power of two
            if self._n_shards > 1:
                self.max_batch = prev_pow2(self.max_batch)
            self.min_bucket = min(max(self.min_bucket, self._n_shards),
                                  self.max_batch)
            shapes = infer_shapes(self.graph)
            self._out_shapes = {o: shapes[o] for o in self.outputs}
        # several processes in lockstep: no hedging, no device tier
        self._multiproc = n_ranks > 1

        if plan.kernel.precat_weights:
            self.params = _precat_mari_weights(batched_graph, self.params)
        self.use_pallas = plan.kernel.use_pallas
        if self.use_pallas and self.device.type == "cuda":
            # the mari_matmul and din_attention kernels' weights,
            # prepared once at load
            self.params = prepare_din_params(
                batched_graph,
                prepare_mari_params(batched_graph, self.params))
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
        # the port's _build_rowwise: one graph per (u_dim, bucket, route)
        self._stage2_run = CompiledRun(self._stage2_body, device=self.device,
                                       pool=self.graph_pool, name="stage2",
                                       node_ranges=node_ranges)

        # -- device-resident tier: persistent slot tables beside the LRU --
        self.device_resident = (plan.cache.device_resident
                                and self.cache_user_reps
                                and not self._multiproc)
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
        # (U_dim, bucket, on device-tier slots): one stage-2 graph each
        self._stage2_keys: set[tuple[int, int, bool]] = set()
        # first-seen candidate-feed signature {name: (dtype, row shape)}:
        # pack buffers are shaped from it, so drift must fail fast
        self._feed_sig: dict[str, tuple] | None = None
        self.profiler = StageProfiler()

        # -- observability (plan.obs): histogram metrics here, the tracer
        # after the fault injector it is handed to --
        self.metrics: MetricsRegistry | None = None
        if plan.obs.metrics:
            self.metrics = MetricsRegistry()
            for name, fn in (
                    ("cache_hits", lambda: self.cache.hits),
                    ("cache_misses", lambda: self.cache.misses),
                    ("cache_evictions", lambda: self.cache.evictions),
                    ("stage1_calls", lambda: self.stage1_calls),
                    ("stage2_calls", lambda: self.stage2_calls),
                    ("coalesced_calls", lambda: self.coalesced_calls),
                    ("pipeline_forks", lambda: self.pipeline_forks)):
                self.metrics.gauge(name, fn)
        self._group_seq = 0           # begin_coalesced calls (group ids)
        self._group_slots: set[int] = set()  # outstanding trace tracks
        self._trace_req_seq = 0       # engine-side request sampling seq

        # -- hedging: duplicate straggling dispatches (never with the
        # device tier, which the plan already resolves; enforced here too)
        self.hedge_policy = hedge_policy or HedgePolicy()
        self.hedging = (plan.batch.hedging and not self.device_resident
                        and not self._multiproc)
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
                probes=ftp.breaker_probes,
                on_transition=self._on_breaker_transition)
        self.fallback_packs = 0       # packs the open breaker re-routed
        self.corruptions_detected = 0  # NaN scores caught at collect

        # -- hierarchical memory tier (plan.mem): host-RAM cold store +
        # async promotion + bulk warming. The cold tier only makes sense
        # under a live hot cache (single-stage engines have none) --
        self.cold_tier = plan.mem.cold_tier and self.cache_user_reps
        self._cold: ColdRepStore | None = None
        self._promoter: PromotionWorker | None = None
        self._warmer: RepWarmer | None = None
        self._mem_stream = None       # the tier's own CUDA stream
        self.cold_hits = 0            # requests served from the arena read
        self.cold_misses = 0          # full misses past an armed cold tier
        self.demotions = 0            # hot-LRU evictions caught by the arena
        if self.cold_tier:
            if self.device.type == "cuda":
                # from the high-priority pool: torch.cuda.Stream() hands
                # out the 32 default-priority pool streams round-robin,
                # and one of those is some engine's capture stream
                # (GraphPool) — a tier copy there would join its capture
                self._mem_stream = torch.cuda.Stream(self.device,
                                                     priority=-1)
            self._cold = ColdRepStore(plan.mem.cold_bytes)
            # promotions enter the hot cache as device tensors: the device
            # tier's row writes and the re-stacking cat both take them
            self._promoter = PromotionWorker(
                self._cold, self.cache,
                touches=plan.mem.promote_touches,
                window_s=plan.mem.promote_window_s, to_hot=self._to_device)
            self._warmer = RepWarmer(self._warm_stage1, self._cold,
                                     batch=plan.mem.warm_batch,
                                     sync=self._sync, to_host=self._to_host)
            # hot-LRU evictions DEMOTE into the arena instead of being
            # discarded (fired outside the cache lock)
            self.cache.subscribe_removal(self._on_cache_removal)
            if self.metrics is not None:
                for name, fn in (
                        ("cold_hits", lambda: self.cold_hits),
                        ("cold_misses", lambda: self.cold_misses),
                        ("demotions", lambda: self.demotions),
                        ("promotions", lambda: self._promoter.promotions),
                        ("warmed_users", lambda: self._warmer.warmed),
                        ("cold_users", lambda: len(self._cold)),
                        ("cold_tier_bytes",
                         lambda: self._cold.stats()["bytes"])):
                    self.metrics.gauge(name, fn)

        # ring-buffer tracing: off keeps the hot path at a `tracer is None`
        # check; the caches and the fault injector get the tracer for
        # their instants
        self.tracer: Tracer | None = None
        if plan.obs.trace:
            self.set_tracer(Tracer(
                capacity=plan.obs.trace_capacity or DEFAULT_CAPACITY,
                sample_every=plan.obs.sample_every))

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

    def set_tracer(self, tracer: Tracer | None) -> None:
        """Attach a ``Tracer`` (or detach it with None): the engine, its
        caches, its fault injector and any batcher over it record into it
        from the next call on. ``plan.obs.trace`` attaches one at
        construction."""
        self.tracer = tracer
        self.cache.set_tracer(tracer)
        self._stage2_run.set_tracer(tracer)
        if self._stage1_run is not None:
            self._stage1_run.set_tracer(tracer)
        if self._device_store is not None:
            self._device_store.set_tracer(tracer)
        if self.fault_injector is not None:
            self.fault_injector.set_tracer(tracer)
        if self._promoter is not None:
            self._promoter.set_tracer(tracer)
            self._warmer.set_tracer(tracer)

    # -- hierarchical memory tier hooks --------------------------------------
    def _mem_ctx(self):
        """The tier's copies run on its own stream (CUDA) and each waits
        for that stream alone."""
        return (torch.cuda.stream(self._mem_stream)
                if self._mem_stream is not None else contextlib.nullcontext())

    def _to_device(self, rows: Mapping[str, np.ndarray]) -> dict[str, Tensor]:
        """Arena rows (fresh host copies) -> tensors on the engine's
        device: one synchronous copy per boundary, finished on return."""
        with self._mem_ctx():
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in rows.items()}

    def _to_host(self, reps: Mapping[str, Tensor]) -> dict[str, np.ndarray]:
        """One warmed user's reps -> numpy (synchronous copies)."""
        with self._mem_ctx():
            return {k: v.cpu().numpy() for k, v in reps.items()}

    def _warm_stage1(self, params, feeds):
        """The warmer runs the engine's OWN compiled stage 1 at the live
        path's (1, ...) feed shapes, in the graph's feed order — warmed
        reps are bit-identical to what a request would have computed."""
        return self._stage1_run(params, {k: feeds[k]
                                         for k in self._stage1_inputs
                                         if k in feeds})

    def _on_cache_removal(self, user_id, version, reps, reason) -> None:
        """Hot-cache removal listener: evictions demote into the cold
        arena; supersede/invalidate/clear drop any cold copy too (a stale
        version must never be re-promoted). Runs outside the cache lock,
        on whichever thread evicted."""
        if self._cache_scope is not None and not (
                isinstance(user_id, tuple) and len(user_id) == 2
                and user_id[0] == self._cache_scope):
            return                    # another scenario's keys in a shared
            #                           cache: not this arena's layout
        if reason == EVICT:
            with self.profiler.phase("demote"), self._mem_ctx():
                self._cold.put((user_id, version), reps)
            self.demotions += 1
            if self.tracer is not None:
                self.tracer.instant("demote", user=user_id)
        else:
            self._cold.drop(user_id)

    def warm(self, items, feature_version: int = 0) -> int:
        """Bulk-precompute stage-1 reps straight into the cold tier.

        ``items`` is an iterable of ``(user_id, user_feeds)`` pairs (feeds
        at leading dim 1, the dict a ``ServeRequest`` would carry); a
        warmed user's first live request is a cold hit — one arena read,
        no stage-1 recompute. Returns the number of users warmed."""
        if not self.cold_tier:
            raise RuntimeError(
                "warm() requires plan.mem.cold_tier=True (and a two-stage "
                "engine with cache_user_reps)")
        triples = [(self._scoped_uid(uid), feature_version, feeds)
                   for uid, feeds in items]
        return self._warmer.warm(triples, self.params)

    def flush_promotions(self, timeout: float | None = 10.0) -> None:
        """Block until every cold-hit touch recorded so far has been
        processed by the promotion worker (deterministic tests/benches)."""
        if self._promoter is not None:
            self._promoter.flush(timeout)

    def mem_stats(self) -> dict:
        """One snapshot of the memory hierarchy (all tiers); the
        promotion worker's ``errors`` counts failed promotions."""
        if not self.cold_tier:
            return {"cold_tier": False}
        return {
            "cold_tier": True,
            "cold_hits": self.cold_hits,
            "cold_misses": self.cold_misses,
            "demotions": self.demotions,
            "cold": self._cold.stats(),
            "promote": self._promoter.stats(),
            "warm": {"warmed": self._warmer.warmed,
                     "stage1_launches": self._warmer.stage1_launches},
        }

    def _on_breaker_transition(self, old: str, new: str) -> None:
        trc = self.tracer
        if trc is not None:
            trc.instant({"open": "breaker_open",
                         "half_open": "breaker_half_open",
                         "closed": "breaker_close"}[new], previous=old)

    def _poke(self, site: str, **ctx):
        """Fault-injection hook: no-op unless the plan armed an injector."""
        inj = self.fault_injector
        return None if inj is None else inj.poke(site, **ctx)

    def _quarantine_device_tier(self, reason: str) -> None:
        """A failed row write (or corruption detected on the slot path)
        poisons the current table generation: invalidate it wholesale so
        a stale row is never served (rows rebuild lazily from the host
        LRU; the tables keep their allocation, so stage-2 graphs stay
        valid). Counts as one device-tier failure toward the breaker."""
        if self._device_store is not None:
            self._device_store.quarantine(reason=reason)
        if self.breaker is not None:
            self.breaker.record_failure()

    # -- stage 2 ---------------------------------------------------------
    def _stage2_body(self, params: dict, feeds: Mapping[str, Tensor]
                     ) -> dict[str, Tensor]:
        """The row-wise batched stage, as each stage-2 graph captures it:
        every rep-table entry is gathered per candidate row (clamped),
        except the entries a kernel gathers itself at load time
        (``lazy_gather_inputs``: the mari_matmul accumulator init under
        ``kernel_gather``, the decomposed-attention tables under
        ``gather_attention``), which are fed stacked with the row index."""
        lazy = self.lazy_gather_inputs
        uidx = feeds[_UIDX]
        run = {}
        for k, v in feeds.items():
            if k.startswith(_TABLE):
                name = k[len(_TABLE):]
                run[name] = v if name in lazy else take_clip(v, uidx)
            elif k.startswith(_CAND):
                run[k[len(_CAND):]] = v
        if lazy:
            run[USER_INDEX_FEED] = uidx
        return self._stage2_ex.run(params, run)

    def _stage2(self, params: dict, table: Mapping[str, object],
                table_refs: Mapping[str, Tensor], user_index: Tensor,
                cand: Mapping[str, Tensor]) -> dict[str, Tensor]:
        """Stage 2 through its compiled graph: ``table`` entries (a rep
        tensor, or the per-slot rows to stack) and ``cand`` / the user
        index (host buffers) are copied into the graph's static inputs;
        ``table_refs`` (the device tier's persistent tables) are read in
        place."""
        feeds = {_TABLE + k: v for k, v in table.items()}
        feeds.update((_CAND + k, v) for k, v in cand.items())
        feeds[_UIDX] = user_index
        refs = {_TABLE + k: v for k, v in table_refs.items()}
        return self._stage2_run(params, feeds, refs)

    def _dispatch(self, stream, params, table, table_refs, uidx, cand):
        """Blocking stage 2 for the hedged runner: runs on a worker thread,
        so it enters the caller's CUDA stream itself (the compiled run
        enters inference mode), then waits for the device. Its arguments stay
        referenced by this frame until the call returns, so an abandoned
        loser never reads freed memory."""
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            out = self._stage2(params, table, table_refs, uidx, cand)
            self._sync()
        return out

    # -- candidate mini-batching -----------------------------------------
    def _bucket(self, n: int) -> int:
        """Smallest power-of-two bucket >= n, clamped to
        [min_bucket, max_batch] and kept a multiple of the shard count:
        every pool size maps onto a small, fixed set of stage-2 shapes and
        no shard receives a ragged tail."""
        return _bucket_for(n, self._n_shards, min_bucket=self.min_bucket,
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

    @property
    def stage2_routes(self) -> int:
        """Distinct (rep-table rows, bucket, table route) stage 2 has run
        at: a device-tier pack reads its tables by address and a re-stacked
        one copies them, so one shape served both ways is two graphs."""
        return len(self._stage2_keys)

    @property
    def stage2_compilations(self) -> int:
        """Number of compiled batched-stage graphs (the reference's name:
        one per distinct (rep-table, bucket) shape and table route)."""
        return self._stage2_run.compilations

    @property
    def stage1_compilations(self) -> int:
        """Number of compiled stage-1 graphs (one per user-feed
        signature; 0 for a single-stage engine)."""
        return 0 if self._stage1_run is None else \
            self._stage1_run.compilations

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
        if self._cold is not None:
            # a warmed-but-never-promoted user lives ONLY in the cold
            # arena — the hot cache fires no removal listener for it
            self._cold.drop(self._scoped_uid(user_id))

    def _user_reps(self, req: ServeRequest
                   ) -> tuple[Mapping[str, Tensor], bool, float, bool]:
        """The tier walk: hot LRU, then the cold arena, then stage 1.
        Returns (reps, hot hit, stage-1 ms, cold hit)."""
        key = (self._scoped_uid(req.user_id), req.feature_version)
        if self.cache_user_reps:
            reps = self.cache.get(key)
            if reps is not None:
                return reps, True, 0.0, False
            if self._cold is not None:
                with self.profiler.phase("cold_read"):
                    creps = self._cold.get(key)
                    if creps is not None:
                        creps = self._to_device(creps)
                if creps is not None:
                    # cold hit: served from the arena read — no stage-1
                    # recompute, no hot put (the promotion worker decides
                    # residency off the request path), no device slot
                    # (cold-served packs re-stack: _resolve_device_slots)
                    self.cold_hits += 1
                    self._promoter.touch(key)
                    return creps, False, 0.0, True
                self.cold_misses += 1
        if self.two_stage:
            self._poke("stage1", user=req.user_id)
            t0 = time.perf_counter()
            # in the graph's input order: a feed order is part of a
            # compiled signature
            feeds = {k: req.user_feeds[k] for k in self._stage1_inputs
                     if k in req.user_feeds}
            reps = self._stage1_run(self.params, feeds)
            trc = self.tracer
            if trc is None:
                self._sync()
            else:
                t_s = time.perf_counter()
                self._sync()
                trc.complete("stage1.sync", t_s, time.perf_counter() - t_s)
            self.stage1_calls += 1
            s = time.perf_counter() - t0
            self.profiler.add("stage1", s)
            ms = s * 1e3
            if self.tracer is not None:
                self.tracer.complete("stage1", t0, s, user=req.user_id)
        else:
            # single-stage: the "representation" is the raw user feed dict
            reps = {k: torch.as_tensor(_host_array(v), device=self.device)
                    for k, v in req.user_feeds.items()}
            ms = 0.0
        if self.cache_user_reps:
            self.cache.put(key, reps)
        return reps, False, ms, False

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
        trc = self.tracer
        self._group_seq += 1
        gid = self._group_seq
        g_slot, g_track = -1, None
        if trc is not None:
            # one synthetic trace track per OUTSTANDING group (the lowest
            # free slot, released at collect): overlapped groups land on
            # two tracks, so their concurrency shows in Perfetto
            g_slot = 0
            while g_slot in self._group_slots:
                g_slot += 1
            self._group_slots.add(g_slot)
            g_track = f"group:{g_slot}"
            trc.begin("group", track=g_track, group=gid, reqs=len(reqs))
        try:
            return self._begin_coalesced_body(reqs, t0, gid, g_track, g_slot)
        except BaseException:
            # close the group span on any failure after it opened, so
            # traces stay B/E-balanced and the track slot is released
            if trc is not None:
                trc.end("group", track=g_track, group=gid, error=True)
                self._group_slots.discard(g_slot)
            raise

    def _begin_coalesced_body(self, reqs: Sequence[ServeRequest], t0: float,
                              gid: int, g_track: str | None, g_slot: int
                              ) -> _InFlight:
        trc = self.tracer
        infos: list[_ReqInfo] = []
        for ri, req in enumerate(reqs):
            reps, hit, s1ms, chit = self._user_reps(req)
            if trc is not None:
                self._trace_req_seq += 1
                if trc.sampled(self._trace_req_seq):
                    trc.instant("cache_hit" if hit
                                else "cold_hit" if chit else "cache_miss",
                                group=gid, user=req.user_id)
                    if not hit and not chit and self._cold is not None:
                        trc.instant("cold_miss", group=gid,
                                    user=req.user_id)
            infos.append(_ReqInfo(
                reps=reps, hit=hit, stage1_ms=s1ms, cold_hit=chit,
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
        # the current generation freely. Cold-served keys never get a row
        # write (their packs re-stack), so they cannot trigger the fork
        cold_keys = {info.slot_key for info in infos if info.cold_hit}
        forked = False
        store = self._device_store
        if store is not None and self._inflight:
            keys = {info.slot_key for info in infos} - cold_keys
            if any(not store.is_live(self._scoped_uid(u), v)
                   for u, v in keys):
                self.pipeline_forks += 1
                store.fork_next_write()
                forked = True
                if trc is not None:
                    trc.instant("fork_armed", group=gid,
                                inflight=len(self._inflight))

        # write barrier: every row write of the call is enqueued before
        # any of its launches; timed as its own phase so ``pack`` stays
        # one entry per pack
        if store is None:
            dslots = [None] * len(packs)
        else:
            with self.profiler.phase("slots"):
                dslots = self._resolve_device_slots(packs, cold_keys)
        if forked:
            store.clear_fork_mark()

        # prepare + launch each pack in turn: launches do not wait, so the
        # host fills pack k+1 while the device computes pack k
        launched = []
        try:
            for (pack_items, slot_reps, _), ds in zip(packs, dslots):
                t_pk = time.perf_counter()
                with self.profiler.phase("pack"):
                    prep = self._prepare_pack(pack_items, slot_reps, ds)
                t_ds = time.perf_counter()
                launched.append(self._launch_pack(prep,
                                                  on_slots=ds is not None))
                if trc is not None:
                    total = sum(n for _, _, _, n in pack_items)
                    bucket = prep.bucket
                    trc.complete(
                        "pack", t_pk, t_ds - t_pk, group=gid,
                        bucket=bucket, rows=total, pad=bucket - total,
                        users=len(slot_reps),
                        path="slots" if ds is not None else "restack")
                    trc.complete("dispatch", t_ds,
                                 time.perf_counter() - t_ds, group=gid,
                                 bucket=bucket)
        except BaseException:
            # leave no untracked launch behind
            self._sync()
            raise
        handle = _InFlight(reqs=reqs, infos=infos, packs=packs,
                           launched=launched, t0=t0,
                           slots_mask=[ds is not None for ds in dslots],
                           gid=gid, track=g_track, slot=g_slot)
        self._inflight.append(handle)
        if trc is not None:
            trc.complete("begin_coalesced", t0, time.perf_counter() - t0,
                         group=gid, reqs=len(reqs), packs=len(packs))
        return handle

    def poll(self, handle: _InFlight) -> bool:
        """Non-blocking: True when ``collect(handle)`` would not wait on the
        device (every pack's event has completed)."""
        return all(ev is None or ev.query()
                   for _, ev, _, _ in handle.launched)

    def collect(self, handle: _InFlight) -> list[ServeResult]:
        """Phase 2: wait on the handle's packs, copy scores to the host and
        slice per-request results. Each handle is collected exactly once."""
        trc = self.tracer
        t0c = time.perf_counter()
        try:
            self._inflight.remove(handle)
        except ValueError:
            raise RuntimeError(
                "collect() on a handle that is not in flight (already "
                "collected, or from another engine)") from None
        try:
            return self._collect_body(handle, t0c)
        except BaseException:
            # a mid-sweep failure (injected fault, detected corruption)
            # leaves no untracked launch behind, and closes the group span
            self._sync()
            if trc is not None and handle.track is not None:
                trc.end("group", track=handle.track, group=handle.gid,
                        error=True)
                self._group_slots.discard(handle.slot)
            raise

    def _collect_body(self, handle: _InFlight, t0c: float
                      ) -> list[ServeResult]:
        trc = self.tracer
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
            if trc is not None:
                t_w = time.perf_counter()
            if ev is not None:
                with prof.phase("device"):
                    ev.synchronize()
            if trc is not None:
                t_p = time.perf_counter()
            act = self._poke("collect", group=handle.gid)
            if trc is not None:
                t_u = time.perf_counter()
            with prof.phase("unpack"):
                scores = np.concatenate(
                    [out[o].cpu().numpy() for o in self.outputs],
                    axis=-1)[:total]
            if trc is not None:
                # the device and unpack phases' intervals, the fault hook
                # between them left out
                trc.steps(("collect.wait" if ev is not None else None,
                           None, "collect.unpack"),
                          (t_w, t_p, t_u, time.perf_counter()))
            if act is CORRUPT:
                scores = np.full_like(scores, np.nan)
            if detect and not np.isfinite(scores).all():
                # detectable corruption: a NaN-poisoned payload is failed
                # typed, never served
                self.corruptions_detected += 1
                if trc is not None:
                    trc.instant("corruption_detected", group=handle.gid,
                                path="slots" if on_slots else "restack")
                if on_slots:
                    # the device tier may hold the poisoned row: wipe the
                    # generation so a retry rebuilds from the host LRU
                    self._quarantine_device_tier(
                        "corrupted scores detected at collect")
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
        if trc is not None:
            trc.complete("collect", t0c, time.perf_counter() - t0c,
                         group=handle.gid, packs=len(handle.packs))
            if handle.track is not None:
                trc.end("group", track=handle.track, group=handle.gid)
                self._group_slots.discard(handle.slot)
        return [ServeResult(
            scores=np.concatenate(per_req_scores[ri], axis=0),
            latency_ms=wall_ms, n_batches=per_req_packs[ri],
            user_cache_hit=infos[ri].hit, hedged=per_req_hedged[ri],
            stage1_ms=infos[ri].stage1_ms, coalesced=len(reqs) > 1,
            cold_hit=infos[ri].cold_hit)
            for ri in range(len(reqs))]

    # -- pack preparation ----------------------------------------------------
    def _resolve_device_slots(self, packs: list,
                              cold_keys: set = frozenset()
                              ) -> list[list[int] | None]:
        """Map every pack's slot keys to device-table slots (one row write
        per user not already resident); called only with the device tier
        on. ``None`` per pack when that pack falls back to re-stacking: it
        overflowed capacity, the breaker is open, it carries a user that
        appears under two feature versions in this call (the store keeps
        one slot per user, so resolving the second version would rewrite
        the row the first version's rows read), or it carries a key of
        ``cold_keys``, served from the cold tier this call (a cold-served,
        by policy tail, user must not cost a row write or steal a hot
        user's slot, and with no hot-cache entry no eviction listener
        would ever free the slot). Every device-resolved user of the call
        is protected while resolving: a later pack's write may never steal
        a slot an earlier pack references."""
        store = self._device_store
        if self.breaker is not None and not self.breaker.allow():
            # open: every pack re-stacks; after the cooldown allow() turns
            # half-open and lets probe traffic back onto the slot path
            self.fallback_packs += len(packs)
            if self.tracer is not None:
                self.tracer.instant("breaker_fallback", packs=len(packs))
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
            if (any(uid in conflicted for uid, _ in slot_keys)
                    or (cold_keys
                        and any(k in cold_keys for k in slot_keys))):
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
            except Exception as e:
                # a failed write leaves the generation suspect: quarantine
                # it and re-stack EVERY pack of the call (the quarantine
                # freed the slots earlier packs resolved) — the request
                # still succeeds while the breaker counts the failure
                self._quarantine_device_tier(
                    f"row write failed: {type(e).__name__}: {e}")
                return [None] * len(packs)
            out.append(slots if all(s is not None for s in slots) else None)
        return out

    def _prepare_pack(self, pack_items: list, slot_reps: list,
                      dslots: list[int] | None = None) -> "_Pack":
        """Assemble one stage-2 call's arguments.

        ``pack_items`` is a list of (req idx, slot idx, cand chunk, n_valid);
        ``slot_reps`` maps slot idx -> that user's rep dict; ``dslots`` maps
        slot idx -> persistent device-table slot (the tables are read in
        place), or None to re-stack one row-block per slot, padded to a
        pow2 slot count (the rows are stacked into the graph's static
        table at dispatch). Candidate rows and the user index are filled
        into host buffers PRIVATE to this pack (pinned on CUDA), copied
        ``non_blocking`` into the graph's static inputs at dispatch;
        nothing may write them afterwards. A sharded engine fills only this
        rank's ``bucket / shards`` rows."""
        self._poke("pack")
        total = sum(n for _, _, _, n in pack_items)
        bucket = self._bucket(total)
        n_slots = len(slot_reps)
        rows = bucket // self._n_shards
        if self._shard_rank is None:
            # past the shard count: no rows to fill, only the injector's
            # pokes, which every rank makes in the same order
            self._poke("transfer_copy")
            return _Pack({}, {}, None, {}, n_slots, False, bucket)
        if dslots is not None:
            # device-resident: the persistent (capacity, ...) tables; rows
            # address their user's live slot directly
            table, table_refs = {}, self._device_store.tables
            u_dim = self._device_store.capacity
            slot_ids = dslots
        else:
            u_dim = next_pow2(n_slots)
            padded = slot_reps + [slot_reps[0]] * (u_dim - n_slots)
            table = {k: [r[k] for r in padded] for k in sorted(slot_reps[0])}
            table_refs = {}
            slot_ids = list(range(n_slots))

        # this rank fills rows [lo, hi) of the pack's layout (all of it
        # unsharded); the layout and its padding are the same on every rank
        lo = self._shard_rank * rows
        hi = lo + rows
        pin = self.device.type == "cuda"
        trc = self.tracer
        if trc is not None:
            t_a = time.perf_counter()
        uidx = torch.empty((rows,), dtype=torch.int32, pin_memory=pin)
        # candidate feeds in the pinned signature's order, whatever order
        # a request lists them in: one compiled signature per shape
        cand = {k: torch.empty((rows,) + row, dtype=_torch_dtype(dt),
                               pin_memory=pin)
                for k, (dt, row) in self._feed_sig.items()}
        if trc is not None:
            t_f = time.perf_counter()
        uidx_np = uidx.numpy()
        cand_np = {k: b.numpy() for k, b in cand.items()}
        offset = 0
        for _, slot, chunk, n in pack_items:
            a, b = max(offset, lo), min(offset + n, hi)
            if a < b:
                uidx_np[a - lo:b - lo] = slot_ids[slot]
                for k, buf in cand_np.items():
                    buf[a - lo:b - lo] = chunk[k][a - offset:b - offset]
            offset += n
        if total < hi:
            # padding rows repeat the LAST real row (user slot and candidate
            # row), so pad scores are copies of a real score
            a = max(total, lo) - lo
            _, slot, chunk, n = pack_items[-1]
            uidx_np[a:] = slot_ids[slot]
            for k, buf in cand_np.items():
                buf[a:] = chunk[k][n - 1]
        if trc is not None:
            trc.steps(("pack.alloc", "pack.fill"),
                      (t_a, t_f, time.perf_counter()))
        if self._poke("transfer_copy") is CORRUPT:
            # detectable corruption: NaN-poison the float candidate rows;
            # NaN reaches the scores and is caught at collect
            for buf in cand_np.values():
                if np.issubdtype(buf.dtype, np.floating):
                    buf.fill(np.nan)
        # the first call at a new graph signature is not a straggler (it
        # warms up and captures the graph): it is never hedged
        key = (u_dim, bucket, dslots is not None)
        first_shape = key not in self._stage2_keys
        self._stage2_keys.add(key)
        self._batch_shapes.add((u_dim, bucket))
        return _Pack(table, table_refs, uidx, cand, n_slots, first_shape,
                     bucket)

    def _launch_pack(self, prep: "_Pack", on_slots: bool = False
                     ) -> tuple[dict, object, tuple, int]:
        """Enqueue one prepared pack; returns (outputs, CUDA event recorded
        after its replay — None on the CPU or when hedging already waited
        for the result —, the pack's host buffers, held until collect, and
        1 if a duplicate was launched). ``on_slots`` marks the device-slot
        path: a failed launch there counts toward the breaker."""
        self.stage2_calls += 1
        if prep.n_slots > 1:
            self.coalesced_calls += 1
        try:
            self._poke("stage2_dispatch")
        except Exception:
            if on_slots and self.breaker is not None:
                self.breaker.record_failure()
            raise
        cuda = self.device.type == "cuda"
        host_bufs = (prep.uidx, prep.cand)
        args = (self.params, prep.table, prep.table_refs, prep.uidx,
                prep.cand)
        out, hedged, blocked = None, 0, False
        if prep.uidx is None:
            pass                          # this rank serves no rows
        elif self._hedged is not None and not prep.first_shape:
            stream = torch.cuda.current_stream(self.device) if cuda else None
            with self.profiler.phase("dispatch"):
                out, outcome = self._hedged.run(stream, *args)
            hedged, blocked = int(outcome.hedged), True
        else:
            with self.profiler.phase("dispatch"):
                try:
                    out = self._stage2(*args)
                except Exception:
                    if on_slots and self.breaker is not None:
                        self.breaker.record_failure()
                    raise
        gathered = self._collective or self.compress_scores
        if gathered:
            t_g = time.perf_counter()
            with self.profiler.phase("gather"):
                out = self._gather(out, prep.bucket)
            if self.tracer is not None:
                self.tracer.complete("gather", t_g,
                                     time.perf_counter() - t_g,
                                     bucket=prep.bucket)
        ev = None
        if cuda and (gathered or not blocked):
            # recorded after the gather: collect waits for both
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        return out, ev, host_bufs, hedged

    def _gather(self, out: dict | None, bucket: int) -> dict[str, Tensor]:
        """The closing all-gather of a sharded pack, outside any captured
        graph: every rank's block of scores to every rank (int8 codes and
        one fp32 scale per shard and output with ``compress_scores``). A
        rank past the shard count sends zeros; every rank keeps the first
        ``bucket`` rows, the serving ranks' blocks."""
        rows = bucket // self._n_shards
        if out is None:
            out = {o: torch.zeros((rows,) + self._out_shapes[o],
                                  device=self.device) for o in self.outputs}
        if self.compress_scores:
            return {o: compressed_all_gather(out[o], n_ranks=self._n_shards)
                    for o in self.outputs}
        flat = [out[o].reshape(rows, -1) for o in self.outputs]
        parts = gather_rows(torch.cat(flat, dim=1))[:bucket].split(
            [f.shape[1] for f in flat], dim=1)
        return {o: p.reshape((bucket,) + tuple(out[o].shape[1:]))
                for o, p in zip(self.outputs, parts)}

    def close(self) -> None:
        """Wait for uncollected launches and stop the promotion worker and
        the hedging pool."""
        self._sync()
        self._inflight.clear()
        if self._promoter is not None:
            self._promoter.stop()
        if self._hedged is not None:
            self._hedged.close()
