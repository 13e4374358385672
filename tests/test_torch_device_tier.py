"""The port's device-resident rep tier on the CPU, held against the JAX
reference: ``DeviceRepStore`` and the ``UserRepCache`` removal listeners
run the same operations as the reference's and give the same slots, rows
and counters; the ``ServingEngine`` device tier runs the reference's
``TestDeviceRepStore`` / ``TestDeviceResidentTier`` scenarios
(tests/test_serve_runtime.py) — slot lifecycle, steal, overflow fallback,
version supersede, mixed versions of one user, quarantine, fork — each
score held to fp32 rtol = atol = 2e-4 against the reference's per-request
``score()``, never bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro.serve.cache as jcache
import repro_torch.serve as tserve
import repro_torch.serve.cache as tcache
from repro.graph.executor import init_graph_params
from repro.models.ranking import PaperRankingConfig as JPaperCfg
from repro.models.ranking import build_paper_ranking_model as j_paper
from repro_torch.common import params_from_numpy
from repro_torch.models.ranking import PaperRankingConfig as TPaperCfg
from repro_torch.models.ranking import build_paper_ranking_model as t_paper

TOL = dict(rtol=2e-4, atol=2e-4)
PRESETS = {"vani": "vanilla", "uoi": "uoi", "mari": "paper"}


# -- DeviceRepStore against the reference's ---------------------------------

def _reps(val, d=4, ref=False):
    if ref:
        return {"a": jnp.full((1, d), float(val)),
                "b": jnp.full((1, 2, 3), float(val) + 0.5)}
    return {"a": torch.full((1, d), float(val)),
            "b": torch.full((1, 2, 3), float(val) + 0.5)}


def _both(capacity, **kw):
    return (tcache.DeviceRepStore(capacity, **kw),
            jcache.DeviceRepStore(capacity, **kw))


def _ensure(stores, items, protect=()):
    ours, ref = stores
    a = ours.ensure_rows([(u, v, _reps(x)) for u, v, x in items], protect)
    b = ref.ensure_rows([(u, v, _reps(x, ref=True)) for u, v, x in items],
                        protect)
    assert a == b
    return a


def _same_state(stores):
    ours, ref = stores
    s_t, s_j = ours.stats(), ref.stats()
    assert s_t == s_j
    for k in ("a", "b"):
        np.testing.assert_array_equal(ours.tables[k].numpy(),
                                      np.asarray(ref.tables[k]))


def test_store_slot_lifecycle_and_rows():
    st = _both(3)
    assert _ensure(st, [(1, 0, 1), (2, 0, 2)]) == [0, 1]
    assert _ensure(st, [(1, 0, 99)]) == [0]            # live: no write
    assert st[0].writes == 2 and st[0].hits == 1
    np.testing.assert_array_equal(st[0].tables["a"][0].numpy(), np.ones(4))
    assert _ensure(st, [(1, 1, 7)]) == [0]             # supersede in place
    np.testing.assert_array_equal(st[0].tables["a"][0].numpy(),
                                  np.full(4, 7.0))
    _same_state(st)


def test_store_lru_steal_respects_protection():
    st = _both(2)
    _ensure(st, [(1, 0, 1), (2, 0, 2)])
    assert _ensure(st, [(3, 0, 3)], protect=[1]) == [1]
    assert st[0].slot_of(2) is None and st[0].slot_of(1) == 0
    assert _ensure(st, [(4, 0, 4)], protect=[1, 3]) == [None]
    assert st[0].overflows == 1 and len(st[0]) == 2
    _same_state(st)


def test_store_drop_recycles_without_touching_rows():
    st = _both(2)
    _ensure(st, [(1, 0, 1), (2, 0, 2)])
    for s in st:
        s.drop(1)
    np.testing.assert_array_equal(st[0].tables["a"][0].numpy(), np.ones(4))
    assert _ensure(st, [(5, 0, 5)]) == [0]
    np.testing.assert_array_equal(st[0].tables["a"][0].numpy(),
                                  np.full(4, 5.0))
    _same_state(st)


def test_store_spec_validation_stats_fork_and_quarantine():
    st = _both(2, boundary_specs={"a": (4,), "b": (2, 3)})
    with pytest.raises(ValueError, match="shape"):
        st[0].ensure_rows([(1, 0, {"a": torch.zeros((1, 5)),
                                   "b": torch.zeros((1, 2, 3))})])
    with pytest.raises(ValueError, match="shape"):
        st[1].ensure_rows([(1, 0, {"a": jnp.zeros((1, 5)),
                                   "b": jnp.zeros((1, 2, 3))})])
    assert st[0].stats()["free_slots"] == 2            # no slot leaked
    _ensure(st, [(1, 0, 1)])
    s = st[0].stats()
    assert s["bytes"] == 2 * (4 + 2 * 3) * 4
    assert s["boundary_bytes"] == {"a": 2 * 4 * 4, "b": 2 * 6 * 4}
    # the reference's copy-on-write fork: the armed write is counted as
    # one ordered behind in-flight launches (stream order keeps them from
    # seeing it); the port writes in place, so the tables keep their
    # address, which captured stage-2 graphs read
    held = st[0].tables
    ptrs = {k: t.data_ptr() for k, t in held.items()}
    for s in st:
        s.fork_next_write()
    _ensure(st, [(2, 0, 2), (3, 0, 3)])                # one fork, 2 writes
    assert st[0].forks == 1 and st[0].tables is held
    _same_state(st)
    for s in st:
        s.quarantine()
    # quarantine frees every slot and keeps the allocation
    assert len(st[0]) == 0 and st[0].tables is held
    assert {k: t.data_ptr() for k, t in held.items()} == ptrs
    assert _ensure(st, [(4, 0, 4)]) == [0]             # rebuilds lazily
    assert st[0].stats() == st[1].stats()
    for k in ("a", "b"):                               # the live row
        np.testing.assert_array_equal(st[0].tables[k][0].numpy(),
                                      np.asarray(st[1].tables[k][0]))


def test_cache_removal_listeners_match_reference():
    """subscribe / subscribe_removal deliver the same records for the same
    operations: eviction, supersede, invalidate, clear."""
    logs = []
    for mod in (tcache, jcache):
        c = mod.UserRepCache(max_users=2)
        ids, recs = [], []
        c.subscribe(ids.append)
        c.subscribe_removal(lambda u, v, r, why: recs.append((u, v, r, why)))
        for k in ((1, 0), (2, 0), (3, 0), (2, 1)):
            c.put(k, {"x": k})
        c.invalidate_user(3)
        c.put((5, 0), {"x": 5})
        c.clear()
        logs.append((ids, recs, c.stats()["evictions"]))
    assert logs[0] == logs[1]
    assert [r[3] for r in logs[0][1]] == ["evict", "supersede", "invalidate",
                                          "clear", "clear"]


# -- the engine's device tier -----------------------------------------------

@pytest.fixture(scope="module")
def paper():
    jg = j_paper(JPaperCfg().scaled(0.05))[0]
    tg = t_paper(TPaperCfg().scaled(0.05))[0]
    jp = init_graph_params(jg, jax.random.PRNGKey(0))
    return jg, tg, jp, jax.tree_util.tree_map(np.asarray, jp)


def _pair(graph, uid, n, seed, version=0):
    rng = np.random.default_rng(seed)
    user, cand = {}, {}
    for node in graph.input_nodes():
        is_user = node.attrs["domain"] == "user"
        shape = (1 if is_user else n,) + tuple(node.attrs["shape"])
        (user if is_user else cand)[node.name] = rng.standard_normal(
            shape).astype(np.float32)
    return (jserve.ServeRequest(uid, user, cand, version),
            tserve.ServeRequest(uid, user, cand, version))


def _ref(paper, preset="paper"):
    jg, _, jp, _ = paper
    return jserve.ServingEngine(jg, jp, jserve.ServePlan.preset(
        preset).evolve(batch__max_batch=64, batch__min_bucket=8,
                       batch__hedging=False))


def _dev(paper, preset="paper", cache=None, cache_scope=None, **evolve):
    _, tg, _, np_params = paper
    base = dict(batch__max_batch=64, batch__min_bucket=8,
                cache__device_resident=True)
    base.update(evolve)
    return tserve.ServingEngine(
        tg, params_from_numpy(np_params, "cpu"),
        tserve.ServePlan.preset(preset).evolve(**base), cache=cache,
        cache_scope=cache_scope, device="cpu")


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.scores, w.scores, **TOL)


@pytest.mark.parametrize("mode", ["vani", "uoi", "mari"])
def test_device_tier_matches_reference(paper, mode):
    ref, dev = _ref(paper, PRESETS[mode]), _dev(paper, PRESETS[mode])
    pairs = [_pair(paper[1], u, n, seed=u + 7)
             for u, n in ((0, 21), (1, 40), (2, 12))]
    want = [ref.score(j) for j, _ in pairs]
    _close([dev.score(t) for _, t in pairs], want)
    # coalesced over the same persistent tables: all three resident
    _close(dev.score_coalesced([t for _, t in pairs]), want)
    if dev.two_stage:
        assert dev.device_resident and dev.device_store.writes == 3
        assert len(dev.device_store) == 3
    else:
        # single-stage: no reps to keep resident, the tier stays off
        assert not dev.device_resident and dev.device_store is None


def test_eviction_churn_recycles_slots(paper):
    ref = _ref(paper)
    dev = _dev(paper, cache__max_cached_users=2, cache__device_slots=2)
    pairs = [_pair(paper[1], u, 12, seed=u) for u in range(5)]
    for j, t in pairs:
        _close([dev.score(t)], [ref.score(j)])
    st = dev.device_store.stats()
    assert st["resident"] <= 2 and st["drops"] >= 3
    writes = st["writes"]
    _close([dev.score(pairs[4][1])], [ref.score(pairs[4][0])])
    assert dev.device_store.writes == writes             # a pure hit
    _close([dev.score(pairs[0][1])], [ref.score(pairs[0][0])])
    assert dev.device_store.writes == writes + 1         # recycled slot


def test_scoped_invalidation_frees_slot(paper):
    dev = _dev(paper, cache=tserve.UserRepCache(max_users=8),
               cache_scope="sA")
    j, t = _pair(paper[1], 5, 12, seed=5)
    first = dev.score(t)
    assert dev.device_store.slot_of(("sA", 5)) is not None
    dev.invalidate_user(5)
    assert dev.device_store.slot_of(("sA", 5)) is None
    assert dev.device_store.drops == 1 and len(dev.device_store) == 0
    again = dev.score(t)
    assert not again.user_cache_hit and dev.device_store.writes == 2
    _close([first, again], [_ref(paper).score(j)] * 2)


def test_dead_and_out_of_range_slots_clamp(paper):
    dev = _dev(paper, cache__device_slots=4)
    (_, r1), (j2, r2) = (_pair(paper[1], u, 16, seed=u) for u in (1, 2))
    dev.score(r1)
    s2 = dev.score(r2)
    dev.invalidate_user(1)                     # slot 0 is dead
    _close([dev.score(r2), s2], [_ref(paper).score(j2)] * 2)
    table = dev.device_store.tables
    cap = dev.device_store.capacity
    cand = {k: torch.as_tensor(v) for k, v in r2.candidate_feeds.items()}
    run = lambda i: dev._stage2(dev.params, {}, table,
                                torch.full((16,), i, dtype=torch.int32),
                                cand)
    for a, b in ((cap + 3, cap - 1), (-5, 0)):
        out_a, out_b = run(a), run(b)
        for o in dev.outputs:
            torch.testing.assert_close(out_a[o], out_b[o], rtol=0, atol=0)


def test_mixed_version_same_user_falls_back(paper):
    """One call with user 1 under two feature versions: every pack
    carrying user 1 re-stacks (both versions in one pack, and split over
    packs), and scores stay the reference's."""
    ref = _ref(paper)
    mk = lambda: [_pair(paper[1], 1, 12, seed=11, version=0),
                  _pair(paper[1], 1, 12, seed=12, version=1),
                  _pair(paper[1], 2, 12, seed=13)]
    want = [ref.score(j) for j, _ in mk()]
    one = _dev(paper)
    _close(one.score_coalesced([t for _, t in mk()]), want)
    split = _dev(paper, batch__max_users_per_batch=1)
    _close(split.score_coalesced([t for _, t in mk()]), want)
    # user 2's own pack went device-resident; user 1's never
    assert split.device_store.slot_of(2) is not None
    assert split.device_store.writes == 1
    jf, tf = _pair(paper[1], 3, 12, seed=14)
    _close([one.score(tf)], [ref.score(jf)])
    assert one.device_store.writes >= 1


def test_feed_signature_drift_fails_fast(paper):
    dev = _dev(paper)
    dev.score(_pair(paper[1], 1, 8, seed=1)[1])
    _, drifted = _pair(paper[1], 2, 8, seed=2)
    k = next(iter(drifted.candidate_feeds))
    drifted.candidate_feeds = {**drifted.candidate_feeds,
                               k: drifted.candidate_feeds[k].astype(
                                   np.float64)}
    with pytest.raises(ValueError, match="signature drifted"):
        dev.score(drifted)


def test_restack_fallback_on_slot_overflow(paper):
    ref = _ref(paper)
    dev = _dev(paper, cache__device_slots=2, batch__max_users_per_batch=4)
    pairs = [_pair(paper[1], u, 8, seed=u + 3) for u in range(4)]
    _close(dev.score_coalesced([t for _, t in pairs]),
           [ref.score(j) for j, _ in pairs])
    assert dev.device_store.overflows >= 1


def test_version_supersede_rewrites_the_slot(paper):
    ref = _ref(paper)
    dev = _dev(paper, cache__device_slots=4)
    j0, t0 = _pair(paper[1], 1, 12, seed=1, version=0)
    j1, t1 = _pair(paper[1], 1, 12, seed=2, version=1)
    _close([dev.score(t0)], [ref.score(j0)])
    _close([dev.score(t1)], [ref.score(j1)])
    assert dev.device_store.writes == 2 and len(dev.device_store) == 1


def test_fork_under_inflight_and_quarantine(paper):
    """A call that writes while another is in flight arms the
    copy-on-write fork (pipeline_forks); a quarantined tier rebuilds from
    the host LRU and keeps scoring the reference's scores."""
    ref = _ref(paper)
    dev = _dev(paper, cache__device_slots=1)
    (ja, ta), (jb, tb) = (_pair(paper[1], u, 20, seed=u) for u in (1, 2))
    want_a, want_b = ref.score(ja), ref.score(jb)
    dev.score(ta)
    h_a = dev.begin_coalesced([ta])            # a resident: no write
    h_b = dev.begin_coalesced([tb])            # b steals a's only slot
    assert dev.pipeline_forks == 1 and dev.device_store.forks == 1
    _close(dev.collect(h_a) + dev.collect(h_b), [want_a, want_b])
    dev.device_store.quarantine()
    _close([dev.score(ta), dev.score(tb)], [want_a, want_b])
    assert dev.device_store.quarantines == 1 and dev.device_store.writes >= 3


def test_failed_write_of_second_pack_restacks_the_whole_call(paper):
    """The second pack's row write fails after the first pack already
    holds a slot: the quarantine frees that slot, so every pack of the
    call re-stacks, and the coalesced call itself returns the reference's
    scores (no batcher retry in between)."""
    ref = _ref(paper)
    dev = _dev(paper, batch__max_users_per_batch=1, ft__inject=True,
               ft__sites=("slot_write:error:after=1,count=1",),
               ft__breaker_failures=3)
    pairs = [_pair(paper[1], u, 12, seed=u + 20) for u in range(3)]
    _close(dev.score_coalesced([t for _, t in pairs]),
           [ref.score(j) for j, _ in pairs])
    st = dev.ft_stats()
    assert st["faults_fired"] == 1 and dev.device_store.quarantines == 1
    assert dev.device_store.writes == 1 and len(dev.device_store) == 0
    assert dev.breaker.stats()["failures"] == 1
    # the next call rebuilds the tier from the host LRU
    _close(dev.score_coalesced([t for _, t in pairs]),
           [ref.score(j) for j, _ in pairs])
    assert len(dev.device_store) == 3


def test_store_concurrent_resolve_and_drop_keeps_slots_consistent():
    """The store is shared by the dispatching thread and the cache's
    removal listeners (another scenario's worker in a shared cache): many
    threads resolving and dropping at once never give one slot to two
    users, and every slot stays either free or held."""
    import sys
    import threading
    st = tcache.DeviceRepStore(capacity=6)
    errors = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def worker(k):
        try:
            for i in range(150):
                u = (k * 7 + i) % 20
                slots = st.ensure_rows([(u, i % 2, _reps(u))],
                                       protect=[u])
                if slots[0] is not None and not 0 <= slots[0] < 6:
                    errors.append(slots)
                if i % 3 == 0:
                    st.drop((u + 5) % 20)
        except Exception as e:          # pragma: no cover - the failure
            errors.append(e)

    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors
    held = [st.slot_of(u) for u in range(20)]
    held = [s for s in held if s is not None]
    assert len(held) == len(set(held)) == len(st)
    s = st.stats()
    assert s["resident"] + s["free_slots"] == 6
