"""The readers of the served path's spans, and device ops named by the
step, node and host op that launched them, on made-up runs; the same
readers on a traced CPU run of the small served system; and the device
trace's own readings on a trace that carries the new spans."""
import time

import numpy as np
import pytest
import torch

import portbench_small as small
from portbench import attribution, devtrace, harness
from repro_torch.obs import Tracer

S = 0.01        # the made-up runs' times, in s: steps tens of us to ms
DTOD = "Memcpy DtoD (Device -> Device)"
EW = "at::native::vectorized_elementwise_kernel"

# the kernel maps a program records: stage 1's and one stage-2 graph's
MAPS = [
    ("stage1.graph", 0.0, 0.0, {
        "graph": 0, "copy_in": ("Memcpy HtoD (Pageable -> Device)",),
        "replay": (("", "", "", "gemv"),), "copy_out": (DTOD,),
        "eager": 1}),
    ("stage2.graph", 0.0, 0.0, {
        "graph": 3, "copy_in": ("Memcpy HtoD (Pinned -> Device)",),
        "replay": (
            ("target_attention", "attn", "aten::add",
             "void at::native::vectorized_elementwise_kernel<4, "
             "at::native::CUDAFunctor_add<float> >(int)"),
            ("target_attention", "attn", "", "q_t_tc_kernel"),
            (None, None, None, "sm80_gemm"),
            ("mari_dense", "mlp", "", "mari_wgmma_kernel")),
        "copy_out": (DTOD,), "eager": 3}),
]


def spans(replay_graph=3):
    g = {"graph": 0}
    return MAPS + [(n, S * s, S * e, a) for n, s, e, a in [
        ("stage1", 0.09, 0.9, {}),
        ("stage1.copy_in", 0.10, 0.12, g),
        ("stage1.replay", 0.12, 0.13, g),
        ("stage1.copy_out", 0.13, 0.14, g),
        ("stage1.sync", 0.14, 0.9, {}),
        ("dispatch", 1.0, 1.2, {}),
        ("stage2.copy_in", 1.0, 1.05, {"graph": replay_graph}),
        ("stage2.replay", 1.05, 1.1, {"graph": replay_graph}),
        ("stage2.copy_out", 1.1, 1.2, {"graph": replay_graph}),
        ("collect", 2.0, 3.0, {}),
        ("collect.wait", 2.0, 2.5, {}),
        ("collect.unpack", 2.5, 3.0, {}),
    ]]


OPS = [(n, S * s, S * e) for n, s, e in [
       ("Memcpy HtoD (Pageable -> Device)", 0.11, 0.115),
       ("gemv", 0.125, 0.2), (DTOD, 0.2, 0.21),
       ("Memcpy HtoD (Pinned -> Device)", 1.01, 1.02),
       (EW, 1.06, 1.16), ("q_t_tc_kernel", 1.16, 1.3),
       ("sm80_gemm", 1.3, 1.35), ("mari_wgmma_kernel", 1.35, 1.4),
       (DTOD, 1.4, 1.41), ("Memcpy DtoH (Device -> Pageable)", 2.6, 2.65),
       ("stray", 5.0, 5.5)]]


def run_of(spans, ops=OPS, t0=S * 0.05, t1=S * 10.0, **kw):
    sub = devtrace.SubWindow()
    sub.t0, sub.t1 = t0, t1
    sub.ops = sorted(ops)              # as ``collect`` leaves them: by name
    return harness.Run(kind="served", seconds=t1 - t0, t0=t0, t1=t1,
                       start=np.zeros(1), done=np.ones(1),
                       rows=np.ones(1), spans=spans, counters={}, cfg={},
                       path="two_stage", work=None, peaks={}, sub=sub, **kw)


def test_ops_by_step_node_and_op():
    res = attribution.attribute(run_of(spans()))
    assert res.busy_s == pytest.approx(S * 1.0)
    # every op a map lists is taken by its step; the unpack's copy by the
    # span covering its start; the stray op by none
    assert res.by_map_s == pytest.approx(S * 0.45)
    assert res.by_time_s == pytest.approx(S * 0.05)
    assert res.by_key[(attribution.NO_SPAN, "-", "-")] == \
        pytest.approx(S * 0.5)
    assert res.by_key[("collect.unpack", "-", "-")] == pytest.approx(S * 0.05)
    assert res.by_key[("stage2.replay", "attn", "aten::add")] == \
        pytest.approx(S * 0.1)
    assert res.by_key[("stage2.replay", "attn", "-")] == \
        pytest.approx(S * 0.14)
    assert res.by_key[("stage2.replay", "?", "?")] == pytest.approx(S * 0.05)
    assert res.by_key[("stage1.replay", "-", "-")] == pytest.approx(S * 0.075)
    assert res.by_key[("stage2.copy_out", "-", "-")] == pytest.approx(S * 0.01)
    assert res.replay_s == pytest.approx(S * 0.34)
    assert res.replay_node_s == pytest.approx(S * 0.29)
    # the attention node's kernels outside the two families
    assert res.tail_s == pytest.approx(S * 0.1)
    assert res.replays == 1 and res.unmatched_steps == 0
    assert res.by_kernel[("stage2.replay", "attn", "aten::add", EW)] == \
        pytest.approx(S * 0.1)


def test_tail_reader_prints_the_report(capsys):
    run = run_of(spans() + [("batcher.linger", 0.0, S * 0.05,
                             {"reqs": 1, "rows": 9, "depth": 3,
                              "dropped": 0})])
    assert attribution.attention_tail_ms(run) == pytest.approx(1e3 * S * 0.1)
    err = capsys.readouterr().err
    assert "attribution tracer.dropped 0" in err
    assert "to_span 50.00%" in err and "unattributed 50.00%" in err
    assert "attribution span_node_op stage2.replay attn aten::add" in err
    # computed once a run
    assert attribution.attribute(run) is attribution.attribute(run)


def test_a_name_mismatch_names_no_node():
    """A replay whose map lists its kernels in another order matches
    nothing, and the step is counted: its kernels go by time to the span
    covering the latest instant each can have been launched at (the
    replay: the next step, ``copy_out``, matched), with no node."""
    maps = [MAPS[0], ("stage2.graph", 0.0, 0.0, dict(
        MAPS[1][3], graph=4, replay=tuple(reversed(MAPS[1][3]["replay"]))))]
    res = attribution.attribute(run_of(maps + spans(4)[2:]))
    assert res.unmatched_steps == 1 and res.replays == 0
    assert res.replay_s == pytest.approx(S * 0.34)
    assert res.replay_node_s == 0.0 and res.tail_s == 0.0
    assert res.by_key[("stage2.replay", "-", "-")] == pytest.approx(S * 0.34)
    assert res.by_key[("stage2.copy_out", "-", "-")] == pytest.approx(S * 0.01)
    assert attribution.attention_tail_ms(run_of(maps + spans(4)[2:])) \
        is None


def test_ops_launched_behind_a_busy_stream():
    """Two replays of one graph back to back, the second's kernels queued
    behind the first's: each replay takes its own, by order."""
    sp = MAPS + [("stage2.replay", 1.0, 1.01, {"graph": 3}),
                 ("stage2.replay", 1.02, 1.03, {"graph": 3})]
    ops = []
    t = 1.005
    for _ in range(2):
        for k in (EW, "q_t_tc_kernel", "sm80_gemm", "mari_wgmma_kernel"):
            ops.append((k, t, t + 0.01))
            t += 0.01
    res = attribution.attribute(run_of(sp, ops, t0=0.5, t1=2.0))
    assert res.replays == 2 and res.by_map_s == pytest.approx(0.08)
    assert res.tail_s == pytest.approx(0.02)


def test_a_drifting_device_clock():
    """The device trace's clock drifts early by 10 us a call (1%), past
    its ops' launch after the 5th call: matching by order keeps every
    step's ops, the lag envelope reports the drift, and taking it off puts
    the idle gaps back under the host spans they fall in."""
    sp, ops = list(MAPS), []
    kernels = (EW, "q_t_tc_kernel", "sm80_gemm", "mari_wgmma_kernel")
    for k in range(200):
        s = 0.01 + 1e-3 * k
        sp += [("stage2.replay", s, s + 1e-4, {"graph": 3}),
               ("collect.wait", s + 5e-4, s + 9e-4, {})]
        t = s + 5e-5 - 1e-5 * k
        for name in kernels:
            ops.append((name, t, t + 1e-5))
            t += 1e-5
    res = attribution.attribute(run_of(sp, ops, t0=0.005, t1=0.215))
    assert res.unmatched_steps == 0 and res.replays == 200
    assert res.by_map_s == pytest.approx(res.busy_s)
    # the envelope: the 10th percentile of the last 64 lags, here the lag
    # six calls back
    assert res.lag_first_s == pytest.approx(5e-5 - 1e-5 * 57)
    assert res.lag_last_s == pytest.approx(5e-5 - 1e-5 * 193)
    assert res.idle_gaps["collect.wait"] == pytest.approx(200 * 4e-4,
                                                          rel=0.05)


def test_the_walk_starts_where_the_steps_line_up():
    """Two graphs in a seeded order, the trace 4 ms late on the host's
    clock, and two calls launched before the sub-window whose ops the
    trace holds: the walk starts at the first step's own ops, not at an
    earlier call's that look alike."""
    g4 = ("stage2.graph", 0.0, 0.0, dict(
        MAPS[1][3], graph=4, replay=MAPS[1][3]["replay"][::2]))
    order = np.random.default_rng(5).integers(3, 5, 60)
    sp, ops = [MAPS[1], g4], []
    for k, g in enumerate(order):
        s = 0.01 + 1e-3 * k
        if k >= 2:                          # earlier calls have no span
            sp.append(("stage2.replay", s, s + 1e-4, {"graph": int(g)}))
        kernels = [x[3] for x in (MAPS[1] if g == 3 else g4)[3]["replay"]]
        t = s + 4e-3 + 2e-5
        for name in kernels:
            ops.append((devtrace.kernel_name(name), t, t + 1e-5))
            t += 1e-5
    res = attribution.attribute(run_of(sp, ops, t0=0.0115, t1=0.08))
    assert res.unmatched_steps == 0 and res.replays == 58
    early = sum(len((MAPS[1] if g == 3 else g4)[3]["replay"])
                for g in order[:2])
    assert res.by_map_s == pytest.approx(res.busy_s - 1e-5 * early)
    assert res.lag_first_s == pytest.approx(4e-3 + 2e-5)


def test_the_walk_starts_past_a_step_the_trace_lost():
    """The trace starts while the first call's copy-in runs and holds none
    of its ops: the walk starts at the next step, not at a later call's
    ops that look alike (every stage-1 call has one pattern; the stage-2
    graph after each, 3 or 4 in a seeded order, tells the calls apart)."""
    g4 = ("stage2.graph", 0.0, 0.0, dict(
        MAPS[1][3], graph=4, replay=MAPS[1][3]["replay"][::2]))
    maps = {("stage1", 0): MAPS[0][3], ("stage2", 3): MAPS[1][3],
            ("stage2", 4): g4[3]}
    order = np.random.default_rng(7).integers(3, 5, 60)
    sp, ops = [MAPS[0], MAPS[1], g4], []
    for k, g in enumerate(order):
        s = 0.01 + 1e-3 * k
        for j, (stage, graph) in enumerate((("stage1", 0), ("stage2", g))):
            for i, step in enumerate(("copy_in", "replay", "copy_out")):
                t = s + 1e-4 * (3 * j + i)
                sp.append((f"{stage}.{step}", t, t + 1e-4,
                           {"graph": int(graph)}))
                if k == 0 and j == 0 and i == 0:
                    continue                # before the trace started
                t += 2e-5
                for x in maps[(stage, graph)][step]:
                    name = x if isinstance(x, str) else x[3]
                    ops.append((devtrace.kernel_name(name), t, t + 1e-5))
                    t += 1e-5
    res = attribution.attribute(run_of(sp, ops, t0=0.0095, t1=0.08))
    assert res.unmatched_steps == 1 and res.replays == 60
    assert res.by_map_s == pytest.approx(res.busy_s)
    assert res.lag_first_s == pytest.approx(2e-5)
    assert res.lag_last_s == pytest.approx(2e-5)


def test_no_maps_no_reading(capsys):
    """A program that records no kernel map (the parent): every reader
    returns None and raises nothing."""
    run = run_of([("stage1", 0.1, 0.2, {}), ("pack", 1.0, 1.1,
                                             {"rows": 9, "users": 1})])
    assert attribution.attribute(run) is None
    assert attribution.attention_tail_ms(run) is None
    assert "no kernel map" in capsys.readouterr().err
    for name in ("engine.stage1_sync_ms", "compiled.copy_in_ms",
                 "batcher.self_ms", "batcher.queue_depth",
                 "executor.attention_tail_ms"):
        assert harness.load_file("metrics", name).read(run) is None, name
    run.sub = None
    assert attribution.attention_tail_ms(run) is None


def test_span_readers():
    sp = [("stage1.sync", 1.0, 1.0004, {}), ("stage1.sync", 2.0, 2.0002, {}),
          ("stage1.sync", 11.0, 11.5, {}),          # after the window
          ("stage2.copy_in", 3.0, 3.0001, {"graph": 0}),
          ("batcher.linger", 4.0, 4.001,
           {"reqs": 2, "rows": 9, "depth": 30, "dropped": 0}),
          ("batcher.linger", 5.0, 5.001,
           {"reqs": 1, "rows": 9, "depth": 28, "dropped": 2}),
          ("batcher.linger", 6.0, 6.001,
           {"reqs": 1, "rows": 9, "depth": 29, "dropped": 2})]
    run = run_of(sp, t0=0.5, t1=10.0)
    assert attribution.span_mean_ms(run, "stage1.sync") == pytest.approx(0.3)
    assert attribution.span_mean_ms(run, "stage2.copy_in") == \
        pytest.approx(0.1)
    assert attribution.span_mean_ms(run, "nothing") is None
    assert attribution.queue_depth(run) == 29.0
    assert attribution.dropped(run) == 2


def test_batcher_self_time_per_group():
    """Its spans' union less the engine's spans inside them, per claim;
    a span nested in another counts once."""
    sp = [("batcher.linger", 1.0, 1.010, {}),
          ("collect", 1.002, 1.006, {}),           # harvested mid-linger
          ("batcher.resolve", 1.006, 1.007, {}),   # inside the linger
          ("batcher.claim", 1.010, 1.011, {}),
          ("begin_coalesced", 1.011, 1.020, {}),
          ("batcher.linger", 2.0, 2.002, {}),
          ("batcher.claim", 2.002, 2.003, {}),
          ("batcher.resolve", 9.99, 10.01, {})]    # past the window
    run = run_of(sp, t0=0.5, t1=10.0)
    want = (0.010 - 0.004) + 0.001 + 0.002 + 0.001 + 0.01
    assert attribution.batcher_self_ms(run) == pytest.approx(1e3 * want / 2)
    assert attribution.batcher_self_ms(run_of([])) is None


def test_device_trace_readings_unchanged_by_the_new_spans():
    """``busy``, ``gaps``, ``by_name`` and the result line's breakdown on
    one fixture, worked by hand: the new spans only take the idle gaps
    they cover, as the shortest covering span."""
    run = run_of(spans())
    sub = run.sub
    assert np.array(sub.busy()) / S == pytest.approx(np.array(
        [(0.11, 0.115), (0.125, 0.21), (1.01, 1.02), (1.06, 1.41),
         (2.6, 2.65), (5.0, 5.5)]))
    assert sub.busy_s() == pytest.approx(S * 1.0)
    assert sub.gaps()[0] == pytest.approx((S * 0.05, S * 0.11))
    assert sub.by_name()[DTOD] == pytest.approx(S * 0.02)
    bd = harness.breakdown(run)
    assert bd["device_ops"][0] == ["stray", pytest.approx(S * 0.5)]
    gaps = dict(bd["idle_gaps"])
    assert gaps["stage1.sync"] == pytest.approx(S * (0.9 - 0.21))
    assert gaps["collect.wait"] == pytest.approx(S * 0.5)
    assert gaps["collect.unpack"] == pytest.approx(S * 0.45)
    assert gaps["stage2.copy_in"] == pytest.approx(S * 0.04)
    assert "stage2.copy_out" not in gaps      # its copy covers it
    assert sum(gaps.values()) == pytest.approx(sub.window_s - S * 1.0)


def test_span_readers_on_a_traced_cpu_run():
    """The small served system, a closed loop of four clients, with a
    tracer attached: every span reader reads, and the batcher's spans and
    the engine's cover its thread."""
    mix = dict(small.SERVED, arrivals={"kind": "closed_loop", "clients": 4,
                                       "max_requests": 100000})
    system = harness.make_system(small.config("din128"), mix, 2**32 + 11,
                                 1.0, torch.device("cpu"))
    system.engine.set_tracer(Tracer(capacity=1 << 18))
    t = time.perf_counter()
    run = system.window()
    system.release()
    assert run.failed == 0 and time.perf_counter() - t < 60
    for name in ("engine.stage1_sync_ms", "compiled.copy_in_ms",
                 "batcher.self_ms", "batcher.queue_depth"):
        v = harness.load_file("metrics", name).read(run)
        assert v is not None and v >= 0, name
    assert 1 <= attribution.queue_depth(run) <= 4
    assert attribution.dropped(run) == 0
    # no profiler: the device-trace reader finds nothing to read
    assert attribution.attention_tail_ms(run) is None
