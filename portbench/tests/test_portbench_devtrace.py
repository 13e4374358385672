"""The device trace's arithmetic on made-up events: kernel names, busy
union, idle gaps and their attribution to host spans, and a roofline
reading from them."""
import numpy as np
import pytest

from portbench import devtrace, harness, readers


def test_kernel_names():
    k = devtrace.kernel_name
    assert k("void (anonymous namespace)::q_t_tc_kernel<2>(float const*, "
             "int)") == "q_t_tc_kernel"
    assert k("void at::native::vectorized_elementwise_kernel<4, "
             "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >"
             "(int, std::array<char*, 3ul>)") == \
        "at::native::vectorized_elementwise_kernel"
    assert k("std::enable_if<!(false), void>::type internal::gemvx::"
             "kernel<int, float>(cublasGemvParamsEx<int, float>)") == \
        "internal::gemvx::kernel"
    assert k("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD (Pinned -> Device)"
    assert k("sm90_xmma_gemm_f32f32_tn") == "sm90_xmma_gemm_f32f32_tn"


def sub(ops, t0=0.0, t1=10.0):
    s = devtrace.SubWindow()
    s.t0, s.t1, s.ops = t0, t1, ops
    return s


def test_busy_gaps_and_attribution():
    s = sub([("a", -1.0, 1.0), ("b", 0.5, 2.0), ("c", 4.0, 5.0),
             ("a", 9.0, 12.0)])
    assert s.busy() == [(0.0, 2.0), (4.0, 5.0), (9.0, 10.0)]
    assert s.busy_s() == pytest.approx(4.0)
    assert s.gaps() == [(2.0, 4.0), (5.0, 9.0)]
    assert s.by_name() == pytest.approx({"a": 2.0, "b": 1.5, "c": 1.0})
    spans = [("collect", 1.0, 8.0), ("pack", 2.5, 3.0)]
    got = devtrace.attribute_gaps(s.gaps(), spans, "none")
    assert got == pytest.approx({"pack": 0.5, "collect": 4.5, "none": 1.0})



def test_gaps_go_to_the_shortest_covering_span():
    gaps = [(6.0, 7.0), (0.0, 4.0), (8.0, 9.0)]
    spans = [("window", -1.0, 10.0), ("pack", 1.0, 2.0),
             ("collect", 1.5, 3.5), ("tie", 1.0, 2.0), ("late", 8.5, 12.0)]
    got = devtrace.attribute_gaps(gaps, spans, "none")
    assert got == pytest.approx({"pack": 1.0, "collect": 1.5,
                                 "window": 3.0, "late": 0.5})
    assert devtrace.attribute_gaps(gaps, [], "none") == pytest.approx(
        {"none": 6.0})


def gaps_by_loops(gaps, spans, default):
    """The attribution walked span by span, shortest first: each span
    takes what is still unclaimed of each gap it overlaps."""
    out = {}
    for g0, g1 in gaps:
        left = [(g0, g1)]
        for name, s, e in sorted(spans, key=lambda x: x[2] - x[1]):
            nxt = []
            for a, b in left:
                lo, hi = max(a, s), min(b, e)
                if hi > lo:
                    out[name] = out.get(name, 0.0) + (hi - lo)
                    if lo > a:
                        nxt.append((a, lo))
                    if b > hi:
                        nxt.append((hi, b))
                else:
                    nxt.append((a, b))
            left = nxt
        rest = sum(b - a for a, b in left)
        if rest > 0:
            out[default] = out.get(default, 0.0) + rest
    return out


@pytest.mark.parametrize("seed", range(4))
def test_gap_attribution_matches_the_loops(seed):
    rng = np.random.default_rng(seed)
    pts = np.sort(rng.uniform(0, 10, 2 * 12))
    gaps = [(pts[i], pts[i + 1]) for i in range(0, len(pts), 2)]
    spans = [(str(rng.choice(list("abcd"))), float(a),
              float(a + rng.choice([0.0, 1.0, rng.uniform(0, 3)])))
             for a in np.round(rng.uniform(-1, 11, 30), 1)]
    got = devtrace.attribute_gaps(gaps, spans, "none")
    want = gaps_by_loops(gaps, spans, "none")
    assert got == pytest.approx(want)

def test_roofline_and_mfu_readings():
    work = harness.load_file("work", "din")
    cfg = harness.load_config("din128")
    peaks = harness.load_json(harness.HERE / "peaks.json")
    ops = [("mari_wgmma_kernel", 1.0, 1.0 + 2e-5),
           ("q_t_tc_kernel", 2.0, 2.0 + 1e-4),
           ("w_keys_kernel", 3.0, 3.0 + 1e-5)]
    run = harness.Run(
        kind="served", seconds=10.0, t0=0.0, t1=10.0,
        start=np.zeros(1), done=np.ones(1), rows=np.array([4096]),
        spans=[("pack", 0.5, 0.6, {"rows": 4096, "users": 2}),
               ("stage1", 0.4, 0.45, {})],
        counters={}, cfg=cfg, path="two_stage", work=work, peaks=peaks,
        sub=sub(ops))
    w = work.kernel_work(cfg["build"], "two_stage", 4096, 2)
    lt = sum(max(f / 165e12, b / 3.35e12) for f, b in w["gather_einsum"])
    assert readers.roofline(run, "gather_einsum") == pytest.approx(
        100 * lt / 1.1e-4)
    assert readers.roofline(run, "din_attention") is None
    flops = (4096 * work.candidate_flops(cfg["build"])
             + work.user_flops(cfg["build"]))
    assert readers.step_mfu(run) == pytest.approx(
        100 * flops / (10.0 * 165e12))
    assert readers.idle_share(run) == pytest.approx(
        100 * (1 - 1.3e-4 / 10.0))
