"""What the metric files of ``portbench/metrics/`` share: the kernel
families a roofline reads, and the readings themselves, each taken from
a ``harness.Run``. A reading that finds nothing to read returns None,
and the harness leaves that metric out of the result line.

Least time of the work = max(bytes / peak bandwidth, flops / peak rate)
per operation, summed (``peaks.json``); a roofline share is that least
time over the device time of the family's kernels, in percent.
"""
from __future__ import annotations

import numpy as np

# the CUDA kernels of each family (``src/repro_torch/csrc/<family>.cu``),
# matched as substrings of the kernel names the device trace shows
FAMILIES = {
    "mari_matmul": ("mari_wgmma_kernel", "mari_bf16_kernel"),
    "gather_einsum": ("q_t_kernel", "q_t_mma_kernel", "q_t_tc_kernel",
                      "w_keys_kernel", "rows_vec_kernel", "ge_sort_",
                      "generic_flat_kernel", "generic_p_kernel",
                      "generic_wres_kernel", "generic_wstaged_kernel"),
    "din_attention": ("din_attention_kernel", "din_attention_bf16_kernel",
                      "din_wg_kernel", "din_wide_fold"),
}


def p95_ms(run) -> float | None:
    lat = run.latencies_ms()
    return float(np.percentile(lat, 95)) if len(lat) else None


def cands_per_s(run) -> float | None:
    rows = run.completed_rows()
    return rows / run.seconds if rows else None


def queue_wait_p50_ms(run) -> float | None:
    return run.counters.get("queue_wait_p50_ms")


def rows_per_pack(run) -> float | None:
    packs = run.packs(run.t0, run.t1)
    return (sum(r for r, _ in packs) / len(packs)) if packs else None


def phase_ms(run, phase: str) -> float | None:
    p = run.counters.get("profiler", {}).get(phase)
    if not p or not p["calls"]:
        return None
    return p["total_ms"] / p["calls"]


def roofline(run, family: str) -> float | None:
    sub = run.sub
    if sub is None:
        return None
    t = sub.time_of(FAMILIES[family])
    least = run.least_time(family, sub.t0, sub.t1)
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least / t


def idle_share(run) -> float | None:
    sub = run.sub
    if sub is None or sub.window_s <= 0:
        return None
    return 100.0 * (1.0 - sub.busy_s() / sub.window_s)


def step_mfu(run) -> float | None:
    """Model FLOPs of the work launched in the sub-window over the peak
    rate times the sub-window, in percent."""
    sub = run.sub
    if sub is None:
        return None
    flops = run.model_flops(sub.t0, sub.t1)
    if flops <= 0 or sub.window_s <= 0:
        return None
    return 100.0 * flops / (sub.window_s * run.peaks["flops_per_s"])
