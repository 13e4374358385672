#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each, in
   parallel) and holds every kernel against its plain PyTorch version at the
   serving path's full-width shapes plus a ragged shape, timing kernel,
   plain version and a library yardstick (cuBLAS ``addmm`` / a pre-gathered
   ``einsum`` / ``bmm`` plus a triangle gather, used nowhere in the port;
   ``din_attention`` has no single-call counterpart in PyTorch).
2. Paper ranking model at full ``PaperRankingConfig()`` width: serves three
   users (1000 / 3000 / 5000 candidates) per request and coalesced under the
   ``tpu`` preset and under ``tpu`` without ``kernel_gather``, against a
   ``use_pallas=False`` engine on the same params; and runs the single-call
   MaRI executor (Eq. 7, one user) against the vanilla executor.
3. DIN at ``configs/din.py`` width (10M-row item vocabulary, on the card)
   under ``tpu``, with the same checks.
4. A ``RankingService`` on the ``tpu`` preset hosting DLRM-MLPerf at full
   width with ``scale_tables=0.1`` (18.8M table rows, 9.6 GB on the card),
   and DeepFM and FM at the registry's full ``BUILD``: an interleaved stream
   at pools 1000 / 3000 / 5000 through ``score_many`` (the continuous
   batcher loop), each score against a ``use_pallas=False`` engine on the
   same params and against the engine's per-request ``score``. Then the
   launcher ``python -m repro_torch.launch.serve`` runs once (smoke builds,
   ``tpu`` preset).
5. Train + convert, DIN at ``configs/din.py`` width: trains on the card
   (VanI executor, autograd, Adam, batch 64, labels from a frozen
   teacher), checkpoints through ``CheckpointManager``, crashes once on
   purpose and resumes to the last step, converts with GCA + MaRI, and
   scores 2048 candidates single-call in VanI, UOI and MaRI (UOI and MaRI
   through the kernels: the whole DIN attention unit is ``din_attention``)
   against ``use_pallas=False`` executors, with per-task AUC; then times
   each paradigm and one training step. Last, the paper model at full
   width single-call in VanI / UOI / MaRI at B = 2048 (the reference's
   ``bench_table1``), timed and printed.

Kernel launch counts are zeroed just before each path (phases 2-3, phase
4, phase 5 and the paper's single call) and read just after it: every
kernel variant on a path must have launched on it. Prints the kernels JSON line, the card's
name and power limit, and last ``{"ok": true, "device": {...}}``. Exits
non-zero on any failure, when no CUDA device is present, or when run
without the repository beside it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

TOL = dict(rtol=2e-4, atol=2e-4)      # fp32 parity, as tests/test_kernels.py
PEAK_FP32_FLOPS = 67e12               # H100 SXM, fp32 outside tensor cores
PEAK_BYTES_S = 3.35e12                # H100 SXM HBM3
POOLS = (1000, 3000, 5000)            # straddle max_batch = 4096
SERVED = ("dlrm-mlperf", "deepfm", "fm")
DLRM_SCALE_TABLES = 0.1               # 96.1 GB of published tables -> 9.6 GB
TRAIN_STEPS, CKPT_EVERY, FAIL_AT = 24, 10, 15   # crash after the step-10 save
SINGLE_CALL_B = 2048                  # candidates of one single-call request
AUC_TOL = 1e-3


def log(tag: str, **kv) -> None:
    print(json.dumps({"phase": tag, **kv}, default=str), flush=True)


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found — run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch.core.mari import convert_params, mari_rewrite
    from repro_torch.graph.executor import Executor, init_graph_params
    from repro_torch.configs import get_config
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.common import timeit
    from repro_torch.core.mari import apply_mari
    from repro_torch.data.features import make_recsys_feeds
    from repro_torch.examples.train_then_convert import teacher_batches
    from repro_torch.kernels import build
    from repro_torch.kernels import din_attention as da
    from repro_torch.kernels import dot_interaction as di
    from repro_torch.launch.train import recsys_step
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.losses import auc
    from repro_torch.train.optim import adam
    from repro_torch.kernels import gather_einsum as ge
    from repro_torch.kernels import mari_matmul as mm
    from repro_torch.models.ranking import (PaperRankingConfig,
                                            build_paper_ranking_model)
    from repro_torch.models.recsys import build_din, build_dlrm
    from repro_torch.serve import (RankingService, ServePlan, ServeRequest,
                                   ServingEngine)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))

    # ---- build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    ptxas = {}
    for name, lib in libs.items():
        logf = lib.with_suffix(".log")
        lines = logf.read_text().splitlines() if logf.exists() else []
        ptxas[name] = [ln.strip() for ln in lines
                       if "registers" in ln or "spill" in ln][:8]
    log("build", seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)

    # ---- phase 1: kernels against their plain versions ---------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def randidx(n, hi, lo=0):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def max_err(a, b):
        torch.cuda.synchronize()
        err = (a - b).abs()
        bad = err > TOL["atol"] + TOL["rtol"] * b.abs()
        if bool(bad.any()) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"kernel disagrees with its plain version: "
                                 f"max |d| {float(err.max()):.3e}")
        return float(err.max())

    def time_ms(fn, iters=20):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def bound(nbytes, flops):
        t_b, t_o = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
        return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")

    entries = {}
    # paper expert fc0 at a full bucket: B=4096, K=64+500+500, N=512; U=8
    B, K, N, U = 4096, 1064, 512, 8
    x, w = randn(B, K), randn(K, N)
    u_of = {"broadcast": randn(1, N), "rowwise": randn(B, N),
            "gather": randn(U, N)}
    idx = randidx(B, U)
    replaces = {"broadcast": "src/repro/kernels/mari_matmul/kernel.py:77",
                "rowwise": "src/repro/kernels/mari_matmul/kernel.py:77",
                "gather": "src/repro/kernels/mari_matmul/kernel.py:119"}
    for mode in mm.ops.INIT_MODES:
        u = u_of[mode]
        ui = idx if mode == "gather" else None
        errs = []
        for act in ("relu", "identity"):
            errs.append(max_err(mm.mari_matmul(x, w, u, ui, act),
                                mm.mari_matmul_plain(x, w, u, ui, act)))
        # ragged edges, every other epilogue, out-of-range indices
        Br, Kr, Nr, Ur = 1000, 333, 65, 5
        xr, wr = randn(Br, Kr), randn(Kr, Nr)
        ur = {"broadcast": randn(1, Nr), "rowwise": randn(Br, Nr),
              "gather": randn(Ur, Nr)}[mode]
        ir = randidx(Br, Ur + 3, lo=-2) if mode == "gather" else None
        for act in ("gelu", "silu", "sigmoid", "tanh"):
            errs.append(max_err(mm.mari_matmul(xr, wr, ur, ir, act),
                                mm.mari_matmul_plain(xr, wr, ur, ir, act)))
        u_init = u.index_select(0, idx) if mode == "gather" else u
        nbytes = 4 * (B * K + K * N + u.numel() + B * N) + (
            4 * B if mode == "gather" else 0)
        b_ms, b_by = bound(nbytes, 2 * B * K * N)
        entries[f"mari_matmul/{mode}"] = dict(
            route="cuda", source="src/repro_torch/csrc/mari_matmul.cu",
            replaces=replaces[mode], max_abs_err=max(errs),
            ms=time_ms(lambda: mm.mari_matmul(x, w, u, ui, "relu")),
            plain_ms=time_ms(lambda: mm.mari_matmul_plain(x, w, u, ui,
                                                          "relu")),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: torch.addmm(u_init, x, w)),
            shape=dict(B=B, K=K, N=N, u_rows=u.shape[0], act="relu"),
            library="torch.addmm (init pre-gathered, no activation)")

    # DIN decomposed attention at a full bucket: D=18, L=100, H=80, U=8
    L, D, H = 100, 18, 80
    cases = {
        "bd,uldh->blh": ((B, D), (U, L, D, H), (1000, D), (5, L, D, H),
                         2 * B * L * H * D, B * D + U * L * D * H + B * L * H),
        "bl,uld->bd": ((B, L), (U, L, D), (1000, L), (5, L, D),
                       2 * B * L * D, B * L + U * L * D + B * D),
        "blh,uh->bl": ((B, L, H), (U, H), (1000, L, H), (5, H),
                       2 * B * L * H, B * L * H + U * H + B * L),
    }
    for spec, (xs, ts, xrs, trs, flops, nfloats) in cases.items():
        xg, tg = randn(*xs), randn(*ts)
        errs = [max_err(ge.gather_einsum(spec, xg, tg, idx),
                        ge.gather_einsum_plain(spec, xg, tg, idx))]
        xr, tr = randn(*xrs), randn(*trs)
        ir = randidx(xrs[0], trs[0] + 3, lo=-2)
        errs.append(max_err(ge.gather_einsum(spec, xr, tr, ir),
                            ge.gather_einsum_plain(spec, xr, tr, ir)))
        rows = tg.index_select(0, idx)
        row_spec = ge.parse_spec(spec)[3]
        b_ms, b_by = bound(4 * nfloats + 4 * B, flops)
        entries[f"gather_einsum/{spec}"] = dict(
            route="cuda", source="src/repro_torch/csrc/gather_einsum.cu",
            replaces="src/repro/kernels/gather_einsum/kernel.py:79",
            max_abs_err=max(errs),
            ms=time_ms(lambda: ge.gather_einsum(spec, xg, tg, idx)),
            plain_ms=time_ms(lambda: ge.gather_einsum_plain(spec, xg, tg,
                                                            idx)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: torch.einsum(row_spec, xg, rows)),
            shape=dict(x=list(xs), table=list(ts)),
            library="torch.einsum on pre-gathered rows")
    del x, w, u_of, rows

    # DLRM interaction at a full bucket: B=4096, F=27, D=128 -> P=351
    F, D = 27, 128
    for keep_self in (False, True):
        P = di.n_pairs(F, keep_self)
        xd = randn(B, F, D)
        errs = [max_err(di.dot_interaction(xd, keep_self),
                        di.dot_interaction_plain(xd, keep_self))]
        for Br, Fr, Dr in ((1000, 5, 128), (1, 27, 16), (130, 7, 33),
                           (33, 40, 64)):
            xr = randn(Br, Fr, Dr)
            errs.append(max_err(di.dot_interaction(xr, keep_self),
                                di.dot_interaction_plain(xr, keep_self)))
        iu, ju = torch.triu_indices(F, F, offset=0 if keep_self else 1,
                                    device=dev)
        b_ms, b_by = bound(4 * (B * F * D + B * P), 2 * B * P * D)
        entries[f"dot_interaction/{di.VARIANTS[keep_self]}"] = dict(
            route="cuda", source="src/repro_torch/csrc/dot_interaction.cu",
            replaces="src/repro/kernels/dot_interaction/kernel.py:41",
            max_abs_err=max(errs),
            ms=time_ms(lambda: di.dot_interaction(xd, keep_self)),
            plain_ms=time_ms(lambda: di.dot_interaction_plain(xd,
                                                              keep_self)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(
                lambda: torch.bmm(xd, xd.transpose(1, 2))[:, iu, ju]),
            shape=dict(B=B, F=F, D=D, P=P, keep_self=keep_self),
            library="torch.bmm (cuBLAS) then a triangle index gather: two "
                    "PyTorch calls")
    del xd

    # DIN attention unit over one shared key block at DIN width: the
    # single-call path's B = 2048 candidates and a full bucket of 4096,
    # L=100, D=18, MLP 72-80-40-1; plus the reference's test shapes
    # (tests/test_kernels.py::TestDinAttention), masks with zeros
    def din_args(Bq, Lq, Dq, h1, h2):
        mask = torch.rand(Lq, generator=gen, device=dev) < 0.8
        mask[0] = True
        return (randn(Bq, Dq), randn(Lq, Dq), mask,
                randn(4 * Dq, h1) * 0.2, randn(h1) * 0.1,
                randn(h1, h2) * 0.2, randn(h2) * 0.1,
                randn(h2, 1) * 0.2, randn(1) * 0.1)

    def din_bound(Bq, Lq, Dq, h1, h2):
        """The least work of the unit: [k, q, k-q, k*q] W1 = k (W1a + W1c)
        + q (W1b - W1c) + (k*q) W1d, so only (k*q) W1d is per (b, l) pair;
        the key part is per l, the query part (with b1) per b."""
        pair = (Dq + 2 * Dq * h1 + 2 * h1        # k*q, (k*q) W1d, + parts
                + 2 * h1 * h2 + h2 + 2 * h2 + 1  # layer 2 + b2, layer 3 + b3
                + 3 + 2 * Dq)                    # softmax, pooled sum
        flops = (Bq * Lq * pair + 2 * Dq * h1         # fold W1's blocks
                 + 2 * Lq * Dq * h1 + Bq * (2 * Dq * h1 + h1))
        nbytes = 4 * (2 * Bq * Dq + Lq * Dq + 4 * Dq * h1 + h1 + h1 * h2
                      + 2 * h2 + 1) + Lq          # the mask is bool
        return bound(nbytes, flops), flops

    Lq, Dq, H1, H2 = 100, 18, 80, 40
    timed = {}
    errs = []
    for Bq in (SINGLE_CALL_B, B):
        dargs = din_args(Bq, Lq, Dq, H1, H2)
        errs.append(max_err(da.din_attention(*dargs),
                            da.din_attention_plain(*dargs)))
        (b_ms, b_by), flops = din_bound(Bq, Lq, Dq, H1, H2)
        timed[Bq] = dict(
            ms=time_ms(lambda: da.din_attention(*dargs)),
            plain_ms=time_ms(lambda: da.din_attention_plain(*dargs)),
            bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9)
        del dargs
    for shp in ((4, 5, 8), (33, 20, 18), (128, 100, 18)):
        a = din_args(*shp, 16, 8)
        errs.append(max_err(da.din_attention(*a), da.din_attention_plain(*a)))
    entries["din_attention/shared_keys"] = dict(
        route="cuda", source="src/repro_torch/csrc/din_attention.cu",
        replaces="src/repro/kernels/din_attention/kernel.py:47",
        max_abs_err=max(errs),
        **{k: v for k, v in timed[SINGLE_CALL_B].items() if k != "gflop"},
        library_ms=None,
        shape=dict(B=SINGLE_CALL_B, L=Lq, D=Dq, h1=H1, h2=H2,
                   gflop=timed[SINGLE_CALL_B]["gflop"],
                   also=[[B, Lq, Dq], [4, 5, 8], [33, 20, 18],
                         [128, 100, 18]]),
        at_full_bucket=dict(B=B, **timed[B]),
        library="none: no single PyTorch call computes the unit")
    # "blh,uh->bl" is a spec the kernel supports but the executor's
    # decomposed attention never reaches, and no served model keeps the
    # gram's diagonal: checked and timed above, reported on their own line
    # rather than among the main path's kernels
    off_path = {k: entries.pop(k) for k in ("gather_einsum/blh,uh->bl",
                                            "dot_interaction/triu_keep_self")}
    log("kernels_vs_plain", tol=TOL,
        max_abs_err={k: v["max_abs_err"] for k, v in entries.items()},
        ms={k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                  "library_ms")}
            for k, v in entries.items()},
        off_path=off_path)

    # ---- phases 2 and 3: the serving path ----------------------------------
    def requests(graph, pools, seed):
        rng = np.random.default_rng(seed)
        vocab = {n.inputs[0]: n.attrs["vocab"]
                 for n in graph.nodes.values() if n.op == "embedding"}
        out = []
        for uid, n in enumerate(pools):
            uf, cf = {}, {}
            for node in graph.input_nodes():
                user = node.attrs["domain"] == "user"
                shape = (1 if user else n,) + tuple(node.attrs["shape"])
                if node.attrs.get("dtype", "float32").startswith("int"):
                    a = rng.integers(0, vocab[node.name], shape,
                                     dtype=np.int32)
                else:
                    a = rng.standard_normal(shape, dtype=np.float32)
                (uf if user else cf)[node.name] = a
            out.append(ServeRequest(user_id=uid, user_feeds=uf,
                                    candidate_feeds=cf))
        return out

    def close(a, b):
        return bool(np.all(np.abs(a - b) <= TOL["atol"] + TOL["rtol"]
                           * np.abs(b)))

    def device_window(eng, reqs):
        """torch.profiler over one warm coalesced call: device busy time
        (kernel self time) against the call's wall time under the profiler."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            eng.score_coalesced(reqs)
            wall_ms = (time.perf_counter() - t) * 1e3
        kern = [e for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")
                and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                    device_idle_share=(1 - busy_ms / wall_ms
                                       if busy_ms else None),
                    top_kernels=[[e.key[:70], e.self_device_time_total / 1e3,
                                  e.count] for e in top])

    def serve_checks(tag, graph, params, plans, oracle_plan, reqs, n_out):
        oracle = ServingEngine(graph, params, oracle_plan, device=dev)
        ref = [oracle.score(r).scores for r in reqs]
        for name, plan in plans.items():
            eng = ServingEngine(graph, params, plan, device=dev)
            per = [eng.score(r) for r in reqs]           # cold: stage 1 runs
            t = time.perf_counter()
            co = eng.score_coalesced(reqs)               # users now cached
            co_ms = (time.perf_counter() - t) * 1e3
            warm = [eng.score(r) for r in reqs]
            d_ref = d_co = 0.0
            for r, p, c, o in zip(reqs, per, co, ref):
                n = next(iter(r.candidate_feeds.values())).shape[0]
                for s in (p.scores, c.scores):
                    if s.shape != (n, n_out) or not np.isfinite(s).all():
                        raise AssertionError(
                            f"{tag}/{name}: bad scores {s.shape}")
                if not (close(p.scores, o) and close(c.scores, p.scores)):
                    raise AssertionError(
                        f"{tag}/{name}: scores outside {TOL}: kernel-vs-"
                        f"plain {np.abs(p.scores - o).max():.3e}, per-vs-"
                        f"coalesced {np.abs(c.scores - p.scores).max():.3e}")
                d_ref = max(d_ref, float(np.abs(p.scores - o).max()))
                d_co = max(d_co, float(np.abs(c.scores - p.scores).max()))
            prof = eng.profiler.snapshot(reset=True)
            try:
                window = device_window(eng, reqs)
            except Exception as e:       # a profiler failure is no smoke fail
                window = f"not measured: {type(e).__name__}: {e}"
            log(tag, plan=name, pools=[r.scores.shape[0] for r in per],
                max_abs_kernel_vs_plain=d_ref,
                max_abs_per_vs_coalesced=d_co,
                cold_latency_ms=[r.latency_ms for r in per],
                cold_stage1_ms=[r.stage1_ms for r in per],
                warm_latency_ms=[r.latency_ms for r in warm],
                coalesced_ms=co_ms, stage2_calls=eng.stage2_calls,
                coalesced_calls=eng.coalesced_calls,
                profile={k: v for k, v in prof.items() if v["calls"]},
                device_window=window)
            del eng
        del oracle

    def reset_launches():
        for mod in (mm, ge, di, da):
            mod.reset_launches()

    def read_launches():
        out = {f"mari_matmul/{m}": n for m, n in mm.LAUNCHES.items()}
        out.update({f"gather_einsum/{s}": n for s, n in ge.LAUNCHES.items()})
        out.update({f"dot_interaction/{v}": n
                    for v, n in di.LAUNCHES.items()})
        out.update({f"din_attention/{v}": n for v, n in da.LAUNCHES.items()})
        return out

    def serve_phase() -> dict:
        """Phase 4; returns the kernel launch counts of the service path."""
        graph, _ = build_dlrm(scale_tables=DLRM_SCALE_TABLES)
        params = init_graph_params(graph, seed=0, device=dev)
        torch.cuda.synchronize()
        log("dlrm_params", scale_tables=DLRM_SCALE_TABLES, gbytes=sum(
            p["table"].numel() * 4 for p in params.values() if "table" in p)
            / 1e9, note="embedding tables, drawn on the card")
        svc = RankingService(tpu, smoke=False, seed=0, device=dev)
        svc.register("dlrm-mlperf", graph=graph, params=params)
        svc.register("deepfm")
        svc.register("fm")
        # the oracles: use_pallas=False engines on the same params (the
        # registry draws deepfm / fm from seed 0 on the card, as here)
        oracle = {"dlrm-mlperf": ServingEngine(graph, params, plain,
                                               device=dev)}
        for sc in ("deepfm", "fm"):
            g = get_config(sc).BUILD()[0]
            oracle[sc] = ServingEngine(g, init_graph_params(g, seed=0,
                                                            device=dev),
                                       plain, device=dev)
        items = []
        for seed, sc in enumerate(SERVED):
            for req in requests(svc.source_graph(sc), POOLS, seed=10 + seed):
                items.append((sc, req))
        items = [items[i] for k in range(len(POOLS))
                 for i in range(k, len(items), len(POOLS))]   # interleave
        # three passes of the stream: the first in fresh batcher threads
        # (per-thread CUDA library set-up lands in it), then new user ids
        # (stage 1 runs again), then the same ids (users cached)
        again = [(sc, dataclasses.replace(req, user_id=req.user_id + 100))
                 for sc, req in items]
        passes = (("first", items), ("cold_users", again),
                  ("warm_users", again))
        reset_launches()
        out = {}
        for name, stream in passes:
            t = time.perf_counter()
            out[name] = svc.score_many(stream)
            stream_ms = (time.perf_counter() - t) * 1e3
            log("service_pass", name=name, stream_ms=stream_ms,
                requests=len(stream), latency_ms={
                    sc: [r.latency_ms for (s, _), r in zip(stream,
                                                           out[name])
                         if s == sc] for sc in SERVED},
                profile={sc: {k: v for k, v in svc.engine(sc).profiler
                              .snapshot(reset=True).items() if v["calls"]}
                         for sc in SERVED})
        results = out["first"]
        for name in ("cold_users", "warm_users"):
            for (sc, _), r, r0 in zip(items, out[name], results):
                if not close(r.scores, r0.scores):
                    raise AssertionError(f"service/{sc}: pass {name} "
                                         f"differs from the first pass")
        # per-request scores on the same engines (users now cached), one
        # request at a time from this thread: no batcher thread competes
        per = [svc.engine(sc).score(req) for sc, req in items]
        torch.cuda.synchronize()
        counts = read_launches()
        log("service_per_request", latency_ms={
            sc: [r.latency_ms for (s, _), r in zip(items, per) if s == sc]
            for sc in SERVED},
            profile={sc: {k: v for k, v in svc.engine(sc).profiler
                          .snapshot(reset=True).items() if v["calls"]}
                     for sc in SERVED})

        d_ref, d_per = {}, {}
        for (sc, req), res, p in zip(items, results, per):
            n = next(iter(req.candidate_feeds.values())).shape[0]
            want = oracle[sc].score(req).scores
            for s in (res.scores, p.scores):
                if s.shape != (n, 1) or not np.isfinite(s).all():
                    raise AssertionError(
                        f"service/{sc}: bad scores {s.shape}")
            if not (close(res.scores, want) and close(p.scores, res.scores)):
                raise AssertionError(
                    f"service/{sc}: scores outside {TOL}: kernel-vs-plain "
                    f"{np.abs(res.scores - want).max():.3e}, per-request-vs-"
                    f"batcher {np.abs(p.scores - res.scores).max():.3e}")
            d_ref[sc] = max(d_ref.get(sc, 0.0),
                            float(np.abs(res.scores - want).max()))
            d_per[sc] = max(d_per.get(sc, 0.0),
                            float(np.abs(p.scores - res.scores).max()))
        stats = svc.stats()
        try:
            dlrm_reqs = [r for sc, r in items if sc == "dlrm-mlperf"]
            window = device_window(svc.engine("dlrm-mlperf"), dlrm_reqs)
        except Exception as e:          # a profiler failure is no smoke fail
            window = f"not measured: {type(e).__name__}: {e}"
        for sc in SERVED:
            s = stats["scenarios"][sc]
            log("service", scenario=sc, pools=list(POOLS),
                max_abs_kernel_vs_plain=d_ref[sc],
                max_abs_per_request_vs_batcher=d_per[sc],
                requests=s["requests"],
                batches=s["batches"],
                coalesced_requests=s["coalesced_requests"],
                stage1_calls=s["stage1_calls"],
                stage2_calls=s["stage2_calls"],
                coalesced_calls=s["coalesced_calls"],
                request_ms=s["latency"]["request_ms"],
                queue_wait_ms=s["latency"]["queue_wait_ms"],
                rewrites=[r.dense for r in
                          svc.engine(sc).conversion.rewrites])
        cache = stats["shared_cache"]
        log("service_cache", shared_cache={k: v for k, v in cache.items()
                          if k != "boundary_bytes"},
            dlrm_device_window=window)
        svc.close()
        del svc, oracle, params
        torch.cuda.empty_cache()

        # the launcher, as a user runs it (smoke builds, on the card)
        cmd = [sys.executable, "-m", "repro_torch.launch.serve",
               "--scenario", ",".join(SERVED), "--preset", "tpu",
               "--requests", "6", "--candidates", "1024"]
        env = dict(os.environ, PYTHONPATH=SRC)
        t = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        log("launcher", cmd=" ".join(cmd[1:]), rc=out.returncode,
            seconds=time.perf_counter() - t,
            stdout=out.stdout.strip().splitlines()[-6:],
            stderr=out.stderr.strip().splitlines()[-6:])
        if out.returncode != 0:
            raise AssertionError(f"launcher exited {out.returncode}")
        return counts

    def single_call(graph, runs, feeds):
        """Score one request single-call through each (name, graph,
        params, mode, use_pallas) run; returns name -> (B, tasks) scores."""
        out = {}
        with torch.inference_mode():
            for name, g, p, mode, pallas in runs:
                o = Executor(g, mode, use_pallas=pallas, device=dev).run(
                    p, feeds)
                out[name] = torch.cat([o[k] for k in graph.outputs], -1)
        torch.cuda.synchronize()
        return out

    def time_calls(runs, feeds):
        """timeit (3 warm-up, 20 timed calls, synchronised) per run."""
        t = {}
        with torch.inference_mode():
            for name, g, p, mode, pallas in runs:
                ex = Executor(g, mode, use_pallas=pallas, device=dev)
                r = timeit(lambda: ex.run(p, feeds), warmup=3, iters=20)
                t[name] = dict(p50_ms=r["p50_us"] / 1e3,
                               mean_ms=r["mean_us"] / 1e3,
                               p99_ms=r["p99_us"] / 1e3)
        return t

    def train_convert_phase() -> dict:
        """Phase 5; returns the kernel launch counts of its path."""
        graph, _ = get_config("din").BUILD()
        outputs = list(graph.outputs)
        params = init_graph_params(graph, seed=0, device=dev)
        teacher = init_graph_params(graph, seed=99, device=dev)
        ex = Executor(graph, "vani", device=dev)
        opt = adam(2e-3)
        step = recsys_step(ex, outputs, opt)
        state0 = {"params": params, "opt": opt.init(params)}
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                                    dir=os.path.join(ROOT, "build"))
        try:
            mgr = CheckpointManager(ckpt_dir, max_to_keep=1)
            cfg = LoopConfig(total_steps=TRAIN_STEPS, ckpt_every=CKPT_EVERY,
                             log_every=1)
            lines = []
            t = time.perf_counter()
            try:
                train_loop(step, state0,
                           teacher_batches(graph, teacher, ex, dev, seed=1),
                           mgr, cfg, fail_at=FAIL_AT, log=lines.append)
                raise AssertionError("the injected failure did not fire")
            except RuntimeError as e:
                if "injected failure" not in str(e):
                    raise
            # the step-10 save was in flight when the crash hit; the writer
            # thread finishes it, as it would in a process that outlived
            # the failed step
            mgr.wait()
            crashed_at_latest = mgr.latest_step()
            if crashed_at_latest != CKPT_EVERY:
                raise AssertionError(f"after the crash the newest checkpoint "
                                     f"is {crashed_at_latest}")
            first_losses = [float(ln.split("loss=")[1]) for ln in lines
                            if "loss=" in ln]
            lines = []
            state, hist = train_loop(
                step, state0, teacher_batches(graph, teacher, ex, dev,
                                              seed=2),
                mgr, cfg, log=lines.append)
            train_s = time.perf_counter() - t
            losses = first_losses + [h["loss"] for h in hist]
            resumed_to = mgr.latest_step()
            if resumed_to != TRAIN_STEPS - 1 or not lines[0].startswith(
                    f"[loop] resumed from step {CKPT_EVERY}"):
                raise AssertionError(f"resume did not reach the last step: "
                                     f"{resumed_to}, {lines[:1]}")
            if not np.all(np.isfinite(losses)):
                raise AssertionError(f"non-finite loss: {losses}")
            ckpt_gb = sum(os.path.getsize(os.path.join(dp, f))
                          for dp, _, fs in os.walk(ckpt_dir)
                          for f in fs) / 1e9
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        del state0
        params = state["params"]
        batch = next(teacher_batches(graph, teacher, ex, dev, seed=3))
        t_step = timeit(lambda: step(state, batch), warmup=2, iters=10)
        del state
        log("train", arch="din", steps=TRAIN_STEPS, batch=64,
            crash_at=FAIL_AT, latest_after_crash=crashed_at_latest,
            resumed=lines[0], latest_after_resume=resumed_to,
            loss_first=losses[0], loss_last=losses[-1], losses=losses,
            wall_s=train_s, checkpoint_gbytes=ckpt_gb,
            train_step_ms=dict(p50=t_step["p50_us"] / 1e3,
                               mean=t_step["mean_us"] / 1e3))

        # convert, then score one user's 2048 candidates single-call
        mg, mp, conv = apply_mari(graph, params)
        feeds = make_recsys_feeds(graph, SINGLE_CALL_B,
                                  np.random.default_rng(4))
        feeds = {k: torch.as_tensor(v, device=dev) for k, v in feeds.items()}
        runs = [("vani", graph, params, "vani", False),
                ("uoi_plain", graph, params, "uoi", False),
                ("uoi", graph, params, "uoi", True),
                ("mari_plain", mg, mp, "uoi", False),
                ("mari", mg, mp, "uoi", True)]
        scores = single_call(graph, runs, feeds)
        with torch.inference_mode():
            tl = Executor(graph, "uoi", device=dev).run(teacher, feeds)
            tl = torch.cat([tl[o] for o in outputs], -1)
            labels = (tl > tl.median(dim=0).values).float().cpu().numpy()
        d = {f"{k}_vs_{k}_plain": float((scores[k] - scores[f"{k}_plain"])
                                        .abs().max()) for k in ("uoi", "mari")}
        d["mari_vs_vani"] = float((scores["mari"] - scores["vani"])
                                  .abs().max())
        for name, ref in (("uoi", "uoi_plain"), ("mari", "mari_plain"),
                          ("mari", "vani")):
            a, b = scores[name].cpu().numpy(), scores[ref].cpu().numpy()
            if a.shape != (SINGLE_CALL_B, len(outputs)) or not (
                    np.isfinite(a).all() and close(a, b)):
                raise AssertionError(f"single-call {name} vs {ref}: "
                                     f"{np.abs(a - b).max():.3e}")
        van, mar = scores["vani"].cpu().numpy(), scores["mari"].cpu().numpy()
        aucs = [(auc(van[:, t], labels[:, t]), auc(mar[:, t], labels[:, t]))
                for t in range(len(outputs))]
        if not all(abs(a - b) <= AUC_TOL for a, b in aucs):
            raise AssertionError(f"AUC moved with the conversion: {aucs}")
        times = time_calls(runs, feeds)
        log("single_call", model="din", candidates=SINGLE_CALL_B,
            rewrites=[r.dense for r in conv.rewrites],
            attn_rewrites=len(conv.attn_rewrites), max_abs=d,
            auc_vani_mari=aucs, auc_delta=[abs(a - b) for a, b in aucs],
            times=times)
        torch.cuda.synchronize()
        return read_launches()

    def table1_phase() -> dict:
        """The paper model at full width single-call in VanI / UOI / MaRI
        (the reference's bench_table1), timed and printed, not gated."""
        graph, _ = build_paper_ranking_model(PaperRankingConfig())
        params = init_graph_params(graph, seed=0, device=dev)
        mg, mp, conv = apply_mari(graph, params)
        feeds = make_recsys_feeds(graph, SINGLE_CALL_B,
                                  np.random.default_rng(5))
        feeds = {k: torch.as_tensor(v, device=dev) for k, v in feeds.items()}
        runs = [("vani", graph, params, "vani", False),
                ("uoi", graph, params, "uoi", True),
                ("mari_plain", mg, mp, "uoi", False),
                ("mari", mg, mp, "uoi", True)]
        scores = single_call(graph, runs, feeds)
        times = time_calls(runs, feeds)
        log("table1", model="paper", candidates=SINGLE_CALL_B,
            rewrites=[r.dense for r in conv.rewrites],
            max_abs_vs_vani={k: float((v - scores["vani"]).abs().max())
                             for k, v in scores.items() if k != "vani"},
            times=times, speedup_mari_vs_uoi=dict(
                p50=times["uoi"]["p50_ms"] / times["mari"]["p50_ms"],
                mean=times["uoi"]["mean_ms"] / times["mari"]["mean_ms"]),
            note="printed, not gated")
        torch.cuda.synchronize()
        return read_launches()

    tpu = ServePlan.preset("tpu")
    plain = tpu.evolve(kernel__use_pallas=False, kernel__kernel_gather=False)
    reset_launches()

    cfg = PaperRankingConfig()
    graph, _ = build_paper_ranking_model(cfg)
    params = init_graph_params(graph, seed=0, device=dev)
    serve_checks("paper", graph, params,
                 {"tpu": tpu, "tpu_no_kernel_gather":
                  tpu.evolve(kernel__kernel_gather=False)},
                 plain, requests(graph, POOLS, seed=1), n_out=cfg.n_tasks)
    # the single-call MaRI executor (Eq. 7 for one user: broadcast init)
    # against the vanilla graph it was rewritten from
    conv = mari_rewrite(graph)
    one = requests(graph, (B,), seed=2)[0]
    feeds = {**one.user_feeds, **one.candidate_feeds}
    got = Executor(conv.graph, "uoi", use_pallas=True, device=dev).run(
        convert_params(conv, params), feeds)
    want = Executor(graph, "vani", device=dev).run(params, feeds)
    d_eq7 = max(float((got[o] - want[o]).abs().max()) for o in graph.outputs)
    if not all(close(got[o].cpu().numpy(), want[o].cpu().numpy())
               for o in graph.outputs):
        raise AssertionError(f"MaRI executor vs vanilla: {d_eq7:.3e}")
    log("paper_eq7", rows=B, max_abs_mari_vs_vanilla=d_eq7)
    del params, got, want

    graph, _ = build_din(embed_dim=18, seq_len=100, attn_mlp=(80, 40),
                         mlp=(200, 80), item_vocab=10_000_000)
    params = init_graph_params(graph, seed=0, device=dev)
    log("din_params", gbytes=sum(
        p["table"].numel() * 4 for p in params.values() if "table" in p)
        / 1e9, note="embedding tables, drawn on the card")
    serve_checks("din", graph, params, {"tpu": tpu}, plain,
                 requests(graph, POOLS, seed=3), n_out=1)
    del params
    torch.cuda.synchronize()
    by_path = {"paper+din": read_launches()}

    # ---- phase 4: RankingService + continuous batcher, DLRM/DeepFM/FM -----
    by_path["service"] = serve_phase()

    # ---- phase 5: train, convert, score single-call ------------------------
    reset_launches()
    by_path["train+convert"] = train_convert_phase()
    reset_launches()
    by_path["table1"] = table1_phase()
    log("launches_by_path", **by_path)
    # each path is held to its own counts: paper + DIN to every kernel of
    # PR 11's path, the service to the DLRM interaction and the gathered
    # MaRI init, train+convert to the shared-key DIN unit and the broadcast
    # MaRI init of DIN's mlp_0; the table-1 timing is only printed
    own = {"paper+din": [k for k in entries
                         if k.startswith(("mari_matmul/", "gather_einsum/"))],
           "service": ["dot_interaction/triu", "mari_matmul/gather"],
           "train+convert": ["din_attention/shared_keys",
                             "mari_matmul/broadcast"]}
    missing = [f"{p}:{k}" for p, ks in own.items() for k in ks
               if by_path[p][k] == 0]
    launches = {k: sum(p[k] for p in by_path.values())
                for k in by_path["service"]}
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    kernels = [{"name": name, "launches": launches[name],
                "launches_by_path": {p: c[name] for p, c in by_path.items()},
                **e} for name, e in entries.items()]
    print(json.dumps({"kernels": kernels}), flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: rc={smi.returncode} {smi.stderr.strip()}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
