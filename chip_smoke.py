#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each, in
   parallel; the ``build`` line has the seconds and the ``-Xptxas -v``
   report) and holds every kernel against its plain PyTorch version at the
   serving path's full-width shapes plus a ragged shape, timing kernel,
   plain version and a library yardstick (cuBLAS ``addmm`` / a pre-gathered
   ``einsum`` / ``bmm`` plus a triangle gather /
   ``torch.nn.functional.embedding_bag``, used nowhere in the port;
   ``din_attention`` has no single-call counterpart in PyTorch).
   ``dot_interaction`` is also timed at the service's buckets 256 .. 2048
   (``by_batch``) and checked on both copy instances (TMA, 4-byte
   ``cp.async``); the CSR entry of ``embedding_bag`` with sorted and
   shuffled segment ids, its counting sort alone (``prep_ms``) and the
   sort-based preparation it replaced (``old_prep_ms``), whose output it
   must equal bit for bit.
   ``mari_matmul`` (3xTF32 on the tensor cores) is also checked and timed
   beside ``addmm`` at every ``mari_dense`` shape of the served models, in
   each init mode, at B = 4096 and 2048 (``mari_matmul_shapes``); its
   per-call host costs are the ``mari_matmul_host`` line, its bf16 entry
   is held at 2e-2.
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
   width single-call in VanI / UOI / MaRI at B = 2048, compiled as the
   reference's ``bench_table1`` and eager, timed and printed.
6. Multi-hot DLRM (``build_dlrm``'s topology at its published widths, the
   26 tables at ``scale_tables=0.1``, sparse fields multi-hot with MLPerf
   DLRM-DCNv2's hotness, pooled with ``pool="sum"``: 8 bags per
   candidate, 7 per user) through a ``RankingService`` on ``tpu`` with the
   device-resident rep tier (8 slots, retries, the circuit breaker): (a)
   four passes of an interleaved 9-request stream — new users, the same
   users, a bumped feature version, twelve new users (steals and overflow)
   — each score against a plain re-stacking engine and its own
   per-request score, the store's counters and the ``pack`` / ``dispatch``
   means beside the same stream without the tier; (b) injected faults (a
   failed slot write, a corrupted collect) recovered by quarantine and
   retries; (c) hedging on the ``paper`` preset with kernels; (d, inside
   phases 2 and 3) device-resident twins of the paper and DIN engines.
7. The memory tier (``memtier``), the reference's ``benchmarks/memtier.py``
   run through the port at the paper model's full width: a ``tpu`` engine
   with the device tier (256 slots, a 4096-user hot LRU) and the host-RAM
   cold arena (8 GiB, halved when the host has less than 16 GiB
   available); per Zipf(1.1) universe of 10k, 100k and 1M users the head
   warmed up to 0.92 of the mass (capped by the arena), then 3000
   requests of 128 candidates: hit rate, per-class (hot / cold /
   recompute) host-wall p50 / p99, warm rate, demotions, promotions and
   promotion errors (must be 0), arena bytes, graphs (a repeated traced
   pass captures nothing); 16 requests per class rescored on a cache-off
   engine (bitwise equality printed, held to 2e-4) and 4 on a
   ``use_pallas=False`` one. ``memtier_copies`` times the tier's copies
   per user on the real path: 256 demotions through a 64-user hot LRU,
   then 256 cold hits. Then DIN at ``configs/din.py`` width over the 10k
   universe: the paper model's attention (``cross_attention``) is not
   re-parameterized, so only DIN's decomposed attention runs
   ``gather_einsum`` on this path.

Every stage runs compiled, as the reference's ``jax.jit``: the engines'
stage 1 and stage 2 (one graph per (rows, bucket) shape and table route)
and the single calls (``CompiledRun`` over ``Executor(g, mode).run``) are
replays of captured CUDA graphs. Per path the run prints max |Δ| of the
compiled scores against the same engine's stage bodies run eagerly on the
card and against ``use_pallas=False``; the graphs built (stage-2 graphs
held equal to the distinct (rows, bucket, route) signatures served, and a
repeated warm pass held to capture nothing) and the memory their captures
reserved; ``dispatch`` ms per pack compiled and eager; and one pass traced
into ``build/chip_smoke_traces/<path>.json`` (written, reloaded, its B/E
pairs and events checked). The single calls print compiled and eager
p50 / device / host side by side and the MaRI / UOI ratio beside the
paper's 1.32x.

Kernel launch counts are zeroed just before each run of a path and read
just after it (a replay counts the launches its graph holds), the
readings summed per path: the paper and DIN ``tpu``
engines, their device-resident twins, the phase-4 service, that service
under the preset's default hedging, train + convert, the paper's single
call, in phase 6 the device-tier service, its re-stacking twin, the
fault run and the hedged engine, and phase 7's memory-tier engines, each
its own path. Every kernel variant
held to a path must have launched on it; runs made only to compare (the
plain engines, phase 1's checks, per-request oracles) count nowhere.
Every path hands ``mari_matmul`` prepared weights: weights prepared inside
a call (``PREPARES``) must be 0 on each path, and x copies to a padded
row stride (``STRIDE_COPIES``) are printed per path
(``mari_matmul_host_by_path``).
Phase 4 also times the ``tpu`` preset as shipped (hedging on) beside
``hedging=False`` on its DLRM stream. Prints the kernels JSON line, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``. Exits
non-zero on any failure, when no CUDA device is present, or when run
without the repository beside it.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import gc
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
PEAK_TF32_FLOPS = 495e12              # H100 SXM tensor cores, dense TF32
PEAK_BF16_FLOPS = 989e12              # H100 SXM tensor cores, dense bf16
BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # bf16 parity, as tests/test_kernels.py
# every mari_dense stream of the served models' rewritten graphs:
# (model layer, stream K, N, activation)
MARI_SHAPES = (("paper expert*_fc0", 1064, 512, "relu"),
               ("paper gate*_proj", 1064, 4, "identity"),
               ("paper task*_fc0", 256, 128, "relu"),
               ("paper attn_q_proj", 500, 64, "identity"),
               ("din mlp_0", 48, 200, "relu"),
               ("dlrm top_mlp_0", 351, 1024, "relu"),
               ("deepfm deep_mlp_0", 190, 400, "relu"))
PEAK_BYTES_S = 3.35e12                # H100 SXM HBM3
POOLS = (1000, 3000, 5000)            # straddle max_batch = 4096
SERVED = ("dlrm-mlperf", "deepfm", "fm")
DLRM_SCALE_TABLES = 0.1               # 96.1 GB of published tables -> 9.6 GB
TRAIN_STEPS, CKPT_EVERY, FAIL_AT = 24, 10, 15   # crash after the step-10 save
SINGLE_CALL_B = 2048                  # candidates of one single-call request
# builds of a kernel's source with one part left out, timed beside it
VARIANTS = {"gather_einsum": ("GATHER_EINSUM_NO_ROW_SORT",),
            "din_attention": ("DIN_ATTENTION_GUARDED_ONLY",),
            "dot_interaction": ("DOT_INTERACTION_RING_ONLY",)}
AUC_TOL = 1e-3
# phase 7, the memory tier (the reference's benchmarks/memtier.py setup):
# Zipf(1.1) universes, the head warmed up to 0.92 of the mass, 3000
# requests of 128 candidates over a pool of 64 user-feed dicts
MT_UNIVERSES = (10_000, 100_000, 1_000_000)
MT_ZIPF_S, MT_MASS, MT_REQUESTS, MT_CANDIDATES, MT_POOL = \
    1.1, 0.92, 3000, 128, 64
MT_COLD_BYTES = 8 << 30               # 114,471 full-width users
MT_MIN_AVAILABLE = 16 << 30           # below this MemAvailable, halve it
MT_IDENTITY = 16                      # requests per class rescored
# MLPerf DLRM-DCNv2's Criteo multi-hot sizes (MLCommons training,
# recommendation_v2/torchrec_dlrm, --multi_hot_sizes), one per sparse field
MULTI_HOT = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1,
             6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3, 1, 1)


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
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.launch.train import recsys_step
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.losses import auc
    from repro_torch.train.optim import adam
    from repro_torch.kernels import gather_einsum as ge
    from repro_torch.kernels import mari_matmul as mm
    from repro_torch.models.ranking import (PaperRankingConfig,
                                            build_paper_ranking_model)
    from repro_torch.graph.ir import GraphBuilder
    from repro_torch.models.recsys import (DLRM_TABLE_ROWS, build_din,
                                           build_dlrm, pad_vocab)
    from repro_torch.serve import (RankingService, ServePlan, ServeRequest,
                                   ServingEngine)
    from repro_torch.serve.engine import _CAND, _TABLE, _UIDX
    from repro_torch.serve.hedging import HedgePolicy
    from repro_torch.graph.compiled import CompiledRun
    from repro_torch.obs import Tracer, write_trace

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))

    # ---- build -------------------------------------------------------------
    # every source, and beside them the variants timed against the kernels
    # as built (the row sort of gather_einsum left out; din_attention's
    # guarded instance at DIN's width; dot_interaction's ring plan at
    # every batch): all nvcc processes at once
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1 + len(VARIANTS)) as pool:
        variant_builds = [pool.submit(build.build_all, (n,), d)
                          for n, d in VARIANTS.items()]
        libs = build.build_all()
        for f in variant_builds:
            f.result()
    ptxas = {}
    for name, lib in libs.items():
        logf = lib.with_suffix(".log")
        lines = logf.read_text().splitlines() if logf.exists() else []
        ptxas[name] = [ln.strip() for ln in lines
                       if "registers" in ln or "spill" in ln
                       or "warning" in ln][:16 if name == "mari_matmul"
                                           else 8]
    log("build", seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)

    # ---- phase 1: kernels against their plain versions ---------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def randidx(n, hi, lo=0):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def max_err(a, b, tol=TOL):
        torch.cuda.synchronize()
        a, b = a.float(), b.float()
        err = (a - b).abs()
        bad = err > tol["atol"] + tol["rtol"] * b.abs()
        if bool(bad.any()) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"kernel disagrees with its plain version: "
                                 f"max |d| {float(err.max()):.3e}")
        return float(err.max())

    def time_ms(fn, iters=20):
        """Device ms per call: the calls are enqueued behind ~10 ms of
        device sleep, so the host's launch time (tens of µs per wrapper
        call on these hosts) never leaves the device waiting between
        them."""
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    @contextlib.contextmanager
    def variant(ops_mod, name):
        """The kernel's wrapper launches the variant build of its source
        (``VARIANTS[name]``) inside the block."""
        saved = ops_mod._lib
        ops_mod._lib = lambda: saved(VARIANTS[name])
        try:
            yield
        finally:
            ops_mod._lib = saved

    def host_us(fn, n=50):
        """Host µs per call, enqueued behind a device sleep (the device
        never makes the host wait)."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        t = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t) / n * 1e6
        torch.cuda.synchronize()
        return us

    def bound(nbytes, flops, peak=PEAK_FP32_FLOPS):
        t_b, t_o = nbytes / PEAK_BYTES_S, flops / peak
        return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")

    def mari_bound(B, K, N, u_rows, mode, dtype=torch.float32):
        """The least time of one mari_matmul call as the kernel computes
        it: fp32 through 3xTF32 (three TF32 products; x, the prepared w_hi
        and w_lo, u and out moved once) or bf16 (one product)."""
        kp = -(-K // 4) * 4
        idx_b = 4 * B if mode == "gather" else 0
        if dtype == torch.float32:
            return bound(4 * (B * K + 2 * N * kp + u_rows * N + B * N)
                         + idx_b, 3 * 2 * B * K * N, PEAK_TF32_FLOPS)
        return bound(2 * (B * K + K * N + B * N) + 4 * u_rows * N + idx_b,
                     2 * B * K * N, PEAK_BF16_FLOPS)

    entries = {}
    # paper expert fc0 at a full bucket: B=4096, K=64+500+500, N=512; U=8;
    # the weight prepared once (w_hi / w_lo and their TMA descriptors), as
    # every path does at load
    B, K, N, U = 4096, 1064, 512, 8
    x, w = randn(B, K), randn(K, N) * 0.05
    pw = mm.prepare_mari_weight(w)
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
            errs.append(max_err(mm.mari_matmul(x, pw, u, ui, act),
                                mm.mari_matmul_plain(x, w, u, ui, act)))
        # ragged edges, every other epilogue, out-of-range indices, a raw
        # (unprepared) weight
        Br, Kr, Nr, Ur = 1000, 333, 65, 5
        xr, wr = randn(Br, Kr), randn(Kr, Nr)
        ur = {"broadcast": randn(1, Nr), "rowwise": randn(Br, Nr),
              "gather": randn(Ur, Nr)}[mode]
        ir = randidx(Br, Ur + 3, lo=-2) if mode == "gather" else None
        for act in ("gelu", "silu", "sigmoid", "tanh"):
            errs.append(max_err(mm.mari_matmul(xr, wr, ur, ir, act),
                                mm.mari_matmul_plain(xr, wr, ur, ir, act)))
        u_init = u.index_select(0, idx) if mode == "gather" else u
        b_ms, b_by = mari_bound(B, K, N, u.shape[0], mode)
        simt_ms, _ = bound(4 * (B * K + K * N + u.shape[0] * N + B * N)
                           + (4 * B if mode == "gather" else 0), 2 * B * K * N)
        ms = time_ms(lambda: mm.mari_matmul(x, pw, u, ui, "relu"))
        entries[f"mari_matmul/{mode}"] = dict(
            route="cuda", source="src/repro_torch/csrc/mari_matmul.cu",
            replaces=replaces[mode], max_abs_err=max(errs), ms=ms,
            plain_ms=time_ms(lambda: mm.mari_matmul_plain(x, w, u, ui,
                                                          "relu")),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: torch.addmm(u_init, x, w)),
            shape=dict(B=B, K=K, N=N, u_rows=u.shape[0], act="relu",
                       tile=mm.ops.tile_config(B, N)),
            bound_note="3xTF32: 3 x 2BKN at 495 TFLOP/s, x + w_hi + w_lo + "
                       "u + out at 3.35 TB/s",
            share_of_bound=b_ms / ms, bound_fp32_simt_ms=simt_ms,
            library="torch.addmm (init pre-gathered, no activation)")

    # every mari_dense shape of the served models, each init mode, at a full
    # bucket and at the single call's B, beside torch.addmm
    sweep = []
    for layer, Ks, Ns, act in MARI_SHAPES:
        ws_ = randn(Ks, Ns) * 0.05
        pws = mm.prepare_mari_weight(ws_)
        for Bs in (B, SINGLE_CALL_B):
            xs_ = randn(Bs, Ks)
            us = {"broadcast": randn(1, Ns), "rowwise": randn(Bs, Ns),
                  "gather": randn(U, Ns)}
            for mode in mm.ops.INIT_MODES:
                ui = idx[:Bs] if mode == "gather" else None
                u_init = (us[mode].index_select(0, ui) if ui is not None
                          else us[mode])
                err = max_err(mm.mari_matmul(xs_, pws, us[mode], ui, act),
                              mm.mari_matmul_plain(xs_, ws_, us[mode], ui,
                                                   act))
                b_ms, _ = mari_bound(Bs, Ks, Ns, us[mode].shape[0], mode)
                sweep.append(dict(
                    layer=layer, B=Bs, K=Ks, N=Ns, act=act, mode=mode,
                    tile=mm.ops.tile_config(Bs, Ns), max_abs_err=err,
                    stride_copy=not mm.ops.tma_ready(xs_),
                    ms=time_ms(lambda: mm.mari_matmul(xs_, pws, us[mode], ui,
                                                      act)),
                    addmm_ms=time_ms(lambda: torch.addmm(u_init, xs_, ws_)),
                    bound_ms=b_ms))
        del xs_, us
    log("mari_matmul_shapes", tol=TOL, rows=sweep)
    for mode in mm.ops.INIT_MODES:
        entries[f"mari_matmul/{mode}"]["all_path_shapes_max_abs_err"] = max(
            r["max_abs_err"] for r in sweep if r["mode"] == mode)

    # host costs around a launch: x's TMA descriptor, encoded per call
    # (timed through ctypes, which adds its own cost), and the copy of an x
    # whose row stride TMA cannot read (DLRM's top_mlp_0 stream, K = 351)
    desc = bytearray(128)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(desc))
    n_enc = 2000
    t = time.perf_counter()
    for _ in range(n_enc):
        mm.ops.encode_map(addr, x, 32, 128)
    enc_us = (time.perf_counter() - t) / n_enc * 1e6
    x351 = randn(B, 351)

    # accuracy against an fp64 oracle at the single call's expert fc0,
    # the kernel beside cuBLAS's fp32 GEMM (the plain version)
    xo, wo = x[:SINGLE_CALL_B], w
    oracle = xo.double() @ wo.double()
    zero = torch.zeros(1, N, device=dev)
    log("mari_matmul_accuracy", shape=[SINGLE_CALL_B, K, N],
        max_abs_vs_fp64=dict(
            kernel=float((mm.mari_matmul(xo, pw, zero).double() - oracle)
                         .abs().max()),
            cublas_fp32=float(((xo @ wo).double() - oracle).abs().max())))
    del oracle, zero

    log("mari_matmul_host", x_descriptor_encode_us=enc_us,
        stride_copy_ms_4096x351=time_ms(lambda: mm.ops.stream_operand(x351)),
        wrapper_host_us=host_us(lambda: mm.mari_matmul(
            x, pw, u_of["broadcast"], None, "relu")),
        addmm_host_us=host_us(lambda: torch.addmm(u_of["broadcast"], x, w)),
        note="encode timed on the host clock through ctypes; the copy with "
             "CUDA events; host µs per call of the wrapper and of one "
             "torch.addmm at the main shape")
    del x351

    # the bf16 entry (no path runs it: cast nodes keep plain torch), held
    # to its plain version at the reference's bf16 tolerance
    xb, wb = x.bfloat16(), w.bfloat16()
    pwb = mm.prepare_mari_weight(wb)
    ub = u_of["broadcast"]
    errs = [max_err(mm.mari_matmul(xb, pwb, ub, None, "relu"),
                    mm.mari_matmul_plain(xb, wb, ub, None, "relu"), BF16_TOL)]
    for mode in mm.ops.INIT_MODES:
        Br, Kr, Nr, Ur = 1000, 333, 65, 5
        xr, wr = randn(Br, Kr).bfloat16(), randn(Kr, Nr).bfloat16()
        ur = {"broadcast": randn(1, Nr), "rowwise": randn(Br, Nr),
              "gather": randn(Ur, Nr)}[mode]
        ir = randidx(Br, Ur + 3, lo=-2) if mode == "gather" else None
        for act in mm.ops.EPILOGUES:
            errs.append(max_err(mm.mari_matmul(xr, wr, ur, ir, act),
                                mm.mari_matmul_plain(xr, wr, ur, ir, act),
                                BF16_TOL))
    b_ms, b_by = mari_bound(B, K, N, 1, "broadcast", torch.bfloat16)
    ms = time_ms(lambda: mm.mari_matmul(xb, pwb, ub, None, "relu"))
    entries["mari_matmul/bf16"] = dict(
        route="cuda", source="src/repro_torch/csrc/mari_matmul.cu",
        replaces="src/repro/kernels/mari_matmul/kernel.py:77",
        max_abs_err=max(errs), tol=BF16_TOL, ms=ms,
        plain_ms=time_ms(lambda: mm.mari_matmul_plain(xb, wb, ub, None,
                                                      "relu")),
        bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
        library_ms=time_ms(lambda: torch.addmm(ub.bfloat16(), xb, wb)),
        shape=dict(B=B, K=K, N=N, u_rows=1, act="relu", dtype="bfloat16"),
        library="torch.addmm in bf16 (no activation)")
    del xb, wb, pwb

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
        # the engine's layout: each user's rows one contiguous run (random
        # run lengths, so run boundaries fall anywhere in a row tile)
        runs = torch.sort(randidx(B, U)).values
        errs.append(max_err(ge.gather_einsum(spec, xg, tg, runs),
                            ge.gather_einsum_plain(spec, xg, tg, runs)))
        # the device twin's (capacity 64, ...) slot table, both orders, and
        # packs of short requests: runs of 4 rows, 16 users a 64-row tile
        t64 = randn(64, *ts[1:])
        idx64, runs64 = randidx(B, 64), torch.sort(randidx(B, 64)).values
        short64 = (torch.arange(B, device=dev) // 4 % 64).to(torch.int32)
        for i64 in (idx64, runs64, short64):
            errs.append(max_err(ge.gather_einsum(spec, xg, t64, i64),
                                ge.gather_einsum_plain(spec, xg, t64, i64)))
        rows = tg.index_select(0, idx)
        row_spec = ge.parse_spec(spec)[3]
        b_ms, b_by = bound(4 * nfloats + 4 * B, flops)
        ms = time_ms(lambda: ge.gather_einsum(spec, xg, tg, idx))
        entries[f"gather_einsum/{spec}"] = dict(
            route="cuda", source="src/repro_torch/csrc/gather_einsum.cu",
            replaces="src/repro/kernels/gather_einsum/kernel.py:79",
            max_abs_err=max(errs), ms=ms,
            ms_runs=time_ms(lambda: ge.gather_einsum(spec, xg, tg, runs)),
            plain_ms=time_ms(lambda: ge.gather_einsum_plain(spec, xg, tg,
                                                            idx)),
            bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
            library_ms=time_ms(lambda: torch.einsum(row_spec, xg, rows)),
            u64=dict(ms=time_ms(lambda: ge.gather_einsum(spec, xg, t64,
                                                         idx64)),
                     ms_runs=time_ms(lambda: ge.gather_einsum(spec, xg, t64,
                                                              runs64)),
                     ms_short_runs=time_ms(lambda: ge.gather_einsum(
                         spec, xg, t64, short64)),
                     bound_ms=bound(4 * (nfloats + (64 - U) * t64[0].numel())
                                    + 4 * B, flops)[0]),
            shape=dict(x=list(xs), table=list(ts)),
            timing="ms: user_index in random order; ms_runs: contiguous "
                   "runs of random length (the engine's layout); u64: the "
                   "same at a 64-slot table, and ms_short_runs: runs of 4 "
                   "rows (16 users a 64-row tile)",
            library="torch.einsum on pre-gathered rows")
        if spec == "bd,uldh->blh":   # a random order without the row sort
            with variant(ge.ops, "gather_einsum"):
                errs.append(max_err(ge.gather_einsum(spec, xg, tg, idx),
                                    ge.gather_einsum_plain(spec, xg, tg,
                                                           idx)))
                entries[f"gather_einsum/{spec}"]["no_row_sort_ms"] = time_ms(
                    lambda: ge.gather_einsum(spec, xg, tg, idx))
            entries[f"gather_einsum/{spec}"]["timing"] += (
                "; no_row_sort_ms: ms, built without the row sort")
            entries[f"gather_einsum/{spec}"]["max_abs_err"] = max(errs)
        if spec == "bl,uld->bd":     # the same kernel at B = 1: its floor
            x1, i1 = xg[:1], idx[:1]
            entries[f"gather_einsum/{spec}"]["launch_floor_ms"] = time_ms(
                lambda: ge.gather_einsum(spec, x1, tg, i1))
        del t64
    del x, w, pw, u_of, rows

    # DLRM interaction at a full bucket: B=4096, F=27, D=128 -> P=351
    F, D = 27, 128
    for keep_self in (False, True):
        P = di.n_pairs(F, keep_self)
        xd = randn(B, F, D)
        errs = [max_err(di.dot_interaction(xd, keep_self),
                        di.dot_interaction_plain(xd, keep_self))]
        # ragged shapes and views that take the 4-byte cp.async instance
        # (D % 32 != 0; a start 4 bytes past 16-byte alignment)
        routes = {}
        for Br, Fr, Dr, shift in ((1000, 5, 128, 0), (1, 27, 16, 0),
                                  (130, 7, 33, 0), (33, 40, 64, 0),
                                  (1, 27, 128, 1), (64, 27, 128, 1),
                                  (256, 27, 128, 1)):
            xr = randn(Br * Fr * Dr + shift)[shift:].view(Br, Fr, Dr)
            routes[f"{Br}x{Fr}x{Dr}" + ("+4B" if shift else "")] = \
                di.copy_route(xr)
            errs.append(max_err(di.dot_interaction(xr, keep_self),
                                di.dot_interaction_plain(xr, keep_self)))
        # a row's bits do not depend on B
        if not torch.equal(di.dot_interaction(xd, keep_self)[100:356],
                           di.dot_interaction(xd[100:356], keep_self)):
            raise AssertionError("dot_interaction: a row's result depends "
                                 "on B")
        iu, ju = torch.triu_indices(F, F, offset=0 if keep_self else 1,
                                    device=dev)
        # the service's smaller buckets: leading rows of the same x
        by_batch = {}
        for Bs in (256, 512, 1024, 2048):
            xs_ = xd[:Bs]
            bs_ms = bound(4 * (Bs * F * D + Bs * P), 2 * Bs * P * D)[0]
            ms_s = time_ms(lambda: di.dot_interaction(xs_, keep_self))
            by_batch[Bs] = dict(ms=ms_s, bound_ms=bs_ms,
                                share_of_bound=bs_ms / ms_s)
            if Bs == 1024:     # 8 rows a block: the plan of 11 consumers
                with variant(di.ops, "dot_interaction"):
                    errs.append(max_err(
                        di.dot_interaction(xs_, keep_self),
                        di.dot_interaction_plain(xs_, keep_self)))
                    by_batch[Bs]["ring_plan_only_ms"] = time_ms(
                        lambda: di.dot_interaction(xs_, keep_self))
        b_ms, b_by = bound(4 * (B * F * D + B * P), 2 * B * P * D)
        ms = time_ms(lambda: di.dot_interaction(xd, keep_self))
        entries[f"dot_interaction/{di.VARIANTS[keep_self]}"] = dict(
            route="cuda", source="src/repro_torch/csrc/dot_interaction.cu",
            replaces="src/repro/kernels/dot_interaction/kernel.py:41",
            max_abs_err=max(errs), ms=ms, share_of_bound=b_ms / ms,
            plain_ms=time_ms(lambda: di.dot_interaction_plain(xd,
                                                              keep_self)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(
                lambda: torch.bmm(xd, xd.transpose(1, 2))[:, iu, ju]),
            shape=dict(B=B, F=F, D=D, P=P, keep_self=keep_self,
                       copy_route=di.copy_route(xd), ragged_routes=routes),
            by_batch=by_batch,
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
        # the kernel's route: the two per-pair products ((k*q) W1d, layer
        # 2) as 3xTF32 on the tensor cores, the rest on the CUDA cores
        mma = 3 * 2 * (Dq * h1 + h1 * h2) * Bq * Lq
        simt = flops - 2 * (Dq * h1 + h1 * h2) * Bq * Lq
        b3x = max(bound(nbytes, 0)[0], mma / PEAK_TF32_FLOPS * 1e3,
                  simt / PEAK_FP32_FLOPS * 1e3)
        by = "bytes" if b3x == bound(nbytes, 0)[0] else "operations"
        return (b3x, by), flops, bound(nbytes, flops)[0]

    Lq, Dq, H1, H2 = 100, 18, 80, 40
    timed = {}
    errs = []
    for Bq in (SINGLE_CALL_B, B):
        dargs = din_args(Bq, Lq, Dq, H1, H2)
        errs.append(max_err(da.din_attention(*dargs),
                            da.din_attention_plain(*dargs)))
        (b_ms, b_by), flops, simt_ms = din_bound(Bq, Lq, Dq, H1, H2)
        ms = time_ms(lambda: da.din_attention(*dargs))
        with variant(da.ops, "din_attention"):
            errs.append(max_err(da.din_attention(*dargs),
                                da.din_attention_plain(*dargs)))
            guarded_ms = time_ms(lambda: da.din_attention(*dargs))
        timed[Bq] = dict(
            ms=ms, plain_ms=time_ms(lambda: da.din_attention_plain(*dargs)),
            bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
            bound_3xtf32_ms=b_ms,
            bound_fp32_simt_ms=simt_ms, share_of_bound_fp32_simt=simt_ms / ms,
            guarded_instance_ms=guarded_ms, gflop=flops / 1e9)
        del dargs
    # ... and histories of several 112-key chunks, up to the longest one a
    # block holds at DIN width
    for shp in ((4, 5, 8, 16, 8), (33, 20, 18, 16, 8), (128, 100, 18, 16, 8),
                (1, 7, 6, 12, 5), (300, 37, 33, 128, 64),
                (40, 300, 18, 80, 40), (64, 920, 18, 80, 40)):
        a = din_args(*shp)
        errs.append(max_err(da.din_attention(*a), da.din_attention_plain(*a)))
    entries["din_attention/shared_keys"] = dict(
        route="cuda", source="src/repro_torch/csrc/din_attention.cu",
        replaces="src/repro/kernels/din_attention/kernel.py:47",
        max_abs_err=max(errs),
        **{k: v for k, v in timed[SINGLE_CALL_B].items() if k != "gflop"},
        library_ms=None,
        shape=dict(B=SINGLE_CALL_B, L=Lq, D=Dq, h1=H1, h2=H2,
                   gflop=timed[SINGLE_CALL_B]["gflop"],
                   also=[[B, Lq, Dq, H1, H2], [4, 5, 8, 16, 8],
                         [33, 20, 18, 16, 8], [128, 100, 18, 16, 8],
                         [1, 7, 6, 12, 5], [300, 37, 33, 128, 64],
                         [40, 300, 18, 80, 40], [64, 920, 18, 80, 40]]),
        bound_note="3xTF32: the least work's two per-pair products as "
                   "3xTF32 at 495 TFLOP/s, the rest at 67 TFLOP/s fp32; "
                   "bound_fp32_simt_ms: all of it at 67",
        timing="guarded_instance_ms: the build without the unguarded "
               "instance for these tile counts",
        at_full_bucket=dict(B=B, **timed[B]),
        library="none: no single PyTorch call computes the unit")
    # EmbeddingBag at the multi-hot DLRM path's largest bag: the sparse_20
    # table at scale_tables=0.1 (2,564,352 x 128), B = 4096, H = 100, sum;
    # the fixed-hotness entry (the executor's) and the CSR entry on the
    # same ids; the bound counts each distinct row this run's ids read
    import torch.nn.functional as F
    Vb, Bb, Hb, Db = pad_vocab(int(DLRM_TABLE_ROWS[20] * 0.1)), B, 100, 128
    tab = randn(Vb, Db)
    bag_ids = torch.randint(0, Vb, (Bb, Hb), generator=gen, device=dev,
                            dtype=torch.int32)
    flat = bag_ids.reshape(-1)
    segs = torch.arange(Bb, device=dev).repeat_interleave(Hb)
    offs = torch.arange(0, Bb * Hb, Hb, device=dev)
    rows_read = int(torch.unique(flat).numel())
    b_ms, b_by = bound(Db * 4 * rows_read + 4 * Bb * Hb + 4 * Bb * Db,
                       Bb * Hb * Db)
    errs = {"fixed": [max_err(eb.embedding_bag_fixed(tab, bag_ids),
                              eb.embedding_bag_fixed_plain(tab, bag_ids))],
            "csr": [max_err(eb.embedding_bag(tab, flat, segs, Bb),
                            eb.embedding_bag_plain(tab, flat, segs, Bb))]}
    # ragged: unsorted segments with empty and out-of-range ones, mean,
    # per-id weights, D = 18 / 1 / 130 (scalar path, partial tiles),
    # out-of-range and int64 ids, fixed hotness 1 and 27
    for Vr, Dr, Sr, nnz in ((1000, 18, 300, 2000), (500, 1, 64, 700),
                            (3000, 130, 97, 1500), (10_000, 128, 4096, 8192)):
        tr = randn(Vr, Dr)
        ir = torch.randint(-3, Vr + 3, (nnz,), generator=gen, device=dev)
        sr = torch.randint(-2, Sr + 2, (nnz,), generator=gen, device=dev)
        wr = torch.rand(nnz, generator=gen, device=dev)
        for comb in ("sum", "mean"):
            for w_ in (None, wr):
                errs["csr"].append(max_err(
                    eb.embedding_bag(tr, ir, sr, Sr, comb, w_),
                    eb.embedding_bag_plain(tr, ir, sr, Sr, comb, w_)))
        for Hr in (1, 27):
            ir2 = randidx(64 * Hr, Vr).reshape(64, Hr)
            for comb in ("sum", "mean"):
                errs["fixed"].append(max_err(
                    eb.embedding_bag_fixed(tr, ir2, comb),
                    eb.embedding_bag_fixed_plain(tr, ir2, comb)))
    bag_shape = dict(V=Vb, B=Bb, H=Hb, D=Db, combiner="sum",
                     distinct_rows_read=rows_read,
                     mbytes_for_bound=(Db * 4 * rows_read + 4 * Bb * Hb
                                       + 4 * Bb * Db) / 1e6)
    # the CSR entry with the segment ids sorted (as above) and shuffled,
    # and its preparation (the counting sort) alone; beside them the
    # sort-based preparation it replaced (csr_prep_plain, then the same
    # bag kernel), whose output the entry must equal bit for bit
    perm = torch.randperm(flat.numel(), generator=gen, device=dev)
    flat_sh, segs_sh = flat[perm].contiguous(), segs[perm].contiguous()

    def old_prep(f_, s_):
        order, o_ = eb.csr_prep_plain(s_, Bb)
        return eb.ops._launch("csr", tab, f_[order], o_, None, Bb, 0, "sum")

    for f_, s_ in ((flat, segs), (flat_sh, segs_sh)):
        if not torch.equal(eb.embedding_bag(tab, f_, s_, Bb),
                           old_prep(f_, s_)):
            raise AssertionError("embedding_bag/csr differs from the "
                                 "sort-based preparation")
    fixed_ms = time_ms(lambda: eb.embedding_bag_fixed(tab, bag_ids))
    csr_ms = time_ms(lambda: eb.embedding_bag(tab, flat, segs, Bb))
    csr_timing = dict(
        ms_shuffled=time_ms(lambda: eb.embedding_bag(tab, flat_sh, segs_sh,
                                                     Bb)),
        prep_ms=time_ms(lambda: eb.csr_prep(segs, flat, None, Bb)),
        prep_ms_shuffled=time_ms(lambda: eb.csr_prep(segs_sh, flat_sh, None,
                                                     Bb)),
        old_prep_ms=time_ms(lambda: old_prep(flat, segs)),
        old_prep_ms_shuffled=time_ms(lambda: old_prep(flat_sh, segs_sh)))
    csr_b_ms, csr_b_by = bound(Db * 4 * rows_read + 12 * Bb * Hb
                               + 4 * Bb * Db, Bb * Hb * Db)
    entries["embedding_bag/fixed"] = dict(
        route="cuda", source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/kernel.py:37",
        max_abs_err=max(errs["fixed"]), ms=fixed_ms,
        share_of_bound=b_ms / fixed_ms,
        plain_ms=time_ms(lambda: eb.embedding_bag_fixed_plain(tab, bag_ids)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.embedding_bag(flat, tab, offs,
                                                   mode="sum")),
        shape=bag_shape,
        library="torch.nn.functional.embedding_bag (mode='sum', offsets)")
    entries["embedding_bag/csr"] = dict(
        route="cuda", source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/kernel.py:37",
        max_abs_err=max(errs["csr"]), ms=csr_ms,
        share_of_bound=csr_b_ms / csr_ms,
        plain_ms=time_ms(lambda: eb.embedding_bag_plain(tab, flat, segs,
                                                        Bb)),
        bound_ms=csr_b_ms, bound_by=csr_b_by,
        library_ms=time_ms(lambda: F.embedding_bag(flat, tab, offs,
                                                   mode="sum")),
        **csr_timing,
        shape=dict(bag_shape, segment_ids="int64, sorted (ms) or shuffled "
                   "(ms_shuffled)", note="ms includes the counting sort "
                   "(prep_ms alone); old_prep_ms: csr_prep_plain's stable "
                   "sort + searchsorted + gathers, then the same bag kernel; "
                   "bound adds the int64 segment ids read"),
        library="torch.nn.functional.embedding_bag (mode='sum', offsets)")
    del tab, bag_ids, flat, segs, offs, flat_sh, segs_sh
    # "blh,uh->bl" is a spec the kernel supports but the executor's
    # decomposed attention never reaches, no served model keeps the gram's
    # diagonal, no path calls the CSR entry of embedding_bag (the
    # executor's bags have a fixed hotness), and none runs mari_matmul in
    # bf16 (mixed-precision nodes keep plain torch): checked and timed
    # above, they are listed in the kernels line with on_path false
    OFF_PATH = ("gather_einsum/blh,uh->bl", "dot_interaction/triu_keep_self",
                "embedding_bag/csr", "mari_matmul/bf16")
    log("kernels_vs_plain", tol=TOL,
        max_abs_err={k: v["max_abs_err"] for k, v in entries.items()},
        ms={k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                  "library_ms")}
            for k, v in entries.items()}, off_path=OFF_PATH)

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
            with counting("paper+din"):
                per = [eng.score(r) for r in reqs]       # cold: stage 1 runs
                t = time.perf_counter()
                co = eng.score_coalesced(reqs)           # users now cached
                co_ms = (time.perf_counter() - t) * 1e3
                cold_prof = eng.profiler.snapshot(reset=True)
                warm = [eng.score(r) for r in reqs]
            built = graph_stats(eng)
            d_eager, eager_dispatch = 0.0, []
            for r, p in zip(reqs, per):
                e, ts = eager_scores(eng, r)
                eager_dispatch += ts
                if not close(p.scores, e):
                    raise AssertionError(
                        f"{tag}/{name}: compiled vs eager "
                        f"{np.abs(p.scores - e).max():.3e}")
                d_eager = max(d_eager, float(np.abs(p.scores - e).max()))
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
                with counting("paper+din"):
                    window = device_window(eng, reqs)
            except Exception as e:       # a profiler failure is no smoke fail
                window = f"not measured: {type(e).__name__}: {e}"
            with counting("paper+din"):
                trace = traced(f"{tag}_{name}", {tag: eng},
                               lambda: eng.score_coalesced(reqs))
            check_graphs(f"{tag}/{name}", eng)
            if graph_stats(eng) != built:      # warm passes capture nothing
                raise AssertionError(f"{tag}/{name}: a warm pass captured: "
                                     f"{built} -> {graph_stats(eng)}")
            log(tag, plan=name, pools=[r.scores.shape[0] for r in per],
                max_abs_kernel_vs_plain=d_ref,
                max_abs_compiled_vs_eager=d_eager,
                max_abs_per_vs_coalesced=d_co,
                cold_latency_ms=[r.latency_ms for r in per],
                cold_stage1_ms=[r.stage1_ms for r in per],
                warm_latency_ms=[r.latency_ms for r in warm],
                coalesced_ms=co_ms, stage2_calls=eng.stage2_calls,
                coalesced_calls=eng.coalesced_calls,
                dispatch_ms_per_pack=dict(
                    compiled=prof["dispatch"]["mean_us"] / 1e3,
                    eager=float(np.mean(eager_dispatch)) * 1e3,
                    replay_alone=replay_host_us(eng) / 1e3),
                graphs=built,
                profile_cold={k: v for k, v in cold_prof.items()
                              if v["calls"]},
                profile={k: v for k, v in prof.items() if v["calls"]},
                device_window=window, trace=trace)
            if name == "tpu":
                device_twin(tag, graph, params, plan, reqs, per)
            del eng
        del oracle

    def device_twin(tag, graph, params, plan, reqs, want):
        """Phase 6d: a device-resident twin of a ``tpu`` engine scores the
        same users (per request, then coalesced over the slot tables); each
        score within TOL of the ``tpu`` engine's. Its launches are path
        ``device_twin``'s."""
        twin = ServingEngine(graph, params, plan.evolve(
            cache__device_resident=True, cache__device_slots=8), device=dev)
        with counting("device_twin"):
            per = [twin.score(r) for r in reqs]
            co = twin.score_coalesced(reqs)
        d = 0.0
        for p_, c, w in zip(per, co, want):
            for got in (p_.scores, c.scores):
                if not (np.isfinite(got).all() and close(got, w.scores)):
                    raise AssertionError(
                        f"{tag}/device twin: {np.abs(got - w.scores).max()}")
                d = max(d, float(np.abs(got - w.scores).max()))
        check_graphs(f"{tag}/device twin", twin)
        log(f"{tag}_device_twin", max_abs_vs_tpu=d,
            graphs=graph_stats(twin),
            store=twin.device_store.stats(),
            warm_latency_ms=[r.latency_ms for r in per],
            coalesced_latency_ms=co[0].latency_ms,
            profile={k: v for k, v in twin.profiler.snapshot().items()
                     if v["calls"]})
        twin.close()

    def reset_launches():
        for mod in (mm, ge, di, da, eb):
            mod.reset_launches()

    def read_launches():
        out = {f"mari_matmul/{m}": n for m, n in mm.LAUNCHES.items()}
        out.update({f"gather_einsum/{s}": n for s, n in ge.LAUNCHES.items()})
        out.update({f"dot_interaction/{v}": n
                    for v, n in di.LAUNCHES.items()})
        out.update({f"din_attention/{v}": n for v, n in da.LAUNCHES.items()})
        out.update({f"embedding_bag/{v}": n for v, n in eb.LAUNCHES.items()})
        return out

    by_path: dict[str, dict[str, int]] = {}
    # mari_matmul's weights prepared inside a call (a raw w) and x operands
    # copied to a padded row stride, per path
    host_by_path: dict[str, dict[str, int]] = {}

    @contextlib.contextmanager
    def counting(path):
        """Zero every launch count just before the block and add what the
        block launched to ``by_path[path]`` just after (device synchronised
        at both ends), so each path is read over its own runs only."""
        torch.cuda.synchronize()
        reset_launches()
        yield
        torch.cuda.synchronize()
        tot = by_path.setdefault(path, {})
        for k, n in read_launches().items():
            tot[k] = tot.get(k, 0) + n
        host = host_by_path.setdefault(path, {"prepares": 0,
                                              "stride_copies": 0})
        host["prepares"] += sum(mm.PREPARES.values())
        host["stride_copies"] += sum(mm.STRIDE_COPIES.values())

    def eager_scores(eng, req):
        """The engine's own stage bodies run eagerly on the card (what its
        graphs capture), one request at U = 1, padded to the engine's
        buckets: (scores, host seconds per stage-2 enqueue). The oracle of
        compiled against eager, and the eager ``dispatch`` per pack."""
        times, out = [], []
        with torch.inference_mode():
            if eng.two_stage:
                reps = eng._stage1.run(eng.params, {
                    k: torch.as_tensor(np.asarray(v), device=dev)
                    for k, v in req.user_feeds.items()
                    if k in eng._stage1_inputs})
            else:
                reps = {k: torch.as_tensor(np.asarray(v), device=dev)
                        for k, v in req.user_feeds.items()}
            n = next(iter(req.candidate_feeds.values())).shape[0]
            for lo in range(0, n, eng.max_batch):
                hi = min(lo + eng.max_batch, n)
                b = eng._bucket(hi - lo)
                feeds = {_TABLE + k: v for k, v in reps.items()}
                for k, v in req.candidate_feeds.items():
                    c = np.asarray(v[lo:hi])
                    c = np.concatenate([c, np.repeat(c[-1:], b - len(c), 0)])
                    feeds[_CAND + k] = torch.as_tensor(c, device=dev)
                feeds[_UIDX] = torch.zeros(b, dtype=torch.int32, device=dev)
                torch.cuda.synchronize()
                t = time.perf_counter()
                o = eng._stage2_body(eng.params, feeds)
                times.append(time.perf_counter() - t)
                out.append(torch.cat([o[k] for k in eng.outputs],
                                     -1)[:hi - lo])
        return torch.cat(out).cpu().numpy(), times

    def graph_stats(eng):
        """The engine's compiled graphs: stage-2 graphs against the
        (rows, bucket) shapes and (rows, bucket, route) signatures it
        served, stage-1 graphs, and the memory their captures reserved."""
        return dict(stage2_compilations=eng.stage2_compilations,
                    stage2_shapes=eng.stage2_shapes,
                    stage2_routes=eng.stage2_routes,
                    stage1_compilations=eng.stage1_compilations,
                    captures=eng.graph_pool.captures,
                    graph_reserved_mb=eng.graph_pool.reserved_bytes / 1e6)

    def replay_host_us(eng):
        """Host µs of one ``replay()`` alone (no copy-in, no copy-out) of
        the engine's largest stage-2 graph: the floor of a compiled
        ``dispatch``."""
        entries = list(eng._stage2_run._entries.values())
        big = max(entries, key=lambda e: sum(t.numel()
                                              for t in e.static.values()))
        with eng.graph_pool.lock:
            return host_us(big.graph.replay, n=20)

    def check_graphs(tag, eng):
        if eng.stage2_compilations != eng.stage2_routes:
            raise AssertionError(
                f"{tag}: {eng.stage2_compilations} stage-2 graphs for "
                f"{eng.stage2_routes} distinct (rows, bucket, route)")

    TRACE_DIR = os.path.join(ROOT, "build", "chip_smoke_traces")

    def traced(tag, engines, fn, need=("group", "pack", "dispatch",
                                       "begin_coalesced", "collect")):
        """One more pass of ``fn`` with a tracer on each engine (and the
        batchers over them): writes ``<tag>.json``, reloads it, checks
        every B/E pair and the ``need`` events, and returns a summary with
        each span's mean µs."""
        tracers = {name: Tracer() for name in engines}
        for name, e in engines.items():
            e.set_tracer(tracers[name])
        try:
            fn()
        finally:
            for e in engines.values():
                e.set_tracer(None)
        os.makedirs(TRACE_DIR, exist_ok=True)
        path = os.path.join(TRACE_DIR, f"{tag}.json")
        payload = write_trace(path, tracers)
        with open(path) as f:
            back = json.load(f)
        evs = back["traceEvents"]
        if len(evs) != len(payload["traceEvents"]):
            raise AssertionError(f"trace {tag}: reload lost events")
        depth = {}
        for e in evs:
            key = (e["pid"], e["tid"])
            if e["ph"] == "B":
                depth[key] = depth.get(key, 0) + 1
            elif e["ph"] == "E":
                depth[key] = depth.get(key, 0) - 1
                if depth[key] < 0:
                    raise AssertionError(f"trace {tag}: E before its B")
        names = {}
        spans = {}
        for e in evs:
            if e["ph"] == "M":
                continue
            names[e["name"]] = names.get(e["name"], 0) + 1
            if e["ph"] == "X":
                spans.setdefault(e["name"], []).append(e["dur"])
        missing = [n for n in need if n not in names]
        if missing or any(depth.values()):
            raise AssertionError(f"trace {tag}: missing {missing}, "
                                 f"open spans {depth}")
        return dict(file=os.path.relpath(path, ROOT), events=len(evs),
                    names=names,
                    span_mean_us={k: float(np.mean(v))
                                  for k, v in spans.items()})

    def serve_phase() -> None:
        """Phase 4: the service's passes count as path ``service``; then the
        preset's default hedging beside ``hedging=False`` (path
        ``service_default_hedging``) and the launcher."""
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
        out, built, pass_prof = {}, {}, {}
        for name, stream in passes:
            if name == "warm_users":
                built = {sc: graph_stats(svc.engine(sc)) for sc in SERVED}
            with counting("service"):
                t = time.perf_counter()
                out[name] = svc.score_many(stream)
                stream_ms = (time.perf_counter() - t) * 1e3
            pass_prof[name] = {sc: {k: v for k, v in svc.engine(sc)
                                    .profiler.snapshot(reset=True).items()
                                    if v["calls"]} for sc in SERVED}
            log("service_pass", name=name, stream_ms=stream_ms,
                requests=len(stream), latency_ms={
                    sc: [r.latency_ms for (s, _), r in zip(stream,
                                                           out[name])
                         if s == sc] for sc in SERVED},
                profile=pass_prof[name])
        # the repeated warm pass captured nothing; three batcher threads
        # captured and replayed their engines' graphs
        for sc in SERVED:
            eng = svc.engine(sc)
            check_graphs(f"service/{sc}", eng)
            if graph_stats(eng) != built[sc]:
                raise AssertionError(f"service/{sc}: the warm pass "
                                     f"captured: {built[sc]} -> "
                                     f"{graph_stats(eng)}")
        results = out["first"]
        for name in ("cold_users", "warm_users"):
            for (sc, _), r, r0 in zip(items, out[name], results):
                if not close(r.scores, r0.scores):
                    raise AssertionError(f"service/{sc}: pass {name} "
                                         f"differs from the first pass")
        # per-request scores on the same engines (users now cached), one
        # request at a time from this thread: no batcher thread competes
        with counting("service"):
            per = [svc.engine(sc).score(req) for sc, req in items]
        log("service_per_request", latency_ms={
            sc: [r.latency_ms for (s, _), r in zip(items, per) if s == sc]
            for sc in SERVED},
            profile={sc: {k: v for k, v in svc.engine(sc).profiler
                          .snapshot(reset=True).items() if v["calls"]}
                     for sc in SERVED})

        d_ref, d_per, d_eager, eager_dispatch = {}, {}, {}, {}
        for (sc, req), res, p in zip(items, results, per):
            n = next(iter(req.candidate_feeds.values())).shape[0]
            want = oracle[sc].score(req).scores
            e, ts = eager_scores(svc.engine(sc), req)
            eager_dispatch.setdefault(sc, []).extend(ts)
            if not close(res.scores, e):
                raise AssertionError(
                    f"service/{sc}: compiled vs eager "
                    f"{np.abs(res.scores - e).max():.3e}")
            d_eager[sc] = max(d_eager.get(sc, 0.0),
                              float(np.abs(res.scores - e).max()))
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
        # one traced pass of the stream (warm users), every scenario's
        # engine and batcher into one file
        with counting("service"):
            trace = traced("service", {sc: svc.engine(sc) for sc in SERVED},
                           lambda: svc.score_many(again),
                           need=("submit", "queue_claim", "group_launch",
                                 "resolve", "group", "pack", "dispatch",
                                 "collect", "cache_hit"))
        log("service_trace", **trace)
        for sc in SERVED:
            s = stats["scenarios"][sc]
            log("service", scenario=sc, pools=list(POOLS),
                max_abs_kernel_vs_plain=d_ref[sc],
                max_abs_compiled_vs_eager=d_eager[sc],
                dispatch_ms_per_pack=dict(
                    compiled=pass_prof["warm_users"][sc]["dispatch"]
                    ["mean_us"] / 1e3,
                    eager=float(np.mean(eager_dispatch[sc])) * 1e3,
                    replay_alone=replay_host_us(svc.engine(sc)) / 1e3),
                graphs=graph_stats(svc.engine(sc)),
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
        default_hedging(svc, graph, params, [
            (sc, r, res.scores) for (sc, r), res in zip(items, results)
            if sc == "dlrm-mlperf"])
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

    def default_hedging(svc, graph, params, dlrm):
        """The ``tpu`` preset as shipped (``batch.hedging`` on: a dispatch
        at a shape already seen runs blocking on a hedge worker) beside
        phase 4's ``hedging=False`` service, on the DLRM stream: each
        service warmed, then three rounds of a cold-user and a warm-user
        pass in turns, the order flipped every round. Scores within TOL of
        phase 4's first pass."""
        hsvc = RankingService(ServePlan.preset("tpu"), smoke=False, seed=0,
                              device=dev)
        hsvc.register("dlrm-mlperf", graph=graph, params=params)
        labels = {"hedging_off": (svc, "service"),
                  "hedging_default": (hsvc, "service_default_hedging")}
        with counting("service_default_hedging"):
            hsvc.score_many([(sc, r) for sc, r, _ in dlrm])   # first use
        for s_, _ in labels.values():
            s_.engine("dlrm-mlperf").profiler.snapshot(reset=True)
        h0 = hsvc.engine("dlrm-mlperf").ft_stats()["hedges_launched"]
        rec = {lab: {"cold_users_ms": [], "warm_users_ms": []}
               for lab in labels}
        d = 0.0
        for k in range(3):
            stream = [(sc, dataclasses.replace(r, user_id=r.user_id
                                               + 1000 * (k + 1)))
                      for sc, r, _ in dlrm]
            order = list(labels) if k % 2 == 0 else list(labels)[::-1]
            for pass_ in ("cold_users_ms", "warm_users_ms"):
                for lab in order:
                    s_, path = labels[lab]
                    with counting(path):
                        t = time.perf_counter()
                        got = s_.score_many(stream)
                        rec[lab][pass_].append(
                            (time.perf_counter() - t) * 1e3)
                    for g, (_, _, want) in zip(got, dlrm):
                        if not close(g.scores, want):
                            raise AssertionError(
                                f"service/{lab}: outside {TOL}")
                        d = max(d, float(np.abs(g.scores - want).max()))
        for lab, (s_, _) in labels.items():
            eng = s_.engine("dlrm-mlperf")
            snap = eng.profiler.snapshot(reset=True)
            rec[lab].update(
                hedging=eng.hedging,
                profile={p: v for p, v in snap.items() if v["calls"]})
        rec["hedging_default"]["hedges_launched"] = (
            hsvc.engine("dlrm-mlperf").ft_stats()["hedges_launched"] - h0)
        with counting("service_default_hedging"):
            hsvc.close()                 # joins any abandoned hedge loser
        log("service_default_hedging", scenario="dlrm-mlperf",
            pools=list(POOLS), max_abs_vs_first_pass=d, **rec)

    def make_calls(runs):
        """name -> (params, compiled call, eager call) per (name, graph,
        params, mode, use_pallas) run: the compiled call is ``CompiledRun``
        over ``Executor(g, mode).run`` (the reference's ``jax.jit(
        Executor(g, mode).run)``), the eager one the executor itself."""
        out = {}
        for name, g, p, mode, pallas in runs:
            ex = Executor(g, mode, use_pallas=pallas, device=dev)

            def eager(p_, f_, ex=ex):
                with torch.inference_mode():
                    return ex.run(p_, f_)
            out[name] = (p, CompiledRun(ex.run, device=dev), eager)
        return out

    def single_call(outputs, calls, feeds, which=1):
        """Score one request single-call through each run, compiled
        (``which=1``) or eager (2); returns name -> (B, tasks) scores."""
        out = {}
        for name, c in calls.items():
            o = c[which](c[0], feeds)
            out[name] = torch.cat([o[k] for k in outputs], -1)
        torch.cuda.synchronize()
        return out

    def compiled_vs_eager(outputs, calls, feeds, compiled):
        """max |Δ| of each run's compiled scores against its eager ones."""
        eager = single_call(outputs, calls, feeds, which=2)
        d = {k: float((compiled[k] - eager[k]).abs().max()) for k in calls}
        for k, v in d.items():
            a, b = compiled[k].cpu().numpy(), eager[k].cpu().numpy()
            if not close(a, b):
                raise AssertionError(f"single call {k}: compiled vs eager "
                                     f"{v:.3e}")
        return d

    def device_ms_per_call(fn, n=5):
        """Device busy ms per call (kernel self time, torch.profiler);
        "not measured" when the profiler recorded no device time (it does
        not always see the kernels of a graph replay: device_span_ms, from
        CUDA events, stands beside it)."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")) / n / 1e3
        return busy if busy else "not measured: no device time recorded"

    def time_calls(calls, feeds):
        """Per run, compiled and eager side by side: timeit (3 warm-up, 20
        timed calls, synchronised) p50 / mean / p99; what a call costs the
        device (profiled kernel busy time, and CUDA-event ms of 5 calls
        queued behind a device sleep) and the host (one call enqueued
        behind a device sleep)."""
        t = {}
        for name, (p, comp, eager) in calls.items():
            t[name] = {}
            for label, fn in (("compiled", comp), ("eager", eager)):
                def call(fn=fn):
                    return fn(p, feeds)
                r = timeit(call, warmup=3, iters=20)
                d = dict(p50_ms=r["p50_us"] / 1e3, mean_ms=r["mean_us"] / 1e3,
                         p99_ms=r["p99_us"] / 1e3,
                         host_ms=host_us(call, n=1) / 1e3,
                         device_span_ms=time_ms(call, iters=5))
                try:
                    d["device_ms"] = device_ms_per_call(call)
                except Exception as e:  # a profiler failure is no smoke fail
                    d["device_ms"] = (f"not measured: {type(e).__name__}: "
                                      f"{e}")
                t[name][label] = d
        return t

    def ratio(times, num, den):
        """times[num] / times[den] per measure, compiled and eager."""
        out = {}
        for label in ("compiled", "eager"):
            for k in ("p50_ms", "device_ms", "device_span_ms"):
                a, b = times[num][label][k], times[den][label][k]
                if isinstance(a, float) and isinstance(b, float) and b:
                    out[f"{label}_{k}"] = a / b
        return out

    def train_convert_phase() -> None:
        """Phase 5 (path ``train+convert``)."""
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

        # convert, then score one user's 2048 candidates single-call; the
        # mari_matmul kernel's weights are prepared once, before the calls
        mg, mp, conv = apply_mari(graph, params)
        mp = mm.prepare_mari_params(mg, mp)
        feeds = make_recsys_feeds(graph, SINGLE_CALL_B,
                                  np.random.default_rng(4))
        feeds = {k: torch.as_tensor(v, device=dev) for k, v in feeds.items()}
        runs = [("vani", graph, params, "vani", False),
                ("uoi_plain", graph, params, "uoi", False),
                ("uoi", graph, params, "uoi", True),
                ("mari_plain", mg, mp, "uoi", False),
                ("mari", mg, mp, "uoi", True)]
        calls = make_calls(runs)
        scores = single_call(outputs, calls, feeds)
        d_eager = compiled_vs_eager(outputs, calls, feeds, scores)
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
        times = time_calls(calls, feeds)
        log("single_call", model="din", candidates=SINGLE_CALL_B,
            rewrites=[r.dense for r in conv.rewrites],
            attn_rewrites=len(conv.attn_rewrites), max_abs=d,
            max_abs_compiled_vs_eager=d_eager,
            auc_vani_mari=aucs, auc_delta=[abs(a - b) for a, b in aucs],
            times=times, uoi_over_mari=ratio(times, "uoi", "mari"),
            graph_reserved_mb={k: c[1].pool.reserved_bytes / 1e6
                               for k, c in calls.items()})

    def table1_phase() -> None:
        """The paper model at full width single-call in VanI / UOI / MaRI,
        compiled as the reference's bench_table1 (``jax.jit(Executor(g,
        mode).run)``) and eager side by side, timed and printed, not
        gated."""
        graph, _ = build_paper_ranking_model(PaperRankingConfig())
        params = init_graph_params(graph, seed=0, device=dev)
        mg, mp, conv = apply_mari(graph, params)
        mp = mm.prepare_mari_params(mg, mp)
        feeds = make_recsys_feeds(graph, SINGLE_CALL_B,
                                  np.random.default_rng(5))
        feeds = {k: torch.as_tensor(v, device=dev) for k, v in feeds.items()}
        runs = [("vani", graph, params, "vani", False),
                ("uoi", graph, params, "uoi", True),
                ("mari_plain", mg, mp, "uoi", False),
                ("mari", mg, mp, "uoi", True)]
        outputs = list(graph.outputs)
        calls = make_calls(runs)
        scores = single_call(outputs, calls, feeds)
        d_eager = compiled_vs_eager(outputs, calls, feeds, scores)
        times = time_calls(calls, feeds)
        log("table1", model="paper", candidates=SINGLE_CALL_B,
            rewrites=[r.dense for r in conv.rewrites],
            max_abs_vs_vani={k: float((v - scores["vani"]).abs().max())
                             for k, v in scores.items() if k != "vani"},
            max_abs_compiled_vs_eager=d_eager,
            times=times,
            # the paper's Table 1: MaRI 1.32x faster than UOI
            speedup_mari_vs_uoi=dict(ratio(times, "uoi", "mari"),
                                     paper_claim=1.32),
            graph_reserved_mb={k: c[1].pool.reserved_bytes / 1e6
                               for k, c in calls.items()},
            note="printed, not gated")


    def multihot_dlrm():
        """build_dlrm's graph at its published widths and scale_tables =
        0.1, with sparse field i taking (h_i,) ids pooled by sum where
        h_i > 1 (MULTI_HOT)."""
        rows = [pad_vocab(max(4, int(r * DLRM_SCALE_TABLES)))
                for r in DLRM_TABLE_ROWS]
        b = GraphBuilder()
        h = b.input("user_dense", (13,), "user")
        for li, width in enumerate((512, 256, 128)):
            h = b.dense(f"bot_mlp_{li}", h, width, activation="relu")
        bot_out, embs = h, []
        for fi, hot in enumerate(MULTI_HOT):
            ids = b.input(f"sparse_{fi}_ids", (hot,) if hot > 1 else (),
                          "user" if fi < 13 else "item", dtype="int32")
            embs.append(b.embedding(f"sparse_{fi}_emb", ids, vocab=rows[fi],
                                    dim=128, pool="sum" if hot > 1 else None))
        inter = b.dot_interaction("dot_inter", b.stack_features(
            "feat_stack", [bot_out] + embs))
        h = b.concat("top_in", [bot_out, inter])
        for li, width in enumerate((1024, 1024, 512, 256, 1)):
            h = b.dense(f"top_mlp_{li}", h, width,
                        activation="identity" if width == 1 else "relu")
        b.output(h)
        return b.graph

    def memtier_phase() -> None:
        """Phase 7: the memory tier at full width (path ``memtier``): the
        paper model over three universes, DIN (whose decomposed attention
        runs ``gather_einsum``) over the smallest."""
        avail = 0
        with open("/proc/meminfo") as f:
            for ln in f:
                if ln.startswith("MemAvailable:"):
                    avail = int(ln.split()[1]) * 1024
        cold_bytes, reduced = MT_COLD_BYTES, []
        if avail < MT_MIN_AVAILABLE:
            cold_bytes //= 2
            reduced.append(f"cold_bytes halved to {cold_bytes}: "
                           f"MemAvailable {avail} < {MT_MIN_AVAILABLE}")
        log("memtier_host", mem_available_bytes=avail,
            cold_bytes=cold_bytes, reduced=reduced)
        plan = tpu.evolve(batch__linger_ms=0.0,
                          cache__device_resident=True,
                          cache__device_slots=256,
                          cache__max_cached_users=4096,
                          mem__cold_tier=True, mem__cold_bytes=cold_bytes,
                          mem__warm_batch=4096)

        def ms_stats(a):
            return (dict(n=len(a), p50_ms=float(np.percentile(a, 50)),
                         p99_ms=float(np.percentile(a, 99))) if a
                    else dict(n=0, p50_ms=None, p99_ms=None))

        def held_to(eng, picks, tag, n_out):
            """Rescore ``picks`` (request, scores, class) on ``eng``: max
            |Δ| and bitwise equality, failing beyond TOL."""
            d, same = 0.0, True
            for r, got, cls in picks:
                want = eng.score(r).scores
                if got.shape != (MT_CANDIDATES, n_out) or not (
                        np.isfinite(got).all() and close(got, want)):
                    raise AssertionError(
                        f"memtier {tag} ({cls}): "
                        f"{np.abs(got - want).max():.3e}")
                d = max(d, float(np.abs(got - want).max()))
                same = same and bool(np.array_equal(got, want))
            return dict(checked=len(picks), bitwise_equal=same,
                        max_abs=d)

        def stream(model, graph, params, n_out, universes, seed):
            """Per universe: warm the Zipf head, serve the stream, check
            identity, graphs and promotions; returns the request maker."""
            # the same plan with the cache (and so the cold tier) off:
            # every request recomputes stage 1 and re-stacks
            ident = ServingEngine(graph, params, tpu.evolve(
                batch__linger_ms=0.0, cache__cache_user_reps=False),
                device=dev)
            oracle = ServingEngine(graph, params, plain.evolve(
                batch__linger_ms=0.0, cache__cache_user_reps=False),
                device=dev)
            pool = requests(graph, (MT_CANDIDATES,) * MT_POOL, seed=seed)
            ufeeds = [r.user_feeds for r in pool]
            cand = pool[0].candidate_feeds

            def req(uid):
                return ServeRequest(user_id=int(uid),
                                    user_feeds=ufeeds[uid % MT_POOL],
                                    candidate_feeds=cand)

            for i, universe in enumerate(universes):
                eng = ServingEngine(graph, params, plan, device=dev)
                w = 1.0 / np.arange(1, universe + 1,
                                    dtype=np.float64) ** MT_ZIPF_S
                cdf = np.cumsum(w) / w.sum()
                rng = np.random.default_rng(seed + 100 + i)
                uids = np.searchsorted(cdf, rng.random(MT_REQUESTS),
                                       side="left")
                lat = {"hot": [], "cold": [], "recompute": []}
                picks = {c: [] for c in lat}
                before = dict(by_path.get("memtier", {}))
                with counting("memtier"):
                    t = time.perf_counter()
                    eng.warm([(0, ufeeds[0])])
                    capacity = eng.mem_stats()["cold"]["capacity"]
                    k = min(universe, capacity, int(np.searchsorted(
                        cdf, MT_MASS, side="left")) + 1)
                    if k > 1:
                        eng.warm([(u, ufeeds[u % MT_POOL])
                                  for u in range(1, k)])
                    warm_s = time.perf_counter() - t
                    # each route's first capture, untimed: a recompute
                    # (slot tables) and a cold hit (re-stacked)
                    eng.score(req(universe + 1))
                    eng.warm([(universe + 2,
                               ufeeds[(universe + 2) % MT_POOL])])
                    eng.score(req(universe + 2))
                    for uid in uids:
                        r = req(uid)
                        t = time.perf_counter()
                        res = eng.score(r)
                        ms = (time.perf_counter() - t) * 1e3
                        cls = ("hot" if res.user_cache_hit
                               else "cold" if res.cold_hit else "recompute")
                        lat[cls].append(ms)
                        if len(picks[cls]) < MT_IDENTITY:
                            picks[cls].append((r, res.scores, cls))
                    eng.flush_promotions()
                after = dict(by_path["memtier"])
                built = graph_stats(eng)
                check_graphs("memtier", eng)
                more = np.searchsorted(cdf, rng.random(200), side="left")
                with counting("memtier"):
                    trace = traced(
                        f"memtier_{model}_U{universe}", {model: eng},
                        lambda: ([eng.score(req(u)) for u in more],
                                 eng.warm([(universe + 3, ufeeds[
                                     (universe + 3) % MT_POOL])]),
                                 eng.flush_promotions()),
                        need=("group", "pack", "dispatch", "collect",
                              "warm", "cold_hit", "cold_miss"))
                if graph_stats(eng) != built:
                    raise AssertionError(
                        f"memtier {model} U={universe}: a repeated pass "
                        f"captured: {built} -> {graph_stats(eng)}")
                mst = eng.mem_stats()
                prof = eng.profiler.snapshot()
                identity = {c: held_to(ident, p, "vs cache-off", n_out)
                            for c, p in picks.items()}
                four = [p[j] for j in range(2) for p in picks.values()
                        if len(p) > j][:4]
                vs_plain = held_to(oracle, four, "vs use_pallas=False",
                                   n_out)
                n_hit = len(lat["hot"]) + len(lat["cold"])
                log("memtier", model=model, universe=universe,
                    requests=MT_REQUESTS, hit_rate=n_hit / MT_REQUESTS,
                    **{c: ms_stats(v) for c, v in lat.items()},
                    warmed=k, warm_s=warm_s, warm_users_per_s=k / warm_s,
                    demotions=mst["demotions"],
                    promotions=mst["promote"]["promotions"],
                    promote_errors=mst["promote"]["errors"],
                    promote_last_error=mst["promote"]["last_error"],
                    cold_hits=mst["cold_hits"],
                    cold_misses=mst["cold_misses"],
                    arena=mst["cold"], cold_read_us_mean=prof["cold_read"],
                    demote_us_mean=prof["demote"],
                    identity_vs_cache_off=identity,
                    identity_vs_plain=vs_plain,
                    graphs=built, device_store=eng.device_store.stats(),
                    launches={k2: n - before.get(k2, 0)
                              for k2, n in after.items() if n},
                    trace=trace)
                if mst["promote"]["errors"]:
                    raise AssertionError(
                        f"memtier {model} U={universe}: "
                        f"{mst['promote']['errors']} promotions failed: "
                        f"{mst['promote']['last_error']}")
                missing = [c for c, v in lat.items() if not v]
                if missing:
                    raise AssertionError(f"memtier {model} U={universe}: "
                                         f"no {missing} request")
                eng.close()
                del eng
                gc.collect()                 # the arena's slabs go now
            ident.close()
            oracle.close()
            return req

        cfg = PaperRankingConfig()
        graph, _ = build_paper_ranking_model(cfg)
        params = init_graph_params(graph, seed=0, device=dev)
        req = stream("paper", graph, params, cfg.n_tasks, MT_UNIVERSES,
                     seed=70)

        # the tier's copies per user on the real path: a 64-user hot LRU
        # demotes 256 users, which are then served cold
        eng = ServingEngine(graph, params, plan.evolve(
            cache__max_cached_users=64), device=dev)
        with counting("memtier"):
            for u in range(320):
                eng.score(req(u))
            dem = eng.profiler.snapshot(reset=True)["demote"]
            got = [eng.score(req(u)) for u in range(256)]
            eng.flush_promotions()
        read = eng.profiler.snapshot()["cold_read"]
        mst = eng.mem_stats()
        if not all(r.cold_hit for r in got) or eng.demotions != 256:
            raise AssertionError(f"memtier copies: {eng.demotions} "
                                 f"demotions, cold hits "
                                 f"{sum(r.cold_hit for r in got)}")
        if mst["promote"]["errors"]:
            raise AssertionError("memtier copies: a promotion failed")
        bpu = mst["cold"]["bytes_per_user"]
        log("memtier_copies", model="paper", bytes_per_user=bpu,
            boundaries=len(eng._cold._layout),
            demote_ms_per_user=dem["mean_us"] / 1e3, demotions=dem["calls"],
            cold_hit_read_ms_per_user=read["mean_us"] / 1e3,
            cold_hits=read["calls"],
            demote_gb_s=bpu / (dem["mean_us"] * 1e3),
            cold_hit_gb_s=bpu / (read["mean_us"] * 1e3),
            promote_errors=mst["promote"]["errors"])
        eng.close()
        del eng, params
        gc.collect()

        graph, _ = build_din(embed_dim=18, seq_len=100, attn_mlp=(80, 40),
                             mlp=(200, 80), item_vocab=10_000_000)
        params = init_graph_params(graph, seed=0, device=dev)
        stream("din", graph, params, 1, MT_UNIVERSES[:1], seed=80)
        del params
        torch.cuda.empty_cache()

    def multihot_phase() -> None:
        """Phase 6 (a-c). Every ``score_many`` of the device-tier service
        counts as path ``multihot``; the re-stacking twin, the fault run and
        the hedging engine each count as a path of their own."""
        graph = multihot_dlrm()
        params = init_graph_params(graph, seed=0, device=dev)
        torch.cuda.synchronize()
        log("multihot_params", gbytes=sum(
            p["table"].numel() * 4 for p in params.values() if "table" in p)
            / 1e9, bags_per_candidate=sum(h > 1 for h in MULTI_HOT[13:]),
            ids_per_candidate=sum(MULTI_HOT[13:]))
        # a 20 ms linger lets the batcher put the twelve new users of the
        # last pass into one call (one group stops growing at max_batch
        # rows), so they need more slots than the tier has
        tier = tpu.evolve(cache__device_resident=True, cache__device_slots=8,
                          ft__retries=2, ft__breaker_failures=3,
                          batch__linger_ms=20.0)
        no_tier = tpu.evolve(ft__retries=2, batch__linger_ms=20.0)
        oracle = ServingEngine(graph, params, plain, device=dev)

        def stream(base_uid, users, seed, version=0):
            """9 requests, pools 1000 / 3000 / 5000 interleaved over
            ``users`` user ids from ``base_uid``."""
            reqs = requests(graph, POOLS * 3, seed=seed)
            for i, r in enumerate(reqs):
                r.user_id = base_uid + i % users
                r.feature_version = version
            return reqs

        first = stream(0, 3, seed=61)
        passes = [("new_users", first), ("same_users", first),
                  ("bumped_version", [dataclasses.replace(
                      r, feature_version=1) if r.user_id == 0 else r
                      for r in first]),
                  ("twelve_new_users", requests(graph, (300,) * 12,
                                                seed=62))]
        for i, r in enumerate(passes[-1][1]):
            r.user_id = 100 + i
        # both services are built and warmed (first use of each bucket
        # size: pinned host blocks, per-thread library set-up) on users of
        # their own, then take the four passes in turns, the order flipped
        # every pass, so neither pays first-use costs the other skips
        svcs = {}
        path_of = {"device_tier": "multihot",
                   "restacking": "multihot_restacking"}
        for label, plan_ in (("device_tier", tier), ("restacking", no_tier)):
            svc = RankingService(plan_, device=dev)
            svc.register("dlrm-multihot", graph=graph, params=params)
            warm = stream(900, 3, seed=60) + requests(graph, (300,) * 12,
                                                      seed=59)
            for i, r in enumerate(warm[9:]):
                r.user_id = 910 + i
            with counting(path_of[label]):
                svc.score_many([("dlrm-multihot", r) for r in warm])
            svc.engine("dlrm-multihot").profiler.snapshot(reset=True)
            svcs[label] = svc
        store = svcs["device_tier"].engine("dlrm-multihot").device_store
        before = store.stats()
        prof = {label: {} for label in svcs}
        res = {label: [] for label in svcs}
        for k, (name, reqs) in enumerate(passes):
            order = list(svcs) if k % 2 == 0 else list(svcs)[::-1]
            for label in order:
                svc = svcs[label]
                eng = svc.engine("dlrm-multihot")
                calls0 = eng.stage2_calls
                with counting(path_of[label]):
                    t = time.perf_counter()
                    got = svc.score_many([("dlrm-multihot", r)
                                          for r in reqs])
                    stream_ms = (time.perf_counter() - t) * 1e3
                snap = eng.profiler.snapshot(reset=True)
                packs = eng.stage2_calls - calls0
                # ``pack`` is one entry per pack; the tier's slot
                # resolution (row writes) is its own phase, once per call
                prof[label][name] = dict(
                    stream_ms=stream_ms, packs=packs,
                    pack_ms_per_pack=snap["pack"]["total_ms"] / packs,
                    slots_ms=snap["slots"]["total_ms"],
                    slots_calls=snap["slots"]["calls"],
                    dispatch_mean_us=snap["dispatch"]["mean_us"],
                    stage1_calls=snap["stage1"]["calls"])
                res[label].append(got)
        torch.cuda.synchronize()
        for label, svc in svcs.items():
            eng = svc.engine("dlrm-multihot")
            d_ref = d_per = 0.0
            for (name, reqs), got in zip(passes, res[label]):
                for r, g in zip(reqs, got):
                    n = next(iter(r.candidate_feeds.values())).shape[0]
                    want = oracle.score(r).scores
                    own = eng.score(r).scores
                    if g.scores.shape != (n, 1) or not (
                            np.isfinite(g.scores).all()
                            and close(g.scores, want)
                            and close(own, g.scores)):
                        raise AssertionError(
                            f"multihot/{label}/{name}: outside {TOL}: "
                            f"{np.abs(g.scores - want).max():.3e} vs plain, "
                            f"{np.abs(own - g.scores).max():.3e} vs own")
                    d_ref = max(d_ref, float(np.abs(g.scores - want).max()))
                    d_per = max(d_per, float(np.abs(own - g.scores).max()))
            d_eager, eager_dispatch = 0.0, []
            for r, g in zip(passes[-1][1], res[label][-1]):
                e, ts = eager_scores(eng, r)
                eager_dispatch += ts
                if not close(g.scores, e):
                    raise AssertionError(
                        f"multihot/{label}: compiled vs eager "
                        f"{np.abs(g.scores - e).max():.3e}")
                d_eager = max(d_eager, float(np.abs(g.scores - e).max()))
            check_graphs(f"multihot/{label}", eng)
            st = svc.stats()["scenarios"]["dlrm-multihot"]
            log("multihot_service", plan=label, passes=prof[label],
                max_abs_vs_plain=d_ref, max_abs_vs_own_score=d_per,
                max_abs_compiled_vs_eager=d_eager,
                eager_dispatch_ms_per_pack=float(np.mean(eager_dispatch))
                * 1e3, graphs=graph_stats(eng),
                store=st["device_store"], pipeline_forks=st["pipeline_forks"],
                hedging=st["hedging"])
        # one traced pass of new users on the tier: slot writes, steals and
        # the tier's row writes as instants beside the spans
        tier_eng = svcs["device_tier"].engine("dlrm-multihot")
        tr_reqs = requests(graph, (300,) * 12, seed=63)
        for i, r in enumerate(tr_reqs):
            r.user_id = 300 + i
        with counting("multihot"):
            trace = traced("multihot", {"dlrm-multihot": tier_eng},
                           lambda: svcs["device_tier"].score_many(
                               [("dlrm-multihot", r) for r in tr_reqs]),
                           need=("group", "pack", "dispatch", "collect",
                                 "submit", "slot_steal", "cache_miss"))
        log("multihot_trace", **trace)
        check_graphs("multihot/traced pass", tier_eng)
        # the passes themselves wrote, hit, stole and overflowed slots
        after = store.stats()
        moved = {k: after[k] - before[k] for k in ("writes", "hits",
                                                   "recycles", "overflows")}
        if not all(moved.values()):
            raise AssertionError(f"device tier never exercised: {moved}")
        log("multihot_store_in_passes", **moved)
        # 6b: faults on the same service, one pass of new users
        svc = svcs["device_tier"]
        fplan = tier.evolve(ft__inject=True, ft__sites=(
            "slot_write:error:count=1", "collect:corrupt:count=1"))
        svc.register("dlrm-multihot-ft", graph=graph, params=params,
                     plan=fplan)
        freqs = stream(200, 3, seed=64)
        feng = svc.engine("dlrm-multihot-ft")
        with counting("multihot_faults"):
            fres = []
            ftrace = traced("multihot_faults", {"dlrm-multihot-ft": feng},
                            lambda: fres.extend(svc.score_many(
                                [("dlrm-multihot-ft", r) for r in freqs])),
                            need=("fault_injected", "quarantine",
                                  "corruption_detected", "retry",
                                  "group", "pack", "collect"))
        check_graphs("multihot/faults", feng)
        fst = svc.stats()["scenarios"]["dlrm-multihot-ft"]
        d_f = 0.0
        for r, g in zip(freqs, fres):
            want = oracle.score(r).scores
            if not (np.isfinite(g.scores).all() and close(g.scores, want)):
                raise AssertionError("multihot/faults: bad score")
            d_f = max(d_f, float(np.abs(g.scores - want).max()))
        log("multihot_faults", sites=list(fplan.ft.sites),
            faults_fired=fst["faults_fired"], quarantines=fst["quarantines"],
            corruptions_detected=fst["corruptions_detected"],
            retries_attempted=fst["retries_attempted"],
            breaker=fst["breaker"], max_abs_vs_plain=d_f,
            graphs=graph_stats(feng), trace=ftrace)
        if fst["faults_fired"] != 2 or fst["quarantines"] < 1:
            raise AssertionError(f"faults: {fst['faults_fired']} fired, "
                                 f"{fst['quarantines']} quarantines")
        for svc in svcs.values():
            svc.close()
        del svcs, svc
        # 6c: hedging on the paper preset with kernels; a 0 ms policy floor
        # hedges every dispatch at a shape already seen
        hplan = ServePlan.preset("paper").evolve(kernel__use_pallas=True)
        heng = ServingEngine(graph, params, hplan, device=dev,
                             hedge_policy=HedgePolicy(min_hedge_ms=0.0))
        ref = ServingEngine(graph, params,
                            hplan.evolve(batch__hedging=False), device=dev)
        hreqs = requests(graph, POOLS, seed=65)
        d_h, lat = 0.0, {"hedged": [], "unhedged": [], "hedged_ms": [],
                         "unhedged_ms": []}
        with counting("multihot_hedging"):
            heng.score_coalesced(hreqs)              # first use per shape
        ref.score_coalesced(hreqs)
        for _ in range(3):                           # in turns
            for label_, e in (("hedged", heng), ("unhedged", ref)):
                with (counting("multihot_hedging") if e is heng
                      else contextlib.nullcontext()):
                    t = time.perf_counter()
                    lat[label_].append(e.score_coalesced(hreqs))
                    lat[label_ + "_ms"].append(
                        (time.perf_counter() - t) * 1e3)
        for got, want in zip(lat["hedged"], lat["unhedged"]):
            for g, w in zip(got, want):
                if not close(g.scores, w.scores):
                    raise AssertionError("hedged scores differ")
                d_h = max(d_h, float(np.abs(g.scores - w.scores).max()))
        hst = heng.ft_stats()
        check_graphs("multihot/hedging", heng)
        log("multihot_hedging", hedges_launched=hst["hedges_launched"],
            graphs=graph_stats(heng),
            hedge_wins=hst["hedge_wins"],
            hedged_per_request=[r.hedged for r in lat["hedged"][-1]],
            max_abs_vs_unhedged=d_h,
            coalesced_call_ms=dict(hedged=lat["hedged_ms"],
                                   unhedged=lat["unhedged_ms"]))
        if hst["hedges_launched"] == 0:
            raise AssertionError("hedging launched no duplicate")
        with counting("multihot_hedging"):
            heng.close()                 # joins any abandoned hedge loser
        del heng, ref, oracle, params
        torch.cuda.empty_cache()

    # hedging is the preset's default, as in the reference; phases 2-5
    # keep it off so their dispatch stays non-blocking and their numbers
    # stay comparable across runs, and phase 6c measures it
    tpu = ServePlan.preset("tpu").evolve(batch__hedging=False)
    plain = tpu.evolve(kernel__use_pallas=False, kernel__kernel_gather=False)

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
    eq7_params = mm.prepare_mari_params(conv.graph,
                                        convert_params(conv, params))
    with counting("paper+din"):
        got = CompiledRun(Executor(conv.graph, "uoi", use_pallas=True,
                                   device=dev).run, device=dev)(
            eq7_params, feeds)
    with torch.inference_mode():
        want = Executor(graph, "vani", device=dev).run(params, feeds)
    d_eq7 = max(float((got[o] - want[o]).abs().max()) for o in graph.outputs)
    if not all(close(got[o].cpu().numpy(), want[o].cpu().numpy())
               for o in graph.outputs):
        raise AssertionError(f"MaRI executor vs vanilla: {d_eq7:.3e}")
    log("paper_eq7", rows=B, max_abs_mari_vs_vanilla=d_eq7)
    del params, eq7_params, got, want

    graph, _ = build_din(embed_dim=18, seq_len=100, attn_mlp=(80, 40),
                         mlp=(200, 80), item_vocab=10_000_000)
    params = init_graph_params(graph, seed=0, device=dev)
    log("din_params", gbytes=sum(
        p["table"].numel() * 4 for p in params.values() if "table" in p)
        / 1e9, note="embedding tables, drawn on the card")
    serve_checks("din", graph, params, {"tpu": tpu}, plain,
                 requests(graph, POOLS, seed=3), n_out=1)
    del params

    # ---- phase 4: RankingService + continuous batcher, DLRM/DeepFM/FM -----
    serve_phase()

    # ---- phase 5: train, convert, score single-call ------------------------
    with counting("train+convert"):
        train_convert_phase()
    with counting("table1"):
        table1_phase()

    # ---- phase 6: multi-hot DLRM, device tier, faults, hedging -------------
    multihot_phase()

    # ---- phase 7: the memory tier at full width ----------------------------
    memtier_phase()
    log("launches_by_path", **by_path)
    # each path is held to its own counts: paper + DIN to every variant of
    # mari_matmul and gather_einsum on its path, the device twins to the
    # gathered MaRI init and DIN's gathered contractions over slot tables,
    # the service (with or without the preset's default hedging) to the
    # DLRM interaction and the gathered MaRI init, train+convert to the
    # shared-key DIN unit and the broadcast MaRI init of DIN's mlp_0, the
    # multi-hot device-tier service (and its re-stacking twin, and its
    # fault run) to the pooled bags, the interaction and the gathered MaRI
    # init, the hedged paper-preset engine (no kernel gather) to the bags,
    # the interaction and the row-wise MaRI init, the memory tier's engines
    # to the gathered MaRI init (paper, DIN) and DIN's gathered attention
    # contractions; table1 is only printed
    held = {"paper+din": [k for k in entries
                          if k.startswith(("mari_matmul/", "gather_einsum/"))
                          and k not in OFF_PATH]}
    held["device_twin"] = ["mari_matmul/gather"] + [
        k for k in held["paper+din"] if k.startswith("gather_einsum/")]
    held["service"] = held["service_default_hedging"] = [
        "dot_interaction/triu", "mari_matmul/gather"]
    held["train+convert"] = ["din_attention/shared_keys",
                             "mari_matmul/broadcast"]
    held["multihot"] = held["multihot_restacking"] = \
        held["multihot_faults"] = ["embedding_bag/fixed",
                                   "mari_matmul/gather",
                                   "dot_interaction/triu"]
    held["multihot_hedging"] = ["embedding_bag/fixed", "mari_matmul/rowwise",
                                "dot_interaction/triu"]
    held["memtier"] = ["mari_matmul/gather", "gather_einsum/bd,uldh->blh",
                       "gather_einsum/bl,uld->bd"]
    missing = [f"{p}:{k}" for p, ks in held.items() for k in ks
               if by_path.get(p, {}).get(k, 0) == 0]
    # every path hands mari_matmul prepared weights (engines at load, the
    # single calls before their loop): none is prepared inside a call
    log("mari_matmul_host_by_path", **host_by_path)
    prepared_late = {p: h["prepares"] for p, h in host_by_path.items()
                     if h["prepares"]}
    if prepared_late:
        raise AssertionError(f"mari_matmul prepared weights inside calls: "
                             f"{prepared_late}")
    launches = {k: sum(p.get(k, 0) for p in by_path.values())
                for k in entries}
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi: rc={smi.returncode} {smi.stderr.strip()}")
    kernels = [{"name": name, "launches": launches[name],
                "launches_by_path": {p: c.get(name, 0)
                                     for p, c in by_path.items()},
                "on_path": name not in OFF_PATH, "card": card,
                **e} for name, e in entries.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
