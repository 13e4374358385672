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
   ``cp.async``); the CSR entry of ``embedding_bag`` (fp32 and bf16) with
   sorted and shuffled segment ids, its preparation alone (``prep_ms``:
   one pass over sorted ids, the counting sort over shuffled ones) and,
   in fp32, the sort-based preparation (``old_prep_ms``), whose output
   it must equal bit for bit in both dtypes.
   ``mari_matmul`` (3xTF32 on the tensor cores) is also checked and timed
   beside ``addmm`` at every ``mari_dense`` shape of the served models, in
   each init mode, at B = 4096 and 2048 (``mari_matmul_shapes``); its
   per-call host costs are the ``mari_matmul_host`` line, its bf16 entry
   is held at 2e-2 and, for identity and relu, to an fp64 oracle on the
   widened operands (``oracle_vs_fp64``: ``bf16_vs_widened``), x written
   as the serving path writes a stream (rows ``stream_ld`` apart), and
   timed at the same shapes with a broadcast init at the ``serve_bf16``
   cells' batches 512 / 262,144 / 1M beside one bf16 ``addmm``
   (``mari_matmul_bf16_shapes``). ``din_attention`` also runs past the 920 keys a block
   once held (``by_length``: 921, 2048 and 10,000 keys at B = 512, in fp32
   at 2e-4 and bf16 at 2e-2). Every other kernel's bf16 entry
   (``<kernel>/.../bf16``: bf16 in and out, f32 inside) is held at 2e-2
   and timed at its fp32 entry's shape beside the bf16 library call;
   those that widen where their FMAs read the operands
   (``gather_einsum``'s ``bl,uld->bd`` and ``blh,uh->bl``,
   ``embedding_bag``) also bit for bit against the fp32 kernel on the
   widened operands. ``dot_interaction``'s, ``din_attention``'s and
   ``gather_einsum``'s ``bd,uldh->blh`` run on the bf16 tensor cores:
   ``dot_interaction``'s and ``bd,uldh->blh``'s are held to the fp32
   kernel on the widened operands within one bf16 ulp, or where a sum
   cancels within the f32 reordering bound (``bf16_vs_widened``);
   Every ``gather_einsum`` bf16 entry is also checked and timed at a
   64-slot table (``u64``). ``din_attention``'s wide route
   (``din_attention/wide`` and ``/wide/bf16``: units past the register
   tiles, on ``wgmma`` with weights prepared once by
   ``prepare_din_weights``) is checked at ``DIN_WIDE_CHECKED`` (and 10,000
   keys), held at ``din_args``' 0.2 scale against the unit in fp64
   (``fp32_at_0_2_scale``: no farther from it than the plain version) and
   timed at DIN's public D = 128; fp32 ``bd,uldh->blh`` past D = 40 runs
   on the tensor cores (``gather_einsum/bd,uldh->blh/tc``: checked at D
   41 / 64 / 128 / 130, timed at D = 128 beside the CUDA-core kernel it
   replaces there and ``einsum`` on the gathered operand); the generic
   route (``gather_einsum/generic`` and
   ``/generic/bf16``) runs every ``GENERIC_SPECS`` spec, held to its plain
   version and bit for bit to commit 521130a's generic entries (built from
   ``GENERIC_PARENT`` beside the kernels), bf16 bit for bit the fp32 route
   on widened operands, a row's bits free of B and of the rows' order, and
   timed beside the plain version, 521130a's kernel and ``einsum`` on
   pre-gathered rows (``gather_einsum_generic`` line; its launches are
   path ``generic``: no model forms such a spec).
2. Paper ranking model at full ``PaperRankingConfig()`` width: serves three
   users (1000 / 3000 / 5000 candidates) per request and coalesced under the
   ``tpu`` preset and under ``tpu`` without ``kernel_gather``, against a
   ``use_pallas=False`` engine on the same params; and runs the single-call
   MaRI executor (Eq. 7, one user) against the vanilla executor.
3. DIN at ``configs/din.py`` width (10M-row item vocabulary, on the card)
   under ``tpu``, with the same checks. Then (3b) DIN at its public D =
   128 (item vocabulary cut to 1M rows): the ``tpu`` engine at one pool
   of 1000 (path ``din128_engine``: ``mari_matmul`` and ``gather_einsum``
   at D = 128) and the single call (``launch/steps.py``'s
   ``_recsys_serve``, compiled, fp32 and ``serve_bf16``, path
   ``din128_single``: the attention unit on ``din_attention``'s wide
   route) against its ``use_pallas=False`` program (``din128_single``
   lines: p50 ms, launches, the kernels' device ms, max |d|).
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
   teacher) with the captured step (``recsys_step``:
   one CUDA graph, the state updated in place), checkpoints through
   ``CheckpointManager``, crashes once on purpose and resumes to the last
   step (the restored state copied into the captured one: one graph in
   all), holds 10 captured steps against 10 eager steps of the same body
   from the same state and batches (2e-4), converts with GCA + MaRI, and
   scores 2048 candidates single-call in VanI, UOI and MaRI (UOI and MaRI
   through the kernels: the whole DIN attention unit is ``din_attention``)
   against ``use_pallas=False`` executors, with per-task AUC; then times
   each paradigm and one training step, captured and eager. Last, the
   paper model at full width single-call in VanI / UOI / MaRI at B =
   2048, compiled as the reference's ``bench_table1`` and eager, timed
   and printed.
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
8. Distributed serving (``dist``): ``python -m repro_torch.dist.runner``
   as subprocesses, the paper model at full width with the ``tpu`` graph
   and kernel sections, ``shard_candidates`` on and hedging off, 4 users
   over ~6000 candidates (4096-row packs, 2048 rows per shard), in VanI /
   UOI / MaRI: (a) two gloo ranks time-slicing the one card, (b) a
   one-rank NCCL group, (c) the int8 score gather on two ranks, MaRI.
   Each run is verified, timed over 300 passes and traced (the merged
   trace reloaded: one pid per rank). Per record: processes, shards,
   backend, max |Δ| against the rank's local unsharded engine (2e-4, or
   the int8 bound) with the bitwise flag, max |Δ| of the kernels against
   ``use_pallas=False``, each rank's ``mari_matmul`` gather launches (> 0
   in MaRI), and ``qps``, ``rows_per_s`` (median pass, with p10 / p50 /
   p90) and the ``StageProfiler`` breakdown (mean µs a call, ms a pass at
   p10 / p50 / p90) of (a), (b) and (c) side by side per mode
   (``dist_bench``). Two ranks share one card, so (a) against (b) is the
   cost of the split and the gather, not scaling.
9. The paper's Tables 2 and 3 and the §2.4 reorganization. ``table2``:
   the reference's ``bench_table2`` points at scale 1.0 (17), each timed
   four ways: ``torch.addmm`` on the tiled input, the plain
   ``matmul_mari``, and the ``mari_matmul`` broadcast entry on the tiled
   input (zero init row) and on x_rest (init row u = x_u W_u, the GEMV
   timed with it); both time ratios beside ``WeightPartition``'s FLOPs
   and bytes ratios and each column's bound. ``table3``: ``bench_table3``
   at scale 1.0, the original matmul, neat MaRI and MaRI over the
   interleaved layout at chunks 50 .. 800, compiled (``CompiledRun``) and
   eager. ``reorg``: Table 3's setting as a graph (the chunks of width 100
   as inputs, one concat, dense(256, relu), dense(1)) served by three
   ``tpu`` engines: fragment=True, group_by_domain=True, and its
   ``reorganize`` -> ``convert_params_reorg`` form, each against a plain
   VanI engine; then the three graphs as single calls
   (``table3_single_call``). ``examples``: ``repro_torch.examples.
   gca_demo`` and ``serve_ranking --use-pallas --scale 1.0`` as
   subprocesses.
10. The LM family's serving path (``lm``), in bf16 from random weights:
   ``flash_attention`` at granite's and Mixtral's head shapes (S 4096)
   against ``naive_attention`` and ``moe_ffn`` at granite's width (4096
   tokens, capacity drops) against ``moe_loop_oracle``, each within
   2e-2; granite-moe-3b-a800m at its full size, ``prefill_32k`` (32,768
   tokens, batch 1 of the shape's 32, eager) and ``decode_32k`` (batch 16
   of 128 over a 32,768-slot cache drawn from a seed, 32 steps at the
   cache's end) through ``build_cell(...).compiled()``, then the same
   steps eager from the same cache; Mixtral-8x7B at full width and 4 of
   its 32 layers, ``long_500k``'s 64 captured steps at positions
   524224 .. 524287 over a W = 4096 ring, then one step at position 5119
   through the ring against a 5120-slot cache, held in fp32 (bf16 printed
   beside a chunking control). Captured against eager within 2e-2, one
   graph per model; prefill ms and
   tokens/s, decode ms per step captured and eager, each beside its
   bound (decode: bytes a step over 3.35 TB/s; prefill: the reference
   algorithm's FLOPs, masked blocks included, over the bf16 peak), and
   peak memory per model. No kernel of the six runs on this path.
11. The training and serving cells (``cells``) through
   ``build_cell(...).compiled()`` at full published width:
   ``lm_granite_train`` (granite-moe-3b-a800m, all 32 layers, train_4k's
   seq 4096 at the largest batch of 1..4 that fits beside its 54 GB of
   bf16 params, f32 master weights and moments; eager steps, then the
   captured step, whose loss is held against an eager forward at bf16
   2e-2; the batch planned from a probe sequence's activations and
   ``CELL_POOL_GROWTH``), then granite at full width and
   ``CELL_SLICED_LAYERS`` layers (``lm_granite_sliced_update``: its
   expert leaves span several of AdamW's in-place slices), whose captured
   state after ``CELL_SLICED_STEPS`` steps is held against ``eager()``
   from the same state and batches and against the functional
   ``opt.update`` (2e-4 on all but 0.1% of each leaf, the bf16 params at
   one ulp),
   ``recsys_paper_train`` and ``recsys_din_train`` (65,536 rows; DIN also
   with ``emb_bf16``: captured against eager from one state and the same
   batches, 2e-4), ``recsys_paper_serve`` (512 / 262,144 / 1,000,000
   candidates) and ``recsys_din_serve`` with ``attn_reparam`` (512 /
   262,144) through the kernels against the same program's
   ``use_pallas=False`` runs, compiled and eager (2e-4); then with
   ``serve_bf16`` (params and float feeds in bf16, held at 2e-2):
   ``recsys_paper_serve_bf16`` (512 / 262,144 / 1M), ``recsys_din_serve_bf16``
   (default options, so the whole DIN unit is ``din_attention``; 512 /
   262,144) and ``recsys_dlrm_serve_bf16`` (``dlrm-mlperf`` with all
   187,767,399 table rows, 48.07 GB drawn in bf16 on the card; 512 /
   262,144, and 1M where the probe of the shapes before says it fits in
   ``CELL_MEM_SHARE``), each shape held to launch its bf16 entries; the
   paper model's bf16 call at 262,144 rows is profiled once
   (``profile``: device busy ms and the top kernels). Per
   cell: step ms (p50 of 5 calls after the first), rows or tokens a
   second, the bound by bytes and by operations (serving and recsys FLOPs
   counted by ``FlopCounterMode`` over a plain run; fp32 SIMT peak, TF32
   off; bf16 cells at the bf16 peak), peak memory, and for training the
   in-place update's own extra peak (held to 2 x the largest leaf's f32
   size).
12. SchNet's four training cells (``gnn``) through ``build_cell("schnet",
   shape).compiled()`` at full published width (d_hidden 64, n_rbf 300,
   3 interactions, cutoff 10), Adam, random weights from a seed:
   ``full_graph_sm`` (2708 nodes, 10,556 edges, ``GNN_FULL_SM_STEPS``
   steps over which the loss must fall), ``molecule`` (128 molecules of
   30 atoms and 64 edges), ``minibatch_lg`` (batches of 1024 seeds drawn
   by ``NeighborSampler`` with fanout (15, 10) over a ``random_graph`` of
   232,965 nodes and 114,615,892 edges, its host ``sample``, feature
   gather and copy to the card timed per batch) and ``ogb_products``
   (2,449,029 nodes, its 61,859,140 edges cut to the largest 1 / 2^k
   whose step fits in ``CELL_MEM_SHARE`` of the card, planned from
   eager and captured probes at 2^-6 and 2^-5). Per cell: step ms
   captured and eager, edges a second, the bound by bytes and by
   operations (the GEMMs ``FlopCounterMode`` counts), peak memory,
   captured against eager after the same steps (2e-4), and two eager
   steps from one saved state held equal bit for bit.
13. The cells on a mesh (``sharded``): a real one-rank NCCL group and
   ``make_host_mesh((1, 1))``; each program built with the mesh (state
   and batches as DTensors laid out by the rule sets, the step run
   eagerly on them) against the mesh-less program from the same seed and
   batches: granite-moe-3b-a800m ``train_4k`` at full width and
   ``SHARD_GRANITE_LAYERS`` of its 32 layers, batch ``SHARD_GRANITE_BATCH``
   of 256, plain, with ``moe_local`` and with ``seq_par``;
   ``dlrm-mlperf`` ``train_batch`` (65,536 rows) with ``table_md``, its
   tables at ``SHARD_DLRM_SCALE_TABLES``; ``paper-ranking``
   ``serve_bulk`` (262,144 candidates) with ``serve_full_dp`` through the
   kernels; ``schnet`` ``molecule``. ``SHARD_STEPS`` steps each: losses
   and scores within fp32 2e-4, every state element within 2 · lr · steps
   (an f32 model's also 2e-4 on all but 0.1% of each leaf; granite's bf16
   share printed beside the mesh-less program run twice; bit equality
   printed). Beside it,
   as subprocesses on the host's cores, the dry run
   (``repro_torch.launch.dryrun``) of ``fm × serve_p99 × single`` and
   ``granite-moe-3b-a800m × train_4k × single --opts moe_local`` on a
   fake 256-rank group; both records printed (``sharded_dryrun``).

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
engines, their device-resident twins, phase 3b's D = 128 engine
(``din128_engine``) and single calls (``din128_single``), the
phase-4 service, that service
under the preset's default hedging, train + convert, the paper's single
call, in phase 6 the device-tier service, its re-stacking twin, the
fault run and the hedged engine, phase 7's memory-tier engines,
phase 8's runner workers (each worker zeroes and reads its own counts
around its sharded engine's work and reports them), phase 9's three
``reorg`` engines and its single calls (``table3``), phase 10's
prefill and decode runs (``lm``, held to no launch), phase 11's
kernel serving calls (``cells``), phase 12's training steps (``gnn``,
held to no launch) and phase 13's programs on the mesh (``sharded``),
each its own path.
Every kernel variant held to a path must have launched on it; runs made only to compare (the
plain engines, phase 1's checks, per-request oracles) count nowhere, but
for phase 1's checks of the generic ``gather_einsum`` route, its only
runner (path ``generic``).
Every path hands ``mari_matmul`` and ``din_attention``'s wide route
prepared weights: weights prepared inside a call (each wrapper's
``PREPARES``) must be 0 on each path, and x copies to a padded row stride
(``STRIDE_COPIES``) are printed per path (``mari_matmul_host_by_path``).
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
import functools
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

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
# the serve_bf16 cells' batches (phase 11), at which mari_matmul's bf16
# entry is held at every MARI_SHAPES stream
MARI_BF16_BATCHES = (512, 262_144, 1_000_000)
PEAK_BYTES_S = 3.35e12                # H100 SXM HBM3
POOLS = (1000, 3000, 5000)            # straddle max_batch = 4096
SERVED = ("dlrm-mlperf", "deepfm", "fm")
DLRM_SCALE_TABLES = 0.1               # 96.1 GB of published tables -> 9.6 GB
TRAIN_STEPS, CKPT_EVERY, FAIL_AT = 24, 10, 15   # crash after the step-10 save
TRAIN_COMPARE = 10                    # captured vs eager steps, same batches
SINGLE_CALL_B = 2048                  # candidates of one single-call request
# phase 3b, DIN at its public D = 128: the item vocabulary (10M -> 1M), the
# coalesced engine's pool and the single call's timed calls
DIN128_VOCAB, DIN128_POOL, DIN128_CALLS = 1_000_000, 1000, 30
# din_attention past the 920 keys one block once held, at DIN width
DIN_LONG_L, DIN_LONG_B = (921, 2048, 10_000), 512
# din_attention's wide route: DIN's public width (github.com/zhougr1993/
# DeepInterestNetwork, din/model.py: item and category embeddings of 64
# each, an 80-40 attention MLP), timed; and the widths checked past the
# register tiles (D, h1, h2 each past its tile, all of them, the widest)
DIN_WIDE = (128, 80, 40)
DIN_WIDE_CHECKED = ((65, 129, 65), (256, 512, 256), (18, 2048, 1024),
                    (1024, 80, 40))
# gather_einsum's generic route: specs past KERNEL_SPECS (with a dim
# summed in x alone, one in the table alone, and a multi-head target
# attention's scores and pool), held bit for bit to the route as commit
# 521130a built it (its source under tests/data)
GENERIC_SPECS = ("bd,uldh->bhl", "bi,uij->bj", "bij,uj->bi", "bl,ul->bl",
                 "bd,ud->b", "bdk,ukh->bdh", "bx,uy->bxy", "bij,uj->b",
                 "bi,uij->bi", "bhd,ulhd->bhl", "bhl,ulhd->bhd")
GENERIC_PARENT = os.path.join("tests", "data", "gather_einsum_521130a.cu")
# builds of a kernel's source with one part left out or swapped, timed
# beside it: name -> (source, macros)
VARIANTS = {"gather_einsum": ("gather_einsum", ("GATHER_EINSUM_NO_ROW_SORT",)),
            "din_attention": ("din_attention", ("DIN_ATTENTION_GUARDED_ONLY",)),
            "dot_interaction": ("dot_interaction",
                                ("DOT_INTERACTION_RING_ONLY",))}
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
# phase 8, distributed serving: 4 users of ~1500 candidates each, so
# coalesced packs fill 4096-row buckets, 2048 rows per shard on two ranks
DIST_POOL, DIST_USERS, DIST_PASSES, DIST_TIMEOUT = 6000, 4, 300, 300
MULTI_HOT = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1,
             6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3, 1, 1)
# phase 9, the paper's Tables 2 and 3: the reference's bench_table2 /
# bench_table3 points (benchmarks/run.py) at scale 1.0. Table 2: (point,
# B, WeightPartition(D_user, D_item, D_cross, D_hidden)); Table 3: B,
# D_user, D_item, D_hidden and the chunk widths of the interleaved layout
T2_POINTS = (
    [(f"varyB/B={b}", b, (4000, 1000, 1000, 512)) for b in (100, 500, 1000,
                                                           2000)]
    + [(f"varyDu/Du={u}", 2000, (u, 1000, 0, 512))
       for u in (500, 1000, 2000, 4000, 8000)]
    + [(f"varyDrest/Drest={r}", 2000, (4000, r, 0, 512))
       for r in (500, 1000, 2000, 5000)]
    + [(f"varyDhid/Dhid={h}", 2000, (4000, 1000, 0, h))
       for h in (128, 512, 1024, 2048)])
T3_B, T3_DU, T3_DI, T3_D = 2000, 4000, 1000, 256
T3_CHUNKS = (50, 100, 200, 400, 800)
# the §2.4 path: Table 3's setting as a graph, its inputs the chunks of
# width 100 that the reference's loop forms; warm passes per engine, the
# three engines taking turns in each round
REORG_CHUNK, REORG_WARM_PASSES = 100, 300
EXAMPLES_TIMEOUT = 400
# phase 10, the LM family's serving path in bf16: granite-moe-3b-a800m at
# its full size, prefill_32k at batch 1 of the shape's 32 and decode_32k at
# batch 16 of its 128 (the shape's cache alone would be 275 GB); Mixtral
# 8x7B at full width, 4 of its 32 layers (93 GB in bf16 at full depth),
# long_500k's batch 1 over a ring of W = 4096 at positions past 524k
LM_GRANITE, LM_MIXTRAL = "granite-moe-3b-a800m", "mixtral-8x7b"
LM_PREFILL_BATCH, LM_DECODE_BATCH, LM_DECODE_STEPS = 1, 16, 32
LM_MIXTRAL_LAYERS, LM_LONG_STEPS, LM_RING_POS = 4, 64, 5119
LM_ORACLE_S, LM_MOE_T = 4096, 4096
# phase 11, the training and serving cells at full published width: timed
# calls after each program's first, granite's train_4k batch cut to the
# largest of 1..CELL_GRANITE_MAX_BATCH whose activations fit in
# CELL_MEM_SHARE of the card beside its 54 GB of state
CELL_REPLAYS, CELL_GRANITE_MAX_BATCH, CELL_MEM_SHARE = 5, 4, 0.92
# a captured step's private pool over the eager step's gradients and
# activations: 34.2 GB against 26.3 GB for granite at b = 4 on the card
CELL_POOL_GROWTH = 1.3
# granite at full width and cut depth for the in-place AdamW's slices: its
# (2, 40, 1536, 512) expert leaves and 49,408 x 1536 tables span 2-3 slices
CELL_SLICED_LAYERS, CELL_SLICED_STEPS = 2, 3
# phase 12, SchNet's four training cells at full published width: the
# captured steps over which full_graph_sm's loss must fall, and the two
# edge cuts of ogb_products (61,859,140 / 2^k) probed to plan its cut
GNN_FULL_SM_STEPS, GNN_OGB_PROBE_K = 30, (6, 5)
# eager minibatch_lg steps on the sampler's own padding and on pad_edges'
# spread, taking turns
GNN_PADDING_TURNS = 4
# phase 13, the cells on a one-rank mesh against the mesh-less programs:
# granite at full width cut to 2 layers and 2 sequences of 4096 (the
# comparison holds two states), DLRM's tables at 0.05 of their published
# rows (Adam state of both programs: 29 GB), two steps each; the dry-run
# subprocesses' time limit
SHARD_GRANITE_LAYERS, SHARD_GRANITE_BATCH = 2, 2
SHARD_DLRM_SCALE_TABLES, SHARD_STEPS, SHARD_DRYRUN_TIMEOUT = 0.05, 2, 600
SHARD_DRYRUNS = (("fm", "serve_p99", ()),
                 ("granite-moe-3b-a800m", "train_4k", ("moe_local",)))
# the serve cell and shape whose captured call phase 11 profiles once
CELL_PROFILED = ("recsys_paper_serve_bf16", "serve_bulk")
# phase 11's serve cells: (name, arch, opts, shapes, the shapes run only
# where the probe says they fit, the kernel entries each shape's serving
# calls must launch). serve_bf16 puts params and float feeds in bf16:
# dlrm-mlperf's 26 tables whole (187,767,399 published rows, 48.07 GB)
CELL_SERVES = (("recsys_paper_serve", "paper-ranking", (),
                ("serve_p99", "serve_bulk", "retrieval_cand"), (),
                ("mari_matmul/broadcast",)),
               ("recsys_din_serve", "din", ("attn_reparam",),
                ("serve_p99", "serve_bulk"), (), ("mari_matmul/broadcast",)),
               ("recsys_paper_serve_bf16", "paper-ranking", ("serve_bf16",),
                ("serve_p99", "serve_bulk", "retrieval_cand"), (),
                ("mari_matmul/bf16",)),
               ("recsys_din_serve_bf16", "din", ("serve_bf16",),
                ("serve_p99", "serve_bulk"), (),
                ("mari_matmul/bf16", "din_attention/bf16")),
               ("recsys_dlrm_serve_bf16", "dlrm-mlperf", ("serve_bf16",),
                ("serve_p99", "serve_bulk", "retrieval_cand"),
                ("retrieval_cand",),
                ("mari_matmul/bf16", "dot_interaction/bf16")))


def log(tag: str, **kv) -> None:
    print(json.dumps({"phase": tag, **kv}, default=str), flush=True)


# ---- phase 10: the LM family's serving path ---------------------------------

def lm_config(arch: str, **over):
    """The registry's config for ``arch`` with ``over`` replaced."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).CONFIG, **over)


def naive_attention(q, k, v, q_pos, kv_pos, window=None):
    """Causal masked softmax attention with the whole score matrix in fp32
    (the oracle of tests/test_flash_and_parser.py): (B, Sq, Hq, hd)."""
    import torch
    g = q.shape[2] // k.shape[2]
    kk = k.float().repeat_interleave(g, dim=2)
    vv = v.float().repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / (
        q.shape[-1] ** 0.5)
    dist = q_pos[:, :, None] - kv_pos[:, None, :]
    mask = dist >= 0
    if window is not None:
        mask &= dist < window
    logits = logits.masked_fill(~mask[:, None], -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), vv)


def bf16_vs_widened(got, want32, abs_sums, depth: int) -> dict:
    """A bf16 result whose f32 sums run in another order (the bf16
    tensor-core ``dot_interaction`` and ``gather_einsum`` ``bd,uldh->blh``)
    against the fp32 kernel's result on the widened operands, ``want32``.
    Counts the elements that are its rounding bit for bit, one bf16 ulp
    apart, and further apart. Further
    apart is a sum that cancels: the result is small beside the sum of
    its terms' magnitudes, ``abs_sums``, and bf16's ulp there is finer
    than the error of either f32 order, so such an element is held to
    one ulp plus the two orders' bound 2 * depth * 2^-24 * abs_sums.
    Raises if any element lies beyond that."""
    import torch
    torch.cuda.synchronize()
    got, want = got.float(), want32.bfloat16().float()
    err = (got - want).abs()
    big = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    far = err > ulp
    reorder = 2 * depth * 2.0 ** -24 * abs_sums.float()
    if bool((err > ulp + reorder).any()) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(
            f"bf16 result off the widened fp32 kernel's beyond one ulp and "
            f"the f32 reordering bound: max |d| {float(err.max()):.3e}")
    return dict(elements=got.numel(), same_bits=int((err == 0).sum()),
                one_ulp=int(((err > 0) & ~far).sum()), further=int(far.sum()),
                max_ulps=float((err / ulp).max()),
                max_further_over_reorder_bound=float(
                    (err[far] / reorder[far]).max()) if bool(far.any())
                else 0.0)


def din_scores_fp64(query, keys, mask, w1, b1, w2, b2, w3, b3):
    """The DIN unit's (B, L) scores before the mask, in fp64."""
    import torch
    q, k, w1, b1, w2, b2, w3, b3 = (t.double() for t in (
        query, keys, w1, b1, w2, b2, w3, b3))
    B, D = q.shape
    kk = k[None].expand(B, -1, -1)
    qq = q[:, None].expand(-1, k.shape[0], -1)
    h = torch.relu(torch.cat([kk, qq, kk - qq, kk * qq], -1) @ w1 + b1)
    return (torch.relu(h @ w2 + b2) @ w3 + b3)[..., 0]


def din_oracle_fp64(query, keys, mask, w1, b1, w2, b2, w3, b3):
    """``din_attention_plain``'s unit run in fp64 throughout (its mask
    constant, softmax over l, pool of the keys), for holding an fp32 run
    at scores in the hundreds."""
    import torch
    s = din_scores_fp64(query, keys, mask, w1, b1, w2, b2, w3, b3)
    s = torch.where(mask[None].bool(), s, torch.full_like(s, -1e30))
    return torch.softmax(s, dim=-1) @ keys.double()


def moe_loop_oracle(x, ffn, cfg):
    """``moe_ffn``'s capacity rule by a loop over tokens: each token's
    top-k choices in order, an expert keeping the first C (token, choice)
    pairs that reach it; each kept pair's SwiGLU in fp32 on the same bf16
    weights, weighted by its gate. Routing reads the same bf16 router
    product as the model. Returns (y in fp32, pairs dropped)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.models.transformer import moe_capacity
    T, D = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    C = moe_capacity(cfg, T)
    logits = (x @ ffn["router"].to(x.dtype)).float()
    topv, topi = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(topv, dim=-1)
    kept = [[] for _ in range(E)]
    dropped = 0
    for t, row in enumerate(topi.cpu().numpy()):
        for j, e in enumerate(row):
            if len(kept[e]) < C:
                kept[e].append((t, j))
            else:
                dropped += 1
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for e, pairs in enumerate(kept):
        if not pairs:
            continue
        tj = torch.as_tensor(np.asarray(pairs), device=x.device)
        xe = x[tj[:, 0]].float()
        h = F.silu(xe @ ffn["wg"][e].float()) * (xe @ ffn["wu"][e].float())
        y.index_add_(0, tj[:, 0], (h @ ffn["wd"][e].float())
                     * gates[tj[:, 0], tj[:, 1]][:, None])
    return y, dropped


def lm_prefill_flops(cfg, batch: int, seq: int, layers: int) -> int:
    """FLOPs of the reference's prefill: the projections, every attention
    block (masked ones included: 2·2·B·Hq·S²·hd), the MoE's router and its
    E·C expert rows (or the dense FFN), and the last token's lm_head."""
    from repro_torch.models.transformer import moe_capacity
    T, D, hd = batch * seq, cfg.d_model, cfg.hd
    hq, hkv, F_ = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    proj = 2 * T * D * (hq + 2 * hkv) * hd + 2 * T * hq * hd * D
    attn = 4 * batch * hq * seq * seq * hd
    if cfg.is_moe:
        E = cfg.moe_experts
        ffn = 2 * T * D * E + 6 * E * moe_capacity(cfg, T) * D * F_
    else:
        ffn = 6 * T * D * F_
    return layers * (proj + attn + ffn) + 2 * batch * D * cfg.vocab_padded


def lm_decode_cost(cfg, params, cache, batch: int) -> tuple[int, int]:
    """(bytes, FLOPs) one decode step must move and do: every weight but
    the embedding table read once (each expert gets C >= 1 rows, so all
    of them are read), B embedding rows, the whole cache read once, the
    new K/V and the logits written; the products over those rows and the
    attention over every cache slot."""
    from repro_torch.common import tree_bytes
    from repro_torch.models.transformer import moe_capacity
    L, _, W, hkv, hd = cache["k"].shape
    item = cache["k"].element_size()
    D, hq, F_, V = cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_padded
    embed = params["embed"]
    nbytes = (tree_bytes(params) - embed.numel() * embed.element_size()
              + batch * D * embed.element_size() + tree_bytes(cache)
              + 2 * L * batch * hkv * hd * item + batch * V * item)
    ffn_rows = (cfg.moe_experts * moe_capacity(cfg, batch) if cfg.is_moe
                else batch)
    flops = L * (2 * batch * D * (2 * hq + 2 * hkv) * hd
                 + 4 * batch * hq * W * hd + 6 * ffn_rows * D * F_
                 + (2 * batch * D * cfg.moe_experts if cfg.is_moe else 0)
                 ) + 2 * batch * D * V
    return nbytes, flops


def profile_call(fn) -> dict:
    """torch.profiler over one call: device busy ms (kernel self time)
    against the call's wall ms under the profiler, and the kernels taking
    the most device time (name, ms, count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1 - busy_ms / wall_ms if busy_ms else None,
                top_kernels=[[e.key[:70], e.self_device_time_total / 1e3,
                              e.count] for e in top])


def lm_phase(dev, counting) -> None:
    """Phase 10: the LM serving path at full width in bf16 (the cuts in
    the module constants). Oracles first (flash attention at granite's and
    Mixtral's head shapes against ``naive_attention``, ``moe_ffn`` at
    granite's width against ``moe_loop_oracle``), then granite's prefill
    and its decode captured and eager, then Mixtral's long_500k decode
    captured and eager and one ring step against a full cache. Prefill
    and decode runs are the ``lm`` path of the launch counts."""
    import numpy as np
    import torch
    from repro_torch.data.lm import token_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.launch.steps import build_cell

    t_phase = time.perf_counter()
    mem_at_start = torch.cuda.memory_allocated(dev) / 1e9
    bf16 = torch.bfloat16

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def max_err(a, b):
        a, b = a.float(), b.float()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("non-finite output")
        bad = (a - b).abs() > BF16_TOL["atol"] + BF16_TOL["rtol"] * b.abs()
        err = float((a - b).abs().max())
        if bool(bad.any()):
            raise AssertionError(f"outside bf16 tolerance: max |d| {err:.3e}")
        return err

    def bound(nbytes, flops):
        by_bytes, by_ops = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
        return (1e3 * max(by_bytes, by_ops),
                "bytes" if by_bytes >= by_ops else "operations")

    # -- oracles -----------------------------------------------------------
    oracles = {}
    for arch in (LM_GRANITE, LM_MIXTRAL):
        cfg = lm_config(arch)
        g = gen(1)
        S = LM_ORACLE_S
        q = torch.randn((1, S, cfg.n_heads, cfg.hd), generator=g, dtype=bf16,
                        device=dev)
        k, v = (torch.randn((1, S, cfg.n_kv_heads, cfg.hd), generator=g,
                            dtype=bf16, device=dev) for _ in range(2))
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
        with torch.inference_mode():
            got = tfm.flash_attention(q, k, v, pos, pos, window=cfg.window,
                                      q_chunk=cfg.q_chunk,
                                      kv_chunk=cfg.kv_chunk)
            want = naive_attention(q, k, v, pos, pos, cfg.window)
        oracles[f"flash_{arch}"] = max_err(got, want)
        del q, k, v, got, want
    cfg = lm_config(LM_GRANITE, n_layers=1)
    ffn = tfm.init_lm_params(cfg, seed=2, device=dev)["layers"]["ffn"]
    ffn = {name: w[0] for name, w in ffn.items()}
    g = gen(3)
    # a shared direction skews the routing, so experts overflow
    x = (torch.randn((LM_MOE_T, cfg.d_model), generator=g, device=dev)
         + 2 * torch.randn((cfg.d_model,), generator=g, device=dev)).to(bf16)
    with torch.inference_mode():
        got = tfm.moe_ffn(x, ffn, cfg)
    want, dropped = moe_loop_oracle(x, ffn, cfg)
    if dropped == 0:
        raise AssertionError("moe oracle input dropped no token")
    oracles["moe_granite"] = max_err(got, want)
    log("lm_oracles", tol=BF16_TOL, max_abs_err=oracles, seq=LM_ORACLE_S,
        memory_allocated_at_start_gb=mem_at_start,
        moe_tokens=LM_MOE_T, moe_capacity=tfm.moe_capacity(cfg, LM_MOE_T),
        moe_pairs_dropped=dropped)
    del ffn, x, got, want

    def decode_run(step, params, cache, toks, positions):
        """One step per position: logits and CUDA-event ms per step."""
        outs, ms = [], []
        for t, p in enumerate(positions):
            pos = torch.tensor(p, dtype=torch.int32, device=dev)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            logits, out = step(params, cache, toks[:, t:t + 1], pos)
            ev1.record()
            torch.cuda.synchronize()
            if out is not cache:
                raise AssertionError("decode returned another cache")
            outs.append(logits)
            ms.append(ev0.elapsed_time(ev1))
        return torch.stack(outs), ms

    def decode_both(name, cfg, prog, params, cache, batch, positions, seed):
        """The steps captured (``prog.compiled()``), then eager from the
        same cache (the slots the steps write restored first: a ring slot
        holds an older position until overwritten); logits held against
        each other, the graph built once."""
        toks = token_batch(gen(seed), batch, len(positions),
                           cfg.vocab)["tokens"]
        decode = prog.compiled(dev)

        def eager(params, cache, tok, pos):
            with torch.inference_mode():
                return tfm.lm_decode_step(params, cfg, cache, tok, pos)

        slots = torch.tensor(positions, device=dev) % cache["k"].shape[2]
        saved = {n: t[:, :, slots].clone() for n, t in cache.items()}
        with counting("lm"):
            got, ms_c = decode_run(decode, params, cache, toks, positions)
            for n, t in cache.items():
                t[:, :, slots] = saved[n]
            want, ms_e = decode_run(eager, params, cache, toks, positions)
        if decode.compilations != 1:
            raise AssertionError(f"{name}: {decode.compilations} graphs")
        last = (toks[:, -1:], torch.tensor(positions[-1], dtype=torch.int32,
                                           device=dev))
        profile = profile_call(lambda: decode(params, cache, *last))
        err = max_err(got, want)
        nbytes, flops = lm_decode_cost(cfg, params, cache, batch)
        bound_ms, bound_by = bound(nbytes, flops)
        p50_c, p50_e = float(np.median(ms_c[1:])), float(np.median(ms_e))
        log(f"lm_{name}_decode", batch=batch, cache=list(cache["k"].shape),
            positions=[positions[0], positions[-1]], steps=len(positions),
            compiled_ms_per_step=p50_c,
            compiled_ms_p10_p90=[float(np.percentile(ms_c[1:], q))
                                 for q in (10, 90)],
            first_call_ms=ms_c[0], eager_ms_per_step=p50_e,
            eager_ms_p10_p90=[float(np.percentile(ms_e, q))
                              for q in (10, 90)],
            tokens_per_s_compiled=batch * 1e3 / p50_c,
            tokens_per_s_eager=batch * 1e3 / p50_e,
            bound_ms=bound_ms, bound_by=bound_by, bytes_per_step=nbytes,
            flops_per_step=flops, compilations=decode.compilations,
            max_abs_compiled_vs_eager=err,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev)
            / 1e9)
        log(f"lm_{name}_decode_profile", position=positions[-1],
            captured=True, **profile)

    # -- granite-moe-3b-a800m at its full size -----------------------------
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = lm_config(LM_GRANITE)
    params = tfm.init_lm_params(cfg, seed=0, device=dev)
    prog = build_cell(LM_GRANITE, "prefill_32k")
    seq = prog.args[1].shape[1]
    prefill = prog.compiled(dev)
    toks = token_batch(gen(4), LM_PREFILL_BATCH, seq, cfg.vocab)["tokens"]
    prefill(params, toks[:, :cfg.kv_chunk])        # cuBLAS and kernels warm
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    with counting("lm"):
        t0 = time.perf_counter()
        ev0.record()
        logits, kv = prefill(params, toks)
        ev1.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    ms = ev0.elapsed_time(ev1)
    want_kv = (cfg.n_layers, LM_PREFILL_BATCH, seq, cfg.n_kv_heads, cfg.hd)
    if (tuple(logits.shape) != (LM_PREFILL_BATCH, cfg.vocab_padded)
            or tuple(kv["k"].shape) != want_kv
            or not all(bool(torch.isfinite(t).all())
                       for t in (logits, kv["k"], kv["v"]))):
        raise AssertionError(f"prefill: logits {tuple(logits.shape)}, "
                             f"kv {tuple(kv['k'].shape)} or non-finite")
    flops = lm_prefill_flops(cfg, LM_PREFILL_BATCH, seq, cfg.n_layers)
    from repro_torch.common import tree_bytes
    bound_ms, bound_by = bound(tree_bytes(params) + tree_bytes(kv), flops)
    log("lm_granite_prefill", batch=LM_PREFILL_BATCH, seq=seq, ms=ms,
        host_s=host_s, tokens_per_s=LM_PREFILL_BATCH * seq * 1e3 / ms,
        flops=flops, attention_flop_share=cfg.n_layers * 4 * LM_PREFILL_BATCH
        * cfg.n_heads * seq * seq * cfg.hd / flops, bound_ms=bound_ms,
        bound_by=bound_by, note="eager: prefill is not captured",
        params_gb=tree_bytes(params) / 1e9,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    # where a prefill's time goes, at an eighth of the sequence: the
    # profiler's events at 32k would be ~1.3M, and its host work grows
    # with them (~1 ms an event)
    short = toks[:, :seq // 8]
    log("lm_granite_prefill_profile", seq=seq // 8,
        **profile_call(lambda: prefill(params, short)))
    del logits, kv, toks, short
    gc.collect()
    torch.cuda.empty_cache()

    prog = build_cell(LM_GRANITE, "decode_32k")
    max_len = prog.args[1]["k"].shape[2]
    g = gen(5)
    shape = tfm.init_kv_cache(cfg, LM_DECODE_BATCH, max_len,
                              device="meta")["k"].shape
    cache = {n: torch.randn(shape, generator=g, dtype=bf16, device=dev)
             for n in ("k", "v")}
    decode_both("granite", cfg, prog, params, cache, LM_DECODE_BATCH,
                list(range(max_len - LM_DECODE_STEPS, max_len)), seed=6)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()

    # -- Mixtral-8x7B at full width, LM_MIXTRAL_LAYERS layers ----------------
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = lm_config(LM_MIXTRAL, n_layers=LM_MIXTRAL_LAYERS)
    params = tfm.init_lm_params(cfg, seed=7, device=dev)
    prog = build_cell(LM_MIXTRAL, "long_500k")
    batch, max_len = prog.args[2].shape[0], prog.args[1]["k"].shape[2]
    g = gen(8)
    shape = tfm.init_kv_cache(cfg, batch, 524288, device="meta")["k"].shape
    ring = {n: torch.randn(shape, generator=g, dtype=bf16, device=dev)
            for n in ("k", "v")}
    decode_both("mixtral", cfg, prog, params, ring, batch,
                list(range(524288 - LM_LONG_STEPS, 524288)), seed=9)
    # one step at LM_RING_POS through the ring (slot p % W holds position
    # p for the W - 1 positions before it) against a full cache holding
    # positions 0 .. LM_RING_POS - 1 at their own slots; both mask with
    # the window
    W = ring["k"].shape[2]
    full = {n: torch.randn((cfg.n_layers, batch, LM_RING_POS + 1,
                            cfg.n_kv_heads, cfg.hd), generator=g, dtype=bf16,
                           device=dev) for n in ("k", "v")}
    held = torch.arange(LM_RING_POS - W + 1, LM_RING_POS, device=dev)
    for n in ("k", "v"):
        ring[n][:, :, held % W] = full[n][:, :, held]
    tok = token_batch(gen(10), batch, 1, cfg.vocab)["tokens"]
    pos = torch.tensor(LM_RING_POS, dtype=torch.int32, device=dev)

    def step(cfg, params, cache):
        with torch.inference_mode():
            return tfm.lm_decode_step(params, cfg, cache, tok, pos)[0].float()

    # fp32 (the same bf16 draws, cast) holds the ring's slot-to-position
    # map and masking to 2e-4. In bf16 the step's own rounding is larger
    # than 2e-2 here: the full cache walked in 512-key chunks instead of
    # 1024 (the same semantics) moves the logits as far as the ring does,
    # so bf16 is printed beside that control and the fp32 step, not held
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    from repro_torch.common import tree_map
    to32 = lambda t: t.float()                             # noqa: E731
    p32 = tree_map(to32, params)
    got32 = step(cfg32, p32, tree_map(to32, ring))
    want32 = step(cfg32, p32, tree_map(to32, full))
    del p32
    err_fp32 = float((got32 - want32).abs().max())
    if not bool(((got32 - want32).abs() <= TOL["atol"]
                 + TOL["rtol"] * want32.abs()).all()):
        raise AssertionError(f"ring vs full in fp32: max |d| {err_fp32:.3e}")
    got, want = step(cfg, params, ring), step(cfg, params, full)
    chunk512 = step(dataclasses.replace(cfg, kv_chunk=cfg.kv_chunk // 2),
                    params, full)
    if not all(bool(torch.isfinite(t).all()) for t in (got, want, chunk512)):
        raise AssertionError("ring vs full: non-finite logits")

    def d(a, b):
        return float((a - b).abs().max())

    log("lm_mixtral_ring", pos=LM_RING_POS, window=cfg.window, ring_slots=W,
        full_slots=LM_RING_POS + 1, max_abs_ring_vs_full_fp32=err_fp32,
        fp32_tol=TOL, max_abs_ring_vs_full_bf16=d(got, want),
        max_abs_full_chunk_halved_bf16=d(chunk512, want),
        max_abs_ring_bf16_vs_fp32=d(got, want32),
        max_abs_full_bf16_vs_fp32=d(want, want32),
        max_abs_logit_fp32=float(want32.abs().max()))
    del params, ring, full, got, want, got32, want32, chunk512
    gc.collect()
    torch.cuda.empty_cache()
    log("lm_phase", seconds=time.perf_counter() - t_phase,
        cuts=[f"{LM_GRANITE} prefill_32k: batch {LM_PREFILL_BATCH} of 32",
              f"{LM_GRANITE} decode_32k: batch {LM_DECODE_BATCH} of 128 (the "
              f"shape's cache alone is 275 GB)",
              f"{LM_MIXTRAL} long_500k: {LM_MIXTRAL_LAYERS} of 32 layers "
              f"(93 GB of weights at full depth)"])


# ---- phase 11: the training and serving cells -------------------------------

def lm_train_flops(cfg, batch: int, seq: int) -> int:
    """FLOPs of one training step of the reference's algorithm: the
    layers' forward four times (forward, the remat recompute, a backward
    of twice the forward; attention blocks masked ones included, the MoE's
    E·C expert rows) and the lm_head over every token three times."""
    head = 2 * batch * seq * cfg.d_model * cfg.vocab_padded
    layers = (lm_prefill_flops(cfg, batch, seq, cfg.n_layers)
              - 2 * batch * cfg.d_model * cfg.vocab_padded)
    return 4 * layers + 3 * head


def device_feeds(arch: str, metas: dict, gen, graph=None) -> dict:
    """Random feeds on ``gen``'s device at the shapes and dtypes of a cell
    program's meta feeds: ids uniform over the consuming table's rows (of
    ``graph``, else of ``arch``'s configured build)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.features import _vocab_for_input
    if graph is None:
        graph, _ = get_config(arch).BUILD()
    out = {}
    for name, m in metas.items():
        if m.dtype.is_floating_point:
            out[name] = torch.randn(m.shape, generator=gen, dtype=m.dtype,
                                    device=gen.device)
        else:
            vocab = _vocab_for_input(graph, name) or 1000
            out[name] = torch.randint(0, vocab, m.shape, generator=gen,
                                      dtype=m.dtype, device=gen.device)
    return out


def serve_bytes(arch: str, params: dict, feeds: dict, out) -> int:
    """Bytes one serving call must move: every weight but the embedding
    tables read once, each table row the call's ids name read once, the
    feeds read once and the scores written once."""
    from repro_torch.common import tree_bytes
    from repro_torch.configs import get_config
    graph, _ = get_config(arch).BUILD()
    nbytes = (tree_bytes(params) + tree_bytes(feeds)
              + out.numel() * out.element_size())
    for n in graph.param_nodes():
        if n.op == "embedding" and n.inputs[0] in feeds:
            table = params[n.name]["table"]
            rows = feeds[n.inputs[0]].numel()
            nbytes += (rows - table.shape[0]) * table.shape[1] * \
                table.element_size()
    return nbytes


def adam_state_gap(a, b, lr: float, steps: int) -> dict:
    """Two Adam states' leaves (DTensors read whole) against each other:
    max |a - b|, the largest share of a leaf off by more than 2e-4 (bf16
    leaves: one ulp, 2^-7 |b|, plus 1e-6) and the leaf it is in, and
    whether any element lies beyond 2 · lr · steps of that (Adam moves a
    near-zero gradient's element by ~lr whatever its sign)."""
    import torch
    from repro_torch.common import tree_leaves
    gap = dict(max_abs=0.0, share_off=0.0, leaf=None, beyond_2_lr_steps=False)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = (t.full_tensor() if hasattr(t, "full_tensor") else t
                for t in (x, y))
        tol = (2 ** -7 * y.float().abs() + 1e-6
               if y.dtype == torch.bfloat16
               else 2e-4 + 2e-4 * y.float().abs())
        d = (x.float() - y.float()).abs()
        gap["max_abs"] = max(gap["max_abs"], float(d.max()))
        share = float((d > tol).float().mean())
        if share > gap["share_off"]:
            gap["share_off"], gap["leaf"] = share, list(y.shape)
        gap["beyond_2_lr_steps"] |= bool((d > 2 * lr * steps + tol).any())
    return gap


def adam_state_diff(a, b, lr: float, steps: int, name: str
                    ) -> tuple[float, float]:
    """``adam_state_gap``, held: no element beyond 2 · lr · steps and at
    most 0.1% of each leaf off. Returns (max |a - b|, largest share)."""
    gap = adam_state_gap(a, b, lr, steps)
    if gap["beyond_2_lr_steps"] or gap["share_off"] > 1e-3:
        raise AssertionError(f"{name}: {gap}")
    return gap["max_abs"], gap["share_off"]


def cells_phase(dev, counting) -> None:
    """Phase 11: every training cell and the serving cells through
    ``build_cell(...).compiled()`` at full published width (the cuts in
    ``CELL_*``). Per cell: step ms (p50 over ``CELL_REPLAYS`` calls after
    the first) captured and eager, rows or tokens a second, the bound by
    bytes and by operations, peak memory, the in-place update's own
    extra peak, and captured against eager. The kernel serving calls are
    the ``cells`` path of the launch counts."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.common import tree_bytes, tree_leaves, tree_map
    from repro_torch.common import value_and_grad
    from repro_torch.data.lm import token_batch
    from repro_torch.kernels import read_launches
    from repro_torch.launch.steps import build_cell

    t_phase = time.perf_counter()
    gb = 1e9
    props = torch.cuda.get_device_properties(dev)

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def timed(fn):
        """(fn(), CUDA-event ms)."""
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = fn()
        ev1.record()
        torch.cuda.synchronize()
        return out, ev0.elapsed_time(ev1)

    def bound(nbytes, flops, peak):
        by_bytes, by_ops = nbytes / PEAK_BYTES_S, flops / peak
        return dict(bound_ms=1e3 * max(by_bytes, by_ops),
                    bound_by="bytes" if by_bytes >= by_ops else "operations",
                    bytes=nbytes, flops=flops)

    def p50(ms):
        return dict(p50=float(np.median(ms)),
                    p10_p90=[float(np.percentile(ms, q)) for q in (10, 90)])

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def update_peak(prog, state, feeds):
        """Extra bytes the in-place update allocates over what is live
        (the state and the gradients): gradients first, then the update
        alone."""
        _, grads = value_and_grad(lambda p: prog.loss_fn(p, feeds),
                                  state["params"])
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        prog.opt.update_(grads, state["opt"], state["params"])
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated(dev) - live
        largest = max(t.numel() for t in tree_leaves(state["params"])) * 4
        if extra > 2 * largest:
            raise AssertionError(f"the update's extra peak {extra} B is "
                                 f"above 2 x the largest leaf's f32 size")
        return dict(update_extra_peak_gb=extra / gb,
                    largest_leaf_f32_gb=largest / gb)

    def max_diff(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    # -- lm_granite_train: granite-moe-3b-a800m at its full size -----------
    fresh()
    prog = build_cell(LM_GRANITE, "train_4k")
    cfg = lm_config(LM_GRANITE)
    global_batch, seq = prog.args[1]["tokens"].shape
    state = prog.init(seed=11, device=dev)
    state_bytes = tree_bytes(state)
    grads_bytes = tree_bytes(state["params"])
    vocab = cfg.vocab

    def lm_batch(i, b):
        return token_batch(gen(200 + i), b, seq, vocab)

    # one sequence, the gradients and the update apart: activations per
    # sequence, a no-grad forward's transient memory (the loss check's)
    # and the update's own peak
    probe = lm_batch(0, 1)
    live = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    (_, grads), fb_ms = timed(lambda: value_and_grad(
        lambda p: prog.loss_fn(p, probe), state["params"]))
    act = torch.cuda.max_memory_allocated(dev) - live - grads_bytes
    del grads
    upd = update_peak(prog, state, probe)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        prog.loss_fn(state["params"], probe)
    fwd = torch.cuda.max_memory_allocated(dev) - live
    # the captured step's pool (gradients and activations, grown) and
    # the loss check's no-grad forward beside the state
    room = (CELL_MEM_SHARE * props.total_memory - live
            - CELL_POOL_GROWTH * grads_bytes)
    b = max(1, min(CELL_GRANITE_MAX_BATCH,
                   int(room // (CELL_POOL_GROWTH * act + fwd))))
    log("cell_lm_granite_train_probe", batch=1, seq=seq,
        state_gb=state_bytes / gb, grads_gb=grads_bytes / gb,
        activations_per_sequence_gb=act / gb,
        no_grad_forward_gb=fwd / gb, card_gb=props.total_memory / gb,
        forward_backward_ms=fb_ms, batch_chosen=b, **upd)
    fresh()
    eager_ms, eager_loss = [], []
    for i in range(CELL_REPLAYS):
        # [1]: the metrics only (a name bound to the returned state would
        # keep 47 GB alive past this cell)
        m, ms = timed(lambda: prog.step_fn(state, lm_batch(i, b))[1])
        eager_ms.append(ms)
        eager_loss.append(float(m["loss"]))
    peak_eager = torch.cuda.max_memory_allocated(dev)
    log("cell_lm_granite_train_eager", batch=b, eager_ms=eager_ms,
        losses=eager_loss, peak_gb=peak_eager / gb)
    fresh()
    steps_before = int(state["opt"]["step"])
    step = prog.compiled(dev)
    cap_ms, cap_loss, loss_pairs = [], [], []
    for i in range(1 + CELL_REPLAYS):
        batch = lm_batch(100 + i, b)
        if i in (0, CELL_REPLAYS):
            with torch.no_grad():
                want = float(prog.loss_fn(state["params"], batch))
        m, ms = timed(lambda: step(state, batch)[1])
        cap_ms.append(ms)
        cap_loss.append(float(m["loss"]))
        if i in (0, CELL_REPLAYS):
            loss_pairs.append((cap_loss[-1], want))
    if step.compilations != 1 or step.state is not state:
        raise AssertionError(f"granite train: {step.compilations} graphs")
    if not np.all(np.isfinite(eager_loss + cap_loss)):
        raise AssertionError(f"granite train: non-finite loss")
    d_loss = max(abs(c - e) for c, e in loss_pairs)
    if not all(abs(c - e) <= BF16_TOL["atol"] + BF16_TOL["rtol"] * abs(e)
               for c, e in loss_pairs):
        raise AssertionError(f"granite train: captured vs eager loss "
                             f"{loss_pairs}")
    if int(state["opt"]["step"]) != steps_before + 1 + CELL_REPLAYS:
        raise AssertionError(f"granite train: {1 + CELL_REPLAYS} captured "
                             f"calls took "
                             f"{int(state['opt']['step']) - steps_before} "
                             f"optimizer steps")
    c50, e50 = p50(cap_ms[1:]), p50(eager_ms)
    log("cell_lm_granite_train", arch=LM_GRANITE, shape="train_4k",
        seq=seq, batch=b, layers=cfg.n_layers,
        reduced=[f"global_batch {global_batch} -> {b} (the largest of 1.."
                 f"{CELL_GRANITE_MAX_BATCH} whose captured step and loss "
                 f"check fit beside the state)"],
        state_gb=state_bytes / gb, grads_gb=grads_bytes / gb,
        activations_per_sequence_gb=act / gb, **upd,
        captured_ms=c50, first_call_ms=cap_ms[0], eager_ms=e50,
        captured_over_eager=c50["p50"] / e50["p50"],
        tokens_per_s_captured=b * seq * 1e3 / c50["p50"],
        tokens_per_s_eager=b * seq * 1e3 / e50["p50"],
        **bound(2 * state_bytes + 2 * b * seq * 4,
                lm_train_flops(cfg, b, seq), PEAK_BF16_FLOPS),
        peak_gb=max(peak_eager, torch.cuda.max_memory_allocated(dev)) / gb,
        peak_eager_gb=peak_eager / gb,
        peak_captured_gb=torch.cuda.max_memory_allocated(dev) / gb,
        graph_reserved_gb=step.run.pool.reserved_bytes / gb,
        compilations=step.compilations, losses_eager=eager_loss,
        losses_captured=cap_loss,
        captured_vs_eager_loss=loss_pairs, max_abs_loss=d_loss,
        tol=BF16_TOL)
    del state, step, prog, probe
    fresh()

    # -- lm_granite_sliced_update: AdamW's in-place slices, captured --------
    from repro_torch.launch.steps import _lm_train
    from repro_torch.train.optim import SLICE, apply_updates

    cfg_cut = lm_config(LM_GRANITE, n_layers=CELL_SLICED_LAYERS)
    prog = _lm_train(cfg_cut, seq, 1)
    lr = 3e-4                            # _lm_train's AdamW
    state = prog.init(seed=12, device=dev)
    sizes = [t.numel() for t in tree_leaves(state["params"])]
    slices = sum(-(-n // SLICE) for n in sizes if n > SLICE)
    if slices < 2:
        raise AssertionError(f"granite sliced update: no leaf over "
                             f"{SLICE} elements")
    master0 = tree_map(torch.clone, state["opt"]["master"])
    # one update from the same gradients: in place against functional
    probe = tree_map(torch.clone, state)
    batch = lm_batch(500, 1)
    _, grads = value_and_grad(lambda p: prog.loss_fn(p, batch),
                              probe["params"])
    updates, func_opt = prog.opt.update(grads, probe["opt"], probe["params"])
    func = {"params": apply_updates(probe["params"], updates),
            "opt": func_opt}
    del updates
    prog.opt.update_(grads, probe["opt"], probe["params"])
    d_func = adam_state_diff(probe, func, lr, 1, "granite sliced update")
    del probe, func, func_opt, grads
    fresh()
    # CELL_SLICED_STEPS captured steps against eager() from one state
    twin = tree_map(torch.clone, state)
    step = prog.compiled(dev)
    for i in range(CELL_SLICED_STEPS):
        batch = lm_batch(510 + i, 1)
        step(state, batch)
        step.eager(twin, batch)
    d_cap = adam_state_diff(state, twin, lr, CELL_SLICED_STEPS,
                            "granite sliced update")
    moved = min(float((w - w0).abs().max()) for w, w0 in zip(
        tree_leaves(state["opt"]["master"]), tree_leaves(master0)))
    if (step.compilations != 1 or moved == 0.0
            or int(state["opt"]["step"]) != CELL_SLICED_STEPS
            or int(twin["opt"]["step"]) != CELL_SLICED_STEPS):
        raise AssertionError(f"granite sliced update: "
                             f"{step.compilations} graphs, steps "
                             f"{int(state['opt']['step'])} / "
                             f"{int(twin['opt']['step'])}, least master "
                             f"move {moved}")
    log("cell_lm_granite_sliced_update", arch=LM_GRANITE, seq=seq, batch=1,
        layers=CELL_SLICED_LAYERS,
        reduced=[f"{cfg.n_layers} layers -> {CELL_SLICED_LAYERS} (width "
                 f"kept: the expert leaves span two slices)"],
        slice_elements=SLICE, largest_leaf_elements=max(sizes),
        sliced_leaves=sum(n > SLICE for n in sizes), slices=slices,
        inplace_vs_functional_max_abs=d_func[0],
        inplace_vs_functional_share_off=d_func[1],
        steps=CELL_SLICED_STEPS, captured_vs_eager_max_abs=d_cap[0],
        captured_vs_eager_share_off=d_cap[1], least_master_move=moved,
        compilations=step.compilations,
        tol="2e-4 on all but 0.1% of each leaf (bf16: one ulp), every "
            "element within 2 lr steps")
    del state, twin, master0, step, prog
    fresh()

    # -- recsys train cells -------------------------------------------------
    def recsys_train_cell(name, arch, opts=()):
        fresh()
        prog = build_cell(arch, "train_batch", opts=opts)
        metas, labels_meta = prog.args[1], prog.args[2]
        B, n_out = labels_meta.shape

        def batch(i):
            g = gen(300 + i)
            feeds = device_feeds(arch, metas, g)
            labels = (torch.rand((B, n_out), generator=g, device=dev)
                      < 0.2).float()
            return feeds, labels

        state = prog.init(seed=0, device=dev)
        twin = tree_map(torch.clone, state)
        feeds0 = prog.pack(*batch(0))
        feed_bytes = tree_bytes(feeds0)
        with FlopCounterMode(display=False) as fc:
            value_and_grad(lambda p: prog.loss_fn(p, feeds0),
                           twin["params"])
        flops = fc.get_total_flops()
        del feeds0
        fresh()
        step = prog.compiled(dev)
        cap_ms, eager_ms = [], []
        for i in range(1 + CELL_REPLAYS):
            cap_ms.append(timed(lambda: step(state, *batch(i)))[1])
        peak_captured = torch.cuda.max_memory_allocated(dev)
        for i in range(1 + CELL_REPLAYS):
            eager_ms.append(timed(lambda: prog.step_fn(twin, *batch(i)))[1])
        peak = torch.cuda.max_memory_allocated(dev)
        d = max_diff(state, twin)
        if step.compilations != 1 or not all(
                torch.allclose(a.float(), b.float(), **TOL)
                for a, b in zip(tree_leaves(state), tree_leaves(twin))):
            raise AssertionError(f"{name}: captured vs eager state "
                                 f"{d:.3e}, {step.compilations} graphs")
        del step
        fresh()
        upd = update_peak(prog, twin, prog.pack(*batch(0)))
        c50, e50 = p50(cap_ms[1:]), p50(eager_ms[1:])
        log(f"cell_{name}", arch=arch, shape="train_batch", rows=B,
            opts=list(opts), reduced=[],
            state_gb=tree_bytes(state) / gb, feed_gb=feed_bytes / gb,
            captured_ms=c50, first_call_ms=cap_ms[0], eager_ms=e50,
            captured_over_eager=c50["p50"] / e50["p50"],
            rows_per_s_captured=B * 1e3 / c50["p50"],
            rows_per_s_eager=B * 1e3 / e50["p50"],
            **bound(2 * tree_bytes(state) + feed_bytes, flops,
                    PEAK_FP32_FLOPS),
            peak_gb=peak / gb, peak_captured_gb=peak_captured / gb, **upd,
            compilations=1, steps_compared=1 + CELL_REPLAYS,
            max_abs_captured_vs_eager_state=d, tol=TOL)

    recsys_train_cell("recsys_paper_train", "paper-ranking")
    recsys_train_cell("recsys_din_train", "din")
    recsys_train_cell("recsys_din_train_emb_bf16", "din", ("emb_bf16",))

    # -- recsys serve cells, through the kernels ------------------------------
    # a probed shape runs only if the bytes a row of the shape before
    # reserved (the most of the kernels' captured call, the plain captured
    # call and the plain eager call: a capture's private pool is reserved
    # beside the memory its warm-up run left cached), grown as a captured
    # pool grows, fit in CELL_MEM_SHARE of the card beside what is live
    from repro_torch.models.recsys import DLRM_TABLE_ROWS
    for name, arch, opts, shapes, probed, must_launch in CELL_SERVES:
        fresh()
        bf16 = "serve_bf16" in opts
        tol = BF16_TOL if bf16 else TOL
        params, per_row, t_init = None, 0.0, time.perf_counter()
        for shape in shapes:
            prog = build_cell(arch, shape, opts=opts)
            if params is None:
                params = prog.init(seed=0, device=dev)
                torch.cuda.synchronize()
                t_init = time.perf_counter() - t_init
                init_peak = torch.cuda.max_memory_allocated(dev)
            metas = prog.args[1]
            B = max(m.shape[0] for m in metas.values())
            fresh()
            live = torch.cuda.memory_reserved(dev)
            need = live + CELL_POOL_GROWTH * per_row * B
            if shape in probed and need > CELL_MEM_SHARE * props.total_memory:
                log(f"cell_{name}", arch=arch, shape=shape, rows=B,
                    opts=list(opts), skipped=True,
                    reason=f"probe: {need / gb:.2f} GB planned (live "
                           f"{live / gb:.2f} + {CELL_POOL_GROWTH} x "
                           f"{per_row / 1e3:.2f} kB a row at the shape "
                           f"before) > "
                           f"{CELL_MEM_SHARE} of {props.total_memory / gb:.2f}"
                           f" GB", params_gb=tree_bytes(params) / gb)
                continue
            feeds = device_feeds(arch, metas, gen(400))
            torch.cuda.reset_peak_memory_stats(dev)
            serve = prog.compiled(dev)
            with counting("cells"):
                got, first_ms = timed(lambda: serve(params, feeds))
                cap_ms = [timed(lambda: serve(params, feeds))[1]
                          for _ in range(CELL_REPLAYS)]
                torch.cuda.synchronize()
                launched = {k: v for k, v in read_launches().items() if v}
            peak = torch.cuda.max_memory_allocated(dev)
            reserved = [torch.cuda.max_memory_reserved(dev)]
            # the paper model's bf16 bulk call profiled once: the share of
            # its device time that mari_matmul's bf16 entry takes
            prof = ({"profile": profile_call(lambda: serve(params, feeds))}
                    if (name, shape) == CELL_PROFILED else {})
            del serve
            fresh()
            plain = prog.compiled(dev, use_pallas=False)
            want_c, _ = timed(lambda: plain(params, feeds))
            plain_ms = [timed(lambda: plain(params, feeds))[1]
                        for _ in range(CELL_REPLAYS)]
            peak_plain = torch.cuda.max_memory_allocated(dev)
            reserved.append(torch.cuda.max_memory_reserved(dev))
            del plain
            fresh()
            with FlopCounterMode(display=False) as fc:
                want = prog.step_fn(params, feeds)
            eager_ms = [timed(lambda: prog.step_fn(params, feeds))[1]
                        for _ in range(CELL_REPLAYS)]
            peak_eager = torch.cuda.max_memory_allocated(dev)
            reserved.append(torch.cuda.max_memory_reserved(dev))
            per_row = (max(reserved) - live) / B
            if (tuple(got.shape) != tuple(want.shape)
                    or not bool(torch.isfinite(got).all())
                    or not torch.allclose(got.float(), want.float(), **tol)
                    or not torch.allclose(got.float(), want_c.float(), **tol)
                    or not torch.allclose(want_c.float(), want.float(),
                                          **tol)):
                raise AssertionError(
                    f"{name} {shape}: kernels vs plain "
                    f"{float((got.float() - want.float()).abs().max()):.3e}")
            missing = [k for k in must_launch if not launched.get(k)]
            if missing:
                raise AssertionError(f"{name} {shape}: no launch of "
                                     f"{missing}: {launched}")
            c50, e50 = p50(cap_ms), p50(eager_ms)
            extra = {}
            if arch == "dlrm-mlperf":
                extra = dict(table_rows=sum(
                    p_["table"].shape[0] for p_ in params.values()
                    if isinstance(p_, dict) and "table" in p_),
                    published_table_rows=sum(DLRM_TABLE_ROWS),
                    params_gb=tree_bytes(params) / gb,
                    init_s=t_init, init_peak_gb=init_peak / gb)
            log(f"cell_{name}", arch=arch, shape=shape, rows=B,
                opts=list(opts), reduced=[],
                captured_ms=c50, first_call_ms=first_ms,
                captured_plain_ms=p50(plain_ms), eager_plain_ms=e50,
                eager_over_captured=e50["p50"] / c50["p50"],
                rows_per_s_captured=B * 1e3 / c50["p50"],
                **bound(serve_bytes(arch, params, feeds, got),
                        fc.get_total_flops(),
                        PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS),
                peak_gb=peak / gb, peak_plain_gb=peak_plain / gb,
                peak_eager_plain_gb=peak_eager / gb,
                peak_reserved_gb=max(reserved) / gb,
                reserved_gb_by_program=dict(zip(
                    ("kernels_captured", "plain_captured", "plain_eager"),
                    (r / gb for r in reserved))),
                reserved_kb_per_row=per_row / 1e3,
                feed_gb=tree_bytes(feeds) / gb, launches=launched,
                max_abs_kernels_vs_eager_plain=float(
                    (got.float() - want.float()).abs().max()),
                max_abs_kernels_vs_compiled_plain=float(
                    (got.float() - want_c.float()).abs().max()),
                max_abs_compiled_plain_vs_eager_plain=float(
                    (want_c.float() - want.float()).abs().max()), tol=tol,
                dtype="bfloat16" if bf16 else "float32", **extra, **prof)
            del feeds, got, want, want_c
        del params
    fresh()
    log("cells_phase", seconds=time.perf_counter() - t_phase,
        card_memory_gb=props.total_memory / gb)


# ---- phase 12: SchNet's training cells --------------------------------------

def gnn_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
              gen) -> dict:
    """A ``full`` cell's batch drawn on ``gen``'s device as
    ``data.sampler.random_graph`` draws it on the host (uniform senders
    and receivers, normal features, positions normal x 3, uniform labels),
    its edges padded to a multiple of 1024 with ``edge_mask`` False, as
    ``data.sampler.pad_edges`` pads (each pad edge a self-loop on its own
    node)."""
    import torch
    from repro_torch.launch.steps import _pad_up
    dev, e_pad = gen.device, _pad_up(n_edges)

    def ids(n, high):
        return torch.randint(0, high, (n,), generator=gen, dtype=torch.int32,
                             device=dev)

    pad = torch.arange(n_edges, e_pad, dtype=torch.int32,
                       device=dev) % n_nodes
    mask = torch.zeros(e_pad, dtype=torch.bool, device=dev)
    mask[:n_edges] = True
    return {"features": torch.randn((n_nodes, d_feat), generator=gen,
                                    device=dev),
            "positions": torch.randn((n_nodes, 3), generator=gen,
                                     device=dev) * 3.0,
            "senders": torch.cat([ids(n_edges, n_nodes), pad]),
            "receivers": torch.cat([ids(n_edges, n_nodes), pad]),
            "edge_mask": mask, "labels": ids(n_nodes, n_classes)}


def gnn_phase(dev, counting) -> None:
    """Phase 12: SchNet's four training cells through
    ``build_cell("schnet", shape).compiled()`` at full published width
    (d_hidden 64, n_rbf 300, 3 interactions, cutoff 10); the one cut, of
    ``ogb_products``' edges, planned from probes' measured bytes. Per
    cell: step ms (p50 over the calls after the first) captured and eager,
    edges a second, the bound by bytes and by operations
    (``FlopCounterMode`` counts the GEMMs, over the fp32 peak; the RBF's
    exp and the scatters are bytes), peak memory, captured against eager
    after the same steps (2e-4), two eager steps from one saved state bit
    for bit, finite losses, falling over ``GNN_FULL_SM_STEPS`` steps on
    ``full_graph_sm``; ``minibatch_lg`` also times the host's sampling,
    feature gather and copy to the card per batch. Every step run is the
    ``gnn`` path of the launch counts, held to none of the six kernels."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.common import tree_bytes, tree_leaves, tree_map
    from repro_torch.common import value_and_grad
    from repro_torch.configs import get_config
    from repro_torch.data import sampler
    from repro_torch.launch.steps import _pad_up, build_cell

    t_phase = time.perf_counter()
    gb = 1e9
    props = torch.cuda.get_device_properties(dev)
    n_rbf = get_config("schnet").CONFIG.n_rbf

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def timed(fn):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = fn()
        ev1.record()
        torch.cuda.synchronize()
        return out, ev0.elapsed_time(ev1)

    def p50(ms):
        return dict(p50=float(np.median(ms)),
                    p10_p90=[float(np.percentile(ms, q)) for q in (10, 90)])

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def on_card(batch):
        return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    def run_cell(shape, batches, n_steps, cut_edges=False):
        """The cell's checks and timings over ``batches`` (cycled): the
        batches have the program's shapes and dtypes (``cut_edges``: all
        but the edge arrays' length)."""
        fresh()
        prog = build_cell("schnet", shape)
        metas = prog.args[1]
        for b in batches:
            for k, m in metas.items():
                want = tuple(m.shape)
                if cut_edges and k in ("senders", "receivers", "edge_mask"):
                    want = tuple(b[k].shape)
                if tuple(b[k].shape) != want or b[k].dtype != m.dtype:
                    raise AssertionError(
                        f"gnn {shape}: batch {k} {tuple(b[k].shape)} "
                        f"{b[k].dtype}, the cell's {tuple(m.shape)} "
                        f"{m.dtype}")
        n_nodes = metas["positions"].shape[0]
        n_edges = batches[0]["senders"].shape[0]
        real_edges = float(np.mean([int(b["edge_mask"].sum())
                                    for b in batches]))
        saved = prog.init(seed=0, device=dev)
        # two eager steps from one saved state: bit for bit
        runs = []
        with counting("gnn"):
            for _ in range(2):
                s = tree_map(torch.clone, saved)
                _, m = prog.step_fn(s, batches[0])
                runs.append((m["loss"], s))
        repeat = torch.equal(runs[0][0], runs[1][0]) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(runs[0][1]),
                                              tree_leaves(runs[1][1])))
        if not repeat:
            d = max(float((a - b).abs().max()) for a, b in zip(
                tree_leaves(runs[0][1]), tree_leaves(runs[1][1])))
            raise AssertionError(f"gnn {shape}: two eager steps from one "
                                 f"state differ by {d:.3e}")
        del runs, s
        fresh()
        with FlopCounterMode(display=False) as fc:
            value_and_grad(lambda p: prog.loss_fn(p, batches[0]),
                           saved["params"])
        flops = fc.get_total_flops()
        # where an eager step's device time goes (its kernels by name)
        s = tree_map(torch.clone, saved)
        with counting("gnn"):
            prof = profile_call(lambda: prog.step_fn(s, batches[0]))
        del s
        fresh()
        twin = tree_map(torch.clone, saved)
        eager_ms, eager_loss = [], []
        with counting("gnn"):
            for i in range(n_steps):
                m, ms = timed(lambda: prog.step_fn(
                    twin, batches[i % len(batches)])[1])
                eager_ms.append(ms)
                eager_loss.append(float(m["loss"]))
        peak_eager = torch.cuda.max_memory_allocated(dev)
        fresh()
        state = tree_map(torch.clone, saved)
        step = prog.compiled(dev)
        cap_ms, cap_loss = [], []
        with counting("gnn"):
            for i in range(n_steps):
                m, ms = timed(lambda: step(state,
                                           batches[i % len(batches)])[1])
                cap_ms.append(ms)
                cap_loss.append(float(m["loss"]))
        peak_cap = torch.cuda.max_memory_allocated(dev)
        pairs = list(zip(tree_leaves(state), tree_leaves(twin)))
        d_state = max(float((a - b).abs().max()) for a, b in pairs)
        d_loss = max(abs(a - b) for a, b in zip(cap_loss, eager_loss))
        if step.compilations != 1 or not all(
                torch.allclose(a, b, **TOL) for a, b in pairs) or not all(
                abs(a - b) <= TOL["atol"] + TOL["rtol"] * abs(b)
                for a, b in zip(cap_loss, eager_loss)):
            raise AssertionError(f"gnn {shape}: captured vs eager state "
                                 f"{d_state:.3e}, loss {d_loss:.3e}, "
                                 f"{step.compilations} graphs")
        if not np.all(np.isfinite(cap_loss + eager_loss)):
            raise AssertionError(f"gnn {shape}: non-finite loss")
        if int(state["opt"]["step"]) != n_steps:
            raise AssertionError(f"gnn {shape}: {n_steps} captured calls "
                                 f"took {int(state['opt']['step'])} steps")
        c50, e50 = p50(cap_ms[1:]), p50(eager_ms[1:])
        # the state read and written once, the batch read once, the loss
        nbytes = 2 * tree_bytes(saved) + tree_bytes(batches[0]) + 4
        by_bytes, by_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
        bound_ms = 1e3 * max(by_bytes, by_ops)
        out = dict(
            arch="schnet", shape=shape, nodes=n_nodes, edges_padded=n_edges,
            real_edges=real_edges, steps=n_steps,
            captured_ms=c50, first_call_ms=cap_ms[0], eager_ms=e50,
            eager_over_captured=e50["p50"] / c50["p50"],
            edges_per_s_captured=real_edges * 1e3 / c50["p50"],
            edges_per_s_eager=real_edges * 1e3 / e50["p50"],
            bound_ms=bound_ms,
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            bound_bytes_ms=1e3 * by_bytes, bound_ops_ms=1e3 * by_ops,
            bytes=nbytes, gemm_flops=flops,
            gemm_flops_per_edge=flops / n_edges,
            captured_over_bound=c50["p50"] / bound_ms,
            rbf_gb=n_edges * n_rbf * 4 / gb,
            state_gb=tree_bytes(saved) / gb,
            batch_gb=tree_bytes(batches[0]) / gb,
            peak_gb=max(peak_eager, peak_cap) / gb,
            peak_eager_gb=peak_eager / gb, peak_captured_gb=peak_cap / gb,
            graph_reserved_gb=step.run.pool.reserved_bytes / gb,
            compilations=step.compilations,
            losses_captured=cap_loss, losses_eager=eager_loss,
            max_abs_captured_vs_eager_state=d_state,
            max_abs_captured_vs_eager_loss=d_loss,
            eager_repeat_bit_for_bit=repeat, tol=TOL, eager_profile=prof)
        del state, twin, saved, step, prog
        fresh()
        return out

    shapes = get_config("schnet").SHAPES

    def padded_edges(shape):
        return build_cell("schnet", shape).args[1]["senders"].shape[0]

    # -- full_graph_sm: the whole graph, 2708 nodes, 10,556 edges -----------
    spec = shapes["full_graph_sm"]
    batch = on_card(sampler.pad_edges(sampler.random_graph(
        spec["n_nodes"], spec["n_edges"], spec["d_feat"], seed=0,
        n_classes=spec["n_classes"]), padded_edges("full_graph_sm")))
    r = run_cell("full_graph_sm", [batch], GNN_FULL_SM_STEPS)
    if not r["losses_captured"][-1] < r["losses_captured"][0]:
        raise AssertionError(f"gnn full_graph_sm: the loss did not fall "
                             f"over {GNN_FULL_SM_STEPS} steps: "
                             f"{r['losses_captured']}")
    log("gnn_full_graph_sm", reduced=[], **r)
    del batch

    # -- molecule: 128 molecules x 30 atoms, 64 edges each --------------------
    spec = shapes["molecule"]
    batches = [on_card(sampler.pad_edges(sampler.batched_molecules(
        spec["batch"], spec["n_nodes"], spec["n_edges"], seed=i),
        padded_edges("molecule"))) for i in range(1 + CELL_REPLAYS)]
    log("gnn_molecule", reduced=[],
        **run_cell("molecule", batches, 1 + CELL_REPLAYS))
    del batches

    # -- minibatch_lg: NeighborSampler batches over the published graph -----
    spec = shapes["minibatch_lg"]
    n = spec["n_nodes"]
    t = time.perf_counter()
    big = sampler.random_graph(n, spec["n_edges"], spec["d_feat"], seed=0,
                               n_classes=spec["n_classes"])
    t_graph = time.perf_counter() - t
    t = time.perf_counter()
    ns = sampler.NeighborSampler(big["senders"], big["receivers"], n,
                                 spec["fanout"])
    t_csr = time.perf_counter() - t
    rng = np.random.default_rng(0)
    n_edges = padded_edges("minibatch_lg")
    batches, host = [], {"sample_ms": [], "gather_ms": [], "h2d_ms": []}
    for _ in range(1 + CELL_REPLAYS):
        seeds = rng.choice(n, spec["batch_nodes"], replace=False)
        t0 = time.perf_counter()
        samp = ns.sample(seeds, rng)
        t1 = time.perf_counter()
        b = sampler.pad_edges(sampler.sampled_batch(big, samp), n_edges)
        t2 = time.perf_counter()
        batches.append(on_card(b))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        host["sample_ms"].append(1e3 * (t1 - t0))
        host["gather_ms"].append(1e3 * (t2 - t1))
        host["h2d_ms"].append(1e3 * (t3 - t2))
    # the last batch as the sampler pads it (every masked edge 0 -> its
    # last node), padded on with 0 -> 0 edges: pad_edges' spread beside it
    raw = dict(batches[-1])
    for k, a in (("senders", samp["senders"]),
                 ("receivers", samp["receivers"])):
        raw[k] = torch.zeros(n_edges, dtype=torch.int32, device=dev)
        raw[k][:len(a)] = torch.as_tensor(a, device=dev)
    del big, ns, b, samp
    gc.collect()
    r = run_cell("minibatch_lg", batches, 1 + CELL_REPLAYS)
    prog = build_cell("schnet", "minibatch_lg")
    saved = prog.init(seed=0, device=dev)
    padding = {"spread": ([], batches[-1]), "sampler": ([], raw)}
    with counting("gnn"):
        for turn in range(GNN_PADDING_TURNS):
            for name in ("spread", "sampler")[::1 - 2 * (turn % 2)]:
                s = tree_map(torch.clone, saved)
                m, ms = timed(lambda: prog.step_fn(s, padding[name][1])[1])
                padding[name][0].append((ms, float(m["loss"])))
    losses = {k: {x[1] for x in v[0]} for k, v in padding.items()}
    if losses["spread"] != losses["sampler"] or len(losses["spread"]) != 1:
        raise AssertionError(f"gnn minibatch_lg: the padding moved the "
                             f"loss: {losses}")
    del prog, saved, s, raw
    host_ms = float(np.median(np.add(host["sample_ms"], host["gather_ms"])))
    log("gnn_minibatch_lg", reduced=[], graph_build_s=t_graph,
        csr_build_s=t_csr, host_ms={k: p50(v) for k, v in host.items()},
        host_sample_gather_ms=host_ms,
        host_over_captured_step=host_ms / r["captured_ms"]["p50"],
        eager_ms_by_padding={k: p50([x[0] for x in v[0]])
                             for k, v in padding.items()},
        loss_by_padding={k: sorted(v) for k, v in losses.items()}, **r)
    del batches, padding

    # -- ogb_products: all 2,449,029 nodes, its edges cut to fit -------------
    spec = shapes["ogb_products"]
    full_e = spec["n_edges"]
    prog = build_cell("schnet", "ogb_products")

    def edges_at(k):
        return -(-full_e // 2 ** k)

    def probe(k):
        """Peak reserved bytes (state and batch included) of an eager step
        and of the captured step (warm-up, capture, a replay) at
        61,859,140 / 2^k edges."""
        fresh()
        batch = gnn_graph(spec["n_nodes"], edges_at(k), spec["d_feat"],
                          spec["n_classes"], gen(600 + k))
        state = prog.init(seed=0, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with counting("gnn"):
            prog.step_fn(state, batch)
            torch.cuda.synchronize()
            eager = torch.cuda.max_memory_reserved(dev)
            torch.cuda.empty_cache()
            step = prog.compiled(dev)
            for _ in range(2):
                step(state, batch)
            torch.cuda.synchronize()
        cap = torch.cuda.max_memory_reserved(dev)
        del step, state, batch
        fresh()
        return _pad_up(edges_at(k)), eager, cap

    t = time.perf_counter()
    (e1, a1, c1), (e2, a2, c2) = [probe(k) for k in GNN_OGB_PROBE_K]
    room = CELL_MEM_SHARE * props.total_memory

    def need(e):
        return max(a1 + (a2 - a1) / (e2 - e1) * (e - e1),
                   c1 + (c2 - c1) / (e2 - e1) * (e - e1))

    plan = {k: need(_pad_up(edges_at(k))) for k in range(GNN_OGB_PROBE_K[1])}
    k = min((k for k, b in plan.items() if b <= room), default=None)
    if k is None:
        raise AssertionError(f"gnn ogb_products: no cut fits {room} B: "
                             f"{plan}")
    t_plan = time.perf_counter() - t
    del prog
    batch = gnn_graph(spec["n_nodes"], edges_at(k), spec["d_feat"],
                      spec["n_classes"], gen(700))
    r = run_cell("ogb_products", [batch], 1 + CELL_REPLAYS, cut_edges=True)
    log("gnn_ogb_products", reduced=[
        f"edges {full_e:,} -> {edges_at(k):,} = {full_e:,} / 2^{k} (padded "
        f"to {_pad_up(edges_at(k)):,}): the largest 2^-k cut whose step "
        f"fits in {CELL_MEM_SHARE} of the card, planned from probes at "
        f"2^-{GNN_OGB_PROBE_K[0]} and 2^-{GNN_OGB_PROBE_K[1]}; nodes, "
        f"widths and classes whole"],
        cut_k=k, probes=[dict(edges=e, eager_reserved_gb=a / gb,
                              captured_reserved_gb=c / gb)
                         for e, a, c in ((e1, a1, c1), (e2, a2, c2))],
        planned_gb={f"2^-{kk}": b / gb for kk, b in plan.items()},
        room_gb=room / gb, plan_s=t_plan, **r)
    del batch
    fresh()
    log("gnn_phase", seconds=time.perf_counter() - t_phase,
        card_memory_gb=props.total_memory / gb)


def sharded_phase(dev, counting) -> None:
    """Phase 13: every builder on a one-rank NCCL mesh against its
    mesh-less program (the module docstring), and the dry run of two
    cells in subprocesses started first. The mesh's serving call is the
    ``sharded`` path of the launch counts."""
    import types

    import torch
    import torch.distributed as dist
    from repro_torch import configs as cfgreg
    from repro_torch.common import tree_leaves
    from repro_torch.data import sampler
    from repro_torch.data.features import _vocab_for_input
    from repro_torch.data.lm import token_batch
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=SRC)
    dryruns = [(arch, shape, opts, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single"]
        + (["--opts", ",".join(opts)] if opts else []),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)) for arch, shape, opts in SHARD_DRYRUNS]

    mesh = make_host_mesh((1, 1), device="cuda")
    backend = dist.get_backend()

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def full(t):
        return t.full_tensor() if sh.is_dtensor(t) else t


    def compare(name, plain, sharded, batches, lr, control=False, **info):
        """SHARD_STEPS eager steps of each program from seed 5 on the
        same batches: losses within 2e-4; states by ``adam_state_gap``,
        every element within 2 · lr · steps (Adam's first steps move a
        near-zero gradient's element by ~lr whatever its sign), and at
        most 0.1% of a leaf beyond 2e-4 for an f32 model. A bf16 model's
        gradients are bf16, and the mesh's step sums some in another
        order (its vocab-parallel loss, the embedding's masked lookup):
        its share is printed beside ``control`` — the mesh-less program
        run twice from one seed —, not held."""
        sa = plain.init(seed=5, device=dev)
        sb = sharded.init(seed=5, device=dev)
        step = sharded.compiled(dev)
        la, lb, ms, by_step = [], [], [], []
        for i, batch in enumerate(batches):
            la.append(float(plain.step_fn(sa, *batch)[1]["loss"]))
            dbatch = tuple(sh.distribute(b, mesh, spec) for b, spec in
                           zip(batch, sharded.in_shardings[1:]))
            torch.cuda.synchronize()
            t = time.perf_counter()
            lb.append(float(step(sb, *dbatch)[1]["loss"]))
            ms.append(1e3 * (time.perf_counter() - t))
            gap = adam_state_gap(sb, sa, lr, i + 1)
            by_step.append([gap["max_abs"], gap["share_off"]])
        if control:
            sc = plain.init(seed=5, device=dev)
            lc = [float(plain.step_fn(sc, *batch)[1]["loss"])
                  for batch in batches]
            info["control_plain_twice"] = dict(
                max_abs_loss=max(abs(x - y) for x, y in zip(la, lc)),
                **adam_state_gap(sc, sa, lr, len(batches)))
            del sc
        d_loss = max(abs(x - y) for x, y in zip(la, lb))
        same = la == lb and all(torch.equal(full(x), full(y)) for x, y in
                                zip(tree_leaves(sa), tree_leaves(sb)))
        bf16 = any(full(t).dtype == torch.bfloat16
                   for t in tree_leaves(sa["params"]))
        log(f"sharded_{name}", losses_plain=la, losses_mesh=lb,
            max_abs_loss=d_loss, state=gap,
            state_max_abs_share_by_step=by_step, bit_identical=same,
            step_ms_mesh=ms, policy=sorted(sharded.policy_kv),
            captured=sharded.meta["captured"], tol=TOL,
            state_share_held=not bf16, **info)
        if not all(abs(x - y) <= TOL["atol"] + TOL["rtol"] * abs(x)
                   for x, y in zip(la, lb)):
            raise AssertionError(f"sharded {name}: the mesh's losses are "
                                 f"{d_loss:.3e} from the mesh-less ones")
        if gap["beyond_2_lr_steps"] or (not bf16 and gap["share_off"] > 1e-3):
            raise AssertionError(f"sharded {name}: the mesh's state is "
                                 f"{gap} from the mesh-less one")
        del sa, sb
        gc.collect()
        torch.cuda.empty_cache()

    # -- granite-moe-3b-a800m train_4k: plain, moe_local, seq_par ------------
    cfg = lm_config(LM_GRANITE, n_layers=SHARD_GRANITE_LAYERS)
    seq = cfgreg.get_config(LM_GRANITE).SHAPES["train_4k"]["seq"]
    batches = [(token_batch(gen(500 + i), SHARD_GRANITE_BATCH, seq,
                            cfg.vocab),) for i in range(SHARD_STEPS)]
    for opts in ((), ("moe_local",), ("seq_par",)):
        compare("granite_train_4k" + "".join("_" + o for o in opts),
                steps._lm_train(cfg, seq, SHARD_GRANITE_BATCH),
                steps._lm_train(cfg, seq, SHARD_GRANITE_BATCH, mesh,
                                frozenset(opts)),
                batches, 3e-4, control=not opts,
                reduced=[f"layers {SHARD_GRANITE_LAYERS} of 32",
                                  f"batch {SHARD_GRANITE_BATCH} of 256"])
    del batches

    # -- dlrm-mlperf train_batch with table_md --------------------------------
    mod = types.SimpleNamespace(
        FAMILY="recsys", BUILD=lambda: cfgreg.get_config("dlrm-mlperf").BUILD(
            scale_tables=SHARD_DLRM_SCALE_TABLES))
    plain = steps._recsys_train(mod, 65536)
    sharded = steps._recsys_train(mod, 65536, mesh, frozenset({"table_md"}))
    graph, _ = mod.BUILD()

    def recsys_batch(i):
        g = gen(600 + i)
        feeds = {}
        for name, m in plain.args[1].items():
            if m.dtype.is_floating_point:
                feeds[name] = torch.randn(m.shape, generator=g, device=dev)
            else:
                feeds[name] = torch.randint(
                    0, _vocab_for_input(graph, name) or 1000, m.shape,
                    generator=g, dtype=m.dtype, device=dev)
        labels = (torch.rand(plain.args[2].shape, generator=g, device=dev)
                  < 0.2).float()
        return feeds, labels

    tables = {n.name: n.attrs["vocab"] for n in graph.param_nodes()
              if n.op == "embedding"
              and n.attrs["vocab"] >= sh.TABLE_SHARD_THRESHOLD}
    compare("dlrm_train_batch_table_md", plain, sharded,
            [recsys_batch(i) for i in range(SHARD_STEPS)], 1e-3,
            sharded_tables=len(tables),
            reduced=[f"scale_tables {SHARD_DLRM_SCALE_TABLES}"])
    del plain, sharded

    # -- paper-ranking serve_bulk with serve_full_dp, through the kernels ----
    plain = steps.build_cell("paper-ranking", "serve_bulk")
    sharded = steps.build_cell("paper-ranking", "serve_bulk", mesh,
                               ("serve_full_dp",))
    feeds = device_feeds("paper-ranking", sharded.args[1], gen(700))
    params = plain.init(seed=5, device=dev)
    dparams = sharded.init(seed=5, device=dev)
    want = plain.compiled(dev)(params, feeds)
    want_plain = plain.compiled(dev, use_pallas=False)(params, feeds)
    run = sharded.compiled(dev)
    dfeeds = sh.distribute(feeds, mesh, sharded.in_shardings[1])
    with counting("sharded"):
        got = run(dparams, dfeeds)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(CELL_REPLAYS):
            got = run(dparams, dfeeds)
        torch.cuda.synchronize()
    mesh_ms = 1e3 * (time.perf_counter() - t) / CELL_REPLAYS
    got = full(got)
    d = float((got - want).abs().max())
    d_plain = float((got - want_plain).abs().max())
    log("sharded_paper_serve_bulk_full_dp", rows=got.shape[0],
        padded_batch=sharded.meta["padded_batch"],
        max_abs_vs_meshless_kernels=d, max_abs_vs_meshless_plain=d_plain,
        bit_identical=bool(torch.equal(got, want)), mesh_ms=mesh_ms,
        captured=sharded.meta["captured"], tol=TOL)
    if not (torch.allclose(got, want, **TOL)
            and torch.allclose(got, want_plain, **TOL)):
        raise AssertionError(f"sharded paper serve: {d:.3e} / {d_plain:.3e}")
    del params, dparams, feeds, dfeeds, got, want, want_plain, run
    gc.collect()
    torch.cuda.empty_cache()

    # -- schnet molecule --------------------------------------------------------
    plain = steps.build_cell("schnet", "molecule")
    sharded = steps.build_cell("schnet", "molecule", mesh)
    spec = cfgreg.get_config("schnet").SHAPES["molecule"]
    n_edges = plain.args[1]["senders"].shape[0]
    batches = [({k: torch.as_tensor(v, device=dev) for k, v in
                 sampler.pad_edges(sampler.batched_molecules(
                     spec["batch"], spec["n_nodes"], spec["n_edges"],
                     seed=800 + i), n_edges).items()},)
               for i in range(SHARD_STEPS)]
    compare("schnet_molecule", plain, sharded, batches, 1e-3, reduced=[])
    dist.destroy_process_group()

    # -- the dry run on this machine's torch ------------------------------------
    for arch, shape, opts, p in dryruns:
        out, err = p.communicate(timeout=SHARD_DRYRUN_TIMEOUT)
        if p.returncode != 0:
            raise AssertionError(f"dry run {arch} x {shape} {opts}: exit "
                                 f"{p.returncode}: {err[-2000:]}")
        rec = json.loads(out.strip().splitlines()[-1])
        if not (rec["devices"] == 256 and rec["cost"]["flops_per_device"] > 0
                and rec["roofline"]["bottleneck"] in (
                    "compute_s", "memory_s", "collective_s")):
            raise AssertionError(f"dry run {arch} x {shape}: {rec}")
        log("sharded_dryrun", **rec)
    log("sharded_phase", backend=backend,
        seconds=time.perf_counter() - t_phase)


def main() -> int:
    t_script = time.perf_counter()
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

    from repro_torch.core import (WeightPartition, convert_params_reorg,
                                  reorganize)
    from repro_torch.core.mari import (convert_params, mari_rewrite,
                                       matmul_mari, matmul_mari_fragmented,
                                       matmul_vanilla)
    from repro_torch.graph.executor import Executor, init_graph_params
    from repro_torch.configs import get_config
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.common import timeit, tree_leaves, tree_map
    from repro_torch.core.mari import apply_mari
    from repro_torch.data.features import (interleaved_spans,
                                           make_recsys_feeds)
    from repro_torch.examples.train_then_convert import teacher_batches
    from repro_torch.kernels import build, read_launches, reset_launches
    from repro_torch.kernels import turns
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
    # guarded instance at DIN's width, and its bf16 entry through the fp32
    # pipeline; dot_interaction's ring plan at every batch): all nvcc
    # processes at once
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2 + len(VARIANTS)) as pool:
        variant_builds = [pool.submit(build.build_all, (n,), d)
                          for n, d in VARIANTS.values()]
        parent_build = pool.submit(turns.load_source, "gather_einsum",
                                   Path(ROOT, GENERIC_PARENT))
        libs = build.build_all()
        for f in variant_builds:
            f.result()
        ge_parent = parent_build.result()
    ptxas = {}
    for name, lib in libs.items():
        logf = lib.with_suffix(".log")
        lines = logf.read_text().splitlines() if logf.exists() else []
        ptxas[name] = [ln.strip() for ln in lines
                       if "registers" in ln or "spill" in ln
                       or "warning" in ln][:32]
    log("build", seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)
    t_phase1 = time.perf_counter()

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
                                              "stride_copies": 0,
                                              "din_prepares": 0})
        host["prepares"] += sum(mm.PREPARES.values())
        host["stride_copies"] += sum(mm.STRIDE_COPIES.values())
        host["din_prepares"] += sum(da.PREPARES.values())

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
        ops_mod._lib = lambda: saved(VARIANTS[name][1])
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

    # the bf16 entry (the serve_bf16 cells' path, phase 11), x written as
    # the serving path writes a stream (rows stream_ld apart), held to its
    # plain version at the reference's bf16 tolerance and, for identity
    # and relu, to an fp64 oracle on the widened operands
    # (bf16_vs_widened: its rounding or one ulp, or where a sum cancels one
    # ulp plus the f32 reordering bound over |u| + |x| |w|)
    xb = mm.empty_stream(B, K, torch.bfloat16, dev).copy_(x)
    wb = w.bfloat16()
    pwb = mm.prepare_mari_weight(wb)
    ub = u_of["broadcast"]
    errs = [max_err(mm.mari_matmul(xb, pwb, ub, None, "relu"),
                    mm.mari_matmul_plain(xb, wb, ub, None, "relu"), BF16_TOL)]
    exact = ub.double() + xb.double() @ wb.double()
    abs_sums = ub.double().abs() + xb.double().abs() @ wb.double().abs()
    oracle = {act: bf16_vs_widened(mm.mari_matmul(xb, pwb, ub, None, act),
                                   fn(exact), abs_sums, K)
              for act, fn in (("identity", lambda v: v),
                              ("relu", torch.relu))}
    del exact, abs_sums
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
        shape=dict(B=B, K=K, N=N, u_rows=1, act="relu", dtype="bfloat16",
                   x_row_stride=xb.stride(0),
                   plan=dataclasses.asdict(mm.ops.bf16_plan(B, N))),
        oracle_vs_fp64=oracle,
        library="torch.addmm in bf16 (no activation)")
    del xb, wb, pwb

    # the bf16 entry at every mari_dense shape of the served models, with
    # a broadcast init (what the serve_bf16 cells run), at the cells'
    # batches, x written as the serving path writes it, beside one bf16
    # torch.addmm on the same operands; route: the kernel's only one (no
    # split of K over CTAs), the tile its plan picks
    sweep_bf16 = []
    for layer, Ks, Ns, act in MARI_SHAPES:
        ws_ = (randn(Ks, Ns) * 0.05).bfloat16()
        pws, us = mm.prepare_mari_weight(ws_), randn(1, Ns)
        ub_ = us.bfloat16()
        for Bs in MARI_BF16_BATCHES:
            xs_ = mm.empty_stream(Bs, Ks, torch.bfloat16, dev).copy_(
                randn(Bs, Ks))
            err = max_err(mm.mari_matmul(xs_, pws, us, None, act),
                          mm.mari_matmul_plain(xs_, ws_, us, None, act),
                          BF16_TOL)
            b_ms, _ = mari_bound(Bs, Ks, Ns, 1, "broadcast", torch.bfloat16)
            plan = mm.ops.bf16_plan(Bs, Ns)
            sweep_bf16.append(dict(
                layer=layer, B=Bs, K=Ks, N=Ns, act=act, max_abs_err=err,
                route="main", tile=[plan.bm, plan.bn], grid=plan.grid,
                x_row_stride=xs_.stride(0),
                stride_copy=not mm.ops.tma_ready(xs_),
                ms=time_ms(lambda: mm.mari_matmul(xs_, pws, us, None, act)),
                addmm_ms=time_ms(lambda: torch.addmm(ub_, xs_, ws_)),
                bound_ms=b_ms))
            del xs_
        del ws_, pws
    log("mari_matmul_bf16_shapes", tol=BF16_TOL, init="broadcast",
        rows=sweep_bf16)
    entries["mari_matmul/bf16"]["all_path_shapes_max_abs_err"] = max(
        r["max_abs_err"] for r in sweep_bf16)

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
    # fp32 bd,uldh->blh past D = 40 on the tensor cores (3xTF32 wgmma, the
    # rows grouped by user through a counting sort on the card): the
    # coalesced engine's q against T at DIN's public D = 128 (phase 3b's
    # din128 path). Checked at D 41 / 64 / 128 / 130 in random order, runs,
    # clamped and over 64 slots, a row's bits its own (a slice, a
    # permutation); timed at D = 128 in random order, runs and 64 slots,
    # beside the CUDA-core kernel that took it before (the library's
    # gather_einsum_f32 entry, which keeps D <= 40) and einsum on the
    # gathered (B, L, D, H) operand (16.8 GB, gathered before the timing)
    spec, D128 = "bd,uldh->blh", 128
    tc_errs = []
    for Dt in (41, 64, D128, 130):
        xt, tt, t64 = randn(B, Dt), randn(U, L, Dt, H), randn(64, L, Dt, H)
        for tab, it in ((tt, idx), (tt, torch.sort(idx).values),
                        (tt, randidx(B, U + 3, lo=-2)), (t64, randidx(B, 64))):
            tc_errs.append(max_err(ge.gather_einsum(spec, xt, tab, it),
                                   ge.gather_einsum_plain(spec, xt, tab,
                                                          it)))
        del xt, tt, t64
    xg, tg, t64 = randn(B, D128), randn(U, L, D128, H), randn(64, L, D128, H)
    runs, idx64 = torch.sort(idx).values, randidx(B, 64)
    full = ge.gather_einsum(spec, xg, tg, idx)
    perm = torch.randperm(B, generator=gen, device=dev)
    torch.cuda.synchronize()
    if not (torch.equal(ge.gather_einsum(spec, xg[1000:2100], tg,
                                         idx[1000:2100]), full[1000:2100])
            and torch.equal(ge.gather_einsum(spec, xg[perm], tg, idx[perm]),
                            full[perm])):
        raise AssertionError("gather_einsum tensor-core route: a row's bits "
                             "depend on B or on the rows' order")
    del full
    ge_lib = ge.ops._lib()
    cc_out = torch.empty(B, L, H, device=dev)

    def cuda_core(i):
        rc = ge_lib.gather_einsum_f32(
            0, xg.data_ptr(), tg.data_ptr(), i.data_ptr(), cc_out.data_ptr(),
            B, U, L, D128, H, torch.cuda.current_stream(dev).cuda_stream)
        ge.ops.build.check(ge_lib, rc, "gather_einsum (CUDA cores)")

    flops = 2 * B * L * H * D128
    nbytes = 4 * (B * D128 + U * L * D128 * H + B * L * H + B)
    b_ms, b_by = bound(nbytes, 3 * flops, PEAK_TF32_FLOPS)
    ms = time_ms(lambda: ge.gather_einsum(spec, xg, tg, idx))
    entry = dict(
        route="cuda", source="src/repro_torch/csrc/gather_einsum.cu",
        replaces="src/repro/kernels/gather_einsum/kernel.py:79",
        max_abs_err=max(tc_errs), ms=ms,
        ms_runs=time_ms(lambda: ge.gather_einsum(spec, xg, tg, runs)),
        u64=dict(ms=time_ms(lambda: ge.gather_einsum(spec, xg, t64,
                                                     idx64))),
        cuda_core_ms=time_ms(lambda: cuda_core(idx)),
        cuda_core_ms_runs=time_ms(lambda: cuda_core(runs)),
        plain_ms=time_ms(lambda: ge.gather_einsum_plain(spec, xg, tg, idx)),
        bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
        bound_bytes_ms=nbytes / PEAK_BYTES_S * 1e3,
        bound_3xtf32_ms=3 * flops / PEAK_TF32_FLOPS * 1e3,
        shape=dict(B=B, U=U, L=L, D=D128, H=H, checked_D=[41, 64, D128, 130]),
        bound_note="3xTF32: three TF32 products at 495 TFLOP/s; bytes: x, "
                   "T, out and the index once",
        timing="ms: user_index in random order; ms_runs: the engine's "
               "runs; u64: a 64-slot table in random order; cuda_core_ms: "
               "the CUDA-core kernel the route replaces past D = 40",
        library="torch.einsum on pre-gathered rows")
    del t64
    rows = tg.index_select(0, idx)
    row_spec = ge.parse_spec(spec)[3]
    entry["library_ms"] = time_ms(lambda: torch.einsum(row_spec, xg, rows),
                                  iters=5)
    entries[f"gather_einsum/{ge.ops.TC_KEY}"] = entry
    del xg, tg, rows, cc_out
    torch.cuda.empty_cache()

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

    def din_bound(Bq, Lq, Dq, h1, h2, bf16=False):
        """The least work of the unit: [k, q, k-q, k*q] W1 = k (W1a + W1c)
        + q (W1b - W1c) + (k*q) W1d, so only (k*q) W1d is per (b, l) pair;
        the key part is per l, the query part (with b1) per b. bf16: two
        bytes a value, the two per-pair products once at the bf16 peak."""
        pair = (Dq + 2 * Dq * h1 + 2 * h1        # k*q, (k*q) W1d, + parts
                + 2 * h1 * h2 + h2 + 2 * h2 + 1  # layer 2 + b2, layer 3 + b3
                + 3 + 2 * Dq)                    # softmax, pooled sum
        flops = (Bq * Lq * pair + 2 * Dq * h1         # fold W1's blocks
                 + 2 * Lq * Dq * h1 + Bq * (2 * Dq * h1 + h1))
        nbytes = (2 if bf16 else 4) * (
            2 * Bq * Dq + Lq * Dq + 4 * Dq * h1 + h1 + h1 * h2 + 2 * h2
            + 1) + Lq                             # the mask is bool
        # the kernel's route: the two per-pair products ((k*q) W1d, layer
        # 2) as 3xTF32 on the tensor cores (bf16: once, at its peak), the
        # rest on the CUDA cores
        mma = (1 if bf16 else 3) * 2 * (Dq * h1 + h1 * h2) * Bq * Lq
        simt = flops - 2 * (Dq * h1 + h1 * h2) * Bq * Lq
        b3x = max(bound(nbytes, 0)[0],
                  mma / (PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS) * 1e3,
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
    # ... and histories of several 112-key chunks, and the widest unit of
    # the register tiles (32-key chunks)
    for shp in ((4, 5, 8, 16, 8), (33, 20, 18, 16, 8), (128, 100, 18, 16, 8),
                (1, 7, 6, 12, 5), (300, 37, 33, 128, 64),
                (40, 300, 18, 80, 40), (64, 920, 18, 80, 40),
                (20, 3000, 64, 128, 64)):
        a = din_args(*shp)
        errs.append(max_err(da.din_attention(*a), da.din_attention_plain(*a)))

    def din_by_length(bf16):
        """DIN width past the 920 keys a block once held, at B =
        DIN_LONG_B: ms, plain ms, bound, max |d| per history length."""
        rows = {}
        for Lx in DIN_LONG_L:
            a = din_args(DIN_LONG_B, Lx, Dq, H1, H2)
            if bf16:
                a = tuple(t.bfloat16() if t.is_floating_point() else t
                          for t in a)
            err = max_err(da.din_attention(*a), da.din_attention_plain(*a),
                          BF16_TOL if bf16 else TOL)
            (b_ms, b_by), _, _ = din_bound(DIN_LONG_B, Lx, Dq, H1, H2, bf16)
            ms = time_ms(lambda: da.din_attention(*a))
            rows[Lx] = dict(ms=ms, plain_ms=time_ms(
                lambda: da.din_attention_plain(*a), iters=3),
                bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
                max_abs_err=err)
            del a
        return rows

    timed_long = din_by_length(False)
    errs += [r["max_abs_err"] for r in timed_long.values()]
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
                         [40, 300, 18, 80, 40], [64, 920, 18, 80, 40],
                         [20, 3000, 64, 128, 64]],
                   chunk_keys=da.ops._lib().din_attention_chunk_keys(
                       Dq, H1, H2)),
        bound_note="3xTF32: the least work's two per-pair products as "
                   "3xTF32 at 495 TFLOP/s, the rest at 67 TFLOP/s fp32; "
                   "bound_fp32_simt_ms: all of it at 67",
        timing="guarded_instance_ms: the build without the unguarded "
               "instance for these tile counts",
        at_full_bucket=dict(B=B, **timed[B]),
        by_length={Lx: dict(B=DIN_LONG_B, **r)
                   for Lx, r in timed_long.items()},
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
    # and its preparation alone; beside them the sort-based preparation
    # (csr_prep_plain, then the same bag kernel), whose output the entry
    # must equal bit for bit
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
                   "(ms_shuffled)", note="ms includes the preparation "
                   "(prep_ms alone: one pass when the segment ids are in "
                   "order, else the counting sort); old_prep_ms: "
                   "csr_prep_plain's stable sort + searchsorted + gathers, "
                   "then the same bag kernel; bound adds the int64 segment "
                   "ids read"),
        library="torch.nn.functional.embedding_bag (mode='sum', offsets)")
    del tab, bag_ids, flat, segs, offs, flat_sh, segs_sh

    # ---- the bf16 entries (the TPU kernels' numerics: bf16 in and out,
    # f32 inside), each at its fp32 entry's shape, held to its plain
    # version at BF16_TOL; where the entry widens into the fp32 pipeline
    # (gather_einsum, embedding_bag), bit for bit the fp32 kernel on the
    # widened operands, rounded once (dot_interaction and din_attention
    # run on the bf16 tensor cores). Bounds: two bytes a value, products
    # at the bf16 peak.
    def bf16_entry(name, like, fn, plain, library_fn, nbytes, flops, errs,
                   **extra):
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        ms = time_ms(fn)
        entries[name] = dict(
            route="cuda", source=entries[like]["source"],
            replaces=entries[like]["replaces"], max_abs_err=max(errs),
            tol=BF16_TOL, ms=ms, plain_ms=time_ms(plain), bound_ms=b_ms,
            bound_by=b_by, share_of_bound=b_ms / ms,
            library_ms=time_ms(library_fn) if library_fn else None,
            fp32_entry_ms=entries[like]["ms"], **extra)

    def same_bits(got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: the bf16 entry differs from the "
                                 f"fp32 kernel on the widened operands")

    # gather_einsum: bl,uld->bd and blh,uh->bl widen where the FMAs read
    # the bf16 operands (bit for bit the fp32 kernel on them, rounded);
    # bd,uldh->blh runs on the bf16 tensor cores, its f32 sums in the
    # mma's order (bf16_vs_widened, depth D). Every entry at 8 and 64
    # slots in the three index orders, and a row's bits to its own when the
    # last half of the rows is launched alone.
    idx = randidx(B, U)
    for spec, (xs, ts, xrs, trs, flops, nfloats) in cases.items():
        xg, tg = randn(*xs).bfloat16(), randn(*ts).bfloat16()
        runs = torch.sort(randidx(B, U)).values
        xr, tr = randn(*xrs).bfloat16(), randn(*trs).bfloat16()
        ir = randidx(xrs[0], trs[0] + 3, lo=-2)
        t64 = randn(64, *ts[1:]).bfloat16()
        idx64, runs64 = randidx(B, 64), torch.sort(randidx(B, 64)).values
        short64 = (torch.arange(B, device=dev) // 4 % 64).to(torch.int32)
        errs, vs_widened = [], {}
        mma = spec == "bd,uldh->blh"
        for name, a in (("random", (xg, tg, idx)), ("runs", (xg, tg, runs)),
                        ("ragged", (xr, tr, ir)),
                        ("u64_random", (xg, t64, idx64)),
                        ("u64_runs", (xg, t64, runs64)),
                        ("u64_short_runs", (xg, t64, short64))):
            got = ge.gather_einsum(spec, *a)
            errs.append(max_err(got, ge.gather_einsum_plain(spec, *a),
                                BF16_TOL))
            wide = ge.gather_einsum(spec, a[0].float(), a[1].float(), a[2])
            if mma:
                vs_widened[name] = bf16_vs_widened(
                    got, wide, ge.gather_einsum(spec, a[0].float().abs(),
                                                a[1].float().abs(), a[2]),
                    a[0].shape[1])
            else:
                same_bits(got, wide.bfloat16(), f"gather_einsum {spec}")
            half = a[0].shape[0] // 2
            torch.cuda.synchronize()
            if not torch.equal(ge.gather_einsum(spec, a[0][half:], a[1],
                                                a[2][half:]), got[half:]):
                raise AssertionError(f"gather_einsum {spec} bf16: a row's "
                                     f"result depends on B")
        rows = tg.index_select(0, idx)
        row_spec = ge.parse_spec(spec)[3]
        tm = dict(
            ms_runs=time_ms(lambda: ge.gather_einsum(spec, xg, tg, runs)),
            u64=dict(ms=time_ms(lambda: ge.gather_einsum(spec, xg, t64,
                                                         idx64)),
                     ms_runs=time_ms(lambda: ge.gather_einsum(
                         spec, xg, t64, runs64)),
                     ms_short_runs=time_ms(lambda: ge.gather_einsum(
                         spec, xg, t64, short64))))
        extra = dict(vs_widened_fp32=vs_widened) if mma else {}
        tm["u64"]["bound_ms"] = bound(
            2 * (nfloats + (64 - U) * t64[0].numel()) + 4 * B, flops,
            PEAK_BF16_FLOPS)[0]
        bf16_entry(f"gather_einsum/{spec}/bf16", f"gather_einsum/{spec}",
                   lambda: ge.gather_einsum(spec, xg, tg, idx),
                   lambda: ge.gather_einsum_plain(spec, xg, tg, idx),
                   lambda: torch.einsum(row_spec, xg, rows),
                   2 * nfloats + 4 * B, flops, errs,
                   ms_runs=tm["ms_runs"], u64=tm["u64"],
                   shape=dict(x=list(xs), table=list(ts), dtype="bfloat16"),
                   timing="ms: user_index in random order; ms_runs: "
                   "contiguous runs of random length (the engine's layout); "
                   "u64: the same at a 64-slot table, and ms_short_runs: "
                   "runs of 4 rows (16 users a 64-row tile)",
                   library="torch.einsum on pre-gathered rows, bf16", **extra)
        del xg, tg, rows, t64

    # the generic route: specs past KERNEL_SPECS, which no model forms (the
    # TPU kernel's tests alone do), so these checks are its runner: their
    # launches are path "generic". fp32 within TOL of the plain version,
    # bf16 bit for bit the fp32 route on the widened operands, both bit for
    # bit commit 521130a's generic entries on an index out of range both
    # ways, a row's bits its own when the last half of the rows is launched
    # alone or the rows come in another order; each spec timed (random
    # order and the engine's runs) beside its plain version, 521130a's
    # kernel and einsum on pre-gathered rows at B = 4096, U = 8
    gsz = dict(i=128, j=80, l=100, d=18, k=8, h=80, x=40, y=30)
    old_generic = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 2
    build.bind(ge_parent, {f"gather_einsum_generic_{k}": (old_generic,
                                                          ctypes.c_int)
                           for k in ("f32", "bf16")})

    def parent_generic(spec, x, t, idx):
        """``spec`` through commit 521130a's generic entry (its GePlan)."""
        plan = ge.ops.c_plan(ge.ops.generic_plan(spec, x.shape, t.shape))
        out = torch.empty(ge.ops.out_shape(spec, x, t, idx), dtype=x.dtype,
                          device=dev)
        fn = (ge_parent.gather_einsum_generic_bf16
              if x.dtype == torch.bfloat16
              else ge_parent.gather_einsum_generic_f32)
        build.check(ge_parent, fn(
            x.data_ptr(), t.data_ptr(), idx.data_ptr(), out.data_ptr(),
            x.shape[0], t.shape[0], ctypes.byref(plan),
            torch.cuda.current_stream(dev).cuda_stream), "521130a generic")
        return out

    by_spec, errs = {}, {"fp32": [], "bf16": []}
    with counting("generic"):
        for spec in GENERIC_SPECS:
            xs_, ts_, os_, row_spec = ge.parse_spec(spec)
            xg = randn(B, *(gsz[c] for c in xs_[1:]))
            tg = randn(U, *(gsz[c] for c in ts_[1:]))
            ig = randidx(B, U + 3, lo=-2)
            order = torch.randperm(B, generator=gen, device=dev)
            half = B // 2
            for dt, (xa, ta) in (("fp32", (xg, tg)),
                                 ("bf16", (xg.bfloat16(), tg.bfloat16()))):
                got = ge.gather_einsum(spec, xa, ta, ig)
                # bf16 against the plain version on the widened operands:
                # the route sums in f32 and rounds once, where einsum in
                # bf16 may sum in bf16 (10,240 terms in bij,uj->b)
                errs[dt].append(max_err(got, ge.gather_einsum_plain(
                    spec, xa.float(), ta.float(), ig),
                    BF16_TOL if dt == "bf16" else TOL))
                if dt == "bf16":
                    same_bits(got, ge.gather_einsum(
                        spec, xa.float(), ta.float(), ig).bfloat16(),
                        f"gather_einsum {spec}")
                torch.cuda.synchronize()
                if not torch.equal(got, parent_generic(spec, xa, ta, ig)):
                    raise AssertionError(
                        f"gather_einsum {spec} (generic, {dt}): not the bits "
                        f"of commit 521130a's generic route")
                if not (torch.equal(ge.gather_einsum(spec, xa[half:], ta,
                                                     ig[half:]), got[half:])
                        and torch.equal(ge.gather_einsum(
                            spec, xa[order], ta, ig[order]), got[order])):
                    raise AssertionError(f"gather_einsum {spec} (generic, "
                                         f"{dt}): a row's result depends on "
                                         f"B or on the rows' order")
                del got
            out_n = B * math.prod(gsz[c] for c in os_[1:])
            sum_n = math.prod(gsz[c] for c in set(xs_[1:] + ts_[1:])
                              if c not in os_)
            nval = xg.numel() + tg.numel() + out_n
            ir = randidx(B, U)
            runs = torch.sort(ir).values
            row = {}
            for dt, size, peak in (("fp32", 4, PEAK_FP32_FLOPS),
                                   ("bf16", 2, PEAK_BF16_FLOPS)):
                xa, ta = ((xg, tg) if dt == "fp32"
                          else (xg.bfloat16(), tg.bfloat16()))
                rows = ta.index_select(0, ir)
                b_ms, b_by = bound(size * nval + 4 * B, 2 * out_n * sum_n,
                                   peak)
                ms = time_ms(lambda: ge.gather_einsum(spec, xa, ta, ir))
                row[dt] = dict(
                    ms=ms, ms_runs=time_ms(
                        lambda: ge.gather_einsum(spec, xa, ta, runs)),
                    parent_ms=time_ms(
                        lambda: parent_generic(spec, xa, ta, ir), 5),
                    plain_ms=time_ms(
                        lambda: ge.gather_einsum_plain(spec, xa, ta, ir)),
                    library_ms=time_ms(
                        lambda: torch.einsum(row_spec, xa, rows)),
                    bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
                    tiling=ge.ops.generic_tile(
                        spec, tuple(xa.shape), tuple(ta.shape), size,
                        ge.ops._sms(0))[1])
                row[dt]["vs_library"] = ms / row[dt]["library_ms"]
                row[dt]["vs_parent"] = row[dt]["parent_ms"] / ms
                del rows
            by_spec[spec] = dict(x=list(xg.shape), table=list(tg.shape),
                                 plan=ge.ops.generic_plan(spec, xg.shape,
                                                          tg.shape), **row)
            del xg, tg
            torch.cuda.empty_cache()
    for dt in ("fp32", "bf16"):
        head = dict(by_spec[GENERIC_SPECS[0]][dt])
        del head["tiling"]
        entries["gather_einsum/generic" + ("/bf16" if dt == "bf16" else "")
                ] = dict(
            route="cuda", source="src/repro_torch/csrc/gather_einsum.cu",
            replaces="src/repro/kernels/gather_einsum/kernel.py:79",
            max_abs_err=max(errs[dt]),
            tol=BF16_TOL if dt == "bf16" else TOL,
            **head, shape=dict(spec=GENERIC_SPECS[0],
                               **{k: by_spec[GENERIC_SPECS[0]][k]
                                  for k in ("x", "table")},
                               dtype="bfloat16" if dt == "bf16"
                               else "float32"),
            by_spec={sp: dict(x=r["x"], table=r["table"], **r[dt])
                     for sp, r in by_spec.items()},
            bound_note="products at the fp32 peak (67 TFLOP/s) in fp32 "
                       "and at the bf16 peak (989 TFLOP/s) in bf16, whose "
                       "products are exact in f32; bytes: x, table, out "
                       "once (2 bytes a value in bf16) and the index",
            parent="commit 521130a's generic entries "
                   f"({GENERIC_PARENT}), bit for bit",
            runner="phase 1's checks (path generic): no model forms "
                   "such a spec",
            library="torch.einsum on pre-gathered rows")
    log("gather_einsum_generic", tol=TOL, bf16_tol=BF16_TOL,
        specs=by_spec)

    # dot_interaction's bf16 entry runs on the bf16 tensor cores, its f32
    # sums in the mma's order: held to the fp32 kernel on the widened rows
    # (bf16_vs_widened), and a row's bits to its own when the last half of
    # the rows is launched alone; each copy route (TMA; cp.async: D % 64
    # != 0; sync: D odd, a view 2 bytes past alignment), three m16 tiles
    Fd, Dd = 27, 128
    P = di.n_pairs(Fd)
    xd = randn(B, Fd, Dd).bfloat16()
    errs, vs_widened, routes = [], {}, {}
    for xb in (xd, randn(1000, 5, 16).bfloat16(),
               randn(130, 7, 33).bfloat16(),
               randn(64 * Fd * Dd + 1).bfloat16()[1:].view(64, Fd, Dd),
               randn(33, 40, 64).bfloat16()):
        name = "x".join(map(str, xb.shape)) + (
            "+2B" if xb.data_ptr() % 4 else "")
        got = di.dot_interaction(xb)
        errs.append(max_err(got, di.dot_interaction_plain(xb), BF16_TOL))
        vs_widened[name] = bf16_vs_widened(
            got, di.dot_interaction(xb.float()),
            di.dot_interaction(xb.float().abs()), xb.shape[2])
        routes[name] = di.copy_route(xb)
        half = xb.shape[0] // 2
        if not torch.equal(di.dot_interaction(xb[half:]), got[half:]):
            raise AssertionError("dot_interaction bf16: a row's result "
                                 "depends on B")
    iu, ju = torch.triu_indices(Fd, Fd, offset=1, device=dev)
    bf16_entry("dot_interaction/bf16", "dot_interaction/triu",
               lambda: di.dot_interaction(xd),
               lambda: di.dot_interaction_plain(xd),
               lambda: torch.bmm(xd, xd.transpose(1, 2))[:, iu, ju],
               2 * (B * Fd * Dd + B * P), 2 * B * P * Dd, errs,
               shape=dict(B=B, F=Fd, D=Dd, P=P, keep_self=False,
                          copy_route=di.copy_route(xd), routes=routes),
               vs_widened_fp32=vs_widened,
               library="torch.bmm (cuBLAS) in bf16 then a triangle index "
                       "gather: two PyTorch calls")
    del xd

    errs = []
    dargs = tuple(t.bfloat16() if t.is_floating_point() else t
                  for t in din_args(SINGLE_CALL_B, Lq, Dq, H1, H2))
    for shp in ((4, 5, 8, 16, 8), (300, 37, 33, 128, 64),
                (64, 920, 18, 80, 40)):
        a = tuple(t.bfloat16() if t.is_floating_point() else t
                  for t in din_args(*shp))
        errs.append(max_err(da.din_attention(*a), da.din_attention_plain(*a),
                            BF16_TOL))
    errs.append(max_err(da.din_attention(*dargs),
                        da.din_attention_plain(*dargs), BF16_TOL))
    long_bf16 = din_by_length(True)
    errs += [r["max_abs_err"] for r in long_bf16.values()]
    (b_ms, b_by), _, _ = din_bound(SINGLE_CALL_B, Lq, Dq, H1, H2, True)
    ms = time_ms(lambda: da.din_attention(*dargs))
    lib = da.ops._lib()
    entries["din_attention/bf16"] = dict(
        route="cuda", source="src/repro_torch/csrc/din_attention.cu",
        replaces="src/repro/kernels/din_attention/kernel.py:47",
        max_abs_err=max(errs), tol=BF16_TOL, ms=ms,
        plain_ms=time_ms(lambda: da.din_attention_plain(*dargs)),
        bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
        library_ms=None,
        fp32_entry_ms=entries["din_attention/shared_keys"]["ms"],
        shape=dict(B=SINGLE_CALL_B, L=Lq, D=Dq, h1=H1, h2=H2,
                   dtype="bfloat16",
                   chunk_keys=lib.din_attention_bf16_chunk_keys(Dq, H1, H2),
                   smem_bytes=lib.din_attention_bf16_smem_bytes(Lq, Dq, H1,
                                                                H2)),
        by_length={Lx: dict(B=DIN_LONG_B, **r)
                   for Lx, r in long_bf16.items()},
        # a 16-key tile: GEMM 1 ceil(D / 8) k8 steps x ceil16(h1) / 8 n
        # tiles, GEMM 2 ceil16(h1) / 16 k16 steps x ceil(h2 / 8) n tiles
        # x 2 (h1's bf16 halves); the fp32 pipeline (step (a) keeps 1 + 2
        # of its 3 + 3 products) for comparison
        mma_per_tile=(-(-Dq // 8) * (-(-H1 // 16) * 2)
                      + -(-H1 // 16) * -(-H2 // 8) * 2),
        mma_per_tile_fp32_pipeline=3 * (-(-Dq // 8) * -(-H1 // 8)
                                        + -(-H1 // 8) * -(-H2 // 8)),
        bound_note="bf16: two bytes a value; the per-pair products once "
                   "at 989 TFLOP/s (the kernel runs them on the bf16 "
                   "tensor cores: mma.sync m16n8k8 and m16n8k16, h1 as "
                   "two bf16 halves in the second), the rest at 67",
        library="none: no single PyTorch call computes the unit")
    del dargs

    # din_attention's wide route (units past the register tiles), fp32 and
    # bf16: DIN's public code at D = 128 (item and category embeddings of
    # 64 each) and its 80-40 MLP at the single call's B = 2048 and L = 100,
    # timed; checked at every kind of width past the tiles, 10,000 keys at
    # one, a row's bits its own when the last half of the rows is launched
    # alone. Weights at the models' glorot scale (init_graph_params): at
    # the 0.2 of din_args a unit of fan-in 1024 scores in the hundreds,
    # where any bf16 rounding of a feature moves the softmax's argmax (the
    # plain version's own bf16 run is then 0.2 off its fp32 run on the
    # same values)
    def din_wide_args(Bq, Lq, Dq, h1, h2, bf16):
        a = list(din_args(Bq, Lq, Dq, h1, h2))
        for i, (fi, fo) in ((3, (4 * Dq, h1)), (5, (h1, h2)), (7, (h2, 1))):
            a[i] = a[i] / 0.2 * (2.0 / (fi + fo)) ** 0.5
        return tuple(t.bfloat16() if bf16 and t.is_floating_point() else t
                     for t in a)

    # fp32 at din_args' 0.2 scale: scores large enough that the softmax is
    # near an argmax, where a changed summation order moves the output.
    # The wide route and the plain version are each held against the plain
    # unit run in fp64 (din_oracle_fp64): the route no farther from it than
    # the plain fp32 run, or within TOL of it (max_abs_err, the kernel
    # against the plain version, beside max |score|)
    at_0_2 = {}
    for w in DIN_WIDE_CHECKED[1:3]:
        a = din_args(64, 100, *w)
        got = da.din_attention(*a, prepared=da.prepare_din_weights(a[3],
                                                                  a[5]))
        plain = da.din_attention_plain(*a)
        oracle = din_oracle_fp64(*a)
        at_0_2[",".join(map(str, w))] = r = dict(
            max_abs_err=float((got - plain).abs().max()),
            kernel_vs_fp64=float((got.double() - oracle).abs().max()),
            plain_vs_fp64=float((plain.double() - oracle).abs().max()),
            max_abs_score=din_scores_fp64(*a).abs().max().item())
        if r["kernel_vs_fp64"] > max(r["plain_vs_fp64"], TOL["atol"]):
            raise AssertionError(f"din_attention wide at 0.2 scale {w}: "
                                 f"farther from fp64 than the plain "
                                 f"version ({r})")
        del a, got, plain, oracle
    lib = da.ops._lib()
    for bf16 in (False, True):
        errs, tol = [], BF16_TOL if bf16 else TOL
        for shp in ((64, 100) + DIN_WIDE, *((64, 100) + w
                                            for w in DIN_WIDE_CHECKED),
                    (16, 10_000) + DIN_WIDE_CHECKED[1]):
            a = din_wide_args(*shp, bf16)
            pw = da.prepare_din_weights(a[3], a[5])
            got = da.din_attention(*a, prepared=pw)
            errs.append(max_err(got, da.din_attention_plain(*a), tol))
            half = shp[0] // 2
            torch.cuda.synchronize()
            if not torch.equal(da.din_attention(a[0][half:].contiguous(),
                                                *a[1:], prepared=pw),
                               got[half:]):
                raise AssertionError(f"din_attention wide {shp}: a row's "
                                     f"result depends on B")
            del a, got, pw
        dargs = din_wide_args(SINGLE_CALL_B, Lq, *DIN_WIDE, bf16)
        dprep = da.prepare_din_weights(dargs[3], dargs[5])
        errs.append(max_err(da.din_attention(*dargs, prepared=dprep),
                            da.din_attention_plain(*dargs), tol))
        (b_ms, b_by), flops, simt_ms = din_bound(SINGLE_CALL_B, Lq,
                                                 *DIN_WIDE, bf16)
        ms = time_ms(lambda: da.din_attention(*dargs, prepared=dprep))
        split = profile_call(lambda: da.din_attention(
            *dargs, prepared=dprep))["top_kernels"]
        name = "din_attention/wide" + ("/bf16" if bf16 else "")
        smem = (lib.din_attention_bf16_smem_bytes if bf16
                else lib.din_attention_smem_bytes)(Lq, *DIN_WIDE)
        chunk = (lib.din_attention_bf16_chunk_keys if bf16
                 else lib.din_attention_chunk_keys)(*DIN_WIDE)
        entries[name] = dict(
            route="cuda", source="src/repro_torch/csrc/din_attention.cu",
            replaces="src/repro/kernels/din_attention/kernel.py:47",
            max_abs_err=max(errs), tol=tol, ms=ms,
            plain_ms=time_ms(lambda: da.din_attention_plain(*dargs)),
            bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
            library_ms=None,
            kernels_ms=split,
            **({} if bf16 else {"fp32_at_0_2_scale": at_0_2}),
            shape=dict(B=SINGLE_CALL_B, L=Lq, D=DIN_WIDE[0], h1=DIN_WIDE[1],
                       h2=DIN_WIDE[2], gflop=flops / 1e9,
                       dtype="bfloat16" if bf16 else "float32",
                       chunk_keys=chunk, smem_bytes=smem,
                       work_bytes=lib.din_attention_work_bytes(
                           SINGLE_CALL_B, Lq, *DIN_WIDE, int(bf16)),
                       max_dim=lib.din_attention_max_dim(int(bf16)),
                       checked=[[64, 100, *w] for w in DIN_WIDE_CHECKED]
                       + [[16, 10_000, *DIN_WIDE_CHECKED[1]]]),
            bound_note=("bf16: two bytes a value; the per-pair products "
                        "once at 989 TFLOP/s" if bf16 else
                        "3xTF32: the least work's two per-pair products as "
                        "3xTF32 at 495 TFLOP/s") + ", the rest at 67",
            timing="ms: the wrapper's call on weights prepared once "
                   "(prepare_din_weights): K1 and Q1's fold launch, then "
                   "the unit; kernels_ms splits one call by torch.profiler",
            library="none: no single PyTorch call computes the unit")
        del dargs, dprep

    Vb, Bb, Hb, Db = pad_vocab(int(DLRM_TABLE_ROWS[20] * 0.1)), B, 100, 128
    tab = randn(Vb, Db).bfloat16()
    bag_ids = torch.randint(0, Vb, (Bb, Hb), generator=gen, device=dev,
                            dtype=torch.int32)
    flat = bag_ids.reshape(-1)
    segs = torch.arange(Bb, device=dev).repeat_interleave(Hb)
    offs = torch.arange(0, Bb * Hb, Hb, device=dev)
    rows_read = int(torch.unique(flat).numel())
    errs = {"fixed": [], "csr": []}
    for t_, i_, wts, comb in ((tab, bag_ids, None, "sum"),
                              (randn(1000, 18).bfloat16(),
                               randidx(64 * 27, 1000).reshape(64, 27),
                               torch.rand(64, 27, generator=gen, device=dev),
                               "mean")):
        S_ = i_.shape[0]
        s_ = torch.arange(S_, device=dev).repeat_interleave(i_.shape[1])
        w_ = None if wts is None else wts.reshape(-1)
        got = eb.embedding_bag_fixed(t_, i_, comb, wts)
        errs["fixed"].append(max_err(
            got, eb.embedding_bag_fixed_plain(t_, i_, comb, wts), BF16_TOL))
        same_bits(got, eb.embedding_bag_fixed(t_.float(), i_, comb,
                                              wts).bfloat16(),
                  "embedding_bag/fixed")
        got = eb.embedding_bag(t_, i_.reshape(-1), s_, S_, comb, w_)
        errs["csr"].append(max_err(
            got, eb.embedding_bag_plain(t_, i_.reshape(-1), s_, S_, comb,
                                        w_), BF16_TOL))
        same_bits(got, eb.embedding_bag(t_.float(), i_.reshape(-1), s_, S_,
                                        comb, w_).bfloat16(),
                  "embedding_bag/csr")
    # the CSR entry with the segment ids sorted and shuffled (its own
    # generator: the draws after this point stay as they were) bit for bit
    # the sort-based preparation feeding the same bag kernel, and timed
    # with its preparation alone, as the fp32 entry above
    perm = torch.randperm(flat.numel(), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    flat_sh, segs_sh = flat[perm].contiguous(), segs[perm].contiguous()
    for f_, s_ in ((flat, segs), (flat_sh, segs_sh)):
        order, o_ = eb.csr_prep_plain(s_, Bb)
        if not torch.equal(eb.embedding_bag(tab, f_, s_, Bb),
                           eb.ops._launch("csr", tab, f_[order], o_, None,
                                          Bb, 0, "sum")):
            raise AssertionError("embedding_bag/csr/bf16 differs from the "
                                 "sort-based preparation")
    csr_bf16_timing = dict(
        ms_shuffled=time_ms(lambda: eb.embedding_bag(tab, flat_sh, segs_sh,
                                                     Bb)),
        prep_ms=time_ms(lambda: eb.csr_prep(segs, flat, None, Bb)),
        prep_ms_shuffled=time_ms(lambda: eb.csr_prep(segs_sh, flat_sh, None,
                                                     Bb)))
    for variant_, fn, plain, extra, timing in (
            ("fixed", lambda: eb.embedding_bag_fixed(tab, bag_ids),
             lambda: eb.embedding_bag_fixed_plain(tab, bag_ids), 0, {}),
            ("csr", lambda: eb.embedding_bag(tab, flat, segs, Bb),
             lambda: eb.embedding_bag_plain(tab, flat, segs, Bb),
             8 * Bb * Hb, csr_bf16_timing)):
        bf16_entry(f"embedding_bag/{variant_}/bf16",
                   f"embedding_bag/{variant_}", fn, plain,
                   lambda: F.embedding_bag(flat, tab, offs, mode="sum"),
                   Db * 2 * rows_read + 4 * Bb * Hb + 2 * Bb * Db + extra,
                   Bb * Hb * Db, errs[variant_], **timing,
                   shape=dict(bag_shape, dtype="bfloat16",
                              distinct_rows_read=rows_read),
                   library="torch.nn.functional.embedding_bag (mode='sum', "
                           "offsets), bf16")
    del tab, bag_ids, flat, segs, offs, flat_sh, segs_sh
    # "blh,uh->bl" is a spec the kernel supports but the executor's
    # decomposed attention never reaches, no served model keeps the gram's
    # diagonal, no path calls the CSR entry of embedding_bag (the
    # executor's bags have a fixed hotness), and no bf16 path reaches
    # gather_einsum (the coalesced DIN engine serves fp32) or
    # embedding_bag (single-hot DLRM gathers with index_select): checked
    # and timed above, they are listed in the kernels line with on_path
    # false
    OFF_PATH = ("gather_einsum/blh,uh->bl", "gather_einsum/generic",
                "gather_einsum/generic/bf16",
                "dot_interaction/triu_keep_self",
                "embedding_bag/csr", "embedding_bag/fixed/bf16",
                "embedding_bag/csr/bf16") + tuple(
                    f"gather_einsum/{s}/bf16" for s in ge.KERNEL_SPECS)
    log("kernels_vs_plain", seconds=time.perf_counter() - t_phase1,
        tol=TOL, bf16_tol=BF16_TOL,
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
        """torch.profiler over one warm coalesced call."""
        return profile_call(lambda: eng.score_coalesced(reqs))

    def serve_checks(tag, graph, params, plans, oracle_plan, reqs, n_out,
                     path="paper+din", twin=True):
        oracle = ServingEngine(graph, params, oracle_plan, device=dev)
        ref = [oracle.score(r).scores for r in reqs]
        del oracle              # its graphs' pool (DIN at D = 128: the
        gc.collect()            # plain gathers of T) before the kernels'
        torch.cuda.empty_cache()
        for name, plan in plans.items():
            eng = ServingEngine(graph, params, plan, device=dev)
            with counting(path):
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
                with counting(path):
                    window = device_window(eng, reqs)
            except Exception as e:       # a profiler failure is no smoke fail
                window = f"not measured: {type(e).__name__}: {e}"
            with counting(path):
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
            if name == "tpu" and twin:
                device_twin(tag, graph, params, plan, reqs, per)
            del eng

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
        # one captured graph, the state updated in place; the resume copies
        # the restored checkpoint into the captured state
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
        if step.compilations != 1 or state is not step.state:
            raise AssertionError(f"the captured step built "
                                 f"{step.compilations} graphs across the "
                                 f"crash and resume")
        params = tree_map(torch.clone, state["params"])
        # TRAIN_COMPARE captured steps against as many eager steps of the
        # same body from the same state and batches
        twin = tree_map(torch.clone, state)
        for b in itertools.islice(teacher_batches(graph, teacher, ex, dev,
                                                  seed=5), TRAIN_COMPARE):
            step(state, b)
        for b in itertools.islice(teacher_batches(graph, teacher, ex, dev,
                                                  seed=5), TRAIN_COMPARE):
            step.eager(twin, b)
        d_params = 0.0
        for a, b in zip(tree_leaves(state), tree_leaves(twin)):
            d_params = max(d_params, float((a.float() - b.float()).abs()
                                           .max()))
            if not torch.allclose(a.float(), b.float(), **TOL):
                raise AssertionError(f"captured vs eager state after "
                                     f"{TRAIN_COMPARE} steps: "
                                     f"{d_params:.3e}")
        batch = next(teacher_batches(graph, teacher, ex, dev, seed=3))
        t_step = timeit(lambda: step(state, batch), warmup=2, iters=10)
        t_eager = timeit(lambda: step.eager(twin, batch), warmup=2,
                         iters=10)
        log("train", arch="din", steps=TRAIN_STEPS, batch=64,
            crash_at=FAIL_AT, latest_after_crash=crashed_at_latest,
            resumed=lines[0], latest_after_resume=resumed_to,
            loss_first=losses[0], loss_last=losses[-1], losses=losses,
            wall_s=train_s, checkpoint_gbytes=ckpt_gb,
            compilations=step.compilations,
            max_abs_captured_vs_eager_state=d_params,
            compared_steps=TRAIN_COMPARE, tol=TOL,
            train_step_ms=dict(compiled_p50=t_step["p50_us"] / 1e3,
                               compiled_mean=t_step["mean_us"] / 1e3,
                               eager_p50=t_eager["p50_us"] / 1e3,
                               eager_mean=t_eager["mean_us"] / 1e3))
        del state, twin

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

    def dist_phase() -> None:
        """Phase 8: candidate-axis sharded serving through the runner
        (path ``dist``), as a user runs it: the paper model at full width,
        the ``tpu`` graph and kernel sections with ``shard_candidates`` on
        and hedging off, 4 users over ~6000 candidates (4096-row packs in
        2048-row shards): (a) two gloo ranks on the one card, (b) a
        one-rank NCCL group, (c) the int8 score gather on two ranks; each
        verified, then timed over ``DIST_PASSES`` passes and traced. Each
        worker counts its own launches around its sharded engine's work
        (the runner's ``per_rank``)."""
        t_phase = time.perf_counter()
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        plan_path = os.path.join(ROOT, "build", "dist_plan.json")
        ServePlan.preset("tpu").evolve(shard__shard_candidates=True,
                                       batch__hedging=False).save(plan_path)
        common = ["--scale", "1.0", "--pool", str(DIST_POOL), "--users",
                  str(DIST_USERS), "--plan", plan_path, "--timeout",
                  str(DIST_TIMEOUT), "--verify", "--bench", "--passes",
                  str(DIST_PASSES)]
        runs = {"a_gloo_2": ["--spawn", "2"],
                "b_nccl_1": ["--spawn", "1"],
                "c_int8_2": ["--spawn", "2", "--compress-scores",
                             "--modes", "mari"]}
        env = dict(os.environ, PYTHONPATH=SRC)
        bench = {}
        for tag, extra in runs.items():
            # every run traced alike, so the instrumentation is no
            # difference between them
            trace_path = os.path.join(ROOT, "build", f"dist_{tag}.json")
            cmd = [sys.executable, "-m", "repro_torch.dist.runner",
                   *common, *extra, "--trace", trace_path]
            t = time.perf_counter()
            out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                 text=True, timeout=DIST_TIMEOUT + 60)
            secs = time.perf_counter() - t
            recs = [json.loads(ln) for ln in out.stdout.splitlines()
                    if ln.startswith("{")]
            if out.returncode != 0 or not recs or not recs[-1].get("ok"):
                raise AssertionError(
                    f"dist {tag}: runner exited {out.returncode}\n"
                    f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
            for rec in recs[:-1]:
                ranks = rec["per_rank"]
                tot = by_path.setdefault("dist", {})
                for r in ranks:
                    for k, n in r["launches"].items():
                        tot[k] = tot.get(k, 0) + n
                gather_launches = [r["launches"].get("mari_matmul/gather", 0)
                                   for r in ranks]
                within = rec.get("within_int8_bound",
                                 rec.get("within_2e-4"))
                log("dist", run=tag, mode=rec["mode"],
                    processes=rec["processes"], shards=rec["shards"],
                    backend=rec["backend"], device=rec["device"],
                    max_abs_vs_local=rec["max_abs_vs_local"],
                    bitwise=rec["bit_identical"], within=within,
                    bound=("int8" if rec["compress_scores"] else "2e-4"),
                    int8_bound=[r.get("int8_bound") for r in ranks],
                    max_abs_vs_plain=rec.get("max_abs_vs_plain"),
                    mari_matmul_gather_launches_per_rank=gather_launches,
                    launches_per_rank=[r["launches"] for r in ranks],
                    graphs_per_rank=[r["stage2_compilations"]
                                     for r in ranks],
                    qps=rec.get("qps"), rows_per_s=rec.get("rows_per_s"),
                    rows_per_s_pcts=rec.get("rows_per_s_pcts"),
                    pass_ms_pcts=rec.get("pass_ms_pcts"), seconds=secs)
                # each rank held its scores to its local engine and to a
                # use_pallas=False one (2e-4, or the int8 bound)
                if not (within and all(r["ok"] for r in ranks)
                        and rec.get("max_abs_vs_plain") is not None):
                    raise AssertionError(
                        f"dist {tag} {rec['mode']}: outside the bound: "
                        f"{[(r['max_abs_vs_local'], r['max_abs_vs_plain'])
                            for r in ranks]}")
                if rec["mode"] == "mari" and not all(gather_launches):
                    raise AssertionError(
                        f"dist {tag}: a rank launched no mari_matmul gather "
                        f"{gather_launches}")
                bench.setdefault(rec["mode"], {})[tag] = dict(
                    qps=rec["qps"], rows_per_s=rec["rows_per_s"],
                    rows_per_s_pcts=rec["rows_per_s_pcts"],
                    breakdown=rec["breakdown"])
            # the merged trace: one pid per rank, every rank's spans
            with open(trace_path) as f:
                evs = json.load(f)["traceEvents"]
            pids = sorted({e["pid"] for e in evs})
            per_pid = {p: sorted({e["name"] for e in evs
                                  if e["pid"] == p and e.get("ph") != "M"})
                       for p in pids}
            log("dist_trace", run=tag, path=trace_path, events=len(evs),
                pids=pids, names_per_pid=per_pid)
            if pids != list(range(recs[0]["processes"])) or not all(
                    {"pack", "dispatch", "gather", "collect"} <= set(n)
                    for n in per_pid.values()):
                raise AssertionError(f"dist {tag} trace: pids {pids}, "
                                     f"{per_pid}")
        for mode, cells in bench.items():
            log("dist_bench", mode=mode, passes=DIST_PASSES, **cells)
        log("dist_phase", seconds=time.perf_counter() - t_phase)

    def table2_phase() -> None:
        """Phase 9, ``table2``: the reference's bench_table2 points at scale
        1.0, four columns each (CUDA events, 20 calls behind a device
        sleep): ``torch.addmm`` on the tiled input (library vanilla), the
        port's plain ``matmul_mari`` (Eq. 7), the ``mari_matmul``
        broadcast entry on the tiled input with a zero init row (kernel
        vanilla) and on x_rest with u = x_u W_u as the init row, the GEMV
        timed with it (kernel MaRI). The two time ratios stand beside
        ``WeightPartition``'s FLOPs and bytes ratios and each column's
        bound; the kernel columns are held to their plain versions."""
        for label, B, dims in T2_POINTS:
            part = WeightPartition(*dims)
            Du, Dr, d = part.d_user, part.d_rest, part.d_out
            scale = part.d_in ** -0.5
            xu, xr = randn(1, Du), randn(B, Dr)
            wu, wr = randn(Du, d) * scale, randn(Dr, d) * scale
            x_tiled = torch.cat([xu.expand(B, Du), xr], -1)
            w = torch.cat([wu, wr], 0)
            zero = torch.zeros(1, d, device=dev)
            pw, pw_rest = mm.prepare_mari_weight(w), mm.prepare_mari_weight(wr)
            calls = {
                "library_vanilla": lambda: torch.addmm(zero, x_tiled, w),
                "plain_mari": lambda: matmul_mari(xu, xr, wu, wr),
                "kernel_vanilla": lambda: mm.mari_matmul(x_tiled, pw, zero),
                "kernel_mari": lambda: mm.mari_matmul(xr, pw_rest, xu @ wu),
            }
            errs = {
                "kernel_vanilla": max_err(calls["kernel_vanilla"](),
                                          calls["library_vanilla"]()),
                "kernel_mari": max_err(calls["kernel_mari"](),
                                       calls["plain_mari"]())}
            ms = {k: time_ms(f) for k, f in calls.items()}
            # each column's function moves WeightPartition's bytes (each
            # weight once; kernel vanilla also reads its zero row); the
            # kernel does the stream as 3xTF32, kernel MaRI's GEMV at fp32
            # (its operations given in seconds, at each type's peak)
            km_s = (2 * Du * d / PEAK_FP32_FLOPS
                    + 3 * 2 * B * Dr * d / PEAK_TF32_FLOPS)
            bounds = {
                "library_vanilla": bound(part.bytes_vanilla(B),
                                         part.flops_vanilla(B)),
                "plain_mari": bound(part.bytes_mari(B), part.flops_mari(B)),
                "kernel_vanilla": bound(part.bytes_vanilla(B) + 4 * d,
                                        3 * 2 * B * part.d_in * d,
                                        PEAK_TF32_FLOPS),
                "kernel_mari": bound(part.bytes_mari(B), km_s, 1.0)}
            log("table2", point=label, B=B, D_user=Du, D_item=part.d_item,
                D_cross=part.d_cross, D_hidden=d, ms=ms,
                time_ratio=dict(
                    library_vanilla_over_plain_mari=(
                        ms["library_vanilla"] / ms["plain_mari"]),
                    kernel_vanilla_over_kernel_mari=(
                        ms["kernel_vanilla"] / ms["kernel_mari"])),
                flops_ratio=part.flops_speedup(B),
                bytes_ratio=part.bytes_vanilla(B) / part.bytes_mari(B),
                bound_ms={k: v[0] for k, v in bounds.items()},
                bound_by={k: v[1] for k, v in bounds.items()},
                bound_ratio=dict(
                    library=(bounds["library_vanilla"][0]
                             / bounds["plain_mari"][0]),
                    kernel=(bounds["kernel_vanilla"][0]
                            / bounds["kernel_mari"][0])),
                max_abs_err=errs, tol=TOL)
            del xu, xr, wu, wr, x_tiled, w, pw, pw_rest, calls

    def table3_phase() -> None:
        """Phase 9, ``table3``: the reference's bench_table3 at scale 1.0
        (B 2000, D_user 4000, D_item 1000, D_hidden 256): the original
        (vanilla) matmul, neat MaRI and MaRI over the interleaved layout at
        each chunk width, each compiled (``CompiledRun``: the reference
        times them under ``jax.jit``; inputs read by reference, so a call
        is one replay) and eager; device ms (CUDA events behind a sleep)
        and host-wall p50 ms each, and ``vs_original`` % as the
        reference prints it."""
        B, Du, Di, d = T3_B, T3_DU, T3_DI, T3_D
        scale = (Du + Di) ** -0.5
        xu, xi = randn(1, Du), randn(B, Di)
        params = {"wu": randn(Du, d) * scale, "wi": randn(Di, d) * scale}
        params["w"] = torch.cat([params["wu"], params["wi"]], 0)
        refs = {"xu": xu, "xi": xi,
                "x_tiled": torch.cat([xu.expand(B, Du), xi], -1)}

        def fragmented(chunk):
            spans = interleaved_spans(Du, Di, chunk)

            def fn(p, f):
                segs = [(f["xu"][:, o:o + w], p["wu"][o:o + w])
                        if dom == "user" else
                        (f["xi"][:, o:o + w], p["wi"][o:o + w])
                        for dom, o, w in spans]
                return {"y": matmul_mari_fragmented(segs)}
            return fn, len(spans)

        variants = {
            "original": (lambda p, f: {"y": matmul_vanilla(f["x_tiled"],
                                                           p["w"])}, 1),
            "neat_mari": (lambda p, f: {"y": matmul_mari(
                f["xu"], f["xi"], p["wu"], p["wi"])}, 2)}
        for c in T3_CHUNKS:
            variants[f"fragmented/chunk={c}"] = fragmented(c)
        want = variants["original"][0](params, refs)["y"]
        rows = {}
        for name, (fn, n_mm) in variants.items():
            comp = CompiledRun(fn, device=dev)

            def compiled(comp=comp):
                return comp(params, {}, refs)

            def eager(fn=fn):
                with torch.inference_mode():
                    return fn(params, refs)
            err = max(max_err(f()["y"], want) for f in (compiled, eager))
            rows[name] = dict(matmuls=n_mm, max_abs_vs_original=err)
            for lab, f in (("compiled", compiled), ("eager", eager)):
                t = timeit(f, warmup=3, iters=20)
                rows[name][lab] = dict(ms=time_ms(f),
                                       p50_ms=t["p50_us"] / 1e3,
                                       mean_ms=t["mean_us"] / 1e3)
        for name, r in rows.items():
            r["vs_original_pct"] = {
                lab: {k: 100 * (r[lab][k] - rows["original"][lab][k])
                      / rows["original"][lab][k] for k in ("ms", "p50_ms")}
                for lab in ("compiled", "eager")}
            log("table3", variant=name, B=B, D_user=Du, D_item=Di,
                D_hidden=d, **r)

    def reorg_graph():
        """Table 3's setting as a ranking graph: the user and item chunks
        of width REORG_CHUNK that the reference's loop forms, one concat,
        dense(256, relu), dense(1)."""
        b = GraphBuilder()
        names = [b.input(f"{dom}_{k}", (w,), dom) for k, (dom, _, w)
                 in enumerate(interleaved_spans(T3_DU, T3_DI, REORG_CHUNK))]
        h = b.dense("fc", b.concat("fusion", names), T3_D, activation="relu")
        b.output(b.dense("logit", h, 1))
        return b.graph

    def reorg_phase() -> None:
        """Phase 9, ``reorg`` (path ``reorg``): three ``tpu`` engines over
        the interleaved graph (fragment=True, the §2.4 regime;
        group_by_domain=True) and over its reorganization (``reorganize``
        -> ``convert_params_reorg`` -> the engine's own rewrite), each held
        to a use_pallas=False VanI engine on the original graph and params;
        warm ``score`` p50 per pool, ``pack`` / ``dispatch`` ms per pack,
        graphs built. Then (path ``table3``) the same three graphs as
        single calls of B = T3_B through the kernels, compiled and eager,
        beside the plain VanI call."""
        graph = reorg_graph()
        params = init_graph_params(graph, seed=0, device=dev)
        g3, plans = reorganize(graph)
        p3 = convert_params_reorg(plans, params)
        oracle = ServingEngine(graph, params,
                               plain.evolve(graph__mode="vani"), device=dev)
        reqs = requests(graph, POOLS, seed=20)
        ref = [oracle.score(r).scores for r in reqs]
        oracle.close()
        engines = {
            "fragment": (graph, params, tpu.evolve(graph__fragment=True)),
            "group_by_domain": (graph, params,
                                tpu.evolve(graph__group_by_domain=True)),
            "reorganized": (g3, p3, tpu)}
        engs, built, diffs = {}, {}, {}
        for name, (g, p, plan) in engines.items():
            eng = engs[name] = ServingEngine(g, p, plan, device=dev)
            with counting("reorg"):
                per = [eng.score(r) for r in reqs]       # cold: stage 1 runs
                co = eng.score_coalesced(reqs)
            built[name] = graph_stats(eng)
            d = 0.0
            for r, p_, c, o in zip(reqs, per, co, ref):
                n = next(iter(r.candidate_feeds.values())).shape[0]
                for s_ in (p_.scores, c.scores):
                    if s_.shape != (n, 1) or not (np.isfinite(s_).all()
                                                  and close(s_, o)):
                        raise AssertionError(
                            f"reorg/{name}: outside {TOL} of the plain VanI "
                            f"engine: {np.abs(s_ - o).max():.3e}")
                    d = max(d, float(np.abs(s_ - o).max()))
            diffs[name] = d
            check_graphs(f"reorg/{name}", eng)
            eng.profiler.snapshot(reset=True)
        # warm passes: round k starts at engine k mod 3, so drift on the
        # host falls on the three engines alike
        names = list(engs)
        warm = {name: [] for name in names}
        with counting("reorg"):
            for k in range(REORG_WARM_PASSES):
                for name in names[k % 3:] + names[:k % 3]:
                    warm[name].append([engs[name].score(r).latency_ms
                                       for r in reqs])
        for name, eng in engs.items():
            prof = eng.profiler.snapshot(reset=True)
            if graph_stats(eng) != built[name]:
                raise AssertionError(f"reorg/{name}: a warm pass captured")
            conv = eng.conversion
            log("reorg", engine=name, pools=list(POOLS),
                segments=len(graph.input_nodes()),
                reorg_plans=[dict(concat=pl.concat, perm_moves=sum(
                    i != j for i, j in enumerate(pl.perm)),
                    remapped=pl.remapped_denses,
                    restored=pl.restored_consumers) for pl in plans]
                if name == "reorganized" else None,
                rewrites=[dict(dense=r.dense, fragment=r.fragment,
                               groups=[(lab, len(ix)) for lab, ix in r.groups])
                          for r in conv.rewrites],
                max_abs_vs_vani_plain=diffs[name],
                warm_passes=REORG_WARM_PASSES,
                warm_score_ms={f"p{q}": [float(np.percentile(col, q))
                                         for col in zip(*warm[name])]
                               for q in (10, 50, 90)},
                pack_ms_per_pack=prof["pack"]["mean_us"] / 1e3,
                dispatch_ms_per_pack=prof["dispatch"]["mean_us"] / 1e3,
                packs=prof["dispatch"]["calls"], graphs=graph_stats(eng))
            eng.close()
        del engs, eng

        # the single calls: one request of T3_B candidates
        one = requests(graph, (T3_B,), seed=21)[0]
        feeds = {k: torch.as_tensor(v, device=dev) for k, v in
                 {**one.user_feeds, **one.candidate_feeds}.items()}
        runs = [("vani_plain", graph, params, "vani", False)]
        for name, g, p, kw in (("fragment", graph, params,
                                dict(fragment=True)),
                               ("group_by_domain", graph, params,
                                dict(group_by_domain=True)),
                               ("reorganized", g3, p3, {})):
            mg, mp, _ = apply_mari(g, p, **kw)
            runs.append((name, mg, mm.prepare_mari_params(mg, mp), "uoi",
                         True))
        outputs = list(graph.outputs)
        with counting("table3"):
            calls = make_calls(runs)
            scores = single_call(outputs, calls, feeds)
            d_eager = compiled_vs_eager(outputs, calls, feeds, scores)
            times = time_calls(calls, feeds)
        want = scores["vani_plain"].cpu().numpy()
        for k, v in scores.items():
            a = v.cpu().numpy()
            if a.shape != (T3_B, 1) or not (np.isfinite(a).all()
                                            and close(a, want)):
                raise AssertionError(f"table3 single call {k} vs VanI: "
                                     f"{np.abs(a - want).max():.3e}")
        log("table3_single_call", candidates=T3_B,
            max_abs_vs_vani={k: float((v - scores["vani_plain"]).abs().max())
                             for k, v in scores.items()},
            max_abs_compiled_vs_eager=d_eager, times=times,
            graph_reserved_mb={k: c[1].pool.reserved_bytes / 1e6
                               for k, c in calls.items()})

    def examples_phase() -> None:
        """Phase 9, ``examples``: the two ported examples as a user runs
        them, on the card; each must exit 0 (its asserts held)."""
        env = dict(os.environ, PYTHONPATH=SRC)
        for argv in (["repro_torch.examples.gca_demo"],
                     ["repro_torch.examples.serve_ranking", "--use-pallas",
                      "--scale", "1.0"]):
            t = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                                 env=env, capture_output=True, text=True,
                                 timeout=EXAMPLES_TIMEOUT)
            log("examples", cmd=" ".join(argv), rc=out.returncode,
                seconds=time.perf_counter() - t,
                stdout=out.stdout.strip().splitlines(),
                stderr=out.stderr.strip().splitlines()[-10:])
            if out.returncode != 0:
                raise AssertionError(f"{argv[0]} exited {out.returncode}")

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

    # ---- phase 3b: DIN at its public D = 128 -------------------------------
    # (github.com/zhougr1993/DeepInterestNetwork, din/model.py: item and
    # category embeddings of 64 each; the 80-40 attention MLP and 200-80
    # fusion MLP of configs/din.py; the item vocabulary cut from 10M to 1M
    # rows to keep the script in its time, every width full). The
    # coalesced engine (tpu preset, one pool) runs mari_matmul and
    # gather_einsum's bd,uldh->blh and bl,uld->bd at D = 128 (path
    # din128_engine); the single call (launch/steps.py's _recsys_serve,
    # compiled, fp32 and serve_bf16) runs the whole attention unit through
    # din_attention's wide route (path din128_single)
    din128 = functools.partial(build_din, embed_dim=128, seq_len=100,
                               attn_mlp=(80, 40), mlp=(200, 80),
                               item_vocab=DIN128_VOCAB)
    t_phase = time.perf_counter()
    gc.collect()                # the engines above leave their graphs'
    torch.cuda.empty_cache()    # pools cached: a capture cannot free them
    graph, _ = din128()
    params = init_graph_params(graph, seed=0, device=dev)
    serve_checks("din128", graph, params, {"tpu": tpu}, plain,
                 requests(graph, (DIN128_POOL,), seed=5), n_out=1,
                 path="din128_engine", twin=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.launch.steps import _recsys_serve
    for opts, tol in (((), TOL), (("serve_bf16",), BF16_TOL)):
        prog = _recsys_serve(types.SimpleNamespace(BUILD=din128),
                             SINGLE_CALL_B, opts=frozenset(opts))
        params = prog.init(seed=0, device=dev)
        feeds = device_feeds("din", prog.args[1], gen, graph=graph)
        serve = prog.compiled(dev)
        with counting("din128_single"):
            got = serve(params, feeds)
            ms = []
            for _ in range(DIN128_CALLS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                serve(params, feeds)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            prof = profile_call(lambda: serve(params, feeds))
            torch.cuda.synchronize()
            launched = {k: v for k, v in read_launches().items() if v}
        want = prog.compiled(dev, use_pallas=False)(params, feeds)
        d = float((got.float() - want.float()).abs().max())
        if (tuple(got.shape) != (SINGLE_CALL_B, 1)
                or not bool(torch.isfinite(got).all())
                or not torch.allclose(got.float(), want.float(), **tol)):
            raise AssertionError(f"din128 single call {opts}: kernels vs "
                                 f"plain {d:.3e}, shape {tuple(got.shape)}")
        log("din128_single", opts=list(opts), rows=SINGLE_CALL_B,
            D=128, attn_mlp=[80, 40], item_vocab=DIN128_VOCAB,
            reduced=["item_vocab 10,000,000 -> 1,000,000"],
            p50_ms=float(np.median(ms)),
            p10_p90_ms=[float(np.percentile(ms, q)) for q in (10, 90)],
            calls=DIN128_CALLS, launches=launched,
            din_attention_kernels=[k for k in prof["top_kernels"]
                                   if "din_w" in k[0]],
            profile=prof, max_abs_kernels_vs_plain=d, tol=tol,
            dtype="bfloat16" if opts else "float32")
        del prog, params, feeds, serve, got, want
    log("din128_phase", seconds=time.perf_counter() - t_phase)

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

    # ---- phase 8: distributed serving through the runner -------------------
    gc.collect()
    torch.cuda.empty_cache()
    dist_phase()

    # ---- phase 9: the paper's Tables 2-3, the reorg path, the examples -----
    t_phase = time.perf_counter()
    table2_phase()
    table3_phase()
    reorg_phase()
    examples_phase()
    log("paper_tables_phase", seconds=time.perf_counter() - t_phase)

    # ---- phase 10: the LM family's serving path ----------------------------
    gc.collect()
    torch.cuda.empty_cache()
    lm_phase(dev, counting)
    if any(by_path["lm"].values()):
        raise AssertionError(f"the LM path launched a recsys kernel: "
                             f"{by_path['lm']}")

    # ---- phase 11: the training and serving cells --------------------------
    gc.collect()
    torch.cuda.empty_cache()
    cells_phase(dev, counting)

    # ---- phase 12: SchNet's training cells ----------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    gnn_phase(dev, counting)
    if any(by_path["gnn"].values()):
        raise AssertionError(f"the GNN path launched a recsys kernel: "
                             f"{by_path['gnn']}")

    # ---- phase 13: the cells on a mesh, the dry run --------------------------
    gc.collect()
    torch.cuda.empty_cache()
    sharded_phase(dev, counting)
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
    # contractions, the runner's sharded engines to the gathered MaRI init
    # (every rank, checked in dist_phase), the three engines of the reorg
    # path to the gathered MaRI init and its single calls (table3) to the
    # broadcast init, the serve cells of phase 11 (cells) and phase 13's
    # serving call on the mesh (sharded) to the broadcast init of their
    # single calls; table1 is only printed
    held = {"paper+din": [k for k in entries
                          if k.startswith(("mari_matmul/", "gather_einsum/"))
                          and k not in OFF_PATH
                          and not k.endswith(("/bf16", "/tc"))]}
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
    held["dist"] = ["mari_matmul/gather"]
    held["reorg"] = ["mari_matmul/gather"]
    held["table3"] = ["mari_matmul/broadcast"]
    held["cells"] = ["mari_matmul/broadcast", "mari_matmul/bf16",
                     "din_attention/bf16", "dot_interaction/bf16"]
    held["sharded"] = ["mari_matmul/broadcast"]
    held["generic"] = ["gather_einsum/generic", "gather_einsum/generic/bf16"]
    held["din128_engine"] = ["mari_matmul/gather",
                             f"gather_einsum/{ge.ops.TC_KEY}",
                             "gather_einsum/bl,uld->bd"]
    held["din128_single"] = ["din_attention/wide", "din_attention/wide/bf16",
                             "mari_matmul/broadcast", "mari_matmul/bf16"]
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
    # and din_attention's wide route its prepared weights
    # (prepare_din_params at load; the single calls before their loop)
    din_late = {p: h["din_prepares"] for p, h in host_by_path.items()
                if h["din_prepares"]}
    if din_late:
        raise AssertionError(f"din_attention prepared weights inside calls: "
                             f"{din_late}")
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
    log("timing", total_seconds=time.perf_counter() - t_script)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
