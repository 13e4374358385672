"""Quickstart: MaRI in 60 seconds (port of ``examples/quickstart.py``).

Builds a small user/item/cross ranking graph, auto-detects the eligible
feature-fusion matmuls with GCA (Algorithm 1), re-parameterizes them
(Eq. 7), and shows (a) that the scores are unchanged within fp32
tolerance and (b) the latency of VanI, UOI and MaRI, each compiled (one
captured CUDA graph per paradigm, ``CompiledRun`` — the reference's
``jax.jit``) beside the eager executor::

  python -m repro_torch.examples.quickstart [--device cpu] [--use-pallas]

``--device`` defaults to ``cuda``; ``--use-pallas`` runs the UOI and MaRI
executors through the hand-written kernels (their plain versions on the
CPU, where the compiled runs execute their body eagerly).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.common import resolve_device, timeit
from repro_torch.core.gca import run_gca
from repro_torch.core.mari import apply_mari
from repro_torch.graph.compiled import CompiledRun
from repro_torch.graph.executor import Executor, init_graph_params
from repro_torch.graph.ir import GraphBuilder
from repro_torch.kernels.mari_matmul import prepare_mari_params

TOL = dict(rtol=2e-4, atol=2e-4)      # fp32, as tests/test_kernels.py


def build_graph():
    # a user tower feeds a fusion MLP together with per-candidate item /
    # cross features; D_user dominates (rich user profiles, B candidates)
    b = GraphBuilder()
    user = b.input("user_profile", shape=(2000,), domain="user")
    item = b.input("item_feats", shape=(250,), domain="item")
    cross = b.input("cross_feats", shape=(250,), domain="cross")
    u_emb = b.dense("user_tower", user, 512, activation="relu")
    fusion = b.concat("fusion", [u_emb, item, cross])
    h = b.dense("fc1", fusion, 512, activation="relu")
    h = b.dense("fc2", h, 128, activation="relu")
    b.output(b.dense("ctr_logit", h, 1))
    return b.graph


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-pallas", action="store_true",
                    help="UOI / MaRI through the CUDA kernels")
    ap.add_argument("--candidates", type=int, default=4096)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    # 1. the graph; 2. GCA finds what to rewrite, no annotation of fc1
    graph = build_graph()
    print(run_gca(graph).summary())

    # 3. convert the trained weights (random init stands in)
    params = init_graph_params(graph, seed=0, device=dev)
    mari_graph, mari_params, conv = apply_mari(graph, params)
    print(conv.summary())
    if args.use_pallas:       # the mari_matmul kernel's weights, once
        mari_params = prepare_mari_params(mari_graph, mari_params)

    # 4. score B candidates for one user, three ways
    B = args.candidates
    rng = np.random.default_rng(1)
    feeds = {
        "user_profile": rng.standard_normal((1, 2000), dtype=np.float32),
        "item_feats": rng.standard_normal((B, 250), dtype=np.float32),
        "cross_feats": rng.standard_normal((B, 250), dtype=np.float32),
    }
    feeds = {k: torch.as_tensor(v, device=dev) for k, v in feeds.items()}
    runs = [("VanI", Executor(graph, "vani", device=dev), params),
            ("UOI", Executor(graph, "uoi", use_pallas=args.use_pallas,
                             device=dev), params),
            ("MaRI", Executor(mari_graph, "uoi", use_pallas=args.use_pallas,
                              device=dev), mari_params)]
    compiled = {name: CompiledRun(ex.run, device=dev) for name, ex, _ in runs}
    s_vani = compiled["VanI"](params, feeds)["ctr_logit"]
    s_mari = compiled["MaRI"](mari_params, feeds)["ctr_logit"]
    err = float((s_vani - s_mari).abs().max())
    print(f"max |VanI - MaRI| over {B} candidates: {err:.2e}  "
          f"(lossless within fp32 rounding)")
    torch.testing.assert_close(s_mari, s_vani, **TOL)
    with torch.inference_mode():
        for name, ex, p in runs:
            tc = timeit(lambda: compiled[name](p, feeds), warmup=2, iters=10)
            te = timeit(lambda: ex.run(p, feeds), warmup=2, iters=10)
            print(f"{name:>5}: compiled {tc['mean_us'] / 1e3:8.2f} ms/call "
                  f"(p50 {tc['p50_us'] / 1e3:.2f}), eager "
                  f"{te['mean_us'] / 1e3:8.2f} (p50 "
                  f"{te['p50_us'] / 1e3:.2f})")
    return err


if __name__ == "__main__":
    main()
