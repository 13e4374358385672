"""End to end: TRAIN the paper's ranking model (MMoE + cross-attention +
task towers), CONVERT it with GCA + MaRI, and check the deployment claim:
the same scores, the same AUC, faster serving (port of
``examples/train_then_convert.py``; §2.5 of the paper: the training
pipeline is untouched, the inference graph is re-parameterized after
training)::

  python -m repro_torch.examples.train_then_convert [--steps 300] \\
      [--device cpu] [--use-pallas]

Training runs the VanI executor through autograd (``use_pallas`` off: no
kernel has a backward). ``--use-pallas`` scores the converted model and
the UOI baseline through the hand-written kernels. Where the reference
asserts bit-level equality, this asserts the fp32 tolerance (2e-4) on the
scores and |dAUC| <= 1e-3 per task.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.common import resolve_device, timeit, tree_size
from repro_torch.core.mari import apply_mari
from repro_torch.data.features import make_recsys_feeds
from repro_torch.graph.compiled import CompiledRun
from repro_torch.graph.executor import Executor, init_graph_params
from repro_torch.kernels.mari_matmul import prepare_mari_params
from repro_torch.launch.train import recsys_step
from repro_torch.models.ranking import (PaperRankingConfig,
                                        build_paper_ranking_model)
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.losses import auc
from repro_torch.train.optim import adam

TOL = dict(rtol=2e-4, atol=2e-4)      # fp32, as tests/test_kernels.py
AUC_TOL = 1e-3


def teacher_batches(graph, teacher, ex, device, seed: int, bsz: int = 64):
    """Endless (feeds, labels) batches: user feeds tiled to the batch, and
    labels from a frozen teacher (each task's logit above its batch
    median), so AUC is a meaningful quantity."""
    outputs = list(graph.outputs)
    rng = np.random.default_rng(seed)
    while True:
        feeds = make_recsys_feeds(graph, bsz, rng, tile_user=True)
        with torch.no_grad():
            t = ex.run(teacher, feeds)
            logits = torch.cat([t[o] for o in outputs], -1)
            labels = (logits > logits.median(dim=0).values).float()
        yield feeds, labels


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--scale", type=float, default=0.05,
                    help="model scale (1.0 = paper dims)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ranking_ckpt"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-pallas", action="store_true",
                    help="score UOI / MaRI through the CUDA kernels")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    cfg = PaperRankingConfig().scaled(args.scale)
    graph, cfg = build_paper_ranking_model(cfg)
    outputs = list(graph.outputs)
    params = init_graph_params(graph, seed=0, device=dev)
    print(f"[1/4] built ranking model: {len(graph.nodes)} nodes, "
          f"{tree_size(params) / 1e6:.1f}M params, {len(outputs)} tasks")

    teacher = init_graph_params(graph, seed=99, device=dev)
    ex = Executor(graph, "vani", device=dev)
    opt = adam(2e-3)
    print(f"[2/4] training {args.steps} steps (ckpt + resume enabled)...")
    mgr = CheckpointManager(args.ckpt_dir, max_to_keep=2)
    state, hist = train_loop(
        recsys_step(ex, outputs, opt),
        {"params": params, "opt": opt.init(params)},
        teacher_batches(graph, teacher, ex, dev, seed=1), mgr,
        LoopConfig(total_steps=args.steps, ckpt_every=100, log_every=50))
    params = state["params"]

    print("[3/4] GCA + MaRI conversion (training pipeline untouched)...")
    mari_graph, mari_params, conv = apply_mari(graph, params)
    print("   ", conv.summary())
    if args.use_pallas:       # the mari_matmul kernel's weights, once
        mari_params = prepare_mari_params(mari_graph, mari_params)

    # evaluation: scores + AUC before / after conversion
    feeds, labels = next(teacher_batches(graph, teacher, ex, dev,
                                         seed=12345, bsz=512))
    user_in = {n.name for n in graph.input_nodes()
               if n.attrs.get("domain") == "user"}
    sfeeds = {k: (v[:1] if k in user_in else v) for k, v in feeds.items()}
    mex = Executor(mari_graph, "uoi", use_pallas=args.use_pallas, device=dev)
    with torch.inference_mode():
        base = ex.run(params, feeds)
    mout = CompiledRun(mex.run, device=dev)(mari_params, sfeeds)
    base_logits = torch.cat([base[o] for o in outputs], -1)
    mari_logits = torch.cat([mout[o] for o in outputs], -1)
    err = float((base_logits - mari_logits).abs().max())
    print(f"    max |VanI - MaRI| over {base_logits.shape[0]} candidates: "
          f"{err:.2e}")
    torch.testing.assert_close(mari_logits, base_logits, **TOL)
    b_np, m_np = base_logits.cpu().numpy(), mari_logits.cpu().numpy()
    labels_np = labels.cpu().numpy()
    deltas = []
    for t in range(len(outputs)):
        a0 = auc(b_np[:, t], labels_np[:, t])
        a1 = auc(m_np[:, t], labels_np[:, t])
        deltas.append(abs(a0 - a1))
        print(f"    task {t}: AUC before={a0:.6f} after={a1:.6f} "
              f"delta={abs(a0 - a1):.2e}")
        assert abs(a0 - a1) <= AUC_TOL, "MaRI must be lossless"

    B = 2048
    print(f"[4/4] serving latency (B={B} candidates/request):")
    bench = make_recsys_feeds(graph, B, np.random.default_rng(7))
    bench = {k: torch.as_tensor(v, device=dev) for k, v in bench.items()}
    times = {}
    for name, g, p in [("UOI (prod baseline)", graph, params),
                       ("MaRI", mari_graph, mari_params)]:
        # compiled, as the reference's jax.jit(Executor(g, mode).run)
        run = CompiledRun(Executor(g, "uoi", use_pallas=args.use_pallas,
                                   device=dev).run, device=dev)
        t = timeit(lambda: run(p, bench), warmup=3, iters=20)
        times[name] = t
        print(f"    {name:<20} {t['mean_us'] / 1e3:8.2f} ms "
              f"(p50 {t['p50_us'] / 1e3:.2f}, p99 {t['p99_us'] / 1e3:.2f} ms)")
    return {"history": hist, "max_abs_vani_vs_mari": err,
            "auc_deltas": deltas, "times": times}


if __name__ == "__main__":
    main()
