"""Training launcher (port of ``repro.launch.train``)::

  python -m repro_torch.launch.train --arch din --steps 50 --ckpt-dir D
  python -m repro_torch.launch.train --arch granite-moe-3b-a800m --steps 20

Trains the registry model's smoke build (recsys: VanI executor, Adam, BCE
on synthetic feeds and labels from ``data.features``; LM: the smoke
config in fp32, AdamW with f32 master weights, ``lm_loss`` on 8 × 32
uniform token batches), checkpointing into ``--ckpt-dir`` and resuming
from its newest checkpoint, as the reference's ``--smoke`` path does (the
only size either launcher trains). On the card each step is one replay of
a captured CUDA graph (``graph.compiled.CompiledStep``: the state updated
in place, a restored checkpoint copied into the captured state); on the
CPU the same in-place step runs eagerly. ``--device`` defaults to
``cuda`` (the run fails without a card); ``--device cpu`` runs on the
CPU. The GNN family exits with the reference's message, as the reference
has no GNN launcher: its cells train through
``launch.steps.build_cell("schnet", shape).compiled()``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.common import resolve_device
from repro_torch.graph.compiled import CompiledStep
from repro_torch.launch.steps import (compiled_train_step, lm_train_loss,
                                      recsys_loss, recsys_pack)
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optim import Optimizer


def recsys_step(executor, outputs: list[str], opt: Optimizer
                ) -> CompiledStep:
    """``step(state, (feeds, labels)) -> (state, {"loss"})``: BCE over the
    concatenated task logits, gradients by autograd through the executor,
    and ``opt.update_`` on the state in place, behind one captured CUDA
    graph on the executor's device (eager over static buffers on the
    CPU); ``step.compilations`` counts its graphs."""
    return compiled_train_step(recsys_loss(lambda _: executor, outputs), opt,
                               device=executor.device,
                               pack=lambda batch: recsys_pack(*batch))


def _smoke_lm(arch: str, steps: int, ckpt_dir: str, device):
    from repro_torch import configs as cfgreg
    from repro_torch.data.lm import token_batch
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.train.optim import adamw

    cfg = cfgreg.get_config(arch).smoke_config()
    opt = adamw(1e-3, master_weights=True)
    params = init_lm_params(cfg, seed=0, dtype=torch.float32, device=device)
    state = {"params": params, "opt": opt.init(params)}

    def batches():
        gen = torch.Generator(device=device)
        gen.manual_seed(1)
        while True:
            yield token_batch(gen, 8, 32, cfg.vocab)

    mgr = CheckpointManager(ckpt_dir)
    return train_loop(compiled_train_step(lm_train_loss(cfg), opt,
                                          device=device),
                      state, batches(), mgr, LoopConfig(steps))


def _smoke_recsys(arch: str, steps: int, ckpt_dir: str, device):
    from repro_torch import configs as cfgreg
    from repro_torch.data.features import make_labels, make_recsys_feeds
    from repro_torch.graph.executor import Executor, init_graph_params
    from repro_torch.train.optim import adam

    graph, *_ = cfgreg.get_config(arch).smoke_build()()
    ex = Executor(graph, "vani", device=device)
    outputs = list(graph.outputs)
    opt = adam(1e-3)
    params = init_graph_params(graph, seed=0, device=device)
    state = {"params": params, "opt": opt.init(params)}

    def batches():
        rng = np.random.default_rng(1)
        while True:
            feeds = make_recsys_feeds(graph, 32, rng, tile_user=True)
            labels = make_labels(32, rng, len(outputs))
            yield feeds, torch.as_tensor(labels, device=device)

    mgr = CheckpointManager(ckpt_dir)
    return train_loop(recsys_step(ex, outputs, opt), state,
                      batches(), mgr, LoopConfig(steps))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "path on the host)")
    args = ap.parse_args(argv)

    from repro_torch import configs as cfgreg
    try:
        fam = cfgreg.get_config(args.arch).FAMILY
    except KeyError as e:
        raise SystemExit(str(e.args[0]))
    dev = resolve_device(args.device)
    if fam == "lm":
        _, hist = _smoke_lm(args.arch, args.steps, args.ckpt_dir, dev)
    elif fam == "recsys":
        _, hist = _smoke_recsys(args.arch, args.steps, args.ckpt_dir, dev)
    else:
        raise SystemExit("use examples/train_schnet for gnn smoke training")
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return hist


if __name__ == "__main__":
    main()
