"""Training launcher (port of ``repro.launch.train``, the recsys family)::

  python -m repro_torch.launch.train --arch din --steps 50 --ckpt-dir D

Trains the registry model's smoke build in VanI mode with Adam on
synthetic feeds and labels (``data.features``), checkpointing into
``--ckpt-dir`` and resuming from its newest checkpoint, as the
reference's ``--smoke`` path does (the only size either launcher
trains). ``--device`` defaults to ``cuda`` (the
run fails without a card); ``--device cpu`` runs on the CPU. The LM
family's training path and the GNN family are not ported yet: asking for
one exits with a message.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.common import resolve_device, value_and_grad
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.losses import bce_with_logits
from repro_torch.train.optim import Optimizer, apply_updates


def recsys_step(executor, outputs: list[str], opt: Optimizer):
    """``step(state, (feeds, labels)) -> (state, {"loss"})``: BCE over the
    concatenated task logits, gradients by autograd through the
    executor, one optimizer update."""
    def step(state, batch):
        feeds, labels = batch

        def loss_fn(p):
            out = executor.run(p, feeds)
            return bce_with_logits(torch.cat([out[o] for o in outputs], -1),
                                   labels)

        loss, grads = value_and_grad(loss_fn, state["params"])
        with torch.no_grad():
            updates, opt_state = opt.update(grads, state["opt"],
                                            state["params"])
            params = apply_updates(state["params"], updates)
        return {"params": params, "opt": opt_state}, {"loss": loss}
    return step


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
    return train_loop(recsys_step(ex, outputs, opt), state, batches(), mgr,
                      LoopConfig(steps))


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
    if fam == "lm":
        raise SystemExit(
            f"{args.arch}: the LM training path is not ported yet — it comes "
            f"with the next slice of the port (the captured training step "
            f"with lm_loss, AdamW and master weights); the LM serving path "
            f"is in: repro_torch.launch.steps.build_cell")
    if fam != "recsys":
        raise SystemExit(f"the {fam} family is not ported yet")
    dev = resolve_device(args.device)
    _, hist = _smoke_recsys(args.arch, args.steps, args.ckpt_dir, dev)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return hist


if __name__ == "__main__":
    main()
