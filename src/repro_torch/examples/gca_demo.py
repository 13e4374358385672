"""GCA demo: Algorithm 1 on (a) the graph IR and (b) a traced PyTorch
function (port of ``examples/gca_demo.py``).

Shows the coloring, the boundary concats, and why nodes behind a
nonlinearity are NOT eligible — plus the aten-graph auditor
(``detect_in_fx``, the counterpart of the reference's jaxpr auditor) that
works on any plain-torch model function::

  python -m repro_torch.examples.gca_demo [--device cpu]

``--device`` (default ``cuda``) holds part (b)'s tensors; the trace runs
under fake tensors, so nothing is computed on it.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.common import resolve_device
from repro_torch.core import Color, detect_in_fx, run_gca
from repro_torch.models.ranking import (PaperRankingConfig,
                                        build_paper_ranking_model,
                                        expected_eligible)


def my_model(params, feeds):
    u = torch.relu(feeds["user_vec"] @ params["wu"])
    z = torch.cat(
        [u.expand(feeds["item_vec"].shape[0], u.shape[-1]),
         feeds["item_vec"]], dim=-1)
    h = z @ params["w1"]                     # eligible (pre-activation)
    h2 = torch.relu(h) @ params["w2"]        # NOT eligible (behind relu)
    return h2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ---- (a) graph IR: the paper's own ranking model ----------------------
    graph, cfg = build_paper_ranking_model(PaperRankingConfig().scaled(0.05))
    res = run_gca(graph)
    print("=== GCA on the paper's ranking model (Fig. 1) ===")
    print(res.summary())
    print("\nnode colors:")
    for name, color in res.colors.items():
        marker = {Color.YELLOW: "Y", Color.BLUE: "B",
                  Color.UNCOLORED: "."}[color]
        star = " <-- MaRI-eligible" if name in res.eligible else ""
        print(f"  [{marker}] {name}{star}")

    expect = expected_eligible(cfg)
    found = set(res.eligible)
    print(f"\npaper-named sites found automatically: "
          f"{sorted(expect & found)}")
    print(f"extra sites GCA discovered: {sorted(found - expect)}")
    if not expect <= found:
        raise SystemExit(f"GCA missed {sorted(expect - found)}")

    # ---- (b) aten-graph detection on an arbitrary model function ----------
    print("\n=== fx-GCA on a hand-written model function ===")
    params = {"wu": torch.zeros(32, 16, device=dev),
              "w1": torch.zeros(48, 64, device=dev),
              "w2": torch.zeros(64, 1, device=dev)}
    feeds = {"user_vec": torch.zeros(1, 32, device=dev),
             "item_vec": torch.zeros(100, 32, device=dev)}
    report = detect_in_fx(my_model,
                          {"user_vec": "user", "item_vec": "item"},
                          params, feeds)
    print(report.summary())
    if len(report.eligible) != 1:
        raise SystemExit(f"expected exactly one eligible matmul, got "
                         f"{report.eligible}")
    print("exactly the pre-activation matmul is flagged ✓")


if __name__ == "__main__":
    main()
