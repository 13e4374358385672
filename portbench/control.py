"""The readings that ``correct``'s limits are set from, on the card, at
a cell's own size and load: for each seed, one short window of the cell
and its sampled answers held to the reference (the program's reading),
then the reference computed with TF32 on held to the same reference in
the program's place (the control's reading). One process, every seed.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 4
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"       # as run.py: one intra-op thread


def main() -> None:
    import torch
    from portbench import harness, traffic
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    wl = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = harness.load_config(wl["config"])
    mix = traffic.load_mix(wl["traffic"])
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        system = harness.make_system(cfg, mix, seed, args.seconds, dev)
        run = system.window()
        system.release()
        gc.collect()
        torch.cuda.empty_cache()
        prog = harness.judge(system)
        ctrl = harness.judge(system, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": prog, "control": ctrl,
                          "attempted": len(run.start),
                          "failed": run.failed}), flush=True)
        del system, run
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
