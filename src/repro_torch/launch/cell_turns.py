"""Time one cell's compiled call on this checkout and on other checkouts
of the repository, on one card, taking turns.

    python -m repro_torch.launch.cell_turns [OTHER_ROOT ...] \\
        --arch paper-ranking --shape serve_bulk [--opts serve_bf16] \\
        [--calls 10] [--rounds 1]

Each turn is a fresh process that imports ``repro_torch`` from one tree's
``src`` (this checkout's, or an OTHER_ROOT such as an unpacked earlier
commit), builds the cell (``build_cell(arch, shape, opts)``), draws its
params from seed 0 and random feeds at its meta shapes from seed 400 on
the card, calls the compiled program once to capture it, times
``--calls`` calls (host clock around each call and a synchronise) and
profiles one more (``torch.profiler``: device busy ms and the kernels
taking the most device time). Each round runs this checkout, then each
other tree, then the same in reverse order. Prints one JSON line per turn
with the card's name. The turns' code is this module's ``TURN``, run with
the tree's ``src`` first on the path, so an earlier tree needs only
``build_cell`` and ``compiled()`` (the port's cell API since its
training and serving cells).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

TURN = r'''
import json, statistics, sys, time
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.configs import get_config
from repro_torch.data.features import _vocab_for_input
from repro_torch.launch.steps import build_cell

arch, shape, opts, calls = json.loads(sys.argv[1])
dev = torch.device("cuda", 0)
prog = build_cell(arch, shape, opts=tuple(opts))
params = prog.init(seed=0, device=dev)
graph, _ = get_config(arch).BUILD()
g = torch.Generator(device=dev)
g.manual_seed(400)
feeds = {}
for name, m in prog.args[1].items():
    if m.dtype.is_floating_point:
        feeds[name] = torch.randn(m.shape, generator=g, dtype=m.dtype,
                                  device=dev)
    else:
        feeds[name] = torch.randint(0, _vocab_for_input(graph, name) or 1000,
                                    m.shape, generator=g, dtype=m.dtype,
                                    device=dev)
serve = prog.compiled(dev)
out = serve(params, feeds)
torch.cuda.synchronize()
ms = []
for _ in range(calls):
    t = time.perf_counter()
    serve(params, feeds)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t) * 1e3)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    serve(params, feeds)
    torch.cuda.synchronize()
kern = [e for e in p.key_averages()
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total]
top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
print(json.dumps(dict(
    p50_ms=statistics.median(ms), ms=ms,
    device_busy_ms=sum(e.self_device_time_total for e in kern) / 1e3,
    top_kernels=[[e.key[:70], e.self_device_time_total / 1e3, e.count]
                 for e in top],
    out_sum=float(out.float().sum()),
    device=torch.cuda.get_device_name(0))))
'''


def turn(root: Path, args) -> dict:
    """One turn on the tree at ``root``: the JSON ``TURN`` prints."""
    spec = json.dumps([args.arch, args.shape, args.opts, args.calls])
    env_path = str(root / "src")
    p = subprocess.run([sys.executable, "-c",
                        f"import sys; sys.path.insert(0, {env_path!r})\n"
                        + TURN, spec],
                       capture_output=True, text=True, check=True)
    return json.loads(p.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="*")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--opts", action="append", default=[])
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("cell_turns: no CUDA device", file=sys.stderr)
        return 1
    trees = [ROOT] + [p.resolve() for p in args.other]
    for _ in range(args.rounds):
        for root in trees + trees[::-1]:
            rec = turn(root, args)
            print(json.dumps(dict(tree=str(root), arch=args.arch,
                                  shape=args.shape, opts=args.opts,
                                  **rec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
