"""Time this checkout's ``din_attention`` kernel beside builds of other
``din_attention.cu`` sources with the same fp32 C entry (an earlier
commit's, say), on one card, taking turns.

    python -m repro_torch.kernels.din_attention.compare OTHER.cu [...] \\
        [--batch 2048] [--keys 100] [--rounds 4] [--iters 200]

Every library gets the same inputs at DIN's width (D = 18, h1 = 80,
h2 = 40; ``configs/din.py``) and is launched through its C entry alike.
Each round times this checkout's build, then each other's, then the same
in reverse order (A B C C B A), each turn over ``--iters`` launches
enqueued behind a device sleep (CUDA events), so no launch leaves the card
idle and a drift of the clock over a round falls on all. Prints one JSON
line: the ms per launch of every turn, their medians, each source's median
over this checkout's, and the largest difference of each output from this
checkout's.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.din_attention import ops

D, H1, H2 = 18, 80, 40


def load_other(source: Path) -> ctypes.CDLL:
    """``source`` built with the checkout's flags (cached by its hash)."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(build.NVCC_FLAGS).encode())
    lib = (build.BUILD_DIR
           / f"din_attention-other-{digest.hexdigest()[:16]}.so")
    if not lib.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                        str(source)], check=True, capture_output=True)
    out = ctypes.CDLL(str(lib))
    build.bind(out, {k: ops._SIGNATURES[k] for k in ("din_attention_f32",)})
    build.bind(out, {"repro_error_string": ([ctypes.c_int], ctypes.c_char_p)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="+")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--keys", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    B, L = args.batch, args.keys

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    q, keys = randn(B, D), randn(L, D)
    mask = (torch.rand(L, generator=g, device=dev) < 0.8).to(torch.int32)
    mask[0] = 1
    weights = (randn(4 * D, H1) * 0.2, randn(H1) * 0.1, randn(H1, H2) * 0.2,
               randn(H2) * 0.1, randn(H2, 1) * 0.2, randn(1) * 0.1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    libs = {"checkout": ops._lib()}
    libs.update((str(p), load_other(p)) for p in args.other)
    outs = {name: torch.empty(B, D, device=dev) for name in libs}

    def launch(name):
        lib = libs[name]
        rc = lib.din_attention_f32(
            q.data_ptr(), keys.data_ptr(), mask.data_ptr(),
            *(w.data_ptr() for w in weights), outs[name].data_ptr(),
            B, L, D, H1, H2, stream)
        build.check(lib, rc, f"din_attention ({name})")

    def turn(name) -> float:
        for _ in range(3):
            launch(name)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(args.iters):
            launch(name)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.iters

    ms = {name: [] for name in libs}
    order = list(libs)
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            ms[name].append(turn(name))
    med = {name: statistics.median(v) for name, v in ms.items()}
    print(json.dumps(dict(
        B=B, L=L, D=D, h1=H1, h2=H2, iters=args.iters, ms=ms, median_ms=med,
        over_checkout={n: med[n] / med["checkout"] for n in order[1:]},
        max_abs_vs_checkout={n: float((outs[n] - outs["checkout"])
                                      .abs().max()) for n in order[1:]},
        device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
