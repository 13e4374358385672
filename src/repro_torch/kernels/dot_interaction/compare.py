"""Time this checkout's ``dot_interaction`` kernel beside builds of other
``dot_interaction.cu`` sources (an earlier commit's, say), on one card,
taking turns.

    python -m repro_torch.kernels.dot_interaction.compare OTHER.cu [...] \\
        [--dtype bfloat16] [--batch 4096] [--features 27] [--dim 128] \\
        [--keep-self] [--rounds 4] [--iters 200]

Every library gets the same x (B, F, D), in fp32 or bf16, contiguous and
16-byte aligned, through its C entry for that type (``dot_interaction_f32``
/ ``_bf16``). An entry's parameters are read from its source, so a bf16
entry with a copy route (this checkout's: 0, the TMA copy where the shape
takes it, else 1 or 2 as ``ops.copy_route`` picks) and one without (an
earlier source's widening copy) are called alike. Each round times this
checkout's build, then each other's, then the same in reverse order
(``turns.take_turns``). Prints one JSON line: the ms per launch of every
turn, their medians, each source's median over this checkout's, the
largest difference of each output from this checkout's, and how many
elements differ.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, turns
from repro_torch.kernels.dot_interaction import ops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="*")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="bfloat16")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--features", type=int, default=27)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--keep-self", action="store_true")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    B, F, D = args.batch, args.features, args.dim
    P = ops.n_pairs(F, args.keep_self)
    x = torch.randn((B, F, D), generator=g, device=dev).to(dtype)
    entry = "dot_interaction_f32" if dtype == torch.float32 \
        else "dot_interaction_bf16"
    route = ops.ROUTES.index(ops.copy_route(x))
    if dtype == torch.float32:
        route = int(route == 0)          # the fp32 entry's tma flag
    stream = torch.cuda.current_stream(dev).cuda_stream
    sources = {"checkout": build.CSRC / "dot_interaction.cu"}
    sources.update((str(p), p) for p in args.other)
    libs, extra = {}, {}
    for name, src in sources.items():
        libs[name] = (ops._lib() if name == "checkout"
                      else turns.load_source("dot_interaction", src))
        n = len(turns.c_params(src.read_text(), entry))
        build.bind(libs[name], {entry: ([build.ctypes.c_void_p] * 2
                                        + [build.ctypes.c_int] * (n - 3)
                                        + [build.ctypes.c_void_p],
                                        build.ctypes.c_int)})
        extra[name] = (route,) if n == 8 else ()
    outs = {name: torch.empty(B, P, device=dev, dtype=dtype) for name in libs}

    def launcher(name):
        lib = libs[name]

        def launch():
            rc = getattr(lib, entry)(x.data_ptr(), outs[name].data_ptr(), B,
                                     F, D, int(args.keep_self),
                                     *extra[name], stream)
            build.check(lib, rc, f"dot_interaction ({name})")
        return launch

    ms = turns.take_turns({n: launcher(n) for n in libs}, args.rounds,
                          args.iters)
    others = [n for n in libs if n != "checkout"]
    print(json.dumps(dict(
        B=B, F=F, D=D, keep_self=args.keep_self, dtype=args.dtype,
        copy_route=ops.copy_route(x), iters=args.iters,
        **turns.summary(ms, "checkout"),
        max_abs_vs_checkout={n: float((outs[n].float()
                                       - outs["checkout"].float())
                                      .abs().max()) for n in others},
        elements_differing={n: int((outs[n] != outs["checkout"]).sum())
                            for n in others},
        device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
