"""Time this checkout's ``din_attention`` kernel beside builds of other
``din_attention.cu`` sources with the same C entries (an earlier
commit's, say), on one card, taking turns.

    python -m repro_torch.kernels.din_attention.compare OTHER.cu [...] \\
        [--dtype bfloat16] [--variant MACRO] [--batch 2048] [--keys 100] \\
        [--widths 18,80,40] [--rounds 4] [--iters 200]

Every library gets the same inputs at the unit's widths (``--widths
D,h1,h2``; DIN's, D = 18, h1 = 80, h2 = 40 of ``configs/din.py``, by
default), in fp32 or bf16, and is launched through its C entry for that
type alike: ``din_attention_f32`` / ``_bf16``, or past the register tiles
(where the library has it) ``din_attention_wide_f32`` / ``_bf16`` with a
workspace of ``din_attention_work_bytes``, allocated once, and, where the
source's entry takes prepared weights (its parameter list, read by
``turns.c_params``, has ``wprep``), this checkout's
``prepare_din_weights``, made once (a source laid out otherwise cannot be
compared). ``--variant MACRO`` adds this checkout's source built with
``-DMACRO`` as one more contender. Each round times this checkout's build, then each
other's, then the same in reverse order (``turns.take_turns``). Prints
one JSON line: the ms per launch of every turn, their medians, each
source's median over this checkout's, the largest difference of each
output from this checkout's, and whether it is bit for bit the same.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, turns
from repro_torch.kernels.din_attention import ops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="*")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--keys", type=int, default=100)
    ap.add_argument("--widths", default="18,80,40",
                    help="D,h1,h2 of the unit")
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
    B, L = args.batch, args.keys
    D, H1, H2 = (int(v) for v in args.widths.split(","))

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q, keys = randn(B, D), randn(L, D)
    mask = (torch.rand(L, generator=g, device=dev) < 0.8).to(torch.int32)
    mask[0] = 1
    weights = (randn(4 * D, H1) * 0.2, randn(H1) * 0.1, randn(H1, H2) * 0.2,
               randn(H2) * 0.1, randn(H2, 1) * 0.2, randn(1) * 0.1)
    bf16 = dtype == torch.bfloat16
    entry = "din_attention_bf16" if bf16 else "din_attention_f32"
    wide = "din_attention_wide_bf16" if bf16 else "din_attention_wide_f32"
    stream = torch.cuda.current_stream(dev).cuda_stream
    libs = {"checkout": ops._lib()}
    texts = {"checkout": (build.CSRC / "din_attention.cu").read_text()}
    for m in args.variant:
        libs[f"checkout -D{m}"] = ops._lib((m,))
        texts[f"checkout -D{m}"] = texts["checkout"]
    for p in args.other:
        libs[str(p)] = turns.load_source("din_attention", p)
        texts[str(p)] = p.read_text()
    prepared = (None if ops.within_tiles(D, H1, H2)
                else ops.prepare_din_weights(weights[0], weights[2]))
    work = {}   # name -> [prepared weights,] workspace: the wide route runs
    for name, lib in libs.items():
        build.bind(lib, {entry: ops._SIGNATURES[entry]})
        if hasattr(lib, wide):
            params = turns.c_params(texts[name], wide)
            takes_prep = any(p.endswith("wprep") for p in params)
            argtypes = ops._SIGNATURES[wide][0]
            if not takes_prep:             # an entry from before wprep
                argtypes = argtypes[:-3] + argtypes[-2:]
            build.bind(lib, {wide: (argtypes, ctypes.c_int),
                             "din_attention_work_bytes":
                             ops._SIGNATURES["din_attention_work_bytes"]})
            n = lib.din_attention_work_bytes(B, L, D, H1, H2, int(bf16))
            if n > 0:
                buf = torch.empty(n, dtype=torch.uint8, device=dev)
                work[name] = ([prepared.buf.data_ptr()] if takes_prep
                              else []) + [buf.data_ptr()]
                work[name + " buf"] = buf
    outs = {name: torch.empty(B, D, device=dev, dtype=dtype) for name in libs}

    def launcher(name):
        lib = libs[name]
        fn = getattr(lib, wide if name in work else entry)
        extra = work[name] if name in work else []

        def launch():
            rc = fn(q.data_ptr(), keys.data_ptr(), mask.data_ptr(),
                    *(w.data_ptr() for w in weights), outs[name].data_ptr(),
                    B, L, D, H1, H2, *extra, stream)
            build.check(lib, rc, f"din_attention ({name})")
        return launch

    ms = turns.take_turns({n: launcher(n) for n in libs}, args.rounds,
                          args.iters)
    others = [n for n in libs if n != "checkout"]
    print(json.dumps(dict(
        B=B, L=L, D=D, h1=H1, h2=H2, dtype=args.dtype, iters=args.iters,
        wide_route=sorted(n for n in work if n in libs),
        **turns.summary(ms, "checkout"),
        max_abs_vs_checkout={n: float((outs[n].float()
                                       - outs["checkout"].float())
                                      .abs().max()) for n in others},
        bitwise_vs_checkout={n: bool(torch.equal(outs[n], outs["checkout"]))
                             for n in others},
        device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
