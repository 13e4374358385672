"""Time this checkout's ``mari_matmul`` kernel beside builds of other
``mari_matmul.cu`` sources with the same C entries (an earlier commit's,
say), on one card, taking turns.

    python -m repro_torch.kernels.mari_matmul.compare OTHER.cu [...] \\
        [--dtype bfloat16] [--batch 4096 ...] [--shape 1064,512 ...] \\
        [--init broadcast] [--act relu] [--bm 64|128] [--addmm] \\
        [--ld LD] [--rounds 4] [--iters 200]

Every library gets the same inputs per (batch, shape): x (B, K) and w (K,
N) from a seed (w scaled by 0.05), u an f32 init in the ``--init`` layout
(8 users for ``gather``), the weight prepared once, and is launched
through its C entry for that type (``mari_matmul_f32`` / ``_bf16``) with
the row tile the wrapper picks (``tile_config``'s) or the one ``--bm``
forces. x lies as the serving path writes a stream (``empty_stream``:
rows ``stream_ld(K)`` apart); ``--ld LD`` gives it a row stride of LD
elements instead (0: K, a contiguous x, copied to a 16-byte stride where
TMA needs one). ``--addmm`` adds one ``torch.addmm`` in the same dtype
on the same operands (the init pre-gathered, no activation) as a
contender.
Each round times this checkout's build, then each other's, then the same
in reverse order (``turns.take_turns``). Prints one JSON line per batch
and shape: the ms per launch of every turn, their medians, each one's
median over this checkout's, the bound (``bound_ms``: operations at the
dtype's tensor-core peak, 3 passes for fp32's 3xTF32, or bytes at 3.35
TB/s, whichever is longer), the largest difference of each output from
this checkout's, and whether it is bit for bit the same.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, turns
from repro_torch.kernels.mari_matmul import ops

PEAK_BYTES_S = 3.35e12


def bound_ms(B: int, K: int, N: int, u_rows: int, dtype) -> float:
    """The least time of the call: fp32 as 3xTF32 (3 x 2BKN at 495
    TFLOP/s; x, w_hi, w_lo, u, out moved once), bf16 one product at 989
    TFLOP/s (x, w, out in bf16, the f32 u)."""
    if dtype == torch.float32:
        ops_s = 3 * 2 * B * K * N / 495e12
        nbytes = 4 * (B * K + 2 * K * N + u_rows * N + B * N)
    else:
        ops_s = 2 * B * K * N / 989e12
        nbytes = 2 * (B * K + K * N + B * N) + 4 * u_rows * N
    return 1e3 * max(ops_s, nbytes / PEAK_BYTES_S)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="*")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="bfloat16")
    ap.add_argument("--batch", type=int, action="append")
    ap.add_argument("--shape", action="append",
                    help="K,N (repeatable; default 1064,512)")
    ap.add_argument("--init", choices=ops.INIT_MODES, default="broadcast")
    ap.add_argument("--act", choices=ops.EPILOGUES, default="relu")
    ap.add_argument("--bm", type=int, choices=(64, 128))
    ap.add_argument("--addmm", action="store_true")
    ap.add_argument("--ld", type=int)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    entry = "mari_matmul_f32" if dtype == torch.float32 \
        else "mari_matmul_bf16"
    libs = {"checkout": ops._lib()}
    for p in args.other:
        libs[str(p)] = turns.load_source("mari_matmul", p)
    for lib in libs.values():
        build.bind(lib, {entry: ops._SIGNATURES[entry]})
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    shapes = [tuple(int(v) for v in s.split(","))
              for s in args.shape or ["1064,512"]]
    for B in args.batch or [4096]:
        for K, N in shapes:
            x = torch.randn((B, K), generator=g, device=dev).to(dtype)
            if args.ld is None:
                x = ops.empty_stream(B, K, dtype, dev).copy_(x)
            elif args.ld:
                x = torch.empty((B, args.ld), device=dev,
                                dtype=dtype)[:, :K].copy_(x)
            x, _ = ops.stream_operand(x)
            w = (torch.randn((K, N), generator=g, device=dev) * 0.05).to(dtype)
            pw = ops.prepare_mari_weight(w)
            U = {"broadcast": 1, "rowwise": B, "gather": 8}[args.init]
            u = torch.randn((U, N), generator=g, device=dev)
            idx = (torch.randint(0, U, (B,), generator=g, device=dev,
                                 dtype=torch.int32)
                   if args.init == "gather" else None)
            bm = args.bm or ops.tile_config(B, N)[0]
            outs = {name: torch.empty((B, N), device=dev, dtype=dtype)
                    for name in libs}

            def launcher(name):
                lib = libs[name]

                def launch():
                    rc = getattr(lib, entry)(
                        x.data_ptr(), x.stride(0), ctypes.addressof(pw.maps),
                        u.data_ptr(), None if idx is None else idx.data_ptr(),
                        outs[name].data_ptr(), B, K, N, U,
                        ops.INIT_MODES.index(args.init),
                        ops.EPILOGUES.index(args.act), bm, pw.bn, stream)
                    build.check(lib, rc, f"mari_matmul ({name})")
                return launch

            launchers = {n: launcher(n) for n in libs}
            if args.addmm:
                u_init = (u.index_select(0, idx) if idx is not None
                          else u).to(dtype)
                launchers["torch.addmm"] = lambda: torch.addmm(u_init, x, w)
            ms = turns.take_turns(launchers, args.rounds, args.iters)
            others = [n for n in libs if n != "checkout"]
            print(json.dumps(dict(
                B=B, K=K, N=N, ld=x.stride(0), dtype=args.dtype,
                init=args.init, act=args.act, iters=args.iters, bm=bm,
                bn=pw.bn, bound_ms=bound_ms(B, K, N, U, dtype),
                **turns.summary(ms, "checkout"),
                max_abs_vs_checkout={n: float((outs[n].float()
                                               - outs["checkout"].float())
                                              .abs().max()) for n in others},
                bitwise_vs_checkout={n: bool(torch.equal(outs[n],
                                                         outs["checkout"]))
                                     for n in others},
                device=torch.cuda.get_device_name(0))), flush=True)
            del x, w, pw, u, outs
    return 0


if __name__ == "__main__":
    sys.exit(main())
