"""Time this checkout's ``gather_einsum`` kernel beside builds of other
``gather_einsum.cu`` sources with the same C entries (an earlier
commit's, say), on one card, taking turns.

    python -m repro_torch.kernels.gather_einsum.compare OTHER.cu [...] \\
        [--spec bd,uldh->blh] [--dtype bfloat16] [--order runs ...] \\
        [--variant MACRO] [--batch 4096] [--dim 18] [--hidden 80] \
        [--rounds 4] [--iters 200]

``--spec`` takes any spec ``parse_spec`` accepts: one past ``KERNEL_SPECS``
runs each library's generic entry, this checkout's with its
``generic_tile`` (and the workspace it asks for), a library without
``gather_einsum_generic_work_bytes`` (commit 521130a's,
``tests/data/gather_einsum_521130a.cu``) with ``GePlan``; its dims take
``chip_smoke.py``'s generic sizes (``GENERIC_DIMS`` here, d and h from
``--dim`` / ``--hidden``).

Every library gets the same inputs, at DIN's width by default (L = 100,
D = 18, H = 80; ``configs/din.py``; ``--dim`` / ``--hidden`` set D and
H, e.g. DIN's public D = 128), in fp32 or bf16, and is launched through
its C entry for that type (``gather_einsum_f32`` / ``_bf16``) alike, but
an fp32 ``bd,uldh->blh`` past D = 40 through the tensor-core entry
``gather_einsum_q_t_tc_f32`` (with a workspace of
``gather_einsum_q_t_work_bytes``, allocated once) where the library has
it, as the wrapper does. Each
``--order`` (repeatable) is one user index: ``runs`` (8 slots, each
user's rows one run of random length: the engine's layout), ``random``
(8 slots), ``random64`` / ``runs64`` (64 slots) and ``short64`` (64
slots, runs of 4 rows). ``--variant MACRO`` adds this checkout's source
built with ``-DMACRO`` (``GATHER_EINSUM_NO_ROW_SORT``) as one more
contender.
Each round times this checkout's build, then each other's, then the same
in reverse order (``turns.take_turns``). Prints one JSON line per order:
the ms per launch of every turn, their medians, each source's median over
this checkout's, the largest difference of each output from this
checkout's, and whether it is bit for bit the same.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, turns
from repro_torch.kernels.gather_einsum import ops

L = 100
ORDERS = ("runs", "random", "random64", "runs64", "short64")
# the sizes of a generic spec's dims (chip_smoke.py's)
GENERIC_DIMS = dict(i=128, j=80, l=L, d=18, k=8, h=80, x=40, y=30)
_OLD_GENERIC = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                + [ctypes.c_void_p] * 2)


def user_index(order: str, B: int,
               g: torch.Generator) -> tuple[int, torch.Tensor]:
    """(U, user_index) of one ``--order``."""
    U = 64 if order in ("random64", "runs64", "short64") else 8
    dev = g.device
    if order == "short64":
        return U, (torch.arange(B, device=dev) // 4 % U).to(torch.int32)
    idx = torch.randint(0, U, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    if order.startswith("runs"):
        idx = torch.sort(idx).values
    return U, idx.contiguous()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="*")
    ap.add_argument("--spec", default="bd,uldh->blh")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="bfloat16")
    ap.add_argument("--order", choices=ORDERS, action="append")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=18, help="D")
    ap.add_argument("--hidden", type=int, default=80, help="H")
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
    B, spec, D, H = args.batch, args.spec, args.dim, args.hidden
    ops.parse_spec(spec)
    libs = {"checkout": ops._lib()}
    libs.update((f"checkout -D{m}", ops._lib((m,))) for m in args.variant)
    for p in args.other:
        libs[str(p)] = turns.load_source("gather_einsum", p)
    if spec not in ops.KERNEL_SPECS:
        return generic(args, libs, dev, dtype, g)
    entry = "gather_einsum_f32" if dtype == torch.float32 \
        else "gather_einsum_bf16"
    tc_entries = ("gather_einsum_q_t_tc_f32", "gather_einsum_q_t_work_bytes")
    for lib in libs.values():
        build.bind(lib, {entry: ops._SIGNATURES[entry]})
        if all(hasattr(lib, e) for e in tc_entries):
            build.bind(lib, {e: ops._SIGNATURES[e] for e in tc_entries})
    stream = torch.cuda.current_stream(dev).cuda_stream
    for order in args.order or ["runs"]:
        U, idx = user_index(order, B, g)
        x_shape, t_shape = {"bd,uldh->blh": ((B, D), (U, L, D, H)),
                            "bl,uld->bd": ((B, L), (U, L, D)),
                            "blh,uh->bl": ((B, L, H), (U, H))}[spec]
        x = torch.randn(x_shape, generator=g, device=dev).to(dtype)
        table = torch.randn(t_shape, generator=g, device=dev).to(dtype)
        shape = ops.out_shape(spec, x, table, idx)
        dims = list(table.shape[1:]) + [0] * (4 - table.ndim)
        if spec == "blh,uh->bl":
            dims[1] = L
        outs = {name: torch.empty(shape, device=dev, dtype=dtype)
                for name in libs}

        def launcher(name):
            lib = libs[name]
            nwork = (lib.gather_einsum_q_t_work_bytes(B, U, D)
                     if spec == "bd,uldh->blh" and dtype == torch.float32
                     and hasattr(lib, tc_entries[0]) else 0)
            work = torch.empty(max(nwork, 1), dtype=torch.uint8, device=dev)
            if nwork > 0:
                tc.append(name)

            def launch():
                if nwork > 0:
                    rc = lib.gather_einsum_q_t_tc_f32(
                        x.data_ptr(), table.data_ptr(), idx.data_ptr(),
                        outs[name].data_ptr(), B, U, L, D, H,
                        work.data_ptr(), stream)
                else:
                    rc = getattr(lib, entry)(
                        ops.KERNEL_SPECS.index(spec), x.data_ptr(),
                        table.data_ptr(), idx.data_ptr(),
                        outs[name].data_ptr(), B, U, *dims, stream)
                build.check(lib, rc, f"gather_einsum ({name})")
            return launch

        tc = []

        ms = turns.take_turns({n: launcher(n) for n in libs}, args.rounds,
                              args.iters)
        others = [n for n in libs if n != "checkout"]
        print(json.dumps(dict(
            spec=spec, order=order, B=B, U=U, L=L, D=D, H=H,
            dtype=args.dtype, iters=args.iters, tensor_core_route=tc,
            **turns.summary(ms, "checkout"),
            max_abs_vs_checkout={n: float((outs[n].float()
                                           - outs["checkout"].float())
                                          .abs().max()) for n in others},
            bitwise_vs_checkout={n: bool(torch.equal(outs[n],
                                                     outs["checkout"]))
                                 for n in others},
            device=torch.cuda.get_device_name(0))), flush=True)
    return 0


def generic(args, libs, dev, dtype, g) -> int:
    """Turns of every library's generic entry on ``args.spec`` (see the
    module note), one JSON line per ``--order`` as ``main``."""
    spec, B = args.spec, args.batch
    sizes = dict(GENERIC_DIMS, d=args.dim, h=args.hidden)
    xs, ts, _, _ = ops.parse_spec(spec)
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lib in libs.values():
        if hasattr(lib, "gather_einsum_generic_work_bytes"):
            build.bind(lib, {k: ops._SIGNATURES[k] for k in (
                f"gather_einsum_generic_{suffix}",
                "gather_einsum_generic_work_bytes")})
        else:
            build.bind(lib, {f"gather_einsum_generic_{suffix}": (
                _OLD_GENERIC, ctypes.c_int)})
    for order in args.order or ["random"]:
        U, idx = user_index(order, B, g)
        x = torch.randn((B,) + tuple(sizes[c] for c in xs[1:]), generator=g,
                        device=dev).to(dtype)
        table = torch.randn((U,) + tuple(sizes[c] for c in ts[1:]),
                            generator=g, device=dev).to(dtype)
        shape = ops.out_shape(spec, x, table, idx)
        outs = {n: torch.empty(shape, device=dev, dtype=dtype) for n in libs}
        tile, tiling = ops.generic_tile(spec, tuple(x.shape),
                                        tuple(table.shape), x.element_size(),
                                        ops._sms(dev.index or 0))
        plan = ops.c_plan(ops.generic_plan(spec, x.shape, table.shape))

        def launcher(name):
            lib = libs[name]
            fn = getattr(lib, f"gather_einsum_generic_{suffix}")
            args_ = [x.data_ptr(), table.data_ptr(), idx.data_ptr(),
                     outs[name].data_ptr(), B, U]
            if hasattr(lib, "gather_einsum_generic_work_bytes"):
                nwork = lib.gather_einsum_generic_work_bytes(
                    B, U, ctypes.byref(tile))
                work = torch.empty(max(nwork, 1), dtype=torch.uint8,
                                   device=dev)
                args_ += [ctypes.byref(tile),
                          work.data_ptr() if nwork > 0 else None]
            else:
                args_.append(ctypes.byref(plan))

            def launch():
                build.check(lib, fn(*args_, stream),
                            f"gather_einsum {spec!r} ({name})")
            launch.work = args_     # keeps the workspace alive
            return launch

        ms = turns.take_turns({n: launcher(n) for n in libs}, args.rounds,
                              args.iters)
        others = [n for n in libs if n != "checkout"]
        print(json.dumps(dict(
            spec=spec, order=order, B=B, U=U, x=list(x.shape),
            table=list(table.shape), dtype=args.dtype, iters=args.iters,
            tiling=tiling, **turns.summary(ms, "checkout"),
            max_abs_vs_checkout={n: float((outs[n].float()
                                           - outs["checkout"].float())
                                          .abs().max()) for n in others},
            bitwise_vs_checkout={n: bool(torch.equal(outs[n],
                                                     outs["checkout"]))
                                 for n in others},
            device=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
