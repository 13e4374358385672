"""Multi-pod dry run (port of ``repro.launch.dryrun``): trace every
(architecture × input shape) cell on the single-pod 16×16 mesh and the
2×16×16 multi-pod mesh over a fake process group, and record per-device
memory, FLOPs, bytes and the collective schedule for the roofline.

Usage:
  python -m repro_torch.launch.dryrun --arch fm --shape serve_p99 --mesh single
  python -m repro_torch.launch.dryrun --all            # subprocess per cell

Each cell joins a fake group of 256 or 512 ranks as rank 0
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once), builds the production mesh on the CPU device type and the cell's
program on it, and runs ``CellProgram.trace()``: one step on DTensors
whose local blocks are fake tensors. Nothing is allocated and no card is
touched. What a record holds, per device (rank 0):

* ``memory``: ``argument_bytes`` / ``output_bytes`` — the local blocks of
  the step's arguments and outputs; ``temp_bytes`` — the peak of the fake
  storage that the step allocates and holds at once (arguments excluded);
* ``cost``: ``flops_per_device`` — over the local ops,
  ``torch.utils.flop_counter``'s formulas for matmuls, convolutions and
  attention, one per output element of a pointwise op and one per input
  element of a reduction (as XLA's cost analysis counts them);
  ``bytes_per_device`` — the inputs plus outputs of every local op that
  is not a view, with no fusion: an upper bound of the HBM traffic;
* ``collectives``: bytes of each kind's results (``_c10d_functional``
  ops; ``wait_tensor`` is no collective), ``count``, and
  ``traffic_bytes`` (an all-reduce moves its buffer twice);
* ``roofline``: each term over the H100's own rates, which the record
  names, and the largest as ``bottleneck``.

The ops that DTensor runs on fake tensors at global shapes to propagate
shardings are not the device's work and are not counted. The port traces
every layer (``scan_factor`` 1), where the reference's compiled scans are
counted once and scaled.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

RESULTS_PATH = "build/dryrun_results.json"

# NVIDIA H100 SXM (per card): dense bf16 tensor-core peak, HBM3 rate, and
# one 400 Gb/s NIC per card — the conservative single link, as the
# reference assumed one 50 GB/s ICI link (a 16-way axis spans two 8-card
# hosts, so it leaves NVLink)
DEVICE = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9

COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
# reductions: one FLOP per input element
REDUCTIONS = frozenset({"sum", "mean", "amax", "amin", "max", "min", "prod",
                        "logsumexp", "cumsum", "var", "std", "norm",
                        "linalg_vector_norm", "_softmax", "_log_softmax"})
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "broadcast")

_state = threading.local()


def _propagating() -> bool:
    return getattr(_state, "propagating", False)


def _mark_propagation() -> None:
    """Flag the ops that DTensor's sharding propagation runs at global
    shapes (once per process)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    fn = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(fn, "_dryrun_marked", False):
        return

    def marked(self, op_schema):
        _state.propagating = True
        try:
            return fn(self, op_schema)
        finally:
            _state.propagating = False
    marked._dryrun_marked = True
    ShardingPropagator._propagate_tensor_meta_non_cached = marked


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _storage_key(t) -> int:
    return t.untyped_storage()._cdata


class DeviceCounter:
    """A dispatch mode over one rank's local ops: FLOPs, bytes in and
    out, collectives and the peak of live storage. A DTensor op is left
    to DTensor (``NotImplemented``); its local ops come back here."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counter = self
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.coll = {k: 0 for k in KINDS}
        self.coll["count"] = 0
        self.live: dict[int, list[int]] = {}
        self.cur = self.peak = 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                if not _propagating():
                    counter._count(func, args, kwargs, out, flop_registry)
                return out

        self.mode = Mode()

    def _release(self, key: int) -> None:
        ent = self.live.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.cur -= ent[0]
            del self.live[key]

    def _hold(self, t, new: bool) -> None:
        key = _storage_key(t)
        ent = self.live.get(key)
        if ent is None:
            if not new:
                return          # a view of an argument: not a temporary
            n = t.untyped_storage().nbytes()
            ent = self.live[key] = [n, 0]
            self.cur += n
            self.peak = max(self.peak, self.cur)
        ent[1] += 1
        weakref.finalize(t, self._release, key)

    def _count(self, func, args, kwargs, out, flop_registry) -> None:
        import torch
        name = func.__name__.split(".")[0]
        if func.namespace == "_c10d_functional":
            if name == "wait_tensor":
                return
            kind = COLLECTIVES.get(name)
            if kind is not None:
                self.coll[kind] += sum(_nbytes(t) for t in _tensors(out))
                self.coll["count"] += 1
            for t in _tensors(out):
                self._hold(t, True)
            return
        self.ops += 1
        ins = list(_tensors((args, kwargs)))
        in_keys = {_storage_key(t) for t in ins}
        outs = list(_tensors(out))
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs)
        elif name in REDUCTIONS and ins:
            self.flops += ins[0].numel()
        for t in outs:
            self._hold(t, _storage_key(t) not in in_keys)

    def collectives(self) -> dict:
        c = dict(self.coll)
        c["traffic_bytes"] = (2 * c["all-reduce"] + c["all-gather"]
                              + c["reduce-scatter"] + c["all-to-all"]
                              + c["broadcast"])
        return c


def fake_group(world_size: int) -> None:
    """Join a fake process group of ``world_size`` ranks as rank 0 (its
    collectives do nothing and return at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def run_cell(arch: str, shape: str, mesh_kind: str, opts=()) -> dict:
    import contextlib

    from repro_torch.dist.sharding import local_bytes
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell

    # DTensor warns at every multi-dim redistribute it runs in steps
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    multi = mesh_kind == "multi"
    fake_group(512 if multi else 256)
    _mark_propagation()
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    prog = build_cell(arch, shape, mesh, opts=opts)
    counter = DeviceCounter()

    @contextlib.contextmanager
    def around(_args):
        with counter.mode:
            yield

    args, out = prog.trace(around)
    t_trace = time.time() - t0
    flops, bytes_acc = float(counter.flops), float(counter.bytes)
    coll = counter.collectives()
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "opts": sorted(opts), "kind": prog.kind, "meta": prog.meta,
        "devices": int(mesh.size()),
        "scan_factor": 1,
        "trace_s": round(t_trace, 1),
        "memory": {
            "argument_bytes": local_bytes(args),
            "output_bytes": local_bytes(out),
            "temp_bytes": int(counter.peak),
        },
        "cost": {"flops_per_device": flops, "bytes_per_device": bytes_acc,
                 "local_ops": counter.ops,
                 "bytes_bound": "upper: every op's inputs and outputs, "
                                "no fusion"},
        "collectives": coll,
        "roofline": {
            "device": DEVICE, "peak_flops_bf16": PEAK_FLOPS_BF16,
            "hbm_bw": HBM_BW, "link_bw": LINK_BW,
            "compute_s": flops / PEAK_FLOPS_BF16,
            "memory_s": bytes_acc / HBM_BW,
            "collective_s": coll["traffic_bytes"] / LINK_BW,
        },
    }
    terms = rec["roofline"]
    rec["roofline"]["bottleneck"] = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    return rec


def _cells(args):
    from repro_torch import configs as cfgreg

    for cell in cfgreg.all_cells(include_paper=args.include_paper):
        if args.arch and cell.arch != args.arch:
            continue
        if args.shape and cell.shape != args.shape:
            continue
        yield cell


def _run_one(arch: str, shape: str, mk: str, opts: tuple, timeout: int
             ) -> dict:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--mesh", mk]
    if opts:
        cmd += ["--opts", ",".join(opts)]
    t0 = time.time()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
        line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        rec = json.loads(line) if line.startswith("{") else {
            "error": (p.stderr or p.stdout)[-2000:] or f"exit {p.returncode}"}
    except subprocess.TimeoutExpired:
        rec = {"error": f"timeout after {timeout}s"}
    rec["wall_s"] = round(time.time() - t0, 1)
    rec.update({"arch": arch, "shape": shape, "mesh": mk})
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true",
                    help="run every cell in an isolated subprocess")
    ap.add_argument("--include-paper", action="store_true",
                    help="also run the paper's own ranking model")
    ap.add_argument("--out", default=RESULTS_PATH)
    ap.add_argument("--opts", default="",
                    help="comma-separated §Perf optimization names")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells traced at once (one process each)")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opts.split(",") if o)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        results = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                results = json.load(f)
        done = {(r["arch"], r["shape"], r["mesh"]) for r in results
                if "error" not in r}
        todo = []
        for cell in _cells(args):
            for mk in meshes:
                if (cell.arch, cell.shape, mk) in done:
                    continue
                if cell.skip_reason:
                    results = [r for r in results
                               if (r["arch"], r["shape"], r["mesh"])
                               != (cell.arch, cell.shape, mk)]
                    results.append({"arch": cell.arch, "shape": cell.shape,
                                    "mesh": mk, "skipped": cell.skip_reason})
                    continue
                todo.append((cell.arch, cell.shape, mk))
        lock = threading.Lock()

        def one(job):
            nonlocal results
            print(f"[dryrun] {job[0]} × {job[1]} × {job[2]} ...", flush=True)
            rec = _run_one(*job, opts, args.timeout)
            with lock:
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"]) != job]
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
            status = ("OK" if "error" not in rec
                      else "FAIL: " + rec["error"].splitlines()[-1][:120])
            print(f"[dryrun]   {job[0]} × {job[1]} × {job[2]} -> {status} "
                  f"({rec['wall_s']} s)", flush=True)

        with ThreadPoolExecutor(max(1, args.jobs)) as pool:
            list(pool.map(one, todo))
        nerr = sum(1 for r in results if "error" in r)
        print(f"[dryrun] done: {len(results)} records, {nerr} failures")
        return 1 if nerr else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    for mk in meshes:
        rec = run_cell(args.arch, args.shape, mk, opts=opts)
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
