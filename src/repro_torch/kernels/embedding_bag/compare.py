"""Time this checkout's ``embedding_bag`` entries beside builds of other
``embedding_bag.cu`` sources (an earlier commit's, say), on one card,
taking turns.

    python -m repro_torch.kernels.embedding_bag.compare OTHER.cu [...] \\
        [--dtype float32 --dtype bfloat16] [--order sorted --order shuffled] \\
        [--prep-only] [--vocab 2564352] [--batch 4096] [--hotness 100] \\
        [--dim 128] [--rounds 4] [--iters 200]

Every library gets the same inputs, by default the multi-hot DLRM path's
largest bag (``sparse_20`` at ``scale_tables=0.1``: a 2,564,352 x 128
table, B = 4096 bags of H = 100 int32 ids, sum, no weights), with int64
segment ids ``arange(B).repeat_interleave(H)``: ``sorted`` as they are,
``shuffled`` with ids and segment ids permuted together. Each library is
called through its own C entries, their parameters read from its source
(``turns.c_params``), as its wrapper calls them:

* ``csr``: ``embedding_bag_csr_prep`` and then the bag entry
  (``embedding_bag_f32`` / ``_bf16``) on the offsets it wrote. A source
  whose preparation takes ``blocks`` gets this checkout's tile plan
  (``ops.csr_plan``) and the bag entry reads the flag it wrote
  (``in_order``); one without (commit 7dd2236's,
  ``tests/data/embedding_bag_7dd2236.cu``) gets that commit's plan
  (``old_csr_plan``) and the bag entry reads the copies;
* ``prep``: the preparation alone;
* ``fixed``: the bag entry on the (B, H) ids with implicit offsets,
  timed under the first order only (it reads no segment ids).

``--prep-only`` times ``prep`` alone. Each round times this checkout's
build, then each other's, then the same in reverse order
(``turns.take_turns``). Prints one JSON line per dtype and order: the ms
per launch of every turn, their medians, each source's median over this
checkout's, and for ``csr`` and ``fixed`` the largest difference of each
output from this checkout's and how many elements differ.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, turns
from repro_torch.kernels.embedding_bag import ops

ORDERS = ("sorted", "shuffled")
BAG_ENTRY = {torch.float32: "embedding_bag_f32",
             torch.bfloat16: "embedding_bag_bf16"}
PREP_ENTRY = "embedding_bag_csr_prep"


def old_csr_plan(nnz: int, S: int) -> tuple[int, int]:
    """Commit 7dd2236's tile plan: tiles of at least 4096 ids, larger
    where the counts would pass 2^22 int32."""
    tile = max(4096, -(-nnz // max(1, (1 << 22) // (S + 1))))
    tile = -(-tile // 32) * 32
    return tile, max(1, -(-nnz // tile))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _ctype(param: str):
    if "*" in param:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "int64_t": ctypes.c_int64}[
        param.rsplit(" ", 1)[0]]


class Library:
    """One build's entries, called by their parameters' names."""

    def __init__(self, lib: ctypes.CDLL, source: str):
        self.lib = lib
        self.params = {}
        for fn in (PREP_ENTRY, *BAG_ENTRY.values()):
            params = turns.c_params(source, fn)
            build.bind(lib, {fn: ([_ctype(p) for p in params],
                                  ctypes.c_int)})
            self.params[fn] = [p.rsplit(" ", 1)[1].lstrip("*")
                               for p in params]
        self.new_plan = "blocks" in self.params[PREP_ENTRY]

    def call(self, fn: str, **values) -> None:
        rc = getattr(self.lib, fn)(*(values.get(n) for n in self.params[fn]))
        build.check(self.lib, rc, fn)

    def prepared(self, seg, ids, S: int, blocks: int,
                 weights=None) -> dict:
        """Buffers for this build's preparation of (seg, ids, weights)."""
        nnz = ids.numel()
        if self.new_plan:
            tile, n_tiles = ops.csr_plan(nnz, S, blocks)
            n_scratch = 1 + n_tiles + blocks + n_tiles * (S + 1)
        else:
            tile, n_tiles = old_csr_plan(nnz, S)
            n_scratch = n_tiles * (S + 1) + -(-(S + 1) // 32) + n_tiles + 2
        dev = ids.device
        scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev)
        return dict(seg=seg, ids=ids, weights=weights, tile=tile,
                    n_tiles=n_tiles, blocks=blocks, scratch=scratch,
                    offsets=torch.empty(S + 1, dtype=torch.int64,
                                        device=dev),
                    ids_out=torch.empty_like(ids),
                    w_out=None if weights is None
                    else torch.empty_like(weights))

    def prep(self, b: dict, S: int, stream: int) -> None:
        self.call(PREP_ENTRY, seg=b["seg"].data_ptr(),
                  seg_int64=int(b["seg"].dtype == torch.int64),
                  ids=b["ids"].data_ptr(),
                  ids_int64=int(b["ids"].dtype == torch.int64),
                  weights=_ptr(b["weights"]), nnz=b["ids"].numel(), S=S,
                  tile=b["tile"], n_tiles=b["n_tiles"], blocks=b["blocks"],
                  scratch=b["scratch"].data_ptr(),
                  offsets=b["offsets"].data_ptr(),
                  ids_out=b["ids_out"].data_ptr(), w_out=_ptr(b["w_out"]),
                  stream=stream)

    def bag(self, table, out, stream: int, ids, S: int, H: int = 0,
            b: dict | None = None, weights=None, mean: int = 0) -> None:
        """The bag entry: fixed hotness H (b None) or on b's offsets (and
        b's weights)."""
        values = dict(table=table.data_ptr(), ids=ids.data_ptr(),
                      ids_int64=int(ids.dtype == torch.int64),
                      offsets=None, weights=_ptr(weights),
                      out=out.data_ptr(), S=S, D=table.shape[1],
                      V=table.shape[0], H=H, mean=mean, stream=stream)
        if b is not None:
            values.update(offsets=b["offsets"].data_ptr(),
                          weights=_ptr(b["weights"]))
            if "in_order" in self.params[BAG_ENTRY[table.dtype]]:
                values.update(ids_bag=b["ids_out"].data_ptr(),
                              w_bag=_ptr(b["w_out"]),
                              in_order=b["scratch"].data_ptr())
            else:
                values.update(ids=b["ids_out"].data_ptr(),
                              weights=_ptr(b["w_out"]))
        self.call(BAG_ENTRY[table.dtype], **values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="*")
    ap.add_argument("--dtype", action="append",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--order", action="append", choices=ORDERS)
    ap.add_argument("--prep-only", action="store_true")
    ap.add_argument("--vocab", type=int, default=2_564_352)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--hotness", type=int, default=100)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    blocks = ops._sm_count(0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    V, B, H, D = args.vocab, args.batch, args.hotness, args.dim
    ids = torch.randint(0, V, (B, H), generator=g, device=dev,
                        dtype=torch.int32)
    flat = ids.reshape(-1)
    segs = torch.arange(B, device=dev).repeat_interleave(H)
    perm = torch.randperm(flat.numel(), generator=g, device=dev)
    inputs = {"sorted": (flat, segs),
              "shuffled": (flat[perm].contiguous(), segs[perm].contiguous())}
    table32 = torch.randn((V, D), generator=g, device=dev)
    sources = {"checkout": build.CSRC / "embedding_bag.cu"}
    sources.update((str(p), p) for p in args.other)
    libs = {name: Library(ops._lib() if name == "checkout"
                          else turns.load_source("embedding_bag", src),
                          src.read_text())
            for name, src in sources.items()}
    others = [n for n in libs if n != "checkout"]
    for dname in args.dtype or ["bfloat16"]:
        table = table32.to(getattr(torch, dname))
        for o_i, order in enumerate(args.order or ["sorted"]):
            f_, s_ = inputs[order]
            bufs = {n: lib.prepared(s_, f_, B, blocks)
                    for n, lib in libs.items()}
            outs = {n: torch.empty((B, D), dtype=table.dtype, device=dev)
                    for n in libs}
            fixed_outs = {n: torch.empty_like(outs[n]) for n in libs}
            kinds = {"prep": lambda n: libs[n].prep(bufs[n], B, stream)}
            if not args.prep_only:
                def csr(n):
                    libs[n].prep(bufs[n], B, stream)
                    libs[n].bag(table, outs[n], stream, f_, B, b=bufs[n])
                kinds["csr"] = csr
                if o_i == 0:
                    kinds["fixed"] = lambda n: libs[n].bag(
                        table, fixed_outs[n], stream, ids, B, H)
            line = dict(dtype=dname, order=order, V=V, B=B, H=H, D=D,
                        blocks=blocks, iters=args.iters)
            for kind, fn in kinds.items():
                ms = turns.take_turns({n: (lambda n=n: fn(n)) for n in libs},
                                      args.rounds, args.iters)
                line[kind] = turns.summary(ms, "checkout")
            torch.cuda.synchronize()
            for kind, o in (("csr", outs), ("fixed", fixed_outs)):
                if kind not in kinds:
                    continue
                line[kind].update(
                    max_abs_vs_checkout={n: float(
                        (o[n].float() - o["checkout"].float()).abs().max())
                        for n in others},
                    elements_differing={n: int((o[n] != o["checkout"]).sum())
                                        for n in others})
            line.update(device=torch.cuda.get_device_name(0),
                        in_order=int(bufs["checkout"]["scratch"][0]))
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
