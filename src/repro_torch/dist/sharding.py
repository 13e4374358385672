"""Sharding rule sets for every model family, their DTensor placements, and
the candidate-axis sharding of serving stage 2 (port of
``repro.dist.sharding``).

Rules, not enumerations: each family gets a function from config / graph
to a tree of specs ``P`` whose structure mirrors the param tree exactly.
A spec is plain data, one entry per tensor dim — ``None``, a mesh axis
name, or a tuple of names — and compares as a tuple, so
``tuple(port_spec) == tuple(reference_spec)`` leaf for leaf.

Conventions
-----------
* axis names: ``data`` (+ ``pod`` when multi-pod) carry batch parallelism,
  ``model`` carries tensor parallelism.
* a dim is sharded only when every production config divides evenly
  (vocab pads to 256 = 16×16 so embed / lm_head can consume both axes);
  anything uncertain stays replicated. ``placements`` / ``distribute``
  raise on a sharded dim that does not divide by its axes' size, where
  DTensor would shard it unevenly (the reference fails to compile there).
* a joint entry ``("model", "data")`` becomes one ``Shard(d)`` on each of
  those mesh dims. DTensor splits such a dim in mesh-dim order, so on the
  ``(data, model)`` mesh ``data`` is the major axis where JAX makes the
  first name (``model``) major: each device holds the same number of
  rows, but another device owns each block (ROADMAP, deliberate
  divergences).

Running a program on these layouts: the launch layer holds state and
batch as DTensors; the models run shard-local blocks on ``to_local``
views (``local``), with the block's collectives as DTensor redistributes
at its edges and, inside it, ``psum`` / ``enter`` / ``pmax``.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence

import torch
import torch.distributed as dist

from repro_torch.common import tree_leaves

Tensor = torch.Tensor

# Embedding tables at or above this row count are worth model-sharding
# (``repro_torch.models.recsys.SHARD_THRESHOLD``: such tables pad their
# vocab to a shardable multiple at build time).
TABLE_SHARD_THRESHOLD = 65536

# ZeRO-1 shards optimizer state over this many data-parallel ways in the
# production meshes (16×16 single pod, 2×16×16 multi-pod: the 'data' axis
# is 16 in both) — a dim is eligible only if it divides evenly.
ZERO1_MULTIPLE = 16


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name
    or a tuple of names). ``P()`` is a scalar's (or a fully replicated
    tensor's of any rank). As JAX's, a one-name tuple is stored as the name
    and an empty one as None."""

    def __new__(cls, *parts):
        def norm(part):
            if isinstance(part, (tuple, list)):
                part = tuple(part)
                return part[0] if len(part) == 1 else (part or None)
            return part
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


class AbstractMesh:
    """Axis names and sizes without devices (``jax.sharding.AbstractMesh``):
    enough for the rule sets, which read names and sizes only."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(axis_names)


def spec_map(fn: Callable, specs, *rest):
    """Map ``fn`` over the ``P`` leaves of a dict tree of specs (and the
    matching leaves of ``rest``), in the key order of ``rest[0]`` when
    given (a state's own order), else of ``specs``."""
    if isinstance(specs, P):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        keys = rest[0].keys() if rest else specs.keys()
        return {k: spec_map(fn, specs[k], *(r[k] for r in rest))
                for k in keys}
    raise TypeError(f"not a spec tree: {specs!r}")


def _rep(shape) -> P:
    """Rank-matched replicated spec (indexable per dim, unlike P())."""
    return P(*([None] * len(shape)))


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    return int(mesh.shape[axis_names(mesh).index(name)])


def _axes(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def dp_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that carry data parallelism ('pod' joins 'data' when the
    mesh spans pods)."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


# ---------------------------------------------------------------------------
# LM family — Megatron-style tensor parallelism + ZeRO-1 optimizer state
# ---------------------------------------------------------------------------

def lm_param_pspecs(cfg) -> dict:
    """Specs mirroring ``init_lm_params(cfg)``: column-parallel
    in-projections (wq/wk/wv, wg/wu) shard their output dim over 'model',
    row-parallel out-projections (wo, wd) their contraction dim;
    embed / lm_head consume ('model', 'data') jointly on the padded
    vocab."""
    attn = {"wq": P(None, None, "model"), "wk": P(None, None, "model"),
            "wv": P(None, None, "model"), "wo": P(None, "model", None)}
    if cfg.qk_norm:
        attn["q_norm"] = P(None, None)
        attn["k_norm"] = P(None, None)
    if cfg.is_moe:
        ffn = {"router": P(None, None, None),
               "wg": P(None, None, None, "model"),
               "wu": P(None, None, None, "model"),
               "wd": P(None, None, "model", None)}
    else:
        ffn = {"wg": P(None, None, "model"), "wu": P(None, None, "model"),
               "wd": P(None, "model", None)}
    return {
        "embed": P(("model", "data"), None),
        "layers": {"attn": attn, "ffn": ffn,
                   "ln1": P(None, None), "ln2": P(None, None)},
        "final_norm": P(None),
        "lm_head": P(None, ("model", "data")),
    }


def zero1_pspecs(pspecs, shapes, *, axis: str = "data",
                 multiple: int = ZERO1_MULTIPLE):
    """ZeRO-1: additionally shard optimizer-state replicas over ``axis``.

    For each param, the largest dim that is unsharded in the param spec
    and divides by ``multiple`` gets ``axis``; params already touching
    ``axis`` (embed / lm_head) and params with no eligible dim keep their
    spec. ``shapes`` is a tree of tensors (``meta`` ones will do)."""
    def one(spec: P, t) -> P:
        if axis in [a for part in spec for a in _axes(part)]:
            return spec
        shape = tuple(t.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        best, best_size = None, 0
        for i, (part, size) in enumerate(zip(parts, shape)):
            if part is None and size % multiple == 0 and size > best_size:
                best, best_size = i, size
        if best is None:
            return spec
        parts[best] = axis
        return P(*parts)

    return spec_map(one, pspecs, shapes)


def lm_batch_pspec(mesh) -> P:
    """(B, S) token batches: batch over the DP axes, sequence replicated."""
    return P(dp_axes(mesh), None)


def _ndp(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in dp_axes(mesh))


def batch_lead(mesh, batch: int):
    """The DP axes when ``batch`` divides over them, else None."""
    ndp = _ndp(mesh)
    return dp_axes(mesh) if batch % ndp == 0 and batch >= ndp else None


def lm_cache_pspecs(mesh, batch: int) -> dict:
    """KV cache (L, B, W, n_kv_heads, hd): batch dim over DP when it
    divides; heads stay replicated (GQA archs have 4-8 KV heads against
    model=16)."""
    spec = P(None, batch_lead(mesh, batch), None, None, None)
    return {"k": spec, "v": spec}


def lm_state_pspecs(cfg, params_shapes=None) -> dict:
    """Train-state specs: Megatron params + ZeRO-1 adamw moments/master."""
    pp = lm_param_pspecs(cfg)
    if params_shapes is None:
        from repro_torch.models.transformer import lm_param_specs
        params_shapes = lm_param_specs(cfg)
    zp = zero1_pspecs(pp, params_shapes)
    return {"params": pp,
            "opt": {"mu": zp, "nu": zp, "master": zp, "step": P()}}


# ---------------------------------------------------------------------------
# RecSys family — big embedding tables sharded, dense layers replicated
# ---------------------------------------------------------------------------

def recsys_param_pspecs(graph, table_axes: tuple[str, ...] = ("model",)
                        ) -> dict:
    """Specs mirroring ``init_graph_params(graph)``: embedding tables at or
    above ``TABLE_SHARD_THRESHOLD`` rows shard their vocab dim over
    ``table_axes``; small tables and every dense / attention weight
    replicate."""
    from repro_torch.graph.executor import init_graph_params

    shapes = init_graph_params(graph, device="meta")

    def rep(tree):
        if isinstance(tree, dict):
            return {k: rep(v) for k, v in tree.items()}
        return _rep(tree.shape)

    pp = rep(shapes)
    lead = table_axes[0] if len(table_axes) == 1 else tuple(table_axes)
    for n in graph.param_nodes():
        if (n.op == "embedding"
                and n.attrs["vocab"] >= TABLE_SHARD_THRESHOLD):
            pp[n.name]["table"] = P(lead, None)
    return pp


def recsys_feed_pspecs(graph, mesh, train: bool = False) -> dict:
    """Input feeds: candidate / example rows over DP; serving-time user
    feeds (leading dim 1) replicated."""
    dp = dp_axes(mesh)
    specs = {}
    for n in graph.input_nodes():
        rank = 1 + len(n.attrs["shape"])
        lead = dp if (train or n.attrs.get("domain") != "user") else None
        specs[n.name] = P(lead, *([None] * (rank - 1)))
    return specs


def recsys_state_pspecs(graph, table_axes: tuple[str, ...] = ("model",)
                        ) -> dict:
    """Train-state specs: adam moments shard exactly like their params."""
    pp = recsys_param_pspecs(graph, table_axes=table_axes)
    return {"params": pp, "opt": {"mu": pp, "nu": pp, "step": P()}}


# ---------------------------------------------------------------------------
# GNN family — small params, fully replicated (edges carry the parallelism)
# ---------------------------------------------------------------------------

def gnn_state_pspecs(params_shapes) -> dict:
    def rep(tree):
        if isinstance(tree, dict):
            return {k: rep(v) for k, v in tree.items()}
        return _rep(tree.shape)

    pp = rep(params_shapes)
    return {"params": pp, "opt": {"mu": pp, "nu": pp, "step": P()}}


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------

def placements(mesh, spec: P, shape: Sequence[int] | None = None) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that a dim ``d`` names, ``Replicate()`` elsewhere. With
    ``shape``, a sharded dim must divide by the product of its axes'
    sizes (``ValueError`` otherwise)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        axes = _axes(part)
        for a in axes:
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {a!r} appears twice in {spec!r}")
            out[i] = Shard(d)
        if shape is not None and axes:
            n = math.prod(axis_size(mesh, a) for a in axes)
            if d >= len(shape) or shape[d] % n:
                raise ValueError(
                    f"spec {spec!r} shards dim {d} of shape {tuple(shape)} "
                    f"over {axes} ({n} ways), which does not divide it")
    return tuple(out)


def local_shape(shape: Sequence[int], mesh, spec: P) -> tuple[int, ...]:
    """A device's shard of a ``shape`` tensor laid out by ``spec`` (every
    sharded dim divides: ``placements`` checks)."""
    placements(mesh, spec, shape)
    out = list(shape)
    for d, part in enumerate(spec):
        for a in _axes(part):
            out[d] //= axis_size(mesh, a)
    return tuple(out)


def named(mesh, tree):
    """Map every ``P`` leaf of a spec tree to its placements on ``mesh``
    (the reference's ``NamedSharding`` tree)."""
    return spec_map(lambda s: placements(mesh, s), tree)


def _coord(mesh, dim: int) -> int:
    return mesh.get_local_rank(dim)


def _local_chunk(t: Tensor, mesh, pl: Sequence) -> Tensor:
    """This rank's block of a full tensor ``t`` under placements ``pl``
    (mesh dims split in order, as DTensor does)."""
    from torch.distributed.tensor import Shard
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            t = t.chunk(mesh.size(i), dim=p.dim)[_coord(mesh, i)]
    return t


def distribute(tree, mesh, spec_tree):
    """A tree of full tensors (every rank holds the same values, e.g. from
    one seed) as DTensors laid out by ``spec_tree``: each rank keeps its
    own block, no collective."""
    from torch.distributed.tensor import DTensor

    def one(spec, t):
        pl = placements(mesh, spec, t.shape)
        local = _local_chunk(t, mesh, pl)
        # a whole block (every axis it is split over holds one rank) is
        # the tensor itself, no copy
        local = t if local.shape == t.shape else local.contiguous()
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return spec_map(one, spec_tree, tree)


def fake_distribute(tree, mesh, spec_tree, fake_mode):
    """``distribute`` of a tree of ``meta`` tensors: every rank's block as a
    fake tensor of its local shape (nothing is allocated)."""
    from torch.distributed.tensor import DTensor

    def one(spec, t):
        pl = placements(mesh, spec, t.shape)
        with fake_mode:
            local = torch.empty(local_shape(t.shape, mesh, spec),
                                dtype=t.dtype, device=mesh.device_type)
        full = torch.empty(t.shape, dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=full.shape, stride=full.stride())
    return spec_map(one, spec_tree, tree)


def local_bytes(tree) -> int:
    """Bytes of this rank's blocks of a tree of DTensors (or tensors)."""
    total = 0
    for t in tree_leaves(tree):
        t = t.to_local() if is_dtensor(t) else t
        total += t.numel() * t.element_size()
    return total


# ---------------------------------------------------------------------------
# Shard-local blocks
# ---------------------------------------------------------------------------

_DTENSOR: type | None = None


def _dtensor_type() -> type:
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor
        _DTENSOR = DTensor
    return _DTENSOR


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor_type())


class Layouts:
    """The placements a program's activations take on ``mesh``: ``rows``
    (dim 0 over the DP axes — or ``Replicate`` there when ``batch`` does
    not divide —, replicated over 'model'), ``seq`` (``rows`` with dim 1
    over 'model') and ``rep``. ``dp`` / ``model`` are mesh-dim indices."""

    def __init__(self, mesh, batch_sharded: bool = True):
        from torch.distributed.tensor import Replicate, Shard
        names = axis_names(mesh)
        self.mesh = mesh
        self.dp = [i for i, a in enumerate(names) if a in dp_axes(mesh)]
        self.model = names.index("model") if "model" in names else None
        lead = Shard(0) if batch_sharded else Replicate()
        self.rows = tuple(lead if i in self.dp else Replicate()
                          for i in range(len(names)))
        self.seq = tuple(Shard(1) if i == self.model else p
                         for i, p in enumerate(self.rows))
        self.rep = (Replicate(),) * len(names)

    def with_(self, base: Sequence, **dims) -> tuple:
        """``base`` with the placement of each named mesh dim replaced:
        ``with_(rows, model=Partial())``; ``dp=`` sets every DP dim."""
        out = list(base)
        for name, p in dims.items():
            idx = self.dp if name == "dp" else [self.model]
            for i in idx:
                out[i] = p
        return tuple(out)

    def model_size(self) -> int:
        return 1 if self.model is None else self.mesh.size(self.model)

    def model_rank(self) -> int:
        return 0 if self.model is None else _coord(self.mesh, self.model)


def local(x, mesh, pl: Sequence, grad: Sequence | None = None) -> Tensor:
    """``x`` (a DTensor) redistributed to ``pl`` and taken as this rank's
    plain tensor. ``grad`` states the placements of the gradient that the
    local computation will produce (``Partial()`` where ranks computed on
    different data with the same block, so their gradients are summed)."""
    if not is_dtensor(x):
        return x
    if tuple(x.placements) != tuple(pl):
        x = x.redistribute(mesh, pl)
    return x.to_local(grad_placements=grad)


def wrap(x: Tensor, mesh, pl: Sequence, shape=None):
    """A local result ``x`` as a DTensor with placements ``pl``."""
    from torch.distributed.tensor import DTensor
    if shape is None:
        return DTensor.from_local(x, mesh, pl, run_check=False)
    full_t = torch.empty(shape, dtype=x.dtype, device="meta")
    return DTensor.from_local(x, mesh, pl, run_check=False,
                              shape=full_t.shape, stride=full_t.stride())


def _dims(mesh, axes: Iterable[str]) -> list[int]:
    names = axis_names(mesh)
    return [names.index(a) for a in axes]


def _all_reduce(x: Tensor, mesh, dims: Sequence[int], op: str = "sum"
                ) -> Tensor:
    import torch.distributed._functional_collectives as funcol
    for d in dims:
        x = funcol.all_reduce(x, op, (mesh, d))
        if isinstance(x, funcol.AsyncCollectiveTensor):
            x = x.wait()
    return x


def _mesh_of(mesh):
    if mesh is None:
        from repro_torch.dist import policy
        mesh = policy.get("mesh")
    if mesh is None:
        raise ValueError("a collective over named axes needs a mesh: "
                         "activate one with launch.mesh.mesh_context")
    return mesh


class _PSum(torch.autograd.Function):
    """Sum over mesh dims; the gradient passes unchanged (the result is
    the same on every rank, so is its gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        return _all_reduce(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """Identity; the gradient is summed over mesh dims (a replicated value
    entering computation that differs per rank)."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.mesh, ctx.dims), None, None


def psum(x: Tensor, axes, mesh=None) -> Tensor:
    """``jax.lax.psum(x, axes)`` inside a shard-local block."""
    mesh = _mesh_of(mesh)
    return _PSum.apply(x, mesh, _dims(mesh, _axes(axes)))


def enter(x: Tensor, axes, mesh=None) -> Tensor:
    """Identity forward, ``psum`` of the gradient over ``axes``."""
    mesh = _mesh_of(mesh)
    return _Enter.apply(x, mesh, _dims(mesh, _axes(axes)))


def pmax(x: Tensor, axes, mesh=None) -> Tensor:
    """``jax.lax.pmax`` of a value that needs no gradient."""
    mesh = _mesh_of(mesh)
    return _all_reduce(x.detach(), mesh, _dims(mesh, _axes(axes)), "max")


def sharded_rows(table, ids, grad: bool = True):
    """Rows ``table[ids]`` of a vocab-sharded table (a DTensor sharded on
    dim 0 only) for ids laid out as a DTensor: the ids are gathered over
    the table's axes, each rank looks up the ids that fall in its block
    (zeros elsewhere) and the result is ``Partial`` over the table's
    axes — the caller's redistribute sums it. Ids out of the table's
    range give zeros."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tpl = tuple(table.placements)
    tax = [i for i, p in enumerate(tpl) if isinstance(p, Shard)]
    if any(tpl[i].dim != 0 for i in tax):
        raise ValueError(f"table placements {tpl}: only the vocab dim may "
                         "be sharded")
    ipl = tuple(Replicate() if i in tax else p
                for i, p in enumerate(ids.placements))
    ids_l = local(ids, mesh, ipl)
    # the table's gradient: its own block (Shard), summed over the dims
    # where the ids (so the rows looked up) differ per rank
    gpl = tuple(tpl[i] if i in tax else
                (Partial() if isinstance(ipl[i], Shard) else Replicate())
                for i in range(len(tpl)))
    rows = table.to_local(grad_placements=gpl if grad else None)
    blk = 0
    for i in tax:
        blk = blk * mesh.size(i) + _coord(mesh, i)
    n = rows.shape[0]
    loc = ids_l.long() - blk * n
    ok = (loc >= 0) & (loc < n)
    out = torch.index_select(rows, 0, loc.clamp(0, n - 1).reshape(-1))
    out = out.reshape(tuple(ids_l.shape) + (rows.shape[1],))
    out = torch.where(ok[..., None], out, out.new_zeros(()))
    opl = tuple(Partial() if i in tax else p for i, p in enumerate(ipl))
    return wrap(out, mesh, opl)


def shard_local(op: str, rows: tuple[str, ...] = ()) -> Callable:
    """A kernel entry that takes DTensors: it runs on this rank's local
    tensors and returns its rows laid out as its row arguments.

    ``rows`` name the arguments whose dim 0 is the output's rows: each
    such DTensor is ``Shard(0)`` or ``Replicate`` on every mesh dim, all
    sharded ones alike. Every other DTensor argument is read whole: a
    placement other than ``Replicate`` is allowed only on a mesh dim of
    one rank. Anything else raises ``ValueError`` naming ``op`` — a
    kernel never quietly gives way to a gather or a plain version. Plain
    arguments pass through untouched (one ``isinstance`` per argument)."""
    import functools
    import inspect

    def deco(fn):
        names = list(inspect.signature(fn).parameters)

        @functools.wraps(fn)
        def entry(*args, **kw):
            dt = _dtensor_type()
            if not any(isinstance(a, dt) for a in args) and not any(
                    isinstance(a, dt) for a in kw.values()):
                return fn(*args, **kw)
            return _shard_local_call(fn, op, rows, names, args, kw)
        return entry
    return deco


def _shard_local_call(fn, op, rows, names, args, kw):
    from torch.distributed.tensor import Replicate, Shard
    bound = dict(zip(names, args), **kw)
    mesh, row_pl = None, None
    for name, a in bound.items():
        if not is_dtensor(a):
            continue
        mesh = a.device_mesh
        pl = tuple(a.placements)
        if name in rows and all(isinstance(p, Replicate) or p == Shard(0)
                                for p in pl):
            if any(isinstance(p, Shard) for p in pl):
                if row_pl is not None and row_pl != pl:
                    raise ValueError(
                        f"{op}: row arguments laid out {row_pl} and {pl}")
                row_pl = pl
            continue
        if any(not isinstance(p, Replicate) and mesh.size(i) > 1
               for i, p in enumerate(pl)):
            raise ValueError(
                f"{op}: argument {name!r} is laid out {pl} on mesh "
                f"{tuple(mesh.shape)}; the kernel reads it whole "
                f"{'(rows: Shard(0) or Replicate)' if name in rows else ''}")
    local_kw = {k: a.to_local() if is_dtensor(a) else a
                for k, a in bound.items()}
    out = fn(**local_kw)
    return wrap(out, mesh, row_pl or (Replicate(),) * mesh.ndim)


# ---------------------------------------------------------------------------
# Serving stage 2 — candidate-axis sharding
# ---------------------------------------------------------------------------

def candidate_pspecs(*, replicate_out: bool = True) -> tuple[tuple, object]:
    """(argument placements, output placement) of the row-wise stage 2
    ``fn(params, rep_table, user_index, candidate_feeds)``: params and rep
    tables ``Replicate()``, user index and candidate rows ``Shard(0)``;
    the output ``Replicate()`` after the closing all-gather, or
    ``Shard(0)`` with ``replicate_out=False`` (each rank keeps its block).
    Per-entry rep-table placements: ``core.split.rep_table_pspecs``."""
    from torch.distributed.tensor import Replicate, Shard
    repl, rows = Replicate(), Shard(0)
    return (repl, repl, rows, rows), (repl if replicate_out else rows)


def group_ready() -> bool:
    """True once this process has joined a default process group."""
    return dist.is_available() and dist.is_initialized()


def world(group=None) -> tuple[int, int]:
    """(size, this process's rank) of ``group`` (the default group for
    None); (1, 0) without a process group."""
    if not group_ready():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def gather_rows(x: Tensor, group=None) -> Tensor:
    """All-gather ``x`` over its leading dim: ``(world * rows, ...)``, block
    i from rank i.

    * NCCL: ``all_gather_into_tensor`` on the card, enqueued on the current
      stream (the caller records its event after this returns);
    * gloo: ``all_gather`` on the tensors where they lie. A CUDA block is
      staged through the host by gloo itself, behind the current stream's
      work; the call returns once the host side of the collective is
      done, and the result lies on the block's device;
    * no process group: ``x`` itself, no collective (a one-rank group
      still runs its collective).
    """
    if not group_ready():
        return x
    n = world(group)[0]
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather(list(out.chunk(n)), x, group=group)
    return out

