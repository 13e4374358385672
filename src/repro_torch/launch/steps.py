"""Per-cell programs (port of ``repro.launch.steps``): for an
(architecture × input shape) cell of the LM, recsys or GNN family, the
step function, its inputs as ``meta``-device tensors at the shape's sizes
(the reference's ``ShapeDtypeStruct``s), and — given a mesh — the specs
that lay them out.

``CellProgram.compiled()`` is the port of ``jitted()``;
``CellProgram.init(seed, device)`` makes the step's first argument (the
train state, or the params) at full size::

    prog = build_cell("granite-moe-3b-a800m", "train_4k")
    step = prog.compiled()                    # a CompiledStep
    state = prog.init(seed=0)
    state, metrics = step(state, batch)       # state updated in place

* **train** (``_lm_train``, ``_recsys_train``, ``_gnn_train``): one step
  behind a captured CUDA graph (``graph.compiled.CompiledStep``). The
  state — params and optimizer state — is updated in place by the
  optimizer's ``update_`` (the reference donates it,
  ``donate_argnums=(0,)``); the batch is copied into static buffers;
  ``loss`` is the only output.
* **serve** (``_recsys_serve``): the GCA + MaRI rewrite, then the
  executor behind one ``CompiledRun`` per feed signature. On the card it
  runs through the CUDA kernels (``use_pallas``), the ``mari_matmul``
  weights prepared once per params object.
* **decode**: one captured graph; ``tokens`` and ``pos`` are feeds, the
  cache's ``k`` / ``v`` refs read and written in place (the reference
  donates the cache). **prefill** stays eager: its attention walks
  S²/(q_chunk·kv_chunk) blocks a layer, each a handful of large kernels,
  so capture would save little launch time for a graph of hundreds of
  thousands of nodes.

On the CPU the same programs run eagerly (a train cell's compiled step is
the eager step over static buffers).

**On a mesh** (``build_cell(arch, shape, mesh, opts)``) each builder sets
``in_shardings`` / ``out_shardings`` — trees of ``dist.sharding.P``
specs, one per argument, that ``sharding.named(mesh, ...)`` maps to
DTensor placements — and ``policy_kv``, as the reference's builders do.
``init(seed, device)`` returns the state as DTensors (each rank its
blocks of the one seeded state); the step runs on DTensors. ``compiled()``
on a mesh runs every kind eagerly, by design: a step there is a sequence
of collectives between shard-local blocks, several of which read a
DTensor's layout on the host, and a one-rank NCCL group is what the card
machine has to replay it on; ``meta["captured"]`` records it.
``trace()`` runs the step once on fake local tensors (no memory, no card)
— the port of ``lower()``, which the dry run measures.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import configs as cfgreg
from repro_torch.common import (resolve_device, tree_leaves, tree_map,
                                value_and_grad)
from repro_torch.data.features import feed_specs
from repro_torch.data.lm import token_batch_specs
from repro_torch.dist import policy
from repro_torch.dist import sharding as sh
from repro_torch.dist.sharding import (
    P, dp_axes, gnn_state_pspecs, lm_batch_pspec, lm_cache_pspecs,
    lm_param_pspecs, recsys_feed_pspecs, recsys_param_pspecs,
    recsys_state_pspecs, zero1_pspecs)
from repro_torch.graph.compiled import CompiledRun, CompiledStep
from repro_torch.graph.executor import Executor, init_graph_params
from repro_torch.models import schnet as schnet_mod
from repro_torch.models.transformer import (LMConfig, init_lm_params,
                                            kv_cache_specs, lm_decode_step,
                                            lm_forward, lm_last_logits_sharded,
                                            lm_loss, lm_param_specs)
from repro_torch.train.losses import bce_with_logits, softmax_xent
from repro_torch.train.optim import Optimizer, adam, adamw

# the batch's labels in a recsys train step's flat feed mapping
LABELS_FEED = "__labels__"


@dataclasses.dataclass
class CellProgram:
    arch: str
    shape: str
    kind: str
    step_fn: Callable
    args: tuple                      # meta-device tensor trees
    in_shardings: Any = None
    out_shardings: Any = None
    donate_argnums: tuple[int, ...] = ()
    meta: dict = dataclasses.field(default_factory=dict)
    policy_kv: dict = dataclasses.field(default_factory=dict)
    mesh: Any = None
    # the port's own: the step's first argument at full size, the runner
    # compiled() returns (``make_compiled(device, use_pallas)``), and a
    # train cell's parts: its loss, optimizer and batch packing
    init: Callable[..., Any] | None = None
    make_compiled: Callable | None = None
    loss_fn: Callable | None = None  # train: loss_fn(params, feeds)
    opt: Optimizer | None = None     # train: what the step updates with
    pack: Callable | None = None     # train: the batch -> flat feeds

    def compiled(self, device: str | torch.device = "cuda",
                 use_pallas: bool | None = None) -> Callable:
        """The step as the reference's ``jitted()`` runs it: train behind
        one captured graph (``CompiledStep``), serve behind a
        ``CompiledRun`` through the kernels on the card (``use_pallas``
        defaults to ``True`` on CUDA), decode behind one captured graph
        (``CompiledDecode``), prefill eager under
        ``torch.inference_mode``. On a mesh every kind runs eagerly on
        DTensors, under the program's policy (``meta["captured"]``)."""
        dev = resolve_device(device)
        if self.mesh is None:
            return self.make_compiled(dev, use_pallas)
        run = self.make_compiled(dev, use_pallas)

        def step(*args):
            with policy.use(**self.policy_kv), _mesh_context(self.mesh):
                return run(*args)
        return step

    def trace(self, around: Callable | None = None):
        """Run ``step_fn`` once on DTensors whose local blocks are fake
        tensors laid out by ``in_shardings`` (allocating nothing), under the
        program's policy — the port of ``lower()``. ``around(args)``, if
        given, is a context manager entered around the step only.
        Returns (args, outputs)."""
        import contextlib

        from torch._subclasses.fake_tensor import FakeTensorMode
        if self.mesh is None:
            raise ValueError("trace() lays the arguments out on a mesh: "
                             "build the cell with one")
        fm = FakeTensorMode()
        args = tuple(sh.fake_distribute(a, self.mesh, spec, fm)
                     for a, spec in zip(self.args, self.in_shardings))
        ctx = around(args) if around is not None else contextlib.nullcontext()
        with fm, policy.use(**self.policy_kv), \
                _mesh_context(self.mesh), ctx:
            out = self.step_fn(*args)
        return args, out


def _mesh_context(mesh):
    from repro_torch.launch.mesh import mesh_context
    return mesh_context(mesh)


def _on_mesh(prog: CellProgram, mesh, in_sh: tuple, out_sh, init_full:
             Callable | None = None, policy_kv: dict | None = None
             ) -> CellProgram:
    """``prog`` laid out on ``mesh``: shardings, policy, ``init`` as
    DTensors, and ``meta["captured"] = False``."""
    prog.mesh, prog.in_shardings, prog.out_shardings = mesh, in_sh, out_sh
    prog.policy_kv = dict(policy_kv or {})
    prog.meta["captured"] = False
    if prog.kind == "train":
        prog.make_compiled = lambda dev, _: prog.step_fn
    full_init = init_full or prog.init

    def init(seed: int = 0, device: str | torch.device = "cuda"):
        return sh.distribute(full_init(seed, device), mesh, in_sh[0])
    prog.init = init
    return prog


class CompiledDecode:
    """``decode(params, cache, tokens, pos) -> (logits, cache)`` behind a
    ``CompiledRun``: ``tokens`` (B, 1) and ``pos`` (a 0-d int32 tensor)
    are copied into static buffers; the cache's ``k`` / ``v`` are passed by
    address and updated in place, never copied in. A new position replays
    the same graph; a new cache, params or batch is a new entry."""

    def __init__(self, step_fn: Callable, *,
                 device: str | torch.device = "cuda"):
        def body(params, feeds):
            logits, _ = step_fn(params, {"k": feeds["k"], "v": feeds["v"]},
                                feeds["tokens"], feeds["pos"])
            return {"logits": logits}

        self.run = CompiledRun(body, device=device)

    @property
    def compilations(self) -> int:
        return self.run.compilations

    def __call__(self, params, cache: dict, tokens: torch.Tensor,
                 pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
        out = self.run(params, {"tokens": tokens, "pos": pos},
                       refs={"k": cache["k"], "v": cache["v"]})
        return out["logits"], cache


def train_body(loss_fn: Callable[[Any, dict], torch.Tensor],
               opt: Optimizer, grad_dtype: torch.dtype | None = None
               ) -> Callable[[dict, dict], dict]:
    """``body(state, feeds) -> {"loss"}``: ``loss_fn(params, feeds)``, its
    gradients by autograd (cast to ``grad_dtype`` when given), and
    ``opt.update_`` on ``state = {"params", "opt"}`` in place."""
    def body(state, feeds):
        loss, grads = value_and_grad(lambda p: loss_fn(p, feeds),
                                     state["params"])
        if grad_dtype is not None:
            grads = tree_map(lambda g: g.to(grad_dtype), grads)
        opt.update_(grads, state["opt"], state["params"])
        return {"loss": loss}
    return body


def compiled_train_step(loss_fn: Callable[[Any, dict], torch.Tensor],
                        opt: Optimizer, *,
                        device: str | torch.device = "cuda",
                        pack: Callable | None = None,
                        grad_dtype: torch.dtype | None = None
                        ) -> CompiledStep:
    """``step(state, *batch) -> (state, {"loss"})``: ``train_body`` behind
    one captured CUDA graph on ``device`` (``CompiledStep``; eager over
    static buffers on the CPU); ``pack(*batch)`` gives the body's feeds."""
    return CompiledStep(train_body(loss_fn, opt, grad_dtype), device=device,
                        pack=pack)


def _train_program(loss_fn: Callable, opt: Optimizer, args: tuple,
                   init: Callable, pack: Callable | None = None,
                   grad_dtype: torch.dtype | None = None) -> CellProgram:
    """A train cell: ``step_fn(state, *batch) -> (state, {"loss"})`` runs
    the body eagerly, in place; ``compiled()`` is
    ``compiled_train_step``."""
    body = train_body(loss_fn, opt, grad_dtype)

    def train_step(state, *batch):
        feeds = pack(*batch) if pack is not None else batch[0]
        return state, body(state, feeds)

    return CellProgram(
        "", "", "train", train_step, args, donate_argnums=(0,), init=init,
        make_compiled=lambda dev, _: compiled_train_step(
            loss_fn, opt, device=dev, pack=pack, grad_dtype=grad_dtype),
        loss_fn=loss_fn, opt=opt, pack=pack)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def lm_train_loss(cfg: LMConfig) -> Callable[[Any, dict], torch.Tensor]:
    """``loss_fn(params, {"tokens", "labels"})``: ``lm_loss``."""
    def loss_fn(params, feeds):
        return lm_loss(params, cfg, feeds["tokens"], feeds["labels"])
    return loss_fn


def _lm_policy(mesh, opts) -> dict:
    """'moe_local': the MoE routes within each DP shard; 'seq_par': the
    residual between layers lies on (dp, 'model', None)."""
    kv = {}
    dp = dp_axes(mesh)
    if "moe_local" in opts:
        kv["moe_shard_axes"] = dp
    if "seq_par" in opts:
        kv["residual"] = (mesh, sh.placements(mesh, P(dp, "model", None)))
    return kv


def _lm_train(cfg: LMConfig, seq: int, batch: int, mesh=None,
              opts=frozenset()) -> CellProgram:
    """``lm_loss`` plus AdamW(3e-4) with f32 master weights; params in
    ``cfg.dtype``. On a mesh: Megatron params, ZeRO-1 moments and master
    (``zero1_pspecs``), the batch over the DP axes."""
    opt = adamw(3e-4, master_weights=True)

    def init(seed: int = 0, device: str | torch.device = "cuda"):
        params = init_lm_params(cfg, seed=seed, device=resolve_device(device))
        return {"params": params, "opt": opt.init(params)}

    params = lm_param_specs(cfg)        # opt.init allocates nothing on meta
    state = {"params": params, "opt": opt.init(params)}
    prog = _train_program(lm_train_loss(cfg), opt,
                          (state, token_batch_specs(batch, seq)), init)
    if mesh is None:
        return prog
    pp = lm_param_pspecs(cfg)
    zp = zero1_pspecs(pp, params)
    state_ps = {"params": pp,
                "opt": {"mu": zp, "nu": zp, "master": zp, "step": P()}}
    bp = lm_batch_pspec(mesh)
    return _on_mesh(prog, mesh, (state_ps, {"tokens": bp, "labels": bp}),
                    (state_ps, {"loss": P()}),
                    policy_kv=_lm_policy(mesh, opts))


def _lm_prefill(cfg: LMConfig, seq: int, batch: int, mesh=None,
                opts=frozenset()) -> CellProgram:
    def prefill_step(params, tokens):
        x, kv = lm_forward(params, cfg, tokens, return_kv=True)
        if sh.is_dtensor(x):
            return lm_last_logits_sharded(params, x), {
                k: v.redistribute(mesh, sh.placements(mesh, cache_ps))
                for k, v in kv.items()}
        logits = x[:, -1, :] @ params["lm_head"].to(x.dtype)
        return logits, kv

    make_compiled = _eager_no_grad(prefill_step)
    tok = torch.empty((batch, seq), dtype=torch.int32, device="meta")
    cache_ps = None if mesh is None else lm_cache_pspecs(mesh, batch)["k"]
    prog = CellProgram("", "", "prefill", prefill_step,
                       (lm_param_specs(cfg), tok),
                       make_compiled=make_compiled,
                       init=lambda seed=0, device="cuda": init_lm_params(
                           cfg, seed=seed, device=resolve_device(device)))
    if mesh is None:
        return prog
    dp = dp_axes(mesh)
    return _on_mesh(prog, mesh, (lm_param_pspecs(cfg), P(dp, None)),
                    (P(dp, "model"), {"k": cache_ps, "v": cache_ps}),
                    policy_kv=_lm_policy(mesh, opts))


def _eager_no_grad(step_fn: Callable) -> Callable:
    def make(dev, _):
        def run(*args):
            with torch.inference_mode():
                return step_fn(*args)
        return run
    return make


def _lm_decode(cfg: LMConfig, seq: int, batch: int, mesh=None
               ) -> CellProgram:
    def decode(params, cache, tokens, pos):
        return lm_decode_step(params, cfg, cache, tokens, pos)

    tok = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    prog = CellProgram("", "", "decode", decode,
                       (lm_param_specs(cfg), kv_cache_specs(cfg, batch, seq),
                        tok, pos), donate_argnums=(1,),
                       make_compiled=lambda dev, _: CompiledDecode(
                           decode, device=dev),
                       init=lambda seed=0, device="cuda": init_lm_params(
                           cfg, seed=seed, device=resolve_device(device)))
    if mesh is None:
        return prog
    prog.make_compiled = _eager_no_grad(decode)
    cache_ps = lm_cache_pspecs(mesh, batch)
    tok_ps = P(sh.batch_lead(mesh, batch), None)
    return _on_mesh(prog, mesh,
                    (lm_param_pspecs(cfg), cache_ps, tok_ps, P()),
                    (P(None, None, "model"), cache_ps))


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def _meta_feeds(graph, batch: int, train: bool,
                float_dtype: torch.dtype = torch.float32) -> dict:
    """``feed_specs`` as meta tensors, float feeds in ``float_dtype``."""
    out = {}
    for name, spec in feed_specs(graph, batch, train=train).items():
        dt = torch.from_numpy(np.empty(0, spec.dtype)).dtype
        if dt.is_floating_point:
            dt = float_dtype
        out[name] = torch.empty(spec.shape, dtype=dt, device="meta")
    return out


def _executors(graph, mode: str, **kw) -> Callable[[torch.device], Executor]:
    """One executor per device, made at first use (an executor moves its
    feeds to its own device)."""
    made: dict = {}

    def get(device: torch.device) -> Executor:
        if device not in made:
            made[device] = Executor(graph, mode, device=device, **kw)
        return made[device]
    return get


def _concat_outputs(out: dict, outputs: list[str]) -> torch.Tensor:
    return torch.cat([out[o] for o in outputs], dim=-1)


def recsys_loss(executor_for: Callable[[torch.device], Executor],
                outputs: list[str]) -> Callable[[dict, dict], torch.Tensor]:
    """``loss_fn(params, feeds)``: BCE over the concatenated task logits
    of ``executor_for(device)`` (the labels' device); the labels ride in
    ``feeds`` under ``LABELS_FEED``."""
    def loss_fn(params, feeds):
        labels = feeds[LABELS_FEED]
        out = executor_for(labels.device).run(
            params, {k: v for k, v in feeds.items() if k != LABELS_FEED})
        return bce_with_logits(_concat_outputs(out, outputs), labels)
    return loss_fn


def recsys_pack(feeds: dict, labels: torch.Tensor) -> dict:
    """A recsys train batch as the flat feed mapping ``recsys_loss``
    reads: the labels under ``LABELS_FEED``."""
    return {**feeds, LABELS_FEED: labels}


def _row_params(params: dict, L, grad_rows: bool) -> dict:
    """A recsys program's params as this rank's tensors: every replicated
    leaf whole, a vocab-sharded table whole when its axes hold one rank
    each, else left a DTensor (the executor's ``lookup`` reads it). With
    ``grad_rows`` the gradients are summed over the DP axes (the ranks
    score different rows)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = L.mesh

    def grad(pl):
        if not grad_rows:
            return None
        return tuple(p if isinstance(p, Shard) else
                     (Partial() if i in L.dp else Replicate())
                     for i, p in enumerate(pl))

    def one(t):
        pl = tuple(t.placements)
        split = [i for i, p in enumerate(pl) if isinstance(p, Shard)]
        if any(mesh.size(i) > 1 for i in split):
            return t
        return sh.local(t, mesh, pl, grad(pl))
    return tree_map(one, params)


def _mesh_lookup(L, rows: tuple, user_ids: frozenset[str], use_pallas: bool):
    """The executor's ``lookup`` on a mesh: rows of a vocab-sharded table
    (``sharding.sharded_rows``) for ids laid out as the feed rows
    (placements ``rows``; replicated for a serving user feed), returned
    as this rank's rows."""
    def lookup(node, table, ids):
        if not sh.is_dtensor(table):
            return None
        if use_pallas and node.attrs.get("pool") in ("sum", "mean"):
            raise ValueError(
                f"embedding {node.name!r}: the embedding_bag kernel pools "
                f"rows of a whole table, but this table is split "
                f"{tuple(table.placements)} over a mesh axis of more than "
                "one rank")
        pl = L.rep if node.inputs[0] in user_ids else rows
        out = sh.sharded_rows(table, sh.wrap(ids, L.mesh, pl))
        return out.redistribute(L.mesh, pl).to_local()
    return lookup


def _user_ids(graph) -> frozenset[str]:
    return frozenset(n.name for n in graph.input_nodes()
                     if n.attrs.get("domain") == "user")


def _recsys_train(mod, batch: int, mesh=None, opts=frozenset()
                  ) -> CellProgram:
    """BCE over the concatenated task logits with Adam(1e-3), VanI
    executor. ``grad_bf16`` casts the gradients to bf16 before the update
    (the moments stay f32); ``emb_bf16`` keeps the embedding tables in
    bf16 (f32 moments). On a mesh: tables at or above
    ``TABLE_SHARD_THRESHOLD`` rows over 'model' (``table_md``: over
    ('model', 'data')), everything else replicated, examples over the DP
    axes."""
    graph, _spec = mod.BUILD()
    ex_for = _executors(graph, "vani")
    outputs = list(graph.outputs)
    opt = adam(1e-3)
    grad_dtype = torch.bfloat16 if "grad_bf16" in opts else None
    emb_nodes = ({n.name for n in graph.param_nodes() if n.op == "embedding"}
                 if "emb_bf16" in opts else set())

    def cast_tables(params):
        return {k: ({kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
                    if k in emb_nodes else v) for k, v in params.items()}

    def init(seed: int = 0, device: str | torch.device = "cuda"):
        params = cast_tables(init_graph_params(graph, seed=seed,
                                               device=device))
        return {"params": params, "opt": opt.init(params)}

    params = cast_tables(init_graph_params(graph, device="meta"))
    state = {"params": params, "opt": opt.init(params)}
    labels = torch.empty((batch, len(outputs)), dtype=torch.float32,
                         device="meta")
    args = (state, _meta_feeds(graph, batch, train=True), labels)
    if mesh is None:
        return _train_program(recsys_loss(ex_for, outputs), opt, args, init,
                              recsys_pack, grad_dtype)
    L = sh.Layouts(mesh)
    ex_mesh = _executors(graph, "vani",
                         lookup=_mesh_lookup(L, L.rows, frozenset(), False))

    def loss_fn(params, feeds):
        from torch.distributed.tensor import Partial
        labels = sh.local(feeds[LABELS_FEED], mesh, L.rows)
        local = {k: sh.local(v, mesh, L.rows) for k, v in feeds.items()
                 if k != LABELS_FEED}
        out = ex_mesh(labels.device).run(_row_params(params, L, True), local)
        part = bce_with_logits(_concat_outputs(out, outputs), labels)
        ndp = math.prod(mesh.size(i) for i in L.dp)
        loss = sh.wrap(part / ndp, mesh, L.with_(L.rep, dp=Partial()))
        return loss.redistribute(mesh, L.rep).to_local()

    table_axes = ("model", "data") if "table_md" in opts else ("model",)
    sp = recsys_state_pspecs(graph, table_axes=table_axes)
    state_ps = {"params": sp["params"], "opt": sp["opt"]}
    prog = _train_program(loss_fn, opt, args, init, recsys_pack, grad_dtype)
    return _on_mesh(prog, mesh,
                    (state_ps, recsys_feed_pspecs(graph, mesh, train=True),
                     P(dp_axes(mesh), None)),
                    (state_ps, {"loss": P()}))


class CompiledServe:
    """``serve(params, feeds) -> scores``: the executor behind one
    ``CompiledRun`` per feed signature. With ``use_pallas`` the
    ``mari_dense`` products run the ``mari_matmul`` kernel and a wide
    DIN unit the ``din_attention`` kernel on weights prepared once per
    params object (``prepare_mari_params``, ``prepare_din_params``)."""

    def __init__(self, graph, mode: str, *, device: torch.device,
                 use_pallas: bool):
        ex = Executor(graph, mode, use_pallas=use_pallas, device=device)
        outputs = list(graph.outputs)
        self.graph, self.use_pallas = graph, use_pallas
        self.run = CompiledRun(
            lambda params, feeds: {"scores": _concat_outputs(
                ex.run(params, feeds), outputs)}, device=device)
        self._prepared: dict[int, tuple[Any, dict]] = {}

    @property
    def compilations(self) -> int:
        return self.run.compilations

    def __call__(self, params: dict, feeds: dict) -> torch.Tensor:
        if self.use_pallas:
            from repro_torch.kernels.din_attention import prepare_din_params
            from repro_torch.kernels.mari_matmul import prepare_mari_params
            hit = self._prepared.get(id(params))
            if hit is None or hit[0] is not params:
                hit = (params, prepare_din_params(
                    self.graph, prepare_mari_params(self.graph, params)))
                self._prepared[id(params)] = hit
            params = hit[1]
        return self.run(params, feeds)["scores"]


class MeshServe:
    """``serve(params, feeds) -> scores`` on a mesh, eagerly: the executor
    on this rank's candidate rows with its local params — through the CUDA
    kernels with ``use_pallas``, the ``mari_matmul`` weights prepared once
    per params object — and a vocab-sharded table through the
    executor's ``lookup``; the scores as a DTensor on ``out``."""

    def __init__(self, graph, mode: str, mesh, out: tuple, *,
                 device: torch.device, use_pallas: bool):
        self.L = sh.Layouts(mesh)
        self.graph, self.out, self.use_pallas = graph, out, use_pallas
        self.ex = Executor(graph, mode, use_pallas=use_pallas, device=device,
                           lookup=_mesh_lookup(self.L, out,
                                               _user_ids(graph), use_pallas))
        self.outputs = list(graph.outputs)
        self._prepared: dict[int, tuple[Any, dict]] = {}

    def _params(self, params: dict) -> dict:
        hit = self._prepared.get(id(params))
        if hit is None or hit[0] is not params:
            local = _row_params(params, self.L, False)
            if self.use_pallas:
                from repro_torch.kernels.din_attention import (
                    prepare_din_params)
                from repro_torch.kernels.mari_matmul import (
                    prepare_mari_params)
                local = prepare_din_params(
                    self.graph, prepare_mari_params(self.graph, local))
            hit = self._prepared[id(params)] = (params, local)
        return hit[1]

    def __call__(self, params: dict, feeds: dict):
        mesh = self.L.mesh
        with torch.inference_mode():
            local = {k: sh.local(v, mesh, tuple(v.placements))
                     for k, v in feeds.items()}
            out = self.ex.run(self._params(params), local)
            scores = _concat_outputs(out, self.outputs)
        return sh.wrap(scores, mesh, self.out)


def _recsys_serve(mod, batch: int, use_mari: bool = True, mode: str = "uoi",
                  mesh=None, opts=frozenset()) -> CellProgram:
    """One request: user feeds at batch 1, ``batch`` candidates. MaRI
    rewrites the graph (``attn_reparam`` also re-parameterizes the target
    attention) and runs it in UOI; ``serve_uoi`` / ``serve_vani`` are the
    paper's baselines; ``serve_bf16`` puts params and float feeds in
    bf16. On a mesh the candidates lie over the DP axes (with
    ``serve_full_dp`` over 'model' too, B padded to a multiple of 512)
    and the params as ``recsys_param_pspecs`` says."""
    from repro_torch.core.mari import mari_rewrite
    graph, _spec = mod.BUILD()
    meta = {}
    if "serve_uoi" in opts:
        use_mari, mode = False, "uoi"
    if "serve_vani" in opts:
        use_mari, mode = False, "vani"
    if use_mari:
        conv = mari_rewrite(graph, reparam_attention="attn_reparam" in opts)
        graph = conv.graph
        meta["mari_rewrites"] = [r.dense for r in conv.rewrites]
        meta["attn_rewrites"] = [a.node for a in conv.attn_rewrites]
        mode = "uoi"
    if mesh is not None:
        cand_axes = dp_axes(mesh)
        if "serve_full_dp" in opts:
            # serving has no TP need: fold 'model' into the candidate axes
            batch = ((batch + 511) // 512) * 512
            cand_axes = cand_axes + ("model",)
            meta["padded_batch"] = batch
    ex_for = _executors(graph, mode)
    outputs = list(graph.outputs)
    dtype = torch.bfloat16 if "serve_bf16" in opts else torch.float32

    def serve_step(params, feeds):
        dev = tree_leaves(params)[0].device
        with torch.inference_mode():
            return _concat_outputs(ex_for(dev).run(params, feeds), outputs)

    def init(seed: int = 0, device: str | torch.device = "cuda"):
        return init_graph_params(graph, seed=seed, dtype=dtype, device=device)

    args = (init_graph_params(graph, dtype=dtype, device="meta"),
            _meta_feeds(graph, batch, train=False, float_dtype=dtype))
    def make_compiled(dev, use_pallas):
        return CompiledServe(graph, mode, device=dev, use_pallas=(
            dev.type == "cuda" if use_pallas is None else use_pallas))

    prog = CellProgram("", "", "serve", serve_step, args, meta=meta,
                       init=init, make_compiled=make_compiled)
    if mesh is None:
        return prog
    user = _user_ids(graph)
    feeds_ps = {}
    for n in graph.input_nodes():
        rank = 1 + len(n.attrs["shape"])
        lead = None if n.name in user else cand_axes
        feeds_ps[n.name] = P(lead, *([None] * (rank - 1)))
    out_ps = P(cand_axes, None)
    out_pl = sh.placements(mesh, out_ps)
    mesh_serve = MeshServe(graph, mode, mesh, out_pl,
                           device=torch.device(mesh.device_type),
                           use_pallas=False)
    prog.step_fn = mesh_serve
    prog.make_compiled = lambda dev, use_pallas: MeshServe(
        graph, mode, mesh, out_pl, device=dev, use_pallas=(
            dev.type == "cuda" if use_pallas is None else use_pallas))
    return _on_mesh(prog, mesh, (recsys_param_pspecs(graph), feeds_ps),
                    out_ps)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def _pad_up(n: int, m: int = 1024) -> int:
    return ((n + m - 1) // m) * m


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def gnn_loss(scfg: schnet_mod.SchNetConfig, shape_spec: dict,
             edge_comm: tuple[Callable, Callable] | None = None
             ) -> Callable[[dict, dict], torch.Tensor]:
    """``loss_fn(params, batch)`` of a GNN cell: ``softmax_xent`` over
    every node (``full``) or the first ``batch_nodes`` rows, the seeds
    (``sampled``); MSE of ``schnet_graph_readout`` against ``energies``
    (``molecule``). ``edge_comm``: ``schnet_forward``'s, on a rank that
    holds a block of the edges."""
    mode = shape_spec["mode"]
    if mode == "molecule":
        ng = shape_spec["batch"]

        def loss_fn(params, batch):
            out = schnet_mod.schnet_forward(
                params, scfg, batch["atom_types"], batch["positions"],
                batch["senders"], batch["receivers"],
                edge_mask=batch["edge_mask"], edge_comm=edge_comm)
            en = schnet_mod.schnet_graph_readout(out, batch["graph_ids"], ng)
            return torch.mean(torch.square(en[:, 0] - batch["energies"]))
        return loss_fn

    def loss_fn(params, batch):
        out = schnet_mod.schnet_forward(
            params, scfg, batch["features"], batch["positions"],
            batch["senders"], batch["receivers"],
            edge_mask=batch["edge_mask"], edge_comm=edge_comm)
        labels = batch["labels"]
        if mode == "sampled":
            out = out[: shape_spec["batch_nodes"]]
            labels = labels[: shape_spec["batch_nodes"]]
        return softmax_xent(out, labels)
    return loss_fn


def _gnn_mesh_loss(scfg, shape_spec: dict, mesh) -> Callable:
    """``gnn_loss`` on a mesh: every rank holds every node and the params
    whole and its block of the edges (over the DP axes); the segment sums
    are summed over the edge blocks and the node-side values entering the
    per-edge work sum their gradients over them, so every rank computes
    the same loss and gradients."""
    dp = dp_axes(mesh)
    inner = gnn_loss(scfg, shape_spec, edge_comm=(
        lambda t: sh.enter(t, dp, mesh), lambda t: sh.psum(t, dp, mesh)))
    L = sh.Layouts(mesh)

    def loss_fn(params, batch):
        local_p = tree_map(lambda t: sh.local(t, mesh, L.rep, L.rep), params)
        local_b = {k: sh.local(v, mesh, tuple(v.placements))
                   for k, v in batch.items()}
        return inner(local_p, local_b)
    return loss_fn


def _gnn_train(cfg: schnet_mod.SchNetConfig, shape_spec: dict, mesh=None
               ) -> CellProgram:
    """SchNet with Adam(1e-3) over one batch of ``shape_spec``'s regime:
    the whole graph (``full``), a padded ``NeighborSampler`` subgraph of
    ``batch_nodes`` seeds (``sampled``) or ``batch`` molecules
    (``molecule``). Edge arrays are padded to a multiple of 1024 (the
    padding carries ``edge_mask`` False); the batch is a dict of the
    reference's ``batch_sds`` names."""
    mode = shape_spec["mode"]
    f32, i32 = torch.float32, torch.int32
    if mode in ("full", "sampled"):
        d_feat = shape_spec["d_feat"]
        scfg = dataclasses.replace(cfg, d_feat=d_feat,
                                   n_out=shape_spec["n_classes"])
        if mode == "full":
            n_nodes, n_edges = shape_spec["n_nodes"], shape_spec["n_edges"]
        else:
            bn, fan = shape_spec["batch_nodes"], shape_spec["fanout"]
            n, n_nodes, n_edges = bn, bn, 0
            for f in fan:
                n *= f
                n_nodes += n
                n_edges += n
        n_edges = _pad_up(n_edges)
        batch = {"features": _meta((n_nodes, d_feat), f32),
                 "positions": _meta((n_nodes, 3), f32),
                 "senders": _meta((n_edges,), i32),
                 "receivers": _meta((n_edges,), i32),
                 "edge_mask": _meta((n_edges,), torch.bool),
                 "labels": _meta((n_nodes,), i32)}
    else:  # molecule: batched energy regression
        scfg = dataclasses.replace(cfg, d_feat=0, n_out=1)
        ng = shape_spec["batch"]
        n_nodes = ng * shape_spec["n_nodes"]
        n_edges = _pad_up(ng * shape_spec["n_edges"])
        batch = {"atom_types": _meta((n_nodes,), i32),
                 "positions": _meta((n_nodes, 3), f32),
                 "senders": _meta((n_edges,), i32),
                 "receivers": _meta((n_edges,), i32),
                 "edge_mask": _meta((n_edges,), torch.bool),
                 "graph_ids": _meta((n_nodes,), i32),
                 "energies": _meta((ng,), f32)}
    opt = adam(1e-3)

    def init(seed: int = 0, device: str | torch.device = "cuda"):
        params = schnet_mod.init_schnet_params(
            scfg, seed=seed, device=resolve_device(device))
        return {"params": params, "opt": opt.init(params)}

    params = schnet_mod.schnet_param_specs(scfg)
    args = ({"params": params, "opt": opt.init(params)}, batch)
    if mesh is None:
        return _train_program(gnn_loss(scfg, shape_spec), opt, args, init)
    dp = dp_axes(mesh)
    edge = {"senders", "receivers", "edge_mask"}
    batch_ps = {k: (P(dp) if k in edge else P(*([None] * v.ndim)))
                for k, v in batch.items()}
    sp = gnn_state_pspecs(params)
    state_ps = {"params": sp["params"], "opt": sp["opt"]}
    prog = _train_program(_gnn_mesh_loss(scfg, shape_spec, mesh), opt, args,
                          init)
    return _on_mesh(prog, mesh, (state_ps, batch_ps),
                    (state_ps, {"loss": P()}))


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape: str, mesh=None, opts=(), **kw
               ) -> CellProgram:
    """The cell's program, for every shape of the LM, recsys and GNN
    families, on one device (``mesh=None``) or laid out on ``mesh``. opts:
    named §Perf options — 'moe_local', 'seq_par' (LM), 'table_md' (recsys
    train), 'serve_full_dp', 'attn_reparam', 'serve_uoi', 'serve_vani',
    'serve_bf16' (recsys serve), 'grad_bf16', 'emb_bf16' (recsys train);
    ``kw`` (``use_mari``, ``mode``) goes to a recsys serve program. As in
    the reference, an option that a family does not read is ignored."""
    opts = frozenset(opts)
    mod = cfgreg.get_config(arch)
    spec = mod.SHAPES[shape]
    if spec.get("skip"):
        raise ValueError(f"cell ({arch}, {shape}) is skipped: {spec['skip']}")
    fam = mod.FAMILY
    if fam == "lm":
        cfg = mod.CONFIG
        seq, batch = spec["seq"], spec["global_batch"]
        if spec["kind"] == "train":
            prog = _lm_train(cfg, seq, batch, mesh, opts)
        elif spec["kind"] == "prefill":
            prog = _lm_prefill(cfg, seq, batch, mesh, opts)
        else:
            prog = _lm_decode(cfg, seq, batch, mesh)
    elif fam == "recsys":
        if spec["kind"] == "train":
            prog = _recsys_train(mod, spec["batch"], mesh, opts=opts)
        else:
            prog = _recsys_serve(mod, spec["batch"], mesh=mesh, opts=opts,
                                 **kw)
    elif fam == "gnn":
        prog = _gnn_train(mod.CONFIG, spec, mesh)
    else:
        raise ValueError(fam)
    prog.arch, prog.shape = arch, shape
    prog.mesh = mesh
    return prog
