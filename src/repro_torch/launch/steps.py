"""Per-cell programs (port of ``repro.launch.steps``): for an
(architecture × input shape) cell of the LM, recsys or GNN family, the
step function and its inputs as ``meta``-device tensors at the shape's
sizes (the reference's ``ShapeDtypeStruct``s).

The port runs on one device with no mesh: ``in_shardings``,
``out_shardings`` and ``mesh`` stay ``None`` and ``policy_kv`` empty
until the sharding rule sets are ported. ``CellProgram.compiled()`` is
the port of ``jitted()``; ``CellProgram.init(seed, device)`` makes the
step's first argument (the train state, or the params) at full size::

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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import configs as cfgreg
from repro_torch.common import (resolve_device, tree_leaves, tree_map,
                                value_and_grad)
from repro_torch.data.features import feed_specs
from repro_torch.data.lm import token_batch_specs
from repro_torch.dist import policy
from repro_torch.graph.compiled import CompiledRun, CompiledStep
from repro_torch.graph.executor import Executor, init_graph_params
from repro_torch.models import schnet as schnet_mod
from repro_torch.models.transformer import (LMConfig, init_lm_params,
                                            kv_cache_specs, lm_decode_step,
                                            lm_forward, lm_loss,
                                            lm_param_specs)
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
        ``torch.inference_mode``."""
        return self.make_compiled(resolve_device(device), use_pallas)


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


def _lm_train(cfg: LMConfig, seq: int, batch: int) -> CellProgram:
    """``lm_loss`` plus AdamW(3e-4) with f32 master weights; params in
    ``cfg.dtype``."""
    opt = adamw(3e-4, master_weights=True)

    def init(seed: int = 0, device: str | torch.device = "cuda"):
        params = init_lm_params(cfg, seed=seed, device=resolve_device(device))
        return {"params": params, "opt": opt.init(params)}

    params = lm_param_specs(cfg)        # opt.init allocates nothing on meta
    state = {"params": params, "opt": opt.init(params)}
    return _train_program(lm_train_loss(cfg), opt,
                          (state, token_batch_specs(batch, seq)), init)


def _lm_prefill(cfg: LMConfig, seq: int, batch: int) -> CellProgram:
    def prefill_step(params, tokens):
        x, kv = lm_forward(params, cfg, tokens, return_kv=True)
        logits = x[:, -1, :] @ params["lm_head"].to(x.dtype)
        return logits, kv

    def make_compiled(dev, _):
        def run(*args):
            with torch.inference_mode():
                return prefill_step(*args)
        return run

    tok = torch.empty((batch, seq), dtype=torch.int32, device="meta")
    return CellProgram("", "", "prefill", prefill_step,
                       (lm_param_specs(cfg), tok),
                       make_compiled=make_compiled,
                       init=lambda seed=0, device="cuda": init_lm_params(
                           cfg, seed=seed, device=resolve_device(device)))


def _lm_decode(cfg: LMConfig, seq: int, batch: int) -> CellProgram:
    def decode(params, cache, tokens, pos):
        return lm_decode_step(params, cfg, cache, tokens, pos)

    tok = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return CellProgram("", "", "decode", decode,
                       (lm_param_specs(cfg), kv_cache_specs(cfg, batch, seq),
                        tok, pos), donate_argnums=(1,),
                       make_compiled=lambda dev, _: CompiledDecode(
                           decode, device=dev),
                       init=lambda seed=0, device="cuda": init_lm_params(
                           cfg, seed=seed, device=resolve_device(device)))


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


def _recsys_train(mod, batch: int, opts=frozenset()) -> CellProgram:
    """BCE over the concatenated task logits with Adam(1e-3), VanI
    executor. ``grad_bf16`` casts the gradients to bf16 before the update
    (the moments stay f32); ``emb_bf16`` keeps the embedding tables in
    bf16 (f32 moments)."""
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
    return _train_program(recsys_loss(ex_for, outputs), opt,
                          (state, _meta_feeds(graph, batch, train=True),
                           labels), init, recsys_pack, grad_dtype)


class CompiledServe:
    """``serve(params, feeds) -> scores``: the executor behind one
    ``CompiledRun`` per feed signature. With ``use_pallas`` the
    ``mari_dense`` products run the ``mari_matmul`` kernel on weights
    prepared once per params object (``prepare_mari_params``)."""

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
            from repro_torch.kernels.mari_matmul import prepare_mari_params
            hit = self._prepared.get(id(params))
            if hit is None or hit[0] is not params:
                hit = (params, prepare_mari_params(self.graph, params))
                self._prepared[id(params)] = hit
            params = hit[1]
        return self.run(params, feeds)["scores"]


def _recsys_serve(mod, batch: int, use_mari: bool = True, mode: str = "uoi",
                  opts=frozenset()) -> CellProgram:
    """One request: user feeds at batch 1, ``batch`` candidates. MaRI
    rewrites the graph (``attn_reparam`` also re-parameterizes the target
    attention) and runs it in UOI; ``serve_uoi`` / ``serve_vani`` are the
    paper's baselines; ``serve_bf16`` puts params and float feeds in
    bf16."""
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

    return CellProgram("", "", "serve", serve_step, args, meta=meta,
                       init=init, make_compiled=make_compiled)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def _pad_up(n: int, m: int = 1024) -> int:
    return ((n + m - 1) // m) * m


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def gnn_loss(scfg: schnet_mod.SchNetConfig, shape_spec: dict
             ) -> Callable[[dict, dict], torch.Tensor]:
    """``loss_fn(params, batch)`` of a GNN cell: ``softmax_xent`` over
    every node (``full``) or the first ``batch_nodes`` rows, the seeds
    (``sampled``); MSE of ``schnet_graph_readout`` against ``energies``
    (``molecule``)."""
    mode = shape_spec["mode"]
    if mode == "molecule":
        ng = shape_spec["batch"]

        def loss_fn(params, batch):
            out = schnet_mod.schnet_forward(
                params, scfg, batch["atom_types"], batch["positions"],
                batch["senders"], batch["receivers"],
                edge_mask=batch["edge_mask"])
            en = schnet_mod.schnet_graph_readout(out, batch["graph_ids"], ng)
            return torch.mean(torch.square(en[:, 0] - batch["energies"]))
        return loss_fn

    def loss_fn(params, batch):
        out = schnet_mod.schnet_forward(
            params, scfg, batch["features"], batch["positions"],
            batch["senders"], batch["receivers"],
            edge_mask=batch["edge_mask"])
        labels = batch["labels"]
        if mode == "sampled":
            out = out[: shape_spec["batch_nodes"]]
            labels = labels[: shape_spec["batch_nodes"]]
        return softmax_xent(out, labels)
    return loss_fn


def _gnn_train(cfg: schnet_mod.SchNetConfig, shape_spec: dict
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
    return _train_program(gnn_loss(scfg, shape_spec), opt,
                          ({"params": params, "opt": opt.init(params)},
                           batch), init)


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

# options that place a cell on a mesh (the sharding rule sets' slice)
SHARDING_OPTS = frozenset({"moe_local", "seq_par", "table_md",
                           "serve_full_dp"})


def build_cell(arch: str, shape: str, mesh=None, opts=(), **kw
               ) -> CellProgram:
    """The cell's program, for every shape of the LM, recsys and GNN
    families. opts: named §Perf options — 'attn_reparam', 'serve_uoi',
    'serve_vani', 'serve_bf16', 'grad_bf16', 'emb_bf16'; ``kw``
    (``use_mari``, ``mode``) goes to a recsys serve program. A mesh and
    the sharding options ('moe_local', 'seq_par', 'table_md',
    'serve_full_dp') raise, naming the slice that brings them."""
    opts = frozenset(opts)
    mod = cfgreg.get_config(arch)
    spec = mod.SHAPES[shape]
    if spec.get("skip"):
        raise ValueError(f"cell ({arch}, {shape}) is skipped: {spec['skip']}")
    fam = mod.FAMILY
    sharded = sorted(opts & SHARDING_OPTS)
    if mesh is not None or sharded:
        raise NotImplementedError(
            f"build_cell({arch!r}, {shape!r}, mesh={mesh!r}, opts={sharded}): "
            f"{policy.SHARDING_SLICE}; the port runs one device")
    if fam == "lm":
        cfg = mod.CONFIG
        seq, batch = spec["seq"], spec["global_batch"]
        if spec["kind"] == "train":
            prog = _lm_train(cfg, seq, batch)
        elif spec["kind"] == "prefill":
            prog = _lm_prefill(cfg, seq, batch)
        else:
            prog = _lm_decode(cfg, seq, batch)
    elif fam == "recsys":
        if spec["kind"] == "train":
            prog = _recsys_train(mod, spec["batch"], opts=opts)
        else:
            prog = _recsys_serve(mod, spec["batch"], opts=opts, **kw)
    elif fam == "gnn":
        prog = _gnn_train(mod.CONFIG, spec)
    else:
        raise ValueError(fam)
    prog.arch, prog.shape = arch, shape
    return prog
