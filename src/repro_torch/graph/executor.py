"""Graph executor: interprets a ``repro_torch.graph`` IR eagerly on tensors
(port of ``repro.graph.executor``).

Batch semantics — the key to VanI / UOI / MaRI:

* Every feed carries a leading batch dim. Item/cross feeds arrive at B
  (candidate count); user feeds arrive at 1.
* ``vani`` mode tiles user feeds to B at entry — the whole graph runs at B.
* ``uoi`` mode keeps user feeds at 1. Batch-1-ness propagates through the
  user-only subgraph; the first op that mixes batch-1 with batch-B inputs
  broadcasts — that IS the deferred tile of Fig. 1(c).
* ``mari`` is not a mode here: the MaRI pass rewrites eligible ``dense``
  nodes into ``mari_dense`` nodes (``repro_torch.core.mari``) and the
  rewritten graph runs in ``uoi`` mode.
* **row-wise user values** — user-side feeds may also arrive at batch B,
  where row b carries user b's value (a cross-user coalesced serving batch).
  Every op dispatches on the leading dim.

With ``use_pallas`` (the plan field keeps the reference's name) the
``mari_dense`` products, the gather-aware attention contractions, a whole
DIN ``target_attention`` over batch-1 keys, the ``dot_interaction`` op and
the pooled (``pool="sum"`` / ``"mean"``) multi-hot ``embedding`` op go
through the hand-written CUDA kernels
(``repro_torch.kernels``); their wrappers take the plain PyTorch versions
for CPU tensors.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.common import (glorot, make_generator, normal_init,
                                resolve_device, take_clip)
from repro_torch.graph.ir import Graph, Node, infer_shapes
from repro_torch.kernels import din_attention as din_kernel
from repro_torch.kernels.dot_interaction import (dot_interaction,
                                                 dot_interaction_plain)
from repro_torch.kernels.embedding_bag import embedding_bag_fixed
from repro_torch.kernels.gather_einsum import gather_einsum, gather_einsum_plain
from repro_torch.kernels.mari_matmul import mari_matmul_fused_groups
from repro_torch.nn.attention import NEG_INF, cross_attention, target_attention
from repro_torch.nn.layers import ACTIVATIONS, dense_apply

Tensor = torch.Tensor

# Reserved feed key: per-candidate-row user index for kernel-side gather.
# When present, input nodes listed in ``Executor.lazy_gather_inputs``
# receive their STACKED (U, ...) rep table as the fed value and the gather
# moves into the consuming kernel. Out-of-range indices (padded batch rows)
# clamp everywhere.
USER_INDEX_FEED = "__user_index__"

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int32": torch.int32,
           "int64": torch.int64}


def init_graph_params(graph: Graph, seed: int = 0, dtype=torch.float32,
                      device: str | torch.device = "cuda") -> dict:
    """Initialize params for every parameterized node, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``."""
    gen = make_generator(seed, resolve_device(device))
    shapes = infer_shapes(graph)
    params: dict = {}
    for n in graph.topo_order():
        if n.op == "dense":
            din = shapes[n.inputs[0]][-1]
            p = {"w": glorot(gen, (din, n.attrs["units"]), dtype)}
            if n.attrs.get("use_bias", True):
                p["b"] = torch.zeros((n.attrs["units"],), dtype=dtype,
                                     device=gen.device)
            params[n.name] = p
        elif n.op == "embedding":
            scale = 1.0 / max(n.attrs["vocab"], 1) ** 0.5
            params[n.name] = {
                "table": normal_init(gen, (n.attrs["vocab"], n.attrs["dim"]),
                                     scale, dtype)}
        elif n.op == "target_attention":
            d = shapes[n.inputs[0]][-1]
            dims = (4 * d,) + tuple(n.attrs["mlp_hidden"]) + (1,)
            p = {}
            for li, (di, do) in enumerate(zip(dims[:-1], dims[1:])):
                p[f"layer_{li}"] = {
                    "w": glorot(gen, (di, do), dtype),
                    "b": torch.zeros((do,), dtype=dtype, device=gen.device)}
            if n.attrs.get("decomposed"):
                h1 = n.attrs["mlp_hidden"][0]
                p["layer_0"] = {
                    "w_kd": glorot(gen, (d, h1), dtype),
                    "w_qd": glorot(gen, (d, h1), dtype),
                    "w_p": glorot(gen, (d, h1), dtype),
                    "b": torch.zeros((h1,), dtype=dtype, device=gen.device)}
            params[n.name] = p
        elif n.op == "mari_dense":
            units = n.attrs["units"]
            p = {}
            for label, seg_idx in n.attrs["groups"]:
                d = sum(n.attrs["seg_widths"][i] for i in seg_idx)
                p[f"w_{label}"] = glorot(gen, (d, units), dtype)
            if n.attrs.get("use_bias", True):
                p["b"] = torch.zeros((units,), dtype=dtype, device=gen.device)
            params[n.name] = p
    return params


def _bcast_batch(xs: list[Tensor]) -> list[Tensor]:
    """Broadcast leading batch dims (1 -> B) across a list of tensors."""
    b = max(x.shape[0] for x in xs)
    return [x if x.shape[0] == b else x.expand((b,) + tuple(x.shape[1:]))
            for x in xs]


def _concat_xs(xs: list[Tensor]) -> Tensor:
    xs = _bcast_batch(xs) if len({x.shape[0] for x in xs}) > 1 else xs
    return torch.cat(xs, dim=-1) if len(xs) > 1 else xs[0]


def _concat_ws(ws: list[Tensor]) -> Tensor:
    return torch.cat(ws, dim=0) if len(ws) > 1 else ws[0]


def _mari_dense_operands(node: Node, params: dict, vals: dict):
    """Assemble (x, w) pairs + accumulator init + bias for a ``mari_dense``.

    Returns (parts, acc0, bias): ``parts`` is a list of (x, w) whose products
    sum to the pre-activation output (minus acc0/bias); ``acc0`` is a
    precomputed user partial — a (1, units) row, or a row-wise (B, units)
    block when stage 2 serves a cross-user coalesced batch — or None.
    The batched (non-user) groups are fused into ONE (x, w) stream via the
    block-matmul identity Σ_g x_g W_g == concat(x_g) @ stack(W_g); a
    pre-concatenated ``w_cat`` in the node's params skips the weight concat.
    """
    attrs = node.attrs
    p = params[node.name]
    cast = _DTYPES[attrs["cast_dtype"]] if attrs.get("cast_dtype") else None

    def seg(name: str) -> Tensor:
        x = vals[name]
        return x.to(cast) if cast is not None else x

    parts: list[tuple[Tensor, Tensor]] = []
    acc0 = vals[node.inputs[0]] if attrs.get("precomputed_user") else None
    if attrs.get("fragment", False):
        if acc0 is not None:
            x = _concat_xs([seg(nm) for nm in node.inputs[1:]])
            w = p.get("w_cat")
            if w is None:
                w = _concat_ws([p[f"w_seg{i}"]
                                for i in attrs["seg_param_idx"]])
            parts.append((x, w))
        else:
            for i, name in enumerate(node.inputs):
                parts.append((seg(name), p[f"w_seg{i}"]))
    else:
        rest_xs: list[Tensor] = []
        rest_ws: list[Tensor] = []
        for label, seg_idx in attrs["groups"]:
            if label == "user":
                parts.append((_concat_xs([seg(node.inputs[i])
                                          for i in seg_idx]), p["w_user"]))
            else:
                rest_xs.extend(seg(node.inputs[i]) for i in seg_idx)
                rest_ws.append(p[f"w_{label}"])
        if rest_xs:
            w = p.get("w_cat")
            if w is None:
                w = _concat_ws(rest_ws)
            parts.append((_concat_xs(rest_xs), w))
    bias = p["b"] if attrs.get("use_bias", True) else None
    return parts, acc0, bias


def _run_mari_dense(node: Node, params: dict, vals: dict, *,
                    use_pallas: bool = False,
                    user_index: Tensor | None = None) -> Tensor:
    """Eq. 7: Tile(Σ_user x_u W_u, B) + Σ_rest x W — tile realized as a
    broadcast add. With ``use_pallas`` the batched side goes to the fused
    ``mari_matmul`` kernel (user row as accumulator init, bias and
    activation in the epilogue); with ``user_index`` the precomputed partial
    arrives as a stacked (U, units) table gathered at accumulator-init load.
    """
    attrs = node.attrs
    parts, acc0, bias = _mari_dense_operands(node, params, vals)
    activation = attrs.get("activation", "identity")
    if use_pallas:
        return mari_matmul_fused_groups(parts, bias, acc0=acc0,
                                        user_index=user_index,
                                        activation=activation)
    if user_index is not None and acc0 is not None:
        acc0 = take_clip(acc0, user_index)
    acc = acc0
    for x, w in parts:
        y = x @ w
        acc = y if acc is None else acc + y  # (1,u) + (B,u) broadcasts
    if bias is not None:
        acc = acc + bias
    return ACTIVATIONS[activation](acc)


class Executor:
    """Interpret a graph eagerly. Feeds are moved to ``device``."""

    def __init__(self, graph: Graph, mode: str = "uoi", *,
                 use_pallas: bool = False, kernel_gather: bool = False,
                 gather_attention: bool = False,
                 device: str | torch.device = "cuda"):
        if mode not in ("vani", "uoi"):
            raise ValueError(f"mode must be 'vani' or 'uoi', got {mode!r}")
        self.graph = graph
        self.mode = mode
        self.device = resolve_device(device)
        self.use_pallas = use_pallas
        self.gather_attention = gather_attention
        self._user_inputs = {
            n.name for n in graph.input_nodes() if n.attrs.get("domain") == "user"
        }
        # Gather-at-load: user-side inputs whose EVERY consumption is
        # gather-capable may be fed as stacked (U, ...) rep tables + a
        # USER_INDEX_FEED row index — a kernel mari_dense accumulator init
        # (kernel_gather) or a decomposed+precomputed target_attention
        # operand (gather_attention). Any other consumer needs the
        # materialized row-wise value.
        self.lazy_gather_inputs: frozenset[str] = frozenset()
        allow_md = kernel_gather and use_pallas
        if allow_md or gather_attention:
            lazy = set()
            for n in graph.input_nodes():
                if n.attrs.get("domain") != "user":
                    continue
                cons = graph.consumers(n.name)
                if cons and all(
                        (allow_md and self._is_md_acc_init(c, n.name))
                        or (gather_attention
                            and self._is_attn_operand(c, n.name))
                        for c in cons):
                    lazy.add(n.name)
            self.lazy_gather_inputs = frozenset(lazy)

    @staticmethod
    def _is_md_acc_init(c: Node, name: str) -> bool:
        """``name`` feeds ``c`` only as a kernel-eligible mari_dense
        accumulator init (the mixed-precision path keeps plain torch)."""
        return (c.op == "mari_dense"
                and c.attrs.get("precomputed_user")
                and not c.attrs.get("cast_dtype")
                and c.inputs[0] == name
                and c.inputs.count(name) == 1)

    @staticmethod
    def _is_attn_operand(c: Node, name: str) -> bool:
        """``name`` feeds ``c`` only in gather-capable positions of a
        decomposed, precomputed target_attention: keys (1), u_part (-2),
        T (-1), and the mask (2) when present."""
        if not (c.op == "target_attention" and c.attrs.get("decomposed")
                and c.attrs.get("precomputed")):
            return False
        k = len(c.inputs)
        allowed = {1, k - 2, k - 1}
        if c.attrs.get("has_mask"):
            allowed.add(2)
        return all(i in allowed
                   for i, s in enumerate(c.inputs) if s == name)

    def run(self, params: dict, feeds: Mapping[str, Tensor]
            ) -> dict[str, Tensor]:
        feeds = {k: torch.as_tensor(v, device=self.device)
                 for k, v in feeds.items()}
        vals: dict[str, Tensor] = {}
        if USER_INDEX_FEED in feeds:
            vals[USER_INDEX_FEED] = feeds[USER_INDEX_FEED]
        batch = max((v.shape[0] for k, v in feeds.items()
                     if k not in self._user_inputs and k != USER_INDEX_FEED),
                    default=1)
        for n in self.graph.topo_order():
            vals[n.name] = self._eval(n, params, vals, feeds, batch)
        return {o: vals[o] for o in self.graph.outputs}

    def _gather_einsum(self, spec, x, table, uidx) -> Tensor:
        """Contract ``x`` against the stacked ``(U, ...)`` table, indexed
        per row by ``uidx`` — the CUDA kernel when enabled, the plain
        gather-then-einsum otherwise."""
        if self.use_pallas:
            return gather_einsum(spec, x, table, uidx)
        return gather_einsum_plain(spec, x, table, uidx)

    # ------------------------------------------------------------------
    def _eval(self, n: Node, params, vals, feeds, batch: int) -> Tensor:
        op = n.op
        if op == "input":
            x = feeds[n.name]
            if (self.mode == "vani" and n.name in self._user_inputs
                    and x.shape[0] == 1 and batch > 1):
                x = x.expand((batch,) + tuple(x.shape[1:]))
            return x
        ins = [vals[i] for i in n.inputs]
        if op == "dense":
            p = params[n.name]
            y = ins[0] @ p["w"]
            if n.attrs.get("use_bias", True):
                y = y + p["b"]
            return ACTIVATIONS[n.attrs.get("activation", "identity")](y)
        if op == "mari_dense":
            # the kernel path needs a clean f32 pipeline; mixed-precision
            # (cast_dtype) nodes keep plain torch
            use_pallas = self.use_pallas and not n.attrs.get("cast_dtype")
            uidx = (vals.get(USER_INDEX_FEED)
                    if n.inputs and n.inputs[0] in self.lazy_gather_inputs
                    else None)
            return _run_mari_dense(n, params, vals, use_pallas=use_pallas,
                                   user_index=uidx)
        if op == "mari_user_partial":
            # Stage-1 half of a split mari_dense: Σ_user x_u W_u (+ b), a
            # (1, units) row the batched stage consumes as accumulator init.
            p = params[n.attrs["param_of"]]
            cast = n.attrs.get("cast_dtype")
            if n.attrs.get("fragment"):
                acc = None
                for i, name in zip(n.attrs["seg_idx"], n.inputs):
                    x = vals[name]
                    if cast:
                        x = x.to(_DTYPES[cast])
                    y = x @ p[f"w_seg{i}"]
                    acc = y if acc is None else acc + y
            else:
                xs = [vals[i] for i in n.inputs]
                x = torch.cat(xs, dim=-1) if len(xs) > 1 else xs[0]
                if cast:
                    x = x.to(_DTYPES[cast])
                acc = x @ p["w_user"]
            if n.attrs.get("use_bias", True) and "b" in p:
                acc = acc + p["b"]
            return acc
        if op == "attn_user_part":
            # One-shot k @ w_kd (+ b) of a decomposed target_attention.
            l0 = params[n.attrs["param_of"]]["layer_0"]
            return (ins[0][0] @ l0["w_kd"] + l0["b"])[None]
        if op == "attn_user_T":
            # One-shot T[l,d,h] = k[l,d] * w_p[d,h].
            l0 = params[n.attrs["param_of"]]["layer_0"]
            return (ins[0][0][:, :, None] * l0["w_p"][None])[None]
        if op == "embedding":
            table = params[n.name]["table"]
            ids = ins[0]
            pool = n.attrs.get("pool")
            if self.use_pallas and pool in ("sum", "mean") and ids.ndim >= 2:
                # a pooled multi-hot lookup: one fixed-hotness bag per row
                # of the flattened (..., H) ids
                out = embedding_bag_fixed(
                    table, ids.reshape(-1, ids.shape[-1]), combiner=pool)
                return out.reshape(tuple(ids.shape[:-1]) + (table.shape[1],))
            rows = torch.index_select(table, 0, ids.reshape(-1)).reshape(
                tuple(ids.shape) + (table.shape[1],))
            if pool == "sum":
                rows = rows.sum(dim=-2)
            elif pool == "mean":
                rows = rows.mean(dim=-2)
            return rows
        if op == "concat":
            return torch.cat(_bcast_batch(ins), dim=n.attrs.get("axis", -1))
        if op == "add":
            return ins[0] + ins[1]
        if op == "mul":
            return ins[0] * ins[1]
        if op == "sub":
            return ins[0] - ins[1]
        if op == "scale":
            return ins[0] * n.attrs["factor"]
        if op == "target_attention":
            return self._target_attention(n, params, vals, ins)
        if op == "act":
            return ACTIVATIONS[n.attrs["fn"]](ins[0])
        if op == "softmax":
            return torch.softmax(ins[0], dim=n.attrs.get("axis", -1))
        if op == "reshape":
            return ins[0].reshape((ins[0].shape[0],) + tuple(n.attrs["shape"]))
        if op == "cast":
            return ins[0].to(_DTYPES[n.attrs["dtype"]])
        if op in ("identity", "stop_gradient"):
            return ins[0].detach() if op == "stop_gradient" else ins[0]
        if op == "reduce":
            fn = {"sum": torch.sum, "mean": torch.mean,
                  "max": torch.amax}[n.attrs["fn"]]
            return fn(ins[0], dim=n.attrs["axis"])
        if op == "weighted_sum":
            w, v = ins
            if w.shape[0] != v.shape[0]:
                w, v = _bcast_batch([w, v])
            return torch.einsum("...k,...kd->...d", w, v)
        if op == "cross_attention":
            q, k, v = ins[0], ins[1], ins[2]
            mask = ins[3] if n.attrs.get("has_mask") else None
            squeeze = q.ndim == 2
            if squeeze:
                q = q[:, None, :]
            out = cross_attention(q, k, v, mask)
            return out[:, 0, :] if squeeze else out
        if op == "fm_interaction":
            x = ins[0]
            s = x.sum(dim=-2)
            sq = (x * x).sum(dim=-2)
            return (0.5 * (s * s - sq).sum(dim=-1))[..., None]
        if op == "dot_interaction":
            keep_self = bool(n.attrs.get("keep_self"))
            if self.use_pallas:
                return dot_interaction(ins[0], keep_self)
            return dot_interaction_plain(ins[0], keep_self)
        if op == "gather_last":
            idx = torch.as_tensor(n.attrs["indices"], dtype=torch.int64,
                                  device=ins[0].device)
            return torch.index_select(ins[0], -1, idx)
        if op == "stack_features":
            return torch.stack(_bcast_batch(ins), dim=-2)
        raise ValueError(f"executor: unknown op {op!r} ({n.name})")

    def _target_attention(self, n: Node, params, vals, ins) -> Tensor:
        p = params[n.name]
        nlayers = len(p)
        q, keys = ins[0], ins[1]
        if n.attrs.get("has_mask"):
            mask = ins[2]
        else:
            mask = torch.ones(keys.shape[:-1], dtype=torch.bool,
                              device=keys.device)

        if not (n.attrs.get("decomposed") and "w_kd" in p["layer_0"]):
            # one (L, D) key block for the whole batch (the single-call UOI
            # / MaRI executor; VanI tiles it and serving gathers it per
            # row) through a three-layer unit: the fused kernel, if it fits
            if (self.use_pallas and keys.shape[0] == 1 and mask.shape[0] == 1
                    and nlayers == 3
                    and all("b" in p[f"layer_{li}"] for li in range(3))):
                args = (q, keys[0], mask[0],
                        *(p[f"layer_{li}"][k] for li in range(3)
                          for k in ("w", "b")))
                if din_kernel.fits(*args):
                    return din_kernel.din_attention(*args)

            def mlp_apply(x):
                for li in range(nlayers):
                    x = dense_apply(p[f"layer_{li}"], x)
                    if li < nlayers - 1:
                        x = torch.relu(x)
                return x

            return target_attention(q, keys, mask, mlp_apply)

        # Re-parameterized unit (core.mari.AttnRewrite). The user-side
        # tensors carry batch 1, batch B (row-wise), or — gather-aware
        # serving — arrive as stacked (U, ...) rep tables alongside a
        # USER_INDEX_FEED, in which case the per-row gather folds into the
        # contractions (kernels.gather_einsum).
        l0 = p["layer_0"]
        uidx = vals.get(USER_INDEX_FEED)

        def stacked(name: str) -> bool:
            return uidx is not None and name in self.lazy_gather_inputs

        t_stacked = u_stacked = k_stacked = False
        if n.attrs.get("precomputed"):
            # two-stage serving: bias is folded into u_part in stage 1
            u_part = ins[-2]                    # (1|B|U, L, h)
            t = ins[-1]                         # (1|B|U, L, D, h)
            u_stacked = stacked(n.inputs[-2])
            t_stacked = stacked(n.inputs[-1])
            k_stacked = stacked(n.inputs[1])
        elif keys.shape[0] == 1:
            u_part = (keys[0] @ l0["w_kd"] + l0["b"])[None]
            t = (keys[0][:, :, None] * l0["w_p"][None])[None]
        else:                                   # row-wise keys
            u_part = keys @ l0["w_kd"] + l0["b"]
            t = keys[..., None] * l0["w_p"][None, None]
        if n.attrs.get("has_mask") and stacked(n.inputs[2]):
            mask = take_clip(mask, uidx)
        elif not n.attrs.get("has_mask") and k_stacked:
            # the default all-ones mask took its shape from the STACKED
            # keys (U, L): re-shape to broadcast (1, L)
            mask = torch.ones((1,) + tuple(keys.shape[1:-1]),
                              dtype=torch.bool, device=keys.device)
        q_part = q @ l0["w_qd"]                 # (B, h)
        if t_stacked:
            p_part = self._gather_einsum("bd,uldh->blh", q, t, uidx)
        elif t.shape[0] == 1 and q.shape[0] != 1:
            p_part = torch.einsum("bd,ldh->blh", q, t[0])
        else:
            p_part = torch.einsum("bd,bldh->blh", q, t)
        if u_stacked:
            # (B, L, h) exists anyway as the relu output below, so an
            # explicit (clamped) gather costs nothing extra
            u_part = take_clip(u_part, uidx)
        h = torch.relu(u_part + q_part[:, None, :] + p_part)
        for li in range(1, nlayers):
            h = dense_apply(p[f"layer_{li}"], h)
            if li < nlayers - 1:
                h = torch.relu(h)
        scores = h[..., 0]                      # (B, L)
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        w = torch.softmax(scores, dim=-1)
        if k_stacked:
            return self._gather_einsum("bl,uld->bd", w, keys, uidx)
        if keys.shape[0] == 1 and w.shape[0] != 1:
            return torch.einsum("bl,ld->bd", w, keys[0])
        return torch.einsum("bl,bld->bd", w, keys)
