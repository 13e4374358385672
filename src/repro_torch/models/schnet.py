"""SchNet [arXiv:1706.08566] (port of ``repro.models.schnet``) —
continuous-filter convolution GNN.

Message passing as the reference writes it: edge-index gathers and a
segment sum over receivers (the SpMM layer of the system). The
interaction blocks' params are stacked ``(T, ...)`` and walked in a loop
(the reference scans them). Node features enter through a linear
projection instead of the atom-type embedding when ``d_feat > 0``.

The reference's index semantics, kept exactly (``tests/test_torch_schnet.py``):

* ``x[idx]`` in JAX wraps a negative index once (``-1`` is the last row)
  and then clamps: ``take_rows``.
* ``jnp.take`` (the atom-type table) wraps once and then fills rows that
  are still out of range with NaN: ``take_fill``.
* ``jax.ops.segment_sum`` drops every id outside ``[0, num_segments)``,
  negative ones included: ``segment_sum``.

Determinism on the card: ``index_select``'s backward and ``index_add_``
sum fp32 with atomics in any order, so two runs of one training step would
differ in the last bits. The gathers use advanced indexing, whose backward
on CUDA is ``index_put_(accumulate=True)``, and the segment sum is that same
op: CUDA sorts the indices (stably) and reduces each run of equal indices
in order, so a step repeats bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.common import glorot, make_generator, normal_init

Tensor = torch.Tensor
LOG2 = 0.6931471805599453


def ssp(x: Tensor) -> Tensor:
    """Shifted softplus, SchNet's activation: ``log(1 + e^x) - log 2`` as
    ``jax.nn.softplus`` computes it (``logaddexp(x, 0)``, no threshold;
    ``F.softplus`` returns ``x`` itself above 20)."""
    return torch.logaddexp(x, x.new_zeros(())) - LOG2


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    d_feat: int = 0          # 0 => atom-type embedding input
    n_atom_types: int = 100
    n_out: int = 1           # classes (node tasks) or 1 (energy)

    def scaled_down(self, **over) -> "SchNetConfig":
        small = dict(n_interactions=2, d_hidden=16, n_rbf=8)
        small.update(over)
        return dataclasses.replace(self, **small)


def _param_tree(cfg: SchNetConfig, w: Callable, zeros: Callable,
                table: Callable) -> dict:
    """The reference's params tree from three leaf factories, called in
    the reference's draw order."""
    H, R, T = cfg.d_hidden, cfg.n_rbf, cfg.n_interactions
    if cfg.d_feat > 0:
        inp = {"w": w((cfg.d_feat, H)), "b": zeros((H,))}
    else:
        inp = {"table": table((cfg.n_atom_types, H))}

    def stacked(shape):
        return torch.stack([w(shape) for _ in range(T)])

    inter = {
        "filt_w1": stacked((R, H)), "filt_b1": zeros((T, H)),
        "filt_w2": stacked((H, H)), "filt_b2": zeros((T, H)),
        "in2f": stacked((H, H)),
        "f2out_w1": stacked((H, H)), "f2out_b1": zeros((T, H)),
        "f2out_w2": stacked((H, H)), "f2out_b2": zeros((T, H)),
    }
    readout = {"w1": w((H, H)), "b1": zeros((H,)),
               "w2": w((H, cfg.n_out)), "b2": zeros((cfg.n_out,))}
    return {"input": inp, "interactions": inter, "readout": readout}


def init_schnet_params(cfg: SchNetConfig, seed: int = 0,
                       dtype=torch.float32,
                       device: str | torch.device = "cuda") -> dict:
    """Glorot weights, zero biases and a normal(0.1) atom-type table,
    drawn in ``dtype`` on ``device`` from a ``torch.Generator`` seeded
    with ``seed``."""
    dev = torch.device(device)
    gen = make_generator(seed, dev)
    return _param_tree(
        cfg, lambda s: glorot(gen, s, dtype),
        lambda s: torch.zeros(s, dtype=dtype, device=dev),
        lambda s: normal_init(gen, s, 0.1, dtype))


def schnet_param_specs(cfg: SchNetConfig, dtype=torch.float32) -> dict:
    """The params tree on the ``meta`` device (no allocation): the port of
    ``jax.eval_shape`` over ``init_schnet_params``."""
    def meta(shape):
        return torch.empty(shape, dtype=dtype, device="meta")
    return _param_tree(cfg, meta, meta, meta)


def _wrap(idx: Tensor, n: int) -> Tensor:
    """A negative index wrapped once, as JAX and numpy index."""
    return torch.where(idx < 0, idx + n, idx)


def take_rows(x: Tensor, idx: Tensor) -> Tensor:
    """``x[idx]`` as JAX gathers it: a negative index wraps once, then
    every index is clamped to ``[0, len(x) - 1]``. Advanced indexing, so
    the backward on CUDA is the deterministic ``index_put_``."""
    n = x.shape[0]
    return x[_wrap(idx.long(), n).clamp(0, n - 1)]


def take_fill(x: Tensor, idx: Tensor) -> Tensor:
    """``jnp.take(x, idx, axis=0)`` in its default mode: a negative index
    wraps once; a row still out of range is NaN (no gradient flows to the
    table from it)."""
    n = x.shape[0]
    i = _wrap(idx.long(), n)
    valid = (i >= 0) & (i < n)
    rows = x[i.clamp(0, n - 1)]
    return torch.where(valid[:, None], rows, rows.new_full((), math.nan))


def segment_sum(data: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """``jax.ops.segment_sum``: rows of ``data`` summed per id, ids outside
    ``[0, num_segments)`` dropped. They go to one extra sink row, cut off
    at the end; the sum is ``index_put_(accumulate=True)``, which CUDA
    reduces in a fixed order (module docstring)."""
    ids = ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    return out.index_put_((ids,), data, accumulate=True)[:num_segments]


def rbf_expand(d: Tensor, n_rbf: int, cutoff: float) -> Tensor:
    """Gaussian radial basis over [0, cutoff]. d: (E,) -> (E, n_rbf)."""
    mu = torch.linspace(0.0, cutoff, n_rbf, dtype=d.dtype, device=d.device)
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * torch.square(d[:, None] - mu[None, :]))


# the interaction params used per edge (the rest act on nodes)
EDGE_PARAMS = frozenset({"filt_w1", "filt_b1", "filt_w2", "filt_b2", "in2f"})


def _interaction_slices(params: dict) -> list[dict]:
    """Every interaction's params: one ``torch.unbind`` per stacked leaf
    (its backward writes each leaf's gradient as one stack)."""
    inter = params["interactions"]
    per_leaf = {k: torch.unbind(v) for k, v in inter.items()}
    depth = inter["in2f"].shape[0]
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(depth)]


def schnet_forward(
    params: dict,
    cfg: SchNetConfig,
    node_input: Tensor,        # (N, d_feat) float or (N,) int atom types
    positions: Tensor,         # (N, 3)
    senders: Tensor,           # (E,)
    receivers: Tensor,         # (E,)
    edge_mask: Tensor | None = None,   # (E,) bool — padded sampled subgraphs
    edge_comm: tuple[Callable, Callable] | None = None,
) -> Tensor:
    """Returns per-node outputs (N, n_out).

    ``edge_comm = (enter, reduce)``: this rank holds a block of the edges
    and every node. ``enter`` marks a node-side value (node features, the
    edge filter's weights) entering the per-edge work — identity, its
    gradient summed over the edge blocks —, ``reduce`` sums the segment
    sums over them (``dist.sharding.enter`` / ``psum``)."""
    enter, reduce = edge_comm or (None, None)
    n_nodes = positions.shape[0]
    if cfg.d_feat > 0:
        h = node_input @ params["input"]["w"] + params["input"]["b"]
    else:
        h = take_fill(params["input"]["table"], node_input)

    diff = take_rows(positions, senders) - take_rows(positions, receivers)
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)       # (E,)
    rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff)                    # (E, R)
    # smooth cutoff envelope
    env = 0.5 * (torch.cos(math.pi * torch.clip(dist / cfg.cutoff, 0, 1))
                 + 1.0)
    if edge_mask is not None:
        env = env * edge_mask.to(env.dtype)

    for ip in _interaction_slices(params):
        h_e = h
        if enter is not None:
            ip = {k: enter(v) if k in EDGE_PARAMS else v
                  for k, v in ip.items()}
            h_e = enter(h)
        filt = ssp(rbf @ ip["filt_w1"] + ip["filt_b1"])
        filt = (filt @ ip["filt_w2"] + ip["filt_b2"]) * env[:, None]  # (E, H)
        src = take_rows(h_e, senders) @ ip["in2f"]                   # (E, H)
        msg = src * filt
        agg = segment_sum(msg, receivers, n_nodes)
        if reduce is not None:
            agg = reduce(agg)
        upd = ssp(agg @ ip["f2out_w1"] + ip["f2out_b1"])
        upd = upd @ ip["f2out_w2"] + ip["f2out_b2"]
        h = h + upd
    r = params["readout"]
    return ssp(h @ r["w1"] + r["b1"]) @ r["w2"] + r["b2"]


def schnet_graph_readout(node_out: Tensor, graph_ids: Tensor,
                         n_graphs: int) -> Tensor:
    """Molecule-level energy: sum node outputs per graph."""
    return segment_sum(node_out, graph_ids, n_graphs)
