"""Optimizers as (init, update) pairs over trees of tensors (port of
``repro.train.optim``: ``sgd``, ``adam``, ``adamw``, ``adafactor``,
``WarmupCosine``, ``clip_by_global_norm``, ``apply_updates``).

States are plain trees, checkpointable as they are. The update formulas
are the reference's: Adam divides by ``sqrt(vhat) + eps`` with both
moments bias-corrected, and AdamW's weight decay is decoupled (added to
the step, scaled by ``lr``). ``update`` is functional: it returns new
tensors and never writes its arguments.

``adam`` / ``adamw`` / ``adafactor`` also carry ``update_(grads, state,
params)``, the in-place form (the port's counterpart of the reference's
donated train state, ``donate_argnums=(0,)``): it writes the new params
and optimizer state into the tensors that hold them and returns nothing,
so a captured training step keeps its addresses and the state never
exists twice. It uses the gradients' memory as scratch: an f32 gradient
leaf holds garbage afterwards. AdamW walks each leaf in slices of at most
``SLICE`` elements and keeps at most two f32 slices of temporaries, so a
1-billion-element expert stack updates in 128 MB pieces. Step counts,
bias corrections and schedules stay on the device: nothing reads back."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.common import PyTree, tree_leaves, tree_map, tree_unflatten


# elements of a leaf that one in-place AdamW pass updates at a time
SLICE = 1 << 25


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]
    # update(grads, opt_state, params) -> (updates, new_opt_state);
    # apply with: params = apply_updates(params, updates)
    update_: Callable[[PyTree, PyTree, PyTree], None] | None = None
    # update_(grads, opt_state, params): the same step, written in place


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> tuple[PyTree, torch.Tensor]:
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in leaves))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params):
        del params
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), ()
        new_m = tree_map(lambda m, g: momentum * m + g, state, grads)
        return tree_map(lambda m: -lr * m, new_m), new_m

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01, master_weights: bool = False
          ) -> Optimizer:
    """AdamW. With ``master_weights=True`` the state carries an f32 master
    copy of the params (params may live in bf16; updates go to the master
    and are re-cast)."""
    def init(params):
        z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        st = {"mu": z, "nu": tree_map(torch.zeros_like, z),
              "step": torch.zeros((), dtype=torch.int32, device=dev)}
        if master_weights:
            # a copy even of an f32 leaf: update_ writes the master in place
            st["master"] = tree_map(
                lambda p: p.to(torch.float32, copy=True), params)
        return st

    def update(grads, state, params):
        step = state["step"] + 1
        stepf = step.float()
        # bias corrections in f32 on the device, as the reference's
        b1t = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                           device=step.device), stepf)
        b2t = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                           device=step.device), stepf)
        master = (state["master"] if master_weights
                  else tree_map(lambda p: p.float(), params))

        def upd(g, m, v, p, w):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mhat = m / b1t
            vhat = v / b2t
            delta = -lr * (mhat / (torch.sqrt(vhat) + eps)
                           + weight_decay * w)
            if master_weights:
                w_new = w + delta
                return (w_new.to(p.dtype) - p, m, v, w_new)
            return (delta.to(p.dtype), m, v, None)

        out = [upd(*a) for a in zip(tree_leaves(grads),
                                    tree_leaves(state["mu"]),
                                    tree_leaves(state["nu"]),
                                    tree_leaves(params),
                                    tree_leaves(master))]
        pick = lambda i: tree_unflatten(grads, [o[i] for o in out])
        new_state = {"mu": pick(1), "nu": pick(2), "step": step}
        if master_weights:
            new_state["master"] = pick(3)
        return pick(0), new_state

    @torch.no_grad()
    def update_(grads, state, params):
        step = _local(state["step"])
        step.add_(1)
        stepf = step.float()
        b1t = 1.0 - torch.pow(b1, stepf)
        b2t = 1.0 - torch.pow(b2, stepf)
        flat_p = tree_leaves(params)
        flat_w = (tree_leaves(state["master"]) if master_weights
                  else [None] * len(flat_p))
        for g, m, v, p, w in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                                 tree_leaves(state["nu"]), flat_p, flat_w):
            g, m, v, p, w, write_back = _state_layout(g, m, v, p, w)
            g = g.reshape(-1)
            m, v, p = m.view(-1), v.view(-1), p.view(-1)
            w = None if w is None else w.view(-1)
            for i in range(0, p.numel(), SLICE):
                sl = slice(i, i + SLICE)
                _adamw_slice(g[sl], m[sl], v[sl], p[sl],
                             None if w is None else w[sl], b1t, b2t)
            if write_back is not None:
                write_back()

    def _adamw_slice(g, m, v, p, w, b1t, b2t):
        # the functional form's arithmetic, operation for operation; the
        # f32 gradient's memory then holds the denominator
        g = g.float()
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        den = torch.div(v, b2t, out=g).sqrt_().add_(eps)
        delta = torch.div(m, b1t).div_(den)
        del g, den
        if weight_decay:
            wf = p.float() if w is None else w
            delta.add_(wf, alpha=weight_decay)
            del wf
        delta.mul_(-lr)
        if w is None:
            p.add_(delta.to(p.dtype))
        else:
            w.add_(delta)
            del delta
            # p + (w.to(p.dtype) - p): apply_updates adds the update
            p.add_(w.to(p.dtype) - p)

    return Optimizer(init, update, update_)


def adafactor(lr: float, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment optimizer: O(n + m) state for an (n, m)
    matrix (rows and columns of the last two axes); a leaf with fewer than
    two axes keeps a full second moment. The update is RMS-clipped to
    ``clip_threshold``."""
    def init(params):
        def st(p):
            dev = p.device
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=dev),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32, device=dev)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=dev)}
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        return {"m": tree_map(st, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def _beta(step):
        return 1.0 - torch.pow(step.float(), -decay)

    def _direction(g, s, beta, p):
        """The clipped update direction and the new moments of one leaf."""
        g = g.float()
        g2 = torch.square(g) + eps
        if p.ndim >= 2:
            vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
            vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
            denom = vr.mean(dim=-1, keepdim=True)
            r = (vr / torch.clamp(denom, min=eps))[..., None]
            u = g * torch.rsqrt(torch.clamp(r * vc[..., None, :], min=eps))
            new_s = {"vr": vr, "vc": vc}
        else:
            v = beta * s["v"] + (1 - beta) * g2
            u = g * torch.rsqrt(torch.clamp(v, min=eps))
            new_s = {"v": v}
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        return u, new_s

    def update(grads, state, params):
        step = state["step"] + 1
        beta = _beta(step)
        out = [_direction(g, s, beta, p)
               for g, s, p in zip(tree_leaves(grads), _leaf_states(
                   grads, state["m"]), tree_leaves(params))]
        return (tree_unflatten(grads, [(-lr * u).to(p.dtype) for (u, _), p
                                       in zip(out, tree_leaves(params))]),
                {"m": tree_unflatten(grads, [s for _, s in out]),
                 "step": step})

    @torch.no_grad()
    def update_(grads, state, params):
        step = state["step"]
        step.add_(1)
        beta = _beta(step)
        for g, s, p in zip(tree_leaves(grads), _leaf_states(grads,
                                                             state["m"]),
                           tree_leaves(params)):
            u, new_s = _direction(g, s, beta, p)
            for k, t in new_s.items():
                s[k].copy_(t)
            p.add_((-lr * u).to(p.dtype))

    return Optimizer(init, update, update_)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (writes to it write the DTensor), or ``t``."""
    from repro_torch.dist.sharding import is_dtensor
    return t.to_local() if is_dtensor(t) else t


def _state_layout(g, m, v, p, w):
    """One leaf's update operands as local tensors in the optimizer state's
    layout (``m``'s placements), and what writes ``p`` back afterwards.

    Plain tensors pass through. On a mesh the gradient — often ``Partial``
    — is reduced into the state's layout; a param laid out otherwise (a
    ZeRO-1 state shards it further) is updated in a copy in the state's
    layout, then redistributed to its own and copied back: ZeRO-1's
    gather of the updated params."""
    from repro_torch.dist.sharding import is_dtensor, wrap
    if not is_dtensor(p):
        return g, m, v, p, w, None
    mesh, pl = m.device_mesh, tuple(m.placements)
    g = g.redistribute(mesh, pl) if tuple(g.placements) != pl else g
    w_l = None if w is None else w.to_local()
    if tuple(p.placements) == pl:
        return g.to_local(), m.to_local(), v.to_local(), p.to_local(), w_l, None
    p_z = p.redistribute(mesh, pl).to_local().clone()

    def write_back():
        full_p = wrap(p_z, mesh, pl, p.shape).redistribute(mesh, p.placements)
        p.to_local().copy_(full_p.to_local())

    return g.to_local(), m.to_local(), v.to_local(), p_z, w_l, write_back


def _leaf_states(template: PyTree, states: PyTree) -> list:
    """Adafactor's per-leaf state dicts ({"vr", "vc"} or {"v"}), in the
    order of ``template``'s leaves."""
    if isinstance(template, dict):
        return [x for k, v in template.items()
                for x in _leaf_states(v, states[k])]
    if isinstance(template, (list, tuple)):
        return [x for v, st in zip(template, states)
                for x in _leaf_states(v, st)]
    return [states]


@dataclasses.dataclass(frozen=True)
class WarmupCosine:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * peak_lr`` at ``total_steps``. Takes the step as
    a 0-d tensor and returns a 0-d f32 tensor on its device, so a captured
    step reads its rate without a host sync."""
    peak_lr: float
    warmup_steps: int
    total_steps: int
    min_ratio: float = 0.1

    def __call__(self, step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = step / max(self.warmup_steps, 1)
        prog = (step - self.warmup_steps) / max(
            self.total_steps - self.warmup_steps, 1)
        cos = self.min_ratio + (1 - self.min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * torch.clamp(prog, 0.0, 1.0)))
        return self.peak_lr * torch.where(step < self.warmup_steps, warm, cos)
