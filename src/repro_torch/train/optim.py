"""Optimizers as (init, update) pairs over trees of tensors (port of
``repro.train.optim``: ``sgd``, ``adam``, ``adamw``,
``clip_by_global_norm``, ``apply_updates``).

States are plain trees, checkpointable as they are. The update formulas
are the reference's: Adam divides by ``sqrt(vhat) + eps`` with both
moments bias-corrected, and AdamW's weight decay is decoupled (added to
the step, scaled by ``lr``). Updates are functional: ``update`` returns
new tensors and never writes its arguments."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.common import PyTree, tree_leaves, tree_map, tree_unflatten


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]
    # update(grads, opt_state, params) -> (updates, new_opt_state);
    # apply with: params = apply_updates(params, updates)


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
            st["master"] = tree_map(lambda p: p.float(), params)
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

    return Optimizer(init, update)
