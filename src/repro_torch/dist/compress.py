"""Int8 compression for cross-shard reductions (port of
``repro.dist.compress``): gradients and shard scores.

Symmetric linear quantizer: ``q = round(x / scale)`` with
``scale = max|x| / 127``, so ``|dequantize(q) - x| <= scale / 2``. Rounding
is half to even (``torch.round``), as ``jnp.round``.

The collectives work over a ``torch.distributed`` process group instead of
an axis name; ``group=None`` is the default group, and with no process
group at all they are the one-participant case with no collective.

* ``compressed_psum``: an ``all_reduce(MAX)`` agrees on one scale per leaf,
  each participant quantizes against it, an ``all_reduce(SUM)`` adds the
  int32 codes (exact for codes of a shared scale), and the local
  quantization residual comes back as the error-feedback term: add it to
  the next step's input and the bias cancels over steps.
* ``compressed_all_gather``: each shard quantizes its block, the gather
  moves int8 rows plus one fp32 scale per shard (~4x less than fp32), and
  every participant dequantizes each block with its producer's scale. The
  serving engine's opt-in score gather (``plan.shard.compress_scores``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.common import tree_leaves, tree_unflatten
from repro_torch.dist.sharding import gather_rows, group_ready, world

Tensor = torch.Tensor


def quantize_int8(x: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric int8 quantization: returns (q int8, scale fp32 scalar).

    ``scale = max|x| / 127``; an all-zero input keeps scale 0 (dequantizes
    to exact zeros — the divide is guarded)."""
    xf = torch.as_tensor(x).float()
    scale = xf.abs().max() / 127.0 if xf.numel() else xf.new_zeros(())
    return _codes(xf, scale), scale


def _codes(xf: Tensor, scale: Tensor) -> Tensor:
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(xf / safe), -127, 127).to(torch.int8)


def dequantize_int8(q: Tensor, scale: Tensor) -> Tensor:
    return q.float() * scale.float()


def _all_reduce(t: Tensor, op, group) -> Tensor:
    """``all_reduce`` in place (none without a process group)."""
    if group_ready():
        dist.all_reduce(t, op=op, group=group)
    return t


def compressed_psum(tree, group=None):
    """Int8-compressed all-reduce **mean** over ``group`` with error
    feedback. Returns ``(mean_tree, err_tree)``:

    * ``mean_tree`` — per-leaf mean over the participants' dequantized
      values;
    * ``err_tree`` — this participant's residual ``x - dequantize(q)``.

    With one participant: ``mean == dequantize(quantize(x))`` and
    ``mean + err == x`` exactly."""
    n = world(group)[0]

    def one(x: Tensor) -> tuple[Tensor, Tensor]:
        xf = torch.as_tensor(x).float()
        amax = _all_reduce(xf.abs().max().reshape(1), dist.ReduceOp.MAX,
                           group)[0]
        scale = amax / 127.0
        q = _codes(xf, scale)
        err = xf - q.float() * scale
        total = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
        return total.float() * scale / n, err

    outs = [one(x) for x in tree_leaves(tree)]
    return (tree_unflatten(tree, [m for m, _ in outs]),
            tree_unflatten(tree, [e for _, e in outs]))


def compressed_all_gather(x: Tensor, group=None, *,
                          n_ranks: int | None = None) -> Tensor:
    """Int8-compressed all-gather over the leading dim: ``(world * rows,
    ...)`` fp32, block i dequantized with shard i's scale (per-element
    error <= that shard's ``scale / 2``), on ``x``'s device.
    ``n_ranks`` keeps only the first blocks."""
    q, scale = quantize_int8(x)
    qg = gather_rows(q, group)
    sg = gather_rows(scale.reshape(1), group)            # (world,)
    if n_ranks is not None:
        qg, sg = qg[:n_ranks * x.shape[0]], sg[:n_ranks]
    row_scale = sg.repeat_interleave(x.shape[0])
    return qg.float() * row_scale.reshape((-1,) + (1,) * (x.dim() - 1))
