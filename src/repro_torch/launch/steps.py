"""Per-cell programs (port of ``repro.launch.steps``, the LM family's
serving programs): for an (LM architecture × prefill / decode shape) cell,
the step function and its inputs as ``meta``-device tensors at the
shape's sizes (the reference's ``ShapeDtypeStruct``s).

The port runs on one device with no mesh: ``in_shardings``,
``out_shardings`` and ``mesh`` stay ``None`` and ``policy_kv`` empty
until the sharding rule sets are ported. ``CellProgram.compiled()`` is
the port of ``jitted()``::

    prog = build_cell("granite-moe-3b-a800m", "decode_32k")
    decode = prog.compiled()                  # a CompiledDecode
    logits, cache = decode(params, cache, tokens, pos)

Decode runs behind ``graph.compiled.CompiledRun``: ``tokens`` and ``pos``
are feeds, the cache's ``k`` / ``v`` are refs read and written in place
(the reference donates the cache, ``donate_argnums=(1,)``), so one
captured graph serves every position. Prefill stays eager: its
attention walks S²/(q_chunk·kv_chunk) blocks a layer, each a handful of
large kernels, so capture would save little launch time for a graph of
hundreds of thousands of nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import configs as cfgreg
from repro_torch.common import resolve_device
from repro_torch.dist import policy
from repro_torch.graph.compiled import CompiledRun
from repro_torch.models.transformer import (LMConfig, kv_cache_specs,
                                            lm_decode_step, lm_forward,
                                            lm_param_specs)

# what build_cell refuses, and the slice of the port that brings it
TRAIN_SLICE = ("the LM training step comes with the next slice of the port "
               "(ROADMAP Queue 1: the training step's capture plus the LM "
               "training path)")
FAMILY_SLICE = ("the {fam} family's cell programs come with a later slice "
                "of the port (ROADMAP Queue 1: SchNet, then the sharding "
                "rule sets with launch/mesh.py and configs.all_cells)")


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

    def compiled(self, device: str | torch.device = "cuda") -> Callable:
        """The step as the reference's ``jitted()`` runs it: decode behind
        one captured CUDA graph (``CompiledDecode``), prefill eager under
        ``torch.inference_mode``."""
        if self.kind == "decode":
            return CompiledDecode(self.step_fn, device=device)
        resolve_device(device)
        step_fn = self.step_fn

        def run(*args):
            with torch.inference_mode():
                return step_fn(*args)
        return run


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


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def _lm_prefill(cfg: LMConfig, seq: int, batch: int) -> CellProgram:
    def prefill_step(params, tokens):
        x, kv = lm_forward(params, cfg, tokens, return_kv=True)
        logits = x[:, -1, :] @ params["lm_head"].to(x.dtype)
        return logits, kv

    tok = torch.empty((batch, seq), dtype=torch.int32, device="meta")
    return CellProgram("", "", "prefill", prefill_step,
                       (lm_param_specs(cfg), tok))


def _lm_decode(cfg: LMConfig, seq: int, batch: int) -> CellProgram:
    def decode(params, cache, tokens, pos):
        return lm_decode_step(params, cfg, cache, tokens, pos)

    tok = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return CellProgram("", "", "decode", decode,
                       (lm_param_specs(cfg), kv_cache_specs(cfg, batch, seq),
                        tok, pos), donate_argnums=(1,))


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape: str, mesh=None, opts=()) -> CellProgram:
    """The cell's program. The LM family's ``prefill`` and ``decode``
    shapes only; ``train`` shapes, the recsys and GNN families, a mesh and
    the sharding options ('moe_local', 'seq_par') raise, naming the slice
    that brings them."""
    opts = frozenset(opts)
    mod = cfgreg.get_config(arch)
    spec = mod.SHAPES[shape]
    if spec.get("skip"):
        raise ValueError(f"cell ({arch}, {shape}) is skipped: {spec['skip']}")
    fam = mod.FAMILY
    if fam != "lm":
        raise NotImplementedError(f"build_cell({arch!r}, {shape!r}): "
                                  + FAMILY_SLICE.format(fam=fam))
    sharded = sorted(opts & {"moe_local", "seq_par"})
    if mesh is not None or sharded:
        raise NotImplementedError(
            f"build_cell({arch!r}, {shape!r}, mesh={mesh!r}, opts={sharded}): "
            f"{policy.SHARDING_SLICE}; the port runs one device")
    cfg = mod.CONFIG
    if spec["kind"] == "train":
        raise NotImplementedError(f"build_cell({arch!r}, {shape!r}): "
                                  + TRAIN_SLICE)
    if spec["kind"] == "prefill":
        prog = _lm_prefill(cfg, spec["seq"], spec["global_batch"])
    else:
        prog = _lm_decode(cfg, spec["seq"], spec["global_batch"])
    prog.arch, prog.shape = arch, shape
    return prog
