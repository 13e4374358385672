"""Embedding tables and EmbeddingBag (port of ``repro.nn.embedding``).

``Embedding`` is a plain single-id lookup; ``EmbeddingBag`` is the pooled
multi-hot lookup of the recsys hot path over a flattened (ids,
segment_ids) encoding, or a fixed-hot ``(B, H)`` id matrix
(``apply_dense``). Both pooled forms go through
``repro_torch.kernels.embedding_bag``: its plain PyTorch version for CPU
tensors, the hand-written CUDA kernel for CUDA tensors. Params are dicts
of tensors drawn on a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import normal_init
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_fixed)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Embedding:
    """Plain single-id lookup table."""

    vocab: int
    dim: int

    def init(self, gen: torch.Generator, dtype=torch.float32) -> dict:
        return {"table": normal_init(gen, (self.vocab, self.dim), 0.02,
                                     dtype)}

    def apply(self, params: dict, ids: Tensor) -> Tensor:
        table = params["table"]
        return torch.index_select(table, 0, ids.reshape(-1).long()).reshape(
            tuple(ids.shape) + (table.shape[1],))


def embedding_bag_lookup(table: Tensor, ids: Tensor, segment_ids: Tensor,
                         num_segments: int, *, combiner: str = "sum",
                         weights: Tensor | None = None) -> Tensor:
    """Pooled multi-hot lookup.

    table: (V, D); ids: (nnz,) flat indices into table; segment_ids: (nnz,)
    row each id belongs to (sorted or not); returns (num_segments, D). On
    CUDA this launches the ``embedding_bag`` kernel."""
    return embedding_bag(table, ids, segment_ids, num_segments,
                         combiner=combiner, weights=weights)


@dataclasses.dataclass(frozen=True)
class EmbeddingBag:
    """Multi-hot pooled embedding (sum/mean combiner), torch.EmbeddingBag
    contract."""

    vocab: int
    dim: int
    combiner: str = "sum"

    def init(self, gen: torch.Generator, dtype=torch.float32) -> dict:
        scale = 1.0 / max(self.vocab, 1) ** 0.5
        return {"table": normal_init(gen, (self.vocab, self.dim), scale,
                                     dtype)}

    def apply(self, params: dict, ids: Tensor, segment_ids: Tensor,
              num_segments: int, weights: Tensor | None = None) -> Tensor:
        return embedding_bag_lookup(
            params["table"], ids, segment_ids, num_segments,
            combiner=self.combiner, weights=weights)

    def apply_dense(self, params: dict, ids: Tensor) -> Tensor:
        """Fixed-hot (B, H) id matrix variant — pools along axis 1."""
        return embedding_bag_fixed(params["table"], ids,
                                   combiner=self.combiner)
