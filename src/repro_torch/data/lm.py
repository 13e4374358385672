"""LM token batches (synthetic) and their ``meta``-device specs (port of
``repro.data.lm``)."""
from __future__ import annotations

import torch


def token_batch(gen: torch.Generator, batch: int, seq: int, vocab: int
                ) -> dict[str, torch.Tensor]:
    """Uniform int32 tokens drawn on ``gen``'s device; labels are the
    tokens rolled by -1 along the sequence."""
    tokens = torch.randint(0, vocab, (batch, seq), generator=gen,
                           dtype=torch.int32, device=gen.device)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}


def token_batch_specs(batch: int, seq: int) -> dict[str, torch.Tensor]:
    return {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                  device="meta"),
            "labels": torch.empty((batch, seq), dtype=torch.int32,
                                  device="meta")}
