"""DIN target attention and the ranking-model cross attention of the
paper's Fig. 1 (port of the two functions of ``repro.nn.attention`` that
the serving path uses)."""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

NEG_INF = -1e30


def target_attention(
    query: Tensor,     # (B, D)   candidate-item embedding (DIN target)
    keys: Tensor,      # (B, L, D) or (1, L, D) user history (broadcast over B)
    mask: Tensor,      # (B, L) or (1, L) bool valid positions
    mlp_apply,         # callable(x: (..., 4D)) -> (..., 1) attention MLP
) -> Tensor:
    """DIN local-activation unit: score each history item against the target
    via an MLP over [key, query, key-query, key*query]; weighted sum-pool."""
    if keys.shape[0] == 1 and query.shape[0] != 1:
        keys = keys.expand((query.shape[0],) + tuple(keys.shape[1:]))
        mask = mask.expand((query.shape[0],) + tuple(mask.shape[1:]))
    q = query[:, None, :].expand(keys.shape)  # (B, L, D)
    feats = torch.cat([keys, q, keys - q, keys * q], dim=-1)
    scores = mlp_apply(feats)[..., 0]  # (B, L)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    dt = torch.promote_types(w.dtype, keys.dtype)   # as jnp.einsum promotes
    return torch.einsum("bl,bld->bd", w.to(dt), keys.to(dt))


def cross_attention(
    q: Tensor,         # (B, I, D) item-side queries
    k: Tensor,         # (1, L, D) user-sequence keys (computed ONCE — UOI)
    v: Tensor,         # (1, L, D)
    mask: Tensor | None = None,  # (1, L)
) -> Tensor:
    """Single-head candidate→user-history cross attention (paper Eq. 1).

    In UOI/MaRI, K/V carry batch 1 (user side, computed one-shot) and the
    einsum broadcasts — the tiled copy never materializes. In VanI, K/V
    arrive already tiled to B and the batched path is used.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    if k.shape[0] == 1 and q.shape[0] != 1:
        logits = torch.einsum("bid,ld->bil", q, k[0]).float() * scale
    else:
        logits = torch.einsum("bid,bld->bil", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask[:, None, :], logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if v.shape[0] == 1 and probs.shape[0] != 1:
        return torch.einsum("bil,ld->bid", probs, v[0])
    return torch.einsum("bil,bld->bid", probs, v)
