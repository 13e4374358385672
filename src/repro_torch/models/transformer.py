"""Decoder-only LM family covering the five assigned architectures (port of
``repro.models.transformer``).

* Per-layer params stacked on a leading ``(L, ...)`` axis, as the
  reference's ``lax.scan`` carries them, so its params cross over leaf for
  leaf; the forward is a Python loop over ``L`` indexing each stacked leaf.
* Flash-style block attention (online softmax, a double loop over Q/KV
  chunks) — a 32k-token prefill never materializes an S×S score matrix.
  Every block is computed, masked ones included, as in the reference.
* Sliding-window attention (Mixtral) with a ring-buffer KV cache for the
  524k-token long-context decode cell.
* Sort-based capacity-dropped MoE dispatch — no (T, E, C) one-hot tensor;
  its combine is deterministic (no atomics), so a captured step and an
  eager one give the same bits.
* Optional per-layer activation checkpointing (``cfg.remat``, under
  grad); activations compute in ``cfg.dtype`` (bf16 target).

The decode step runs no host read (no ``.item()``, no boolean-mask
indexing, no ``torch.bincount``): ``pos`` is a 0-d int32 tensor on the
device, so one captured CUDA graph replays at every position, and the
KV cache is written in place.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common import take_clip, tree_leaves, tree_unflatten
from repro_torch.dist import policy
from repro_torch.nn.layers import rms_norm

Tensor = torch.Tensor
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qk_norm: bool = False
    window: int | None = None          # sliding-window attention
    moe_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    rope_theta: float = 1_000_000.0
    dtype: str = "bfloat16"
    remat: bool = True
    q_chunk: int = 512
    kv_chunk: int = 1024
    loss_chunk: int = 512              # vocab-projection chunking in the loss

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded to 256 (the reference's even embed / lm_head
        shards). Padded logits are masked in the loss."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def scaled_down(self, **over) -> "LMConfig":
        """Reduced config for CPU smoke tests."""
        small = dict(
            n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=max(1, self.n_kv_heads * 4 // self.n_heads),
            d_ff=128, vocab=256, head_dim=16,
            moe_experts=min(self.moe_experts, 4),
            moe_top_k=min(self.moe_top_k, 2),
            window=64 if self.window else None,
            q_chunk=8, kv_chunk=8, loss_chunk=16, dtype="float32", remat=False)
        small.update(over)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _param_tree(cfg: LMConfig, w, ones) -> dict:
    """The params tree from two leaf factories (random, ones)."""
    L, D, hd = cfg.n_layers, cfg.d_model, cfg.hd
    hq, hkv, F_ = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    attn = {"wq": w((L, D, hq * hd)), "wk": w((L, D, hkv * hd)),
            "wv": w((L, D, hkv * hd)), "wo": w((L, hq * hd, D))}
    if cfg.qk_norm:
        attn["q_norm"] = ones((L, hd))
        attn["k_norm"] = ones((L, hd))
    if cfg.is_moe:
        E = cfg.moe_experts
        ffn = {"router": w((L, D, E)), "wg": w((L, E, D, F_)),
               "wu": w((L, E, D, F_)), "wd": w((L, E, F_, D))}
    else:
        ffn = {"wg": w((L, D, F_)), "wu": w((L, D, F_)), "wd": w((L, F_, D))}
    return {
        "embed": w((cfg.vocab_padded, D)),
        "layers": {"attn": attn, "ffn": ffn,
                   "ln1": ones((L, D)), "ln2": ones((L, D))},
        "final_norm": ones((D,)),
        "lm_head": w((D, cfg.vocab_padded)),
    }


def init_lm_params(cfg: LMConfig, seed: int = 0, dtype=None,
                   device: str | torch.device = "cuda") -> dict:
    """normal(0.02) weights drawn in ``dtype`` on ``device`` from a
    ``torch.Generator`` seeded with ``seed``; ones for the norms."""
    dtype = dtype or cfg.torch_dtype
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def w(shape):
        t = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
        return t.mul_(0.02)

    return _param_tree(cfg, w, lambda s: torch.ones(s, dtype=dtype,
                                                    device=dev))


def lm_param_specs(cfg: LMConfig, dtype=None) -> dict:
    """The params tree on the ``meta`` device (no allocation): the port of
    ``jax.eval_shape`` over ``init_lm_params``."""
    dtype = dtype or cfg.torch_dtype

    def meta(shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    return _param_tree(cfg, meta, meta)


# ---------------------------------------------------------------------------
# RoPE (computed from positions on the fly — no 500k-row table)
# ---------------------------------------------------------------------------

def _rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, hd); positions: (B, S). The half-split rotation, in
    fp32, cast back to ``x.dtype``."""
    hd = x.shape[-1]
    # theta stays a Python scalar: a tensor made from it would be a host
    # copy, which a CUDA graph capture refuses
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    inv = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * inv            # (B, S, hd/2)
    c, s = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Flash-style block attention
# ---------------------------------------------------------------------------

def flash_attention(
    q: Tensor,            # (B, Sq, Hq, hd)
    k: Tensor,            # (B, Sk, Hkv, hd)
    v: Tensor,            # (B, Sk, Hkv, hd)
    q_pos: Tensor,        # (B, Sq)
    kv_pos: Tensor,       # (B, Sk)
    *,
    causal: bool = True,
    window: int | None = None,
    kv_valid: Tensor | None = None,   # (B, Sk) bool
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> Tensor:
    """Online-softmax attention over (q_chunk × kv_chunk) blocks, GQA by
    grouping the query heads as (Hkv, g). Scores and the running max / sum
    are fp32; the accumulator stays in ``q.dtype`` and ``p`` is cast to
    ``v.dtype`` before the PV product, as in the reference."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, sk)
    if sq % qc or sk % kc:
        raise ValueError(f"chunks must divide the lengths: {(sq, qc, sk, kc)}")
    nq, nk = sq // qc, sk // kc

    scale = 1.0 / math.sqrt(hd)
    qr = q.reshape(b, nq, qc, hkv, g, hd)
    kr = k.reshape(b, nk, kc, hkv, hd)
    vr = v.reshape(b, nk, kc, hkv, hd)
    qp = q_pos.reshape(b, nq, qc)
    kp = kv_pos.reshape(b, nk, kc)
    kval = kv_valid.reshape(b, nk, kc) if kv_valid is not None else None

    outs = []
    for qi in range(nq):
        qb = qr[:, qi]            # (B, qc, Hkv, g, hd)
        qpb = qp[:, qi]           # (B, qc)
        m = torch.full((b, hkv, g, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, qc, hd), dtype=q.dtype, device=q.device)
        for ki in range(nk):
            kb, vb = kr[:, ki], vr[:, ki]          # (B, kc, Hkv, hd)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb).float() * scale
            dist = qpb[:, :, None] - kp[:, ki][:, None, :]    # (B, qc, kc)
            msk = None if kval is None else kval[:, ki][:, None, :]
            if causal:
                msk = dist >= 0 if msk is None else msk & (dist >= 0)
            if window is not None:
                msk = dist < window if msk is None else msk & (dist < window)
            if msk is not None:
                s = s.masked_fill(~msk[:, None, None, :, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype), vb)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None].to(acc.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qc, hq, hd))
    return torch.stack(outs, dim=1).reshape(b, sq, hq, hd)


# ---------------------------------------------------------------------------
# MoE FFN — sort-based dispatch with capacity dropping (no one-hot tensor)
# ---------------------------------------------------------------------------

def moe_capacity(cfg: LMConfig, tokens: int) -> int:
    """Rows per expert: ``max(1, int(T·k·capacity_factor / E))``."""
    return max(1, int(tokens * cfg.moe_top_k * cfg.capacity_factor
                      / cfg.moe_experts))


def moe_ffn(x: Tensor, ffn: dict, cfg: LMConfig, tp_axis: str | None = None
            ) -> Tensor:
    """x: (T, D) -> (T, D): top-k routing, a stable sort of the (token,
    choice) pairs by expert, the first C of each expert kept (the rest
    routed to a dummy row ``E·C``), SwiGLU experts over (E, C, D), and a
    gated combine summing each token's k contributions."""
    if tp_axis is not None:
        raise NotImplementedError(
            f"moe_ffn(tp_axis={tp_axis!r}): the tensor-parallel reduction "
            f"waits for the sharding slice ({policy.SHARDING_SLICE})")
    T, D = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    C = moe_capacity(cfg, T)
    dev = x.device

    logits = (x @ ffn["router"].to(x.dtype)).float()                   # (T, E)
    topv, topi = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(topv, dim=-1)                                # (T, k)

    fe = topi.reshape(-1)                                 # (T*k,) expert ids
    ar = torch.arange(T * k, device=dev)
    ft = ar // k                                          # (T*k,) token ids
    fg = gates.reshape(-1)
    order = torch.argsort(fe, stable=True)
    se, st, sg = fe[order], ft[order], fg[order]
    # a scatter-add, not torch.bincount: bincount reads its maximum back
    # to the host, which a captured graph cannot do
    counts = torch.zeros(E, dtype=se.dtype, device=dev).scatter_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    pos = ar - starts[se]
    keep = pos < C
    # dropped entries route to a dummy row E*C so they can never clobber a
    # kept token's slot.
    slot = torch.where(keep, se * C + pos, torch.full_like(pos, E * C))

    xd = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    xd.index_copy_(0, slot, x[st])
    xd = xd[: E * C].reshape(E, C, D)
    h = F.silu(torch.bmm(xd, ffn["wg"].to(x.dtype)))
    h = h * torch.bmm(xd, ffn["wu"].to(x.dtype))
    yd = torch.bmm(h, ffn["wd"].to(x.dtype)).reshape(E * C, D)

    # the dummy row is past yd's end: jnp's gather clamps it (its gate is 0)
    contrib = take_clip(yd, slot) * (sg * keep).to(x.dtype)[:, None]
    # the reference's scatter-add combine, as a sum over each token's k
    # contributions put back in (token, choice) order: on the card an
    # index_add_'s atomics sum in any order, and one token's other bf16
    # rounding can flip a later layer's top-k, so runs would disagree
    inv = torch.empty_like(order).scatter_(0, order, ar)
    return contrib[inv].reshape(T, k, D).sum(dim=1)


def dense_ffn(x: Tensor, ffn: dict, cfg: LMConfig) -> Tensor:
    h = F.silu(x @ ffn["wg"].to(x.dtype)) * (x @ ffn["wu"].to(x.dtype))
    return h @ ffn["wd"].to(x.dtype)


# ---------------------------------------------------------------------------
# Transformer block + full forward
# ---------------------------------------------------------------------------

def _attn_block(x, lp, cfg: LMConfig, positions, kv_state=None,
                return_kv: bool = False):
    """x: (B, S, D). kv_state: None (full-seq) or dict with the layer's
    cache (decode), which is written in place at ``slot``."""
    b, s, D = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = lp["attn"]
    xn = rms_norm(x, lp["ln1"].to(x.dtype))
    q = (xn @ attn["wq"].to(x.dtype)).reshape(b, s, hq, hd)
    k = (xn @ attn["wk"].to(x.dtype)).reshape(b, s, hkv, hd)
    v = (xn @ attn["wv"].to(x.dtype)).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, attn["q_norm"].to(x.dtype))
        k = rms_norm(k, attn["k_norm"].to(x.dtype))
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)

    if kv_state is None:
        out = flash_attention(q, k, v, positions, positions, causal=True,
                              window=cfg.window, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk)
        new_kv = (k, v) if return_kv else None
    else:
        kc, vc, slot, kv_pos, kv_valid = (
            kv_state["k"], kv_state["v"], kv_state["slot"],
            kv_state["pos"], kv_state["valid"])
        # dynamic_update_slice: the start clamps so that the s rows fit
        rows = slot.long().clamp(max=kc.shape[1] - s) + torch.arange(
            s, device=slot.device)
        kc.index_copy_(1, rows, k.to(kc.dtype))
        vc.index_copy_(1, rows, v.to(vc.dtype))
        out = flash_attention(q, kc.to(x.dtype), vc.to(x.dtype),
                              positions, kv_pos, causal=True, window=cfg.window,
                              kv_valid=kv_valid, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk)
        new_kv = (kc, vc)
    out = out.reshape(b, s, hq * hd) @ attn["wo"].to(x.dtype)
    return x + out, new_kv


def _ffn_block(x, lp, cfg: LMConfig):
    b, s, D = x.shape
    xn = rms_norm(x, lp["ln2"].to(x.dtype))
    if cfg.is_moe:
        axes = policy.get("moe_shard_axes")
        if axes:
            raise NotImplementedError(
                f"policy moe_shard_axes={axes!r} asks for the shard-local MoE "
                f"dispatch ('moe_local'), but {policy.SHARDING_SLICE}")
        y = moe_ffn(xn.reshape(b * s, D), lp["ffn"], cfg).reshape(b, s, D)
    else:
        y = dense_ffn(xn, lp["ffn"], cfg)
    return x + y


def _depth(params: dict) -> int:
    """Layers in the stacked params (the reference scans over them, so a
    depth-cut params tree runs with the registry's config)."""
    return params["layers"]["ln1"].shape[0]


def _layer_slices(params: dict) -> list[dict]:
    """Every layer's params: one ``torch.unbind`` per stacked leaf. Under
    grad its backward writes the leaf's gradient as one stack, where
    ``t[i]`` per layer would write a zero-filled full-size gradient per
    layer and add them up."""
    layers = params["layers"]
    per_leaf = [torch.unbind(t) for t in tree_leaves(layers)]
    return [tree_unflatten(layers, [u[i] for u in per_leaf])
            for i in range(_depth(params))]


def _embed(params: dict, tokens: Tensor, dt: torch.dtype) -> Tensor:
    flat = torch.index_select(params["embed"], 0, tokens.reshape(-1))
    return flat.reshape(*tokens.shape, -1).to(dt)


def lm_forward(params: dict, cfg: LMConfig, tokens: Tensor,
               positions: Tensor | None = None, return_kv: bool = False):
    """Full-sequence forward. tokens: (B, S) -> final hidden (B, S, D).
    With ``return_kv`` also returns the per-layer K/V stacked on a leading
    (L, ...) axis (prefill cache fill)."""
    dt = cfg.torch_dtype
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)
    x = _embed(params, tokens, dt)

    def layer(x, lp):
        x, kv = _attn_block(x, lp, cfg, positions, return_kv=return_kv)
        x = _ffn_block(x, lp, cfg)
        return policy.constrain(x, "residual"), kv

    remat = cfg.remat and torch.is_grad_enabled()
    ks, vs = [], []
    for lp in _layer_slices(params):
        if remat:
            # the layer draws no random numbers: no RNG state to keep,
            # and reading it would break a CUDA graph capture
            x, kv = checkpoint(layer, x, lp, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            x, kv = layer(x, lp)
        if return_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    x = rms_norm(x, params["final_norm"].to(dt))
    if return_kv:
        return x, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return x


def lm_logits(params: dict, cfg: LMConfig, tokens: Tensor) -> Tensor:
    x = lm_forward(params, cfg, tokens)
    return x @ params["lm_head"].to(x.dtype)


def lm_loss(params: dict, cfg: LMConfig, tokens: Tensor, labels: Tensor
            ) -> Tensor:
    """Chunked-vocab cross entropy — never materializes (B, S, V) at once."""
    x = lm_forward(params, cfg, tokens)          # (B, S, D)
    b, s, D = x.shape
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"loss_chunk {c} must divide the sequence {s}")
    head = params["lm_head"]
    pad_mask = None
    if cfg.vocab_padded != cfg.vocab:  # mask the padding columns
        pad_mask = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab

    def chunk_loss(i):
        xs = x[:, i * c:(i + 1) * c]
        ls = labels[:, i * c:(i + 1) * c]
        logits = (xs @ head.to(xs.dtype)).float()
        if pad_mask is not None:
            logits = logits.masked_fill(pad_mask, -1e30)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ls[..., None].long())[..., 0]
        return (logz - gold).sum()

    total = torch.stack([chunk_loss(i) for i in range(s // c)]).sum()
    return total / (b * s)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
                  device: str | torch.device = "cuda") -> dict:
    """Cache capacity = window (ring buffer) for SWA archs, else max_len."""
    dtype = dtype or cfg.torch_dtype
    W = min(cfg.window, max_len) if cfg.window else max_len
    shape = (cfg.n_layers, batch, W, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_specs(cfg: LMConfig, batch: int, max_len: int, dtype=None
                   ) -> dict:
    """``init_kv_cache``'s tree on the ``meta`` device."""
    return init_kv_cache(cfg, batch, max_len, dtype, device="meta")


def lm_decode_step(params: dict, cfg: LMConfig, cache: dict,
                   tokens: Tensor, pos: Tensor) -> tuple[Tensor, dict]:
    """One decode step. tokens: (B, 1); pos: 0-d int32 tensor on the
    device — the number of tokens already in the cache (uniform across
    the batch, standard batched serving).

    Returns (logits (B, 1, V), cache). The new K/V are written into
    ``cache["k"]`` / ``cache["v"]`` in place (the port of the reference's
    donated cache), so the returned cache is the same dict, holding the
    same tensors, that was passed in."""
    dt = cfg.torch_dtype
    b = tokens.shape[0]
    W = cache["k"].shape[2]
    pos = pos.to(torch.int32)
    slot = torch.remainder(pos, W)
    positions = pos.reshape(1, 1).expand(b, 1)

    # slot j currently holds absolute position: pos - ((slot - j) mod W),
    # once we've written the new token at `slot` (Python's sign: remainder).
    j = torch.arange(W, dtype=torch.int32, device=pos.device)
    kv_pos = pos - torch.remainder(slot - j, W)
    kv_pos_b = kv_pos[None].expand(b, W)
    valid_b = (kv_pos >= 0)[None].expand(b, W)

    x = _embed(params, tokens, dt)                 # (B, 1, D)
    for i, lp in enumerate(_layer_slices(params)):
        kv_state = {"k": cache["k"][i], "v": cache["v"][i], "slot": slot,
                    "pos": kv_pos_b, "valid": valid_b}
        x, _ = _attn_block(x, lp, cfg, positions, kv_state)
        x = _ffn_block(x, lp, cfg)
    x = rms_norm(x, params["final_norm"].to(dt))
    logits = x @ params["lm_head"].to(dt)
    return logits, cache
