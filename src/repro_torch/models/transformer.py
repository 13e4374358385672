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

from repro_torch.common import (take_clip, tree_leaves, tree_map,
                                tree_unflatten)
from repro_torch.dist import policy
from repro_torch.dist import sharding as sh
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
    gated combine summing each token's k contributions.

    tp_axis: inside a shard-local block, the expert weights arrive
    F-sharded (wg / wu on their last dim, wd on its contraction dim); the
    output is a partial sum, summed over ``tp_axis`` of the active mesh
    (``launch.mesh.mesh_context``) after the combine."""
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
    y = contrib[inv].reshape(T, k, D).sum(dim=1)
    if tp_axis is not None:
        y = sh.psum(y, tp_axis)    # TP reduction after the combine
    return y


def dense_ffn(x: Tensor, ffn: dict, cfg: LMConfig) -> Tensor:
    h = F.silu(x @ ffn["wg"].to(x.dtype)) * (x @ ffn["wu"].to(x.dtype))
    return h @ ffn["wd"].to(x.dtype)


# ---------------------------------------------------------------------------
# Transformer block + full forward
# ---------------------------------------------------------------------------

def _qkv(x, lp, cfg: LMConfig, positions):
    """The block's normed, projected and rotated q (B, S, Hq, hd), k and v
    (B, S, Hkv, hd)."""
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
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


def _attn_block(x, lp, cfg: LMConfig, positions, kv_state=None,
                return_kv: bool = False):
    """x: (B, S, D). kv_state: None (full-seq) or dict with the layer's
    cache (decode), which is written in place at ``slot``."""
    b, s, D = x.shape
    hq, hd = cfg.n_heads, cfg.hd
    q, k, v = _qkv(x, lp, cfg, positions)
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
    out = out.reshape(b, s, hq * hd) @ lp["attn"]["wo"].to(x.dtype)
    return x + out, new_kv


def _ffn_block(x, lp, cfg: LMConfig):
    b, s, D = x.shape
    xn = rms_norm(x, lp["ln2"].to(x.dtype))
    if cfg.is_moe:
        axes = policy.get("moe_shard_axes")
        if axes:
            raise TypeError(
                f"policy moe_shard_axes={axes!r} asks for the shard-local MoE "
                "dispatch ('moe_local'), which runs on DTensors: the "
                "activations here are plain tensors")
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
    if sh.is_dtensor(tokens):
        if positions is not None:
            raise ValueError("on a mesh the positions are 0..S-1")
        return _lm_forward_sharded(params, cfg, tokens, return_kv)
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
    if sh.is_dtensor(tokens):
        return _lm_loss_sharded(params, cfg, tokens, labels)
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
    if sh.is_dtensor(tokens):
        return _lm_decode_sharded(params, cfg, cache, tokens, pos)
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


# ---------------------------------------------------------------------------
# On a mesh: shard-local blocks over DTensors
# ---------------------------------------------------------------------------
#
# Params, tokens and caches arrive as DTensors laid out by
# ``dist.sharding.lm_param_pspecs`` & co. Each block runs the plain code
# above on this rank's local tensors; the collectives are DTensor
# redistributes at the block's edges (their backward is DTensor's) and the
# MoE's ``psum`` inside it. ``L`` is the program's ``sharding.Layouts``:
#
# * the residual lies on ``L.rows`` (batch over the DP axes), or on
#   ``L.seq`` (sequence also over 'model') under the 'seq_par' policy
#   entry ``residual``;
# * attention runs sequence-parallel: each 'model' rank takes S / n_model
#   query rows (the heads of the five archs do not divide 16), k / v are
#   all-gathered over 'model', and the block's weights are all-gathered
#   over 'model' too; its output lies on ``L.seq``. Decode (one token)
#   and a sequence that does not divide run the block whole on each
#   'model' rank;
# * the FFN is tensor-parallel as the specs shard it: wg / wu on F, wd on
#   its contraction dim; a dense FFN's partial sum is reduced by the
#   redistribute to the residual's layout (an all-reduce, or a
#   reduce-scatter under 'seq_par'), a MoE's by ``moe_ffn(tp_axis=
#   'model')``. Without 'moe_local' the MoE routes all tokens globally
#   (they are all-gathered over the DP axes); with it each DP shard
#   routes its own;
# * the loss is vocab-parallel over 'model' (lm_head all-gathered over the
#   DP axes): a ``pmax`` and two ``psum`` per chunk.
#
# A gradient placement names what a block's local gradient is: ``Partial``
# on a mesh dim where the ranks computed on different rows with the same
# replicated tensor.

def _layouts(tokens) -> "sh.Layouts":
    from torch.distributed.tensor import Shard
    mesh = tokens.device_mesh
    L0 = sh.Layouts(mesh)
    lead = [tokens.placements[i] for i in L0.dp]
    return sh.Layouts(mesh, batch_sharded=all(isinstance(p, Shard)
                                              for p in lead))


def _grad_of(L, pl) -> tuple:
    """A replicated tensor's gradient when it is used on rows laid out as
    ``pl``: summed over every mesh dim that splits them."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in pl)


def _unbind_dt(t) -> list:
    """``torch.unbind`` of a stacked DTensor along its (unsharded) dim 0:
    one local unbind, so the backward writes the leaf's gradient as one
    stack."""
    from torch.distributed.tensor import Shard
    pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
               for p in t.placements)
    return [sh.wrap(u, t.device_mesh, pl) for u in t.to_local().unbind(0)]


def _layer_slices_sharded(params: dict) -> list[dict]:
    layers = params["layers"]
    per_leaf = [_unbind_dt(t) for t in tree_leaves(layers)]
    return [tree_unflatten(layers, [u[i] for u in per_leaf])
            for i in range(_depth(params))]


def _gathered(tree, L, grad):
    """Every DTensor of ``tree`` all-gathered (``L.rep``) as a local tensor
    whose gradient has placements ``grad``."""
    return tree_map(lambda t: sh.local(t, L.mesh, L.rep, grad), tree)


def _attn_sharded(x, lp, cfg: LMConfig, L, return_kv: bool):
    """The attention block of a full sequence on a mesh; returns the new
    residual (on ``L.seq`` when the sequence splits, else ``L.rows``) and,
    with ``return_kv``, this rank's (B_l, S, Hkv, hd) k / v."""
    from torch.distributed.tensor import Partial
    mesh = L.mesh
    b, s, D = x.shape
    nm = L.model_size()
    split = s % nm == 0
    lay = L.seq if split else L.rows
    x_l = sh.local(x, mesh, lay)
    w = _gathered({"attn": lp["attn"], "ln1": lp["ln1"]}, L, _grad_of(L, lay))
    b_l, s_l = x_l.shape[:2]
    dev = x_l.device
    if not split:
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(
            b_l, s)
        y, kv = _attn_block(x_l, w, cfg, pos, return_kv=return_kv)
        return sh.wrap(y, mesh, lay), kv
    base = L.model_rank() * s_l
    pos = torch.arange(base, base + s_l, dtype=torch.int32,
                       device=dev)[None].expand(b_l, s_l)
    q, k, v = _qkv(x_l, w, cfg, pos)
    kv_grad = L.with_(L.rows, model=Partial())
    k = sh.local(sh.wrap(k, mesh, L.seq), mesh, L.rows, kv_grad)
    v = sh.local(sh.wrap(v, mesh, L.seq), mesh, L.rows, kv_grad)
    kv_pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(
        b_l, s)
    out = flash_attention(q, k, v, pos, kv_pos, causal=True,
                          window=cfg.window, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk)
    y = x_l + out.reshape(b_l, s_l, -1) @ w["attn"]["wo"].to(x_l.dtype)
    return sh.wrap(y, mesh, L.seq), ((k, v) if return_kv else None)


def _ffn_sharded(x, lp, cfg: LMConfig, L, target: tuple):
    """The FFN block on a mesh: ``x`` (any row layout) plus the FFN of its
    norm, on ``target``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = L.mesh
    route_global = cfg.is_moe and not policy.get("moe_shard_axes")
    xin = L.with_(L.rows, dp=Replicate()) if route_global else L.rows
    gdp = _grad_of(L, xin)[L.dp[0]] if L.dp else Replicate()
    x_l = sh.local(x, mesh, xin, L.with_(xin, model=Partial()))
    ln2 = sh.local(lp["ln2"], mesh, L.rep,
                   L.with_(L.rep, dp=gdp, model=Partial()))

    def weight(t):
        pl = tuple(t.placements)
        grad = L.with_(pl, dp=gdp)
        if L.model is not None and not isinstance(pl[L.model], Shard):
            grad = L.with_(grad, model=Partial())
        return sh.local(t, mesh, pl, grad)

    ffn = {k: weight(v) for k, v in lp["ffn"].items()}
    xn = rms_norm(x_l, ln2.to(x_l.dtype))
    if cfg.is_moe:
        with policy.use(mesh=mesh):
            y = moe_ffn(xn.reshape(-1, xn.shape[-1]), ffn, cfg,
                        tp_axis="model").reshape(xn.shape)
        y = sh.wrap(y, mesh, xin)
    else:
        y = sh.wrap(dense_ffn(xn, ffn, cfg), mesh,
                    L.with_(L.rows, model=Partial()))
    return x.redistribute(mesh, target) + y.redistribute(mesh, target)


def _norm_sharded(x, weight, L):
    """``rms_norm`` of a row-wise laid-out DTensor, in place of its rows."""
    pl = tuple(x.placements)
    w = sh.local(weight, L.mesh, L.rep, _grad_of(L, pl))
    x_l = sh.local(x, L.mesh, pl)
    return sh.wrap(rms_norm(x_l, w.to(x_l.dtype)), L.mesh, pl)


def _embed_sharded(params, tokens, L, dt):
    return sh.sharded_rows(params["embed"], tokens).redistribute(
        L.mesh, L.rows).to(dt)


def _lm_forward_sharded(params: dict, cfg: LMConfig, tokens, return_kv):
    from torch.distributed.tensor import Shard
    L = _layouts(tokens)
    dt = cfg.torch_dtype
    res = policy.get("residual")
    target = tuple(res[1]) if res is not None else L.rows
    x = _embed_sharded(params, tokens, L, dt)

    def layer(x, lp):
        x, kv = _attn_sharded(x, lp, cfg, L, return_kv)
        x = _ffn_sharded(x, lp, cfg, L, target)
        return policy.constrain(x, "residual"), kv

    remat = cfg.remat and torch.is_grad_enabled()
    ks, vs = [], []
    for lp in _layer_slices_sharded(params):
        if remat:
            x, kv = checkpoint(layer, x, lp, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            x, kv = layer(x, lp)
        if return_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    x = _norm_sharded(x, params["final_norm"], L)
    if return_kv:
        pl = tuple(Shard(1) if isinstance(p, Shard) else p for p in L.rows)
        return x, {"k": sh.wrap(torch.stack(ks), L.mesh, pl),
                   "v": sh.wrap(torch.stack(vs), L.mesh, pl)}
    return x


def lm_head_local(params: dict, L):
    """lm_head all-gathered over the DP axes, vocab over 'model': this
    rank's (D, V / n_model) columns and their first column's index."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    pl = L.with_(L.rep, model=Shard(1))
    head = params["lm_head"]
    grad = L.with_(pl, dp=Partial() if isinstance(L.rows[L.dp[0]], Shard)
                   else Replicate())
    h = sh.local(head, L.mesh, pl, grad)
    return h, L.model_rank() * h.shape[1]


def lm_last_logits_sharded(params: dict, x):
    """The prefill's ``x[:, -1, :] @ lm_head`` on a mesh: (B, V) logits
    with the batch as ``x``'s rows and the vocab over 'model'."""
    from torch.distributed.tensor import Shard
    L = _layouts(x)
    head, _ = lm_head_local(params, L)
    x_l = sh.local(x, L.mesh, L.rows)[:, -1, :]
    return sh.wrap(x_l @ head.to(x_l.dtype), L.mesh,
                   L.with_(L.rows, model=Shard(1)))


def _lm_loss_sharded(params: dict, cfg: LMConfig, tokens, labels):
    from torch.distributed.tensor import Partial
    L = _layouts(tokens)
    mesh = L.mesh
    x = _lm_forward_sharded(params, cfg, tokens, False)
    b, s, D = x.shape
    x_l = sh.local(x, mesh, L.rows, L.with_(L.rows, model=Partial()))
    ls_l = sh.local(labels, mesh, L.rows)
    head, lo = lm_head_local(params, L)
    col = lo + torch.arange(head.shape[1], device=x_l.device)
    pad = col >= cfg.vocab
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"loss_chunk {c} must divide the sequence {s}")
    with policy.use(mesh=mesh):
        total = []
        for i in range(s // c):
            xs = x_l[:, i * c:(i + 1) * c]
            ls = ls_l[:, i * c:(i + 1) * c]
            logits = (xs @ head.to(xs.dtype)).float()
            if cfg.vocab_padded != cfg.vocab:
                logits = logits.masked_fill(pad, -1e30)
            m = sh.pmax(logits.amax(dim=-1), "model")
            se = sh.psum(torch.exp(logits - m[..., None]).sum(dim=-1),
                         "model")
            gold = sh.psum(torch.where(col == ls[..., None].long(), logits,
                                       logits.new_zeros(())).sum(dim=-1),
                           "model")
            total.append((torch.log(se) + m - gold).sum())
        part = torch.stack(total).sum() / (b * s)
    loss = sh.wrap(part, mesh, L.with_(L.rep, dp=_grad_of(L, L.rows)[
        L.dp[0]]))
    return loss.redistribute(mesh, L.rep).to_local()


def _lm_decode_sharded(params, cfg: LMConfig, cache, tokens, pos):
    """``lm_decode_step`` on a mesh: each rank decodes its batch rows
    whole (the cache is batch-sharded over the DP axes, replicated over
    'model'); the FFN and the logits are tensor-parallel. Returns
    (logits on ``(Replicate.., Shard(2) over 'model')``, cache)."""
    from torch.distributed.tensor import Shard
    L = _layouts(tokens)
    mesh = L.mesh
    dt = cfg.torch_dtype
    pos = sh.local(pos, mesh, L.rep).to(torch.int32)
    kc, vc = sh.local(cache["k"], mesh, cache["k"].placements), sh.local(
        cache["v"], mesh, cache["v"].placements)
    b_l, W = kc.shape[1], kc.shape[2]
    slot = torch.remainder(pos, W)
    positions = pos.reshape(1, 1).expand(b_l, 1)
    j = torch.arange(W, dtype=torch.int32, device=pos.device)
    kv_pos = pos - torch.remainder(slot - j, W)
    kv_pos_b = kv_pos[None].expand(b_l, W)
    valid_b = (kv_pos >= 0)[None].expand(b_l, W)
    x = _embed_sharded(params, tokens, L, dt)
    for i, lp in enumerate(_layer_slices_sharded(params)):
        w = _gathered({"attn": lp["attn"], "ln1": lp["ln1"]}, L, None)
        kv_state = {"k": kc[i], "v": vc[i], "slot": slot, "pos": kv_pos_b,
                    "valid": valid_b}
        y, _ = _attn_block(sh.local(x, mesh, L.rows), w, cfg, positions,
                           kv_state)
        x = _ffn_sharded(sh.wrap(y, mesh, L.rows), lp, cfg, L, L.rows)
    x = _norm_sharded(x, params["final_norm"], L)
    head, _ = lm_head_local(params, L)
    logits = sh.local(x, mesh, L.rows) @ head.to(dt)
    logits = sh.wrap(logits, mesh, L.with_(L.rows, model=Shard(2)))
    return logits.redistribute(mesh, L.with_(L.rep, model=Shard(2))), cache
