"""Fused MaRI matmul (Eq. 7): the CUDA kernel's wrapper, its plain PyTorch
version, and the group-folding op the executor calls.

``mari_matmul(x, w, u, user_index=None, activation=...)`` computes
``act(u_init + x @ w)`` where the accumulator starts from ``u``: a (1, N)
broadcast row, a row-wise (B, N) block, or — with ``user_index`` — row
``clamp(user_index[b])`` of a stacked (U, N) table. A CPU tensor goes to
``mari_matmul_plain``; a CUDA tensor launches ``csrc/mari_matmul.cu`` or
raises. ``LAUNCHES`` counts kernel launches per init mode.

``mari_matmul_fused_groups`` is the port of ``repro.kernels.mari_matmul.ops``:
the batch-1 user products, ``acc0`` and the bias fold into the f32 ``u``
(that small product stays ``torch.matmul``, as it stayed jnp outside the
Pallas kernel), and the batched streams concatenate into one ``x @ w``,
which is the kernel's. The TPU's 8x128 padding is gone: the kernel masks
its own ragged edges.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common import take_clip
from repro_torch.kernels import build
from repro_torch.nn.layers import ACTIVATIONS

Tensor = torch.Tensor

INIT_MODES = ("broadcast", "rowwise", "gather")       # csrc Init enum order
EPILOGUES = ("identity", "relu", "gelu", "silu", "sigmoid", "tanh")  # Act enum

# kernel launches per init mode (one per launch, counted nowhere else)
LAUNCHES = dict.fromkeys(INIT_MODES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def init_mode(B: int, u: Tensor, user_index: Tensor | None) -> str:
    """Which accumulator-init layout ``u`` has for a (B, ...) stream."""
    if user_index is not None:
        if tuple(user_index.shape) != (B,):
            raise ValueError(f"user_index must be ({B},), got "
                             f"{tuple(user_index.shape)}")
        return "gather"
    if u.shape[0] == 1:
        return "broadcast"
    if u.shape[0] == B:
        return "rowwise"
    raise ValueError(f"u rows must be 1 or B={B} (or a table with "
                     f"user_index), got {tuple(u.shape)}")


def mari_matmul_plain(x: Tensor, w: Tensor, u: Tensor,
                      user_index: Tensor | None = None,
                      activation: str = "identity") -> Tensor:
    """Plain PyTorch version: act(u[clamp(user_index)] or u + x @ w), f32."""
    if user_index is not None:
        u = take_clip(u, user_index)
    acc = u.float() + x.float() @ w.float()
    return ACTIVATIONS[activation](acc).to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = build.load("mari_matmul")
    if lib.mari_matmul_f32.argtypes is None:
        lib.mari_matmul_f32.argtypes = _ARGTYPES
        lib.mari_matmul_f32.restype = ctypes.c_int
    return lib


def _launch(x: Tensor, w: Tensor, u: Tensor, user_index: Tensor | None,
            mode: str, activation: str) -> Tensor:
    build.refuse_autograd("mari_matmul", x, w, u)
    for name, t in (("x", x), ("w", w), ("u", u)):
        if t.device != x.device:
            raise ValueError(f"mari_matmul: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"mari_matmul CUDA kernel takes float32 only, "
                            f"{name} is {t.dtype} (bf16 is not ported yet)")
    B, K = x.shape
    if w.shape[0] != K or u.ndim != 2 or u.shape[1] != w.shape[1]:
        raise ValueError(f"mari_matmul: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)} do not agree")
    N = w.shape[1]
    x, w, u = x.contiguous(), w.contiguous(), u.contiguous()
    idx = None
    if mode == "gather":
        if user_index.device != x.device:
            raise ValueError("mari_matmul: user_index on another device")
        idx = user_index.to(torch.int32).contiguous()
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out                        # nothing to launch
    lib = _lib()
    with torch.cuda.device(x.device):    # launch in the tensors' context
        rc = lib.mari_matmul_f32(
            x.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if idx is None else idx.data_ptr(), out.data_ptr(),
            B, K, N, u.shape[0], INIT_MODES.index(mode),
            EPILOGUES.index(activation),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "mari_matmul")
    build.count_launch(LAUNCHES, mode)
    return out


def mari_matmul(x: Tensor, w: Tensor, u: Tensor,
                user_index: Tensor | None = None,
                activation: str = "identity") -> Tensor:
    """act(u_init + x (B, K) @ w (K, N)); see the module docstring."""
    if activation not in EPILOGUES:
        raise ValueError(f"unsupported epilogue activation {activation!r}")
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"mari_matmul takes 2-D x and w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    mode = init_mode(x.shape[0], u, user_index)
    if x.device.type == "cpu":
        return mari_matmul_plain(x, w, u, user_index, activation)
    if x.device.type != "cuda":
        raise ValueError(f"mari_matmul: unsupported device {x.device}")
    return _launch(x, w, u, user_index, mode, activation)


def mari_matmul_fused_groups(parts, b=None, *, acc0=None, user_index=None,
                             activation="identity") -> Tensor:
    """act(Σ_g Tile-or-stream(x_g @ w_g) + acc0 + b) for (x, w) pairs.

    Each x is (1, D_g) (user side — folded into the accumulator-init row)
    or (B, D_g) (batched side — one concatenated stream through the
    kernel). ``acc0`` is an optional precomputed partial: a (1, d) row, a
    row-wise (B, d) block, or — with ``user_index`` (B,) — the stacked
    (U, d) per-user table the kernel gathers at accumulator-init load.
    """
    d = parts[0][1].shape[1]
    user = [(x, w) for x, w in parts if x.shape[0] == 1]
    rest = [(x, w) for x, w in parts if x.shape[0] != 1]
    dev = parts[0][1].device

    # the user row stays f32: it seeds the f32 accumulator
    u = torch.zeros((1, d), dtype=torch.float32, device=dev)
    for x, w in user:
        u = u + x.float() @ w.float()
    if acc0 is not None:
        u = u + acc0.float()
    if b is not None:
        u = u + b.float()

    if not rest:  # no batched stream left: the acc-init row IS the output
        out = ACTIVATIONS[activation](u)
        if user_index is not None and acc0 is not None:
            out = take_clip(out, user_index)
        return out.to(parts[0][0].dtype)

    B = max(x.shape[0] for x, _ in rest)
    if len(rest) == 1 and rest[0][0].shape[0] == B:
        # single pre-concatenated stream: no per-call operand copies
        x_rest, w_rest = rest[0]
    else:
        x_rest = torch.cat([x.expand((B,) + tuple(x.shape[1:]))
                            for x, _ in rest], dim=-1)
        w_rest = torch.cat([w for _, w in rest], dim=0)
    gather = user_index if (user_index is not None and acc0 is not None) \
        else None
    return mari_matmul(x_rest, w_rest, u, gather, activation)
