"""Functional NN layers on tensors (port of ``repro.nn.layers``; params are
plain dicts of tensors)."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# jax.nn.gelu defaults to the tanh approximation; F.gelu does not.
ACTIVATIONS: dict[str, Callable[[Tensor], Tensor]] = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


def dense_apply(params: dict, x: Tensor) -> Tensor:
    """y = x @ w (+ b). w: (D_in, D_out). Mixed dtypes (bf16 embeddings
    into f32 layers) promote as ``jnp.matmul`` does."""
    w = params["w"]
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = x @ w
    if "b" in params:
        y = y + params["b"]
    return y


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm: the mean square in fp32, its ``rsqrt`` cast back to
    ``x.dtype`` before the multiply, then the scale (the reference's order,
    which sets the bf16 bits)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


@dataclasses.dataclass(frozen=True)
class RMSNorm:
    dim: int
    eps: float = 1e-6

    def init(self, dtype=torch.float32, device="cuda") -> dict:
        return {"scale": torch.ones((self.dim,), dtype=dtype, device=device)}

    def apply(self, params: dict, x: Tensor) -> Tensor:
        return rms_norm(x, params["scale"], self.eps)
