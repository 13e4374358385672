"""Functional NN layers on tensors (port of ``repro.nn.layers``; params are
plain dicts of tensors)."""
from __future__ import annotations

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
    """y = x @ w (+ b). w: (D_in, D_out)."""
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y
