"""Small shared utilities: device resolution, init on a torch.Generator,
shape math, and the numpy bridge that moves the reference's params and
feeds into tensors."""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

PyTree = Any


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device the process lacks.

    Entry points default to ``"cuda"``; a missing card is an error, never a
    silent move to the CPU (CPU runs pass ``device="cpu"`` explicitly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False (torch {torch.__version__}); pass device='cpu' to run on "
            f"the CPU")
    return dev


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device``: full-width tables are
    drawn where they live, never built on the host and copied over."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def glorot(gen: torch.Generator, shape: tuple[int, ...],
           dtype=torch.float32) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return u * (2 * lim) - lim


def normal_init(gen: torch.Generator, shape: tuple[int, ...],
                stddev: float = 0.02, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * stddev


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def prev_pow2(n: int) -> int:
    """Largest power of two <= n (requires n >= 1)."""
    return 1 << (n.bit_length() - 1)


def tree_map(fn, tree: PyTree) -> PyTree:
    """Map ``fn`` over the leaves of a nested dict."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: PyTree, device: str | torch.device = "cuda"
                      ) -> PyTree:
    """Nested dict of numpy arrays (the reference's params after
    ``np.asarray``) -> the same nesting of tensors on ``device`` (copies:
    the port never writes through to the caller's arrays)."""
    dev = resolve_device(device)
    return tree_map(lambda x: torch.tensor(np.asarray(x), device=dev), tree)


def feeds_from_numpy(feeds: Mapping[str, Any],
                     device: str | torch.device = "cuda"
                     ) -> dict[str, torch.Tensor]:
    """Flat feed dict of numpy arrays -> tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), device=dev)
            for k, v in feeds.items()}


def take_clip(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows ``x[index]`` with out-of-range indices clamped to
    ``[0, len(x) - 1]`` — ``jnp.take(..., mode="clip")``. torch raises on an
    out-of-range index (device-asserts on CUDA), so clamp first."""
    return torch.index_select(x, 0, index.clamp(0, x.shape[0] - 1))
