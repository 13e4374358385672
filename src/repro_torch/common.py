"""Small shared utilities: device resolution, init on a torch.Generator,
shape math, trees of tensors (map, leaves, sizes, ``value_and_grad``),
``timeit``, and the numpy bridge that moves the reference's params and
feeds into tensors."""
from __future__ import annotations

import time
from typing import Any, Callable, Mapping

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


def tree_map(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    """Map ``fn`` over the leaves of nested dicts, lists and tuples; with
    ``rest``, over the matching leaves of trees of the same structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    """The leaves of nested dicts, lists and tuples, in ``tree_map``'s
    order."""
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template: PyTree, leaves) -> PyTree:
    """A tree shaped like ``template`` holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def tree_size(tree: PyTree) -> int:
    """Total number of scalar elements in a tree of tensors or arrays."""
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def tree_bytes(tree: PyTree) -> int:
    """Total bytes of a tree of tensors or arrays."""
    return sum(int(np.prod(x.shape)) * (x.element_size()
                                        if isinstance(x, torch.Tensor)
                                        else x.dtype.itemsize)
               for x in tree_leaves(tree))


def value_and_grad(fn: Callable[[PyTree], torch.Tensor], params: PyTree
                   ) -> tuple[torch.Tensor, PyTree]:
    """``jax.value_and_grad`` for a scalar ``fn`` of a tree of tensors:
    the value (detached) and the gradient tree, through autograd on
    detached copies, so ``params`` themselves never require grad."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        value = fn(leaves)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(value, flat, allow_unused=True)
    return value.detach(), tree_unflatten(
        leaves, [g if g is not None else torch.zeros_like(t)
                 for g, t in zip(grads, flat)])


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn: Callable[[], Any], *, warmup: int = 2, iters: int = 10
           ) -> dict:
    """Wall-clock a thunk; waits for the card after every call.

    Returns mean/std/p50 (the median)/p99 in microseconds over ``iters``
    runs, as the reference's ``timeit``."""
    for _ in range(warmup):
        fn()
        _synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _synchronize()
        times.append((time.perf_counter() - t0) * 1e6)
    ts = np.asarray(times)
    return {
        "mean_us": float(ts.mean()),
        "std_us": float(ts.std()),
        "p50_us": float(np.percentile(ts, 50)),
        "p99_us": float(np.percentile(ts, 99)),
        "iters": iters,
    }


def params_from_numpy(tree: PyTree, device: str | torch.device = "cuda"
                      ) -> PyTree:
    """Nested dict of numpy arrays (the reference's params after
    ``np.asarray``) -> the same nesting of tensors on ``device`` (copies:
    the port never writes through to the caller's arrays)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _tensor_from_numpy(x, dev), tree)


def feeds_from_numpy(feeds: Mapping[str, Any],
                     device: str | torch.device = "cuda"
                     ) -> dict[str, torch.Tensor]:
    """Flat feed dict of numpy arrays -> tensors on ``device``."""
    dev = resolve_device(device)
    return {k: _tensor_from_numpy(v, dev) for k, v in feeds.items()}


def _tensor_from_numpy(x, device: torch.device) -> torch.Tensor:
    """A copy of array ``x`` on ``device``. numpy has no bfloat16 of its
    own: the reference's bf16 arrays are ``ml_dtypes.bfloat16``, which
    ``torch.tensor`` refuses, so they cross through their 16-bit view and
    keep every bit."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def take_clip(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows ``x[index]`` with out-of-range indices clamped to
    ``[0, len(x) - 1]`` — ``jnp.take(..., mode="clip")``. torch raises on an
    out-of-range index (device-asserts on CUDA), so clamp first."""
    return torch.index_select(x, 0, index.clamp(0, x.shape[0] - 1))
