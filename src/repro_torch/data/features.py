"""Synthetic feature pipeline for the recsys graphs (port of
``repro.data.features``: ``feed_specs``, ``make_recsys_feeds``,
``make_labels`` and ``fragment_layout``; ``interleaved_spans`` is the
layout loop of the reference's ``benchmarks/run.py`` Table 3).

Generates feeds matching a graph's input nodes: user-side inputs at batch
1, item/cross-side at batch B — the serving contract of Fig. 1. Vocab
sizes are discovered from the consuming embedding nodes so generated ids
are in range. Feeds are numpy arrays drawn from a
``numpy.random.Generator``: the reference draws from ``jax.random``, so
the values differ while shapes, dtypes and id ranges are the same.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.ir import Graph


@dataclasses.dataclass(frozen=True)
class FeedSpec:
    """Shape and dtype of one feed (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple[int, ...]
    dtype: np.dtype


def _vocab_for_input(graph: Graph, input_name: str) -> int | None:
    for n in graph.consumers(input_name):
        if n.op == "embedding":
            return n.attrs["vocab"]
    return None


def feed_specs(graph: Graph, batch: int, train: bool = False
               ) -> dict[str, FeedSpec]:
    """Feed shapes and dtypes, allocating nothing.

    Serving: user inputs at batch 1 (one request, B candidates). Training:
    every example carries its own user -> all inputs at B."""
    specs = {}
    for n in graph.input_nodes():
        dom = n.attrs.get("domain")
        lead = batch if (train or dom != "user") else 1
        shape = (lead,) + tuple(n.attrs["shape"])
        specs[n.name] = FeedSpec(shape,
                                 np.dtype(n.attrs.get("dtype", "float32")))
    return specs


def make_recsys_feeds(graph: Graph, batch: int, rng: np.random.Generator,
                      tile_user: bool = False) -> dict[str, np.ndarray]:
    """Random feeds. ``tile_user=True`` pre-tiles user feeds to B (VanI-style
    data batching — used to benchmark the vanilla path faithfully)."""
    feeds = {}
    for n in graph.input_nodes():
        dom = n.attrs.get("domain")
        lead = batch if (dom != "user" or tile_user) else 1
        shape = (lead,) + tuple(n.attrs["shape"])
        dt = np.dtype(n.attrs.get("dtype", "float32"))
        if dt.kind == "i":
            vocab = _vocab_for_input(graph, n.name) or 1000
            a = rng.integers(0, vocab, shape, dtype=dt)
        else:
            a = rng.standard_normal(shape, dtype=np.float32).astype(dt)
        if dom == "user" and tile_user and lead == batch:
            # identical rows, as replication would produce
            a = np.broadcast_to(a[:1], shape).copy()
        feeds[n.name] = a
    return feeds


def make_labels(batch: int, rng: np.random.Generator, n_tasks: int = 1
                ) -> np.ndarray:
    """(batch, n_tasks) float32 labels, each 1 with probability 0.2."""
    return (rng.random((batch, n_tasks)) < 0.2).astype(np.float32)


def fragment_layout(d_total: int, chunk: int,
                    rng: np.random.Generator | None
                    ) -> list[tuple[str, int]]:
    """Split a D-wide feature span into interleaved user/item chunks of size
    ``chunk`` (last chunk may be smaller) — the §2.4 fragmented layout.
    ``rng=None`` alternates user and item; a ``Generator`` draws each
    chunk's domain with ``rng.choice``."""
    out = []
    doms = ["user", "item"]
    i = 0
    off = 0
    while off < d_total:
        w = min(chunk, d_total - off)
        out.append((doms[i % 2] if rng is None else rng.choice(doms), w))
        off += w
        i += 1
    return out


def interleaved_spans(d_user: int, d_item: int, chunk: int
                      ) -> list[tuple[str, int, int]]:
    """(domain, offset, width) of each chunk of the industrial interleaved
    layout, as the reference's Table 3 benchmark forms them: user and item
    chunks of width ``chunk`` alternate until one side runs out, the other
    side's rest follows."""
    spans, off_u, off_i, turn = [], 0, 0, 0
    while off_u < d_user or off_i < d_item:
        if (turn % 2 == 0 and off_u < d_user) or off_i >= d_item:
            w = min(chunk, d_user - off_u)
            spans.append(("user", off_u, w))
            off_u += w
        else:
            w = min(chunk, d_item - off_i)
            spans.append(("item", off_i, w))
            off_i += w
        turn += 1
    return spans
