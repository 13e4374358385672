"""Graph data (port of ``repro.data.sampler``): synthetic graph
generation, a real fanout neighbor sampler (minibatch GNN training), and
small-molecule batching. numpy, as the reference: for one seed these give
the reference's arrays bit for bit."""
from __future__ import annotations

import dataclasses

import numpy as np


def random_graph(n_nodes: int, n_edges: int, d_feat: int, seed: int = 0,
                 n_classes: int = 16) -> dict[str, np.ndarray]:
    """Random directed graph in edge-index (COO) form with features/labels/
    synthetic 3D positions (SchNet needs coordinates — DESIGN.md §4)."""
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    receivers = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    return {
        "features": rng.standard_normal((n_nodes, d_feat), dtype=np.float32),
        "positions": (rng.standard_normal((n_nodes, 3)) * 3.0).astype(np.float32),
        "senders": senders,
        "receivers": receivers,
        "labels": rng.integers(0, n_classes, n_nodes, dtype=np.int32),
    }


@dataclasses.dataclass
class NeighborSampler:
    """GraphSAGE-style fanout sampling with fixed output shapes (padded) so
    every sampled minibatch replays the same captured step."""

    senders: np.ndarray
    receivers: np.ndarray
    n_nodes: int
    fanouts: tuple[int, ...]

    def __post_init__(self):
        # CSR over incoming edges: receiver -> its senders
        order = np.argsort(self.receivers, kind="stable")
        self._src_sorted = self.senders[order]
        counts = np.bincount(self.receivers, minlength=self.n_nodes)
        self._offsets = np.concatenate([[0], np.cumsum(counts)])

    def max_sample_nodes(self, batch_nodes: int) -> int:
        n, total = batch_nodes, batch_nodes
        for f in self.fanouts:
            n *= f
            total += n
        return total

    def max_sample_edges(self, batch_nodes: int) -> int:
        n, total = batch_nodes, 0
        for f in self.fanouts:
            n *= f
            total += n
        return total

    def sample(self, seed_nodes: np.ndarray, rng: np.random.Generator
               ) -> dict[str, np.ndarray]:
        """Returns padded arrays: nodes (max_nodes,), senders/receivers
        (max_edges,) as LOCAL indices into nodes, edge_mask, node_mask."""
        bs = len(seed_nodes)
        max_n = self.max_sample_nodes(bs)
        max_e = self.max_sample_edges(bs)
        nodes = list(seed_nodes)
        local = {int(n): i for i, n in enumerate(seed_nodes)}
        snd, rcv = [], []
        frontier = list(seed_nodes)
        for f in self.fanouts:
            nxt = []
            for v in frontier:
                lo, hi = self._offsets[v], self._offsets[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(f, deg)
                picks = rng.choice(deg, size=take, replace=False)
                for p in picks:
                    u = int(self._src_sorted[lo + p])
                    if u not in local:
                        local[u] = len(nodes)
                        nodes.append(u)
                        nxt.append(u)
                    snd.append(local[u])
                    rcv.append(local[v])
            frontier = nxt
        n_real_nodes, n_real_edges = len(nodes), len(snd)
        nodes_arr = np.zeros(max_n, np.int32)
        nodes_arr[:n_real_nodes] = nodes
        senders = np.zeros(max_e, np.int32)
        receivers = np.full(max_e, max_n - 1, np.int32)  # pad edges to a sink
        senders[:n_real_edges] = snd
        receivers[:n_real_edges] = rcv
        edge_mask = np.zeros(max_e, bool)
        edge_mask[:n_real_edges] = True
        node_mask = np.zeros(max_n, bool)
        node_mask[:n_real_nodes] = True
        return {"nodes": nodes_arr, "senders": senders, "receivers": receivers,
                "edge_mask": edge_mask, "node_mask": node_mask,
                "n_seed": bs}


def batched_molecules(n_graphs: int, n_nodes: int, n_edges: int, seed: int = 0
                      ) -> dict[str, np.ndarray]:
    """Batch of small molecules flattened into one disjoint graph."""
    rng = np.random.default_rng(seed)
    N, E = n_graphs * n_nodes, n_graphs * n_edges
    offs = np.repeat(np.arange(n_graphs) * n_nodes, n_edges)
    return {
        "atom_types": rng.integers(1, 20, N, dtype=np.int32),
        "positions": (rng.standard_normal((N, 3)) * 2.0).astype(np.float32),
        "senders": (rng.integers(0, n_nodes, E) + offs).astype(np.int32),
        "receivers": (rng.integers(0, n_nodes, E) + offs).astype(np.int32),
        "graph_ids": np.repeat(np.arange(n_graphs), n_nodes).astype(np.int32),
        "energies": rng.standard_normal(n_graphs).astype(np.float32),
    }


def pad_edges(batch: dict, n_edges: int) -> dict:
    """``batch`` with ``senders`` / ``receivers`` / ``edge_mask`` padded to
    ``n_edges`` (a GNN cell's length, a multiple of 1024) with
    ``edge_mask`` False. A batch without ``edge_mask`` (a whole graph)
    gets one, True on every real edge.

    Every masked edge, the sampler's own padding included, then runs from
    node ``j % n_nodes`` to node ``j % n_nodes`` (``j`` its position). A
    masked edge carries nothing wherever it points (its filter is
    multiplied by 0), but the card's deterministic scatter reduces all the
    edges of one node in order, one after the other: the sampler's padding
    (every masked edge from node 0 into its last node) would make two runs
    thousands of edges long."""
    e = len(batch["senders"])
    if e > n_edges:
        raise ValueError(f"{e} edges do not fit in {n_edges}")
    mask = np.concatenate([batch.get("edge_mask", np.ones(e, bool)),
                           np.zeros(n_edges - e, bool)])
    spread = np.arange(n_edges) % len(batch["positions"])
    out = dict(batch, edge_mask=mask)
    for k in ("senders", "receivers"):
        a = batch[k]
        a = np.concatenate([a, np.zeros(n_edges - e, a.dtype)])
        out[k] = np.where(mask, a, spread.astype(a.dtype))
    return out


def sampled_batch(graph: dict, sample: dict) -> dict:
    """A ``NeighborSampler.sample`` as a ``sampled`` cell's batch: the
    graph's features, positions and labels gathered at the sample's nodes
    (seeds first), its local edges and mask."""
    nodes = sample["nodes"]
    return {"features": graph["features"][nodes],
            "positions": graph["positions"][nodes],
            "senders": sample["senders"], "receivers": sample["receivers"],
            "edge_mask": sample["edge_mask"],
            "labels": graph["labels"][nodes]}
