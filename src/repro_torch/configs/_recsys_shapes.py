"""Shared recsys shape set."""

RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "serve", "batch": 262144},
    # one user scored against 1M candidates: candidates ARE the batch dim,
    # the user side is computed once (the paper's B>>1 regime).
    "retrieval_cand": {"kind": "serve", "batch": 1_000_000},
}
