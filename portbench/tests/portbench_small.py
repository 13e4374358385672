"""Small configurations and mixes of the benchmark's own shape, for the
CPU tests: the sizes of each model's ``smoke_build`` in
``repro_torch.configs``, the plans and checks of the real files."""
from __future__ import annotations

import copy
import dataclasses

from portbench import harness

DIN = dict(embed_dim=8, seq_len=12, attn_mlp=[16, 8], mlp=[24, 12],
           item_vocab=128, user_profile_dim=36, context_dim=12)


def paper_sizes() -> dict:
    from repro_torch.configs.paper_ranking import CONFIG
    d = dataclasses.asdict(CONFIG.scaled(0.03))
    return {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}


def config(name: str) -> dict:
    cfg = copy.deepcopy(harness.load_config(name))
    cfg["build"] = dict(DIN) if cfg["model"] == "din" else paper_sizes()
    cfg["serve"]["plan"].update({"batch__max_batch": 256,
                                 "batch__min_bucket": 32,
                                 "cache__max_cached_users": 64})
    return cfg


SERVED = {"driver": "served",
          "arrivals": {"kind": "poisson", "rate_per_s": 40},
          "pool": {"kind": "log_uniform", "lo": 20, "hi": 300},
          "users": {"kind": "fresh"}, "user_feature_sets": 16,
          "candidate_rows": 2000, "check_sample": 8}
BULK = {"driver": "bulk", "rows": 512, "feed_ring": 3, "check_sample": 2}
