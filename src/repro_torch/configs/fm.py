"""Factorization Machine [ICDM'10 Rendle; paper]: 39 sparse fields, k=10,
pairwise term via the O(nk) sum-square trick."""
import functools

from repro_torch.configs._recsys_shapes import RECSYS_SHAPES
from repro_torch.models.recsys import build_fm

FAMILY = "recsys"
BUILD = functools.partial(build_fm, n_sparse=39, embed_dim=10,
                          vocab_size=1_000_000, n_user=20)
SHAPES = dict(RECSYS_SHAPES)


def smoke_build():
    return functools.partial(build_fm, n_sparse=8, embed_dim=4,
                             vocab_size=64, n_user=4)
