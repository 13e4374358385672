"""DeepFM [arXiv:1703.04247; paper]: 39 fields, k=10, deep MLP 400-400-400."""
import functools

from repro_torch.configs._recsys_shapes import RECSYS_SHAPES
from repro_torch.models.recsys import build_deepfm

FAMILY = "recsys"
BUILD = functools.partial(build_deepfm, n_sparse=39, embed_dim=10,
                          mlp=(400, 400, 400), vocab_size=1_000_000, n_user=20)
SHAPES = dict(RECSYS_SHAPES)


def smoke_build():
    return functools.partial(build_deepfm, n_sparse=8, embed_dim=4,
                             mlp=(32, 32), vocab_size=64, n_user=4)
