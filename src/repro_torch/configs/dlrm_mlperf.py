"""DLRM MLPerf benchmark config (Criteo 1TB) [arXiv:1906.00091; paper]."""
import functools

from repro_torch.configs._recsys_shapes import RECSYS_SHAPES
from repro_torch.models.recsys import build_dlrm

FAMILY = "recsys"
BUILD = functools.partial(
    build_dlrm, embed_dim=128, bot_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1), n_dense=13)
SHAPES = dict(RECSYS_SHAPES)


def smoke_build():
    return functools.partial(build_dlrm, scale_tables=2e-6,
                             bot_mlp=(32, 16), top_mlp=(64, 32, 1),
                             embed_dim=16)
