"""The paper's own coarse-ranking reference model (Fig. 1): MMoE +
cross-attention + task towers, Table-2 dimension regime."""
import functools

from repro_torch.configs._recsys_shapes import RECSYS_SHAPES
from repro_torch.models.ranking import PaperRankingConfig, build_paper_ranking_model

FAMILY = "recsys"
CONFIG = PaperRankingConfig()
BUILD = functools.partial(build_paper_ranking_model, CONFIG)
SHAPES = dict(RECSYS_SHAPES)


def smoke_build():
    return functools.partial(build_paper_ranking_model, CONFIG.scaled(0.03))
