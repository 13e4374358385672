"""DIN [arXiv:1706.06978; paper]: embed 18, behaviour seq 100,
attention MLP 80-40, fusion MLP 200-80."""
import functools

from repro_torch.configs._recsys_shapes import RECSYS_SHAPES
from repro_torch.models.recsys import build_din

FAMILY = "recsys"
BUILD = functools.partial(build_din, embed_dim=18, seq_len=100,
                          attn_mlp=(80, 40), mlp=(200, 80),
                          item_vocab=10_000_000)
SHAPES = dict(RECSYS_SHAPES)


def smoke_build():
    return functools.partial(build_din, embed_dim=8, seq_len=12,
                             attn_mlp=(16, 8), mlp=(24, 12), item_vocab=128)
