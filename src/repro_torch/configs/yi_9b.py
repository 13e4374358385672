"""Yi 9B [arXiv:2403.04652; hf]: llama-arch GQA, 48L d4096 32H(kv4)
ff11008 v64000."""
from repro_torch.configs._lm_shapes import lm_shapes
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
CONFIG = LMConfig(
    name="yi-9b", n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000, head_dim=128, rope_theta=5e6)
SHAPES = lm_shapes(sub_quadratic=False)


def smoke_config():
    return CONFIG.scaled_down()
