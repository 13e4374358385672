"""DeepSeek 67B [arXiv:2401.02954; hf]: llama-arch, 95L d8192 64H(kv8)
ff22016 v102400."""
from repro_torch.configs._lm_shapes import lm_shapes
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
CONFIG = LMConfig(
    name="deepseek-67b", n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400, head_dim=128, rope_theta=1e4)
SHAPES = lm_shapes(sub_quadratic=False)


def smoke_config():
    return CONFIG.scaled_down()
