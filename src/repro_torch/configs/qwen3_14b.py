"""Qwen3 14B [hf:Qwen]: 40L d5120 40H(kv8) ff17408 v151936, qk_norm."""
from repro_torch.configs._lm_shapes import lm_shapes
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
CONFIG = LMConfig(
    name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6)
SHAPES = lm_shapes(sub_quadratic=False)


def smoke_config():
    return CONFIG.scaled_down(qk_norm=True)
