"""Mixtral 8x7B [arXiv:2401.04088; hf]: 32L d4096 32H(kv8) ff14336 v32000,
MoE 8 experts top-2, sliding-window attention (window 4096)."""
from repro_torch.configs._lm_shapes import lm_shapes
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
CONFIG = LMConfig(
    name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, head_dim=128, window=4096,
    moe_experts=8, moe_top_k=2, rope_theta=1e6)
# SWA => sub-quadratic decode: long_500k runs with a ring-buffer KV cache.
SHAPES = lm_shapes(sub_quadratic=True)


def smoke_config() -> LMConfig:
    return CONFIG.scaled_down()
