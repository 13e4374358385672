"""Granite MoE 3B-A800M [hf:ibm-granite]: 32L d1536 24H(kv8) ff512 v49155,
MoE 40 experts top-8 (fine-grained experts)."""
from repro_torch.configs._lm_shapes import lm_shapes
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
CONFIG = LMConfig(
    name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
    n_kv_heads=8, d_ff=512, vocab=49155, head_dim=64,
    moe_experts=40, moe_top_k=8, rope_theta=1e4)
SHAPES = lm_shapes(sub_quadratic=False)


def smoke_config() -> LMConfig:
    return CONFIG.scaled_down()
