from repro_torch.kernels.din_attention.ops import (  # noqa: F401
    LAUNCHES,
    din_attention,
    din_attention_plain,
    reset_launches,
)
