from repro_torch.kernels.din_attention.ops import (  # noqa: F401
    LAUNCHES,
    PREPARES,
    DinWeights,
    din_attention,
    din_attention_plain,
    prepare_din_params,
    prepare_din_weights,
    reset_launches,
)
