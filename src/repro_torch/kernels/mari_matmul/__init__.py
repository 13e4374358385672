from repro_torch.kernels.mari_matmul.ops import (  # noqa: F401
    LAUNCHES,
    PREPARES,
    STRIDE_COPIES,
    MariWeight,
    aligned_ld,
    empty_stream,
    mari_matmul,
    mari_matmul_fused_groups,
    mari_matmul_plain,
    prepare_mari_params,
    prepare_mari_weight,
    reset_launches,
)
