from repro_torch.kernels.mari_matmul.ops import (  # noqa: F401
    LAUNCHES,
    mari_matmul,
    mari_matmul_fused_groups,
    mari_matmul_plain,
    reset_launches,
)
