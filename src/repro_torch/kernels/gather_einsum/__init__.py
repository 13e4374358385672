from repro_torch.kernels.gather_einsum.ops import (  # noqa: F401
    KERNEL_SPECS,
    LAUNCHES,
    gather_einsum,
    gather_einsum_plain,
    parse_spec,
    reset_launches,
)
