from repro_torch.kernels.dot_interaction.ops import (  # noqa: F401
    LAUNCHES,
    VARIANTS,
    copy_route,
    dot_interaction,
    dot_interaction_plain,
    n_pairs,
    reset_launches,
    smem_bytes,
)
