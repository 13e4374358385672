from repro_torch.kernels.embedding_bag.ops import (  # noqa: F401
    LAUNCHES,
    VARIANTS,
    embedding_bag,
    embedding_bag_fixed,
    embedding_bag_fixed_plain,
    embedding_bag_plain,
    reset_launches,
)
