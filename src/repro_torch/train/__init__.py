"""Training (port of ``repro.train``): losses, optimizers, the loop."""
from repro_torch.train.losses import auc, bce_with_logits, softmax_xent  # noqa: F401
from repro_torch.train.optim import (Optimizer, WarmupCosine,  # noqa: F401
                                     adafactor, adam, adamw, apply_updates,
                                     clip_by_global_norm, sgd)
