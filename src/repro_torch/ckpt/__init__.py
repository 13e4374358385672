from repro_torch.ckpt.manager import (CheckpointManager,  # noqa: F401
                                      restore_tree, save_tree)
