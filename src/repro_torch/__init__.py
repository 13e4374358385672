"""PyTorch/CUDA port of ``repro``: two-stage MaRI serving on an NVIDIA H100.

Module names mirror ``repro`` so each counterpart is easy to find. The
package imports torch and numpy, never jax and nothing of ``repro``; the
hand-written CUDA kernels under ``csrc/`` are built from source at first
use (``repro_torch.kernels.build``).
"""
