"""Hand-written CUDA kernels (sources in ``../csrc``): ``mari_matmul``,
``gather_einsum``, ``dot_interaction``, ``din_attention`` and
``embedding_bag``.

Each kernel module holds the wrapper (CPU tensor -> plain PyTorch version;
CUDA tensor -> the kernel, or an error), the plain version, and a
``LAUNCHES`` count of kernel launches. No kernel has a backward: on a CUDA
tensor each wrapper raises when grad mode is on and an input requires
grad."""
