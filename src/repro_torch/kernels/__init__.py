"""Hand-written CUDA kernels of the serving path (sources in ``../csrc``):
``mari_matmul``, ``gather_einsum`` and ``dot_interaction``.

Each kernel module holds the wrapper (CPU tensor -> plain PyTorch version;
CUDA tensor -> the kernel, or an error), the plain version, and a
``LAUNCHES`` count of kernel launches."""
