"""Hand-written CUDA kernels (sources in ``../csrc``): ``mari_matmul``,
``gather_einsum``, ``dot_interaction``, ``din_attention`` and
``embedding_bag``.

Each kernel module holds the wrapper (CPU tensor -> plain PyTorch version;
CUDA tensor -> the kernel, or an error), the plain version, and a
``LAUNCHES`` count of kernel launches. Every kernel takes fp32 or bf16
tensors of one dtype (bf16: f32 products and sums, the output rounded
once, as the TPU kernels), counted under ``.../bf16``. No kernel has a backward: on a CUDA
tensor each wrapper raises when grad mode is on and an input requires
grad."""

_KERNELS = ("mari_matmul", "gather_einsum", "dot_interaction",
            "din_attention", "embedding_bag")


def _modules():
    import importlib
    return {name: importlib.import_module(f"repro_torch.kernels.{name}")
            for name in _KERNELS}


def read_launches() -> dict[str, int]:
    """Every wrapper's launch counts in this process, keyed
    ``"<kernel>/<entry>"`` (counts are per process: a worker reports its
    own)."""
    return {f"{name}/{k}": n for name, mod in _modules().items()
            for k, n in mod.LAUNCHES.items()}


def reset_launches() -> None:
    """Zero every wrapper's counts (``mari_matmul``'s ``PREPARES`` and
    ``STRIDE_COPIES`` too)."""
    for mod in _modules().values():
        mod.reset_launches()
