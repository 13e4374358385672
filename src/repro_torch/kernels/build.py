"""Build the hand-written CUDA kernels from ``repro_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
into its own shared library, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds). Libraries land in ``build/repro_torch/`` at the
root of the checkout (listed in ``.gitignore``), named by a hash of the
source and flags, so an edited source rebuilds and an unchanged one is
reused. ``build_all`` starts one ``nvcc`` per stale source, all at once.

No source needs more than these flags: ``mari_matmul.cu`` (wgmma, TMA,
setmaxnreg: the ``sm_90a`` target) encodes its TMA descriptors with the
driver's ``cuTensorMapEncodeTiled``, which it reaches through the runtime's
``cudaGetDriverEntryPoint(ByVersion)``, so no library links ``-lcuda``; no
source includes CUTLASS or PyTorch headers.

Nothing here runs at import time: the CPU tests import every module, and
the CPU machine has no ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("mari_matmul", "gather_einsum", "dot_interaction",
           "din_attention", "embedding_bag")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_count_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build from source at first use")


def _flags(defines=()) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines=()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=SOURCES, defines=()) -> dict[str, Path]:
    """Compile every stale source in ``names`` (one ``nvcc`` each, started
    together); returns name -> library path. ``defines`` (macro names, none
    by default) build a source's variant that ``chip_smoke.py`` times
    beside it. The compiler's ``-Xptxas=-v`` report (registers, shared
    memory, spills) goes to ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n, defines) for n in names}
    procs = []
    for name, lib in paths.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        log = open(lib.with_suffix(".log"), "w")
        cmd = [nvcc_path(), *_flags(defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, lib, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (rc={rc}, see {lib.with_suffix('.log')}):\n"
                          + lib.with_suffix(".log").read_text()[-4000:])
            continue
        os.replace(tmp, lib)          # atomic: a reader never sees half a .so
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str, defines=(), signatures=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with ``defines``),
    building it if needed, with ``signatures`` bound (``bind``). Every
    source exports ``repro_error_string(int)`` beside its launchers."""
    key = (name, tuple(defines))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_all((name,), defines)[name]))
            bind(lib, {"repro_error_string": ([ctypes.c_int],
                                              ctypes.c_char_p)})
            _loaded[key] = lib
        if signatures:
            bind(lib, signatures)
        return lib


def bind(lib: ctypes.CDLL, signatures) -> None:
    """Set ``argtypes`` / ``restype`` of each exported function named in
    ``signatures`` (name -> (argtypes, restype)) that has none yet: a
    pointer or stream as ``c_void_p``, never the default 32-bit int."""
    for fn, (argtypes, restype) in signatures.items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes, f.restype = list(argtypes), restype


_recording = threading.local()


def count_launch(launches: dict[str, int], key: str) -> None:
    """Add one to ``launches[key]``: the serving batchers launch kernels
    from one worker thread per scenario, so the increment takes a lock.
    Inside ``recording_launches`` on this thread (a CUDA graph capture,
    which runs nothing on the card) the launch is recorded instead."""
    rec = getattr(_recording, "log", None)
    if rec is not None:
        rec.append((launches, key))
        return
    with _count_lock:
        launches[key] += 1


@contextlib.contextmanager
def recording_launches():
    """Record, not count, this thread's ``count_launch`` calls inside the
    block; yields the list of ``(counts dict, key)`` recorded, which
    ``add_launches`` counts once per replay of what was captured."""
    prev = getattr(_recording, "log", None)
    _recording.log = log = []
    try:
        yield log
    finally:
        _recording.log = prev


def add_launches(recorded) -> None:
    """Count every ``(counts dict, key)`` of ``recorded`` once."""
    if recorded:
        with _count_lock:
            for launches, key in recorded:
                launches[key] += 1


def refuse_autograd(what: str, *tensors) -> None:
    """Raise when grad mode is on and an input requires grad: no kernel
    here has a backward, and a kernel's output would leave the gradient
    out without a word. Training runs the plain versions
    (``use_pallas=False``), as the reference's does."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, and an input "
            f"requires grad; run under torch.no_grad() / "
            f"torch.inference_mode(), or with use_pallas=False to train")


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def one_dtype(what: str, **tensors) -> torch.dtype:
    """The one dtype of ``tensors`` (None skipped), float32 or bfloat16;
    ``TypeError`` on a mix or on another type, as the kernels take either
    type throughout (accumulating in f32) and nothing in between."""
    dts = {n: t.dtype for n, t in tensors.items() if t is not None}
    kinds = set(dts.values())
    if len(kinds) != 1 or next(iter(kinds)) not in KERNEL_DTYPES:
        got = ", ".join(f"{n} {str(d).removeprefix('torch.')}"
                        for n, d in dts.items())
        raise TypeError(f"{what} CUDA kernel takes float32 or bfloat16 "
                        f"tensors of one dtype, got {got}")
    return kinds.pop()


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg}) at launch")
