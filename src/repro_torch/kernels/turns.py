"""Time builds of one kernel source against each other on one card, in
turns: the machinery of the kernels' ``compare`` tools.

``load_source`` builds a ``.cu`` file (another commit's copy of a
kernel's source, say) with the checkout's flags into the build directory,
cached by its hash; ``take_turns`` times every contender once per turn,
each round in one order and then the reverse (A B C C B A), so a drift of
the card's clock over a round falls on all; ``c_params`` reads the
parameter list of an ``extern "C"`` entry from a source, so a tool can
call an entry whose signature changed between the sources.
"""
from __future__ import annotations

import ctypes
import hashlib
import re
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build


def load_source(name: str, source: Path, defines=()) -> ctypes.CDLL:
    """``source`` (a version of ``csrc/<name>.cu``) built with the
    checkout's flags and ``defines``; ``repro_error_string`` bound."""
    flags = build._flags(defines)
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    lib = build.BUILD_DIR / f"{name}-other-{digest.hexdigest()[:16]}.so"
    if not lib.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *flags, "-o", str(lib),
                        str(source)], check=True, capture_output=True)
    out = ctypes.CDLL(str(lib))
    build.bind(out, {"repro_error_string": ([ctypes.c_int], ctypes.c_char_p)})
    return out


def c_params(source: str, fn: str) -> list[str]:
    """The parameters of ``extern "C"`` function ``fn`` in ``source``'s
    text, one declaration each."""
    body = source[source.index('extern "C" {'):]
    m = re.search(rf"^\w[\w ]*\**\s*{fn}\(([^)]*)\)", body, re.M)
    if m is None:
        raise ValueError(f"no extern \"C\" entry {fn}")
    return [p.strip() for p in m.group(1).split(",")]


def take_turns(launchers: dict, rounds: int, iters: int) -> dict:
    """ms per launch of every contender (name -> fn launching it once), a
    turn being ``iters`` launches enqueued behind a device sleep (CUDA
    events), so no launch leaves the card idle. Returns name -> the ms of
    each of its turns."""
    def turn(fn) -> float:
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    ms = {name: [] for name in launchers}
    order = list(launchers)
    for _ in range(rounds):
        for name in order + order[::-1]:
            ms[name].append(turn(launchers[name]))
    return ms


def summary(ms: dict, first: str) -> dict:
    """Medians of ``take_turns``' result and each contender's median over
    ``first``'s."""
    med = {name: statistics.median(v) for name, v in ms.items()}
    return dict(ms=ms, median_ms=med,
                over_checkout={n: med[n] / med[first] for n in med
                               if n != first})
