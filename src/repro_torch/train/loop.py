"""Training loop with checkpoint/restart and (simulated) failure handling
(port of ``repro.train.loop``).

The loop drives any ``step_fn(state, batch) -> (state, metrics)`` with a
data iterator, a ``CheckpointManager`` and an optional injected failure:
the restart path is exactly what a preempted worker runs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

from repro_torch.ckpt.manager import CheckpointManager


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    log_every: int = 10


def train_loop(
    step_fn: Callable,
    init_state,
    batches: Iterator,
    ckpt: CheckpointManager,
    cfg: LoopConfig,
    *,
    fail_at: int | None = None,      # inject a crash (tests/drills)
    log: Callable[[str], None] = print,
):
    """Runs to cfg.total_steps, resuming from the newest checkpoint if one
    exists. Returns (state, history)."""
    state = init_state
    start = 0
    if ckpt.latest_step() is not None:
        state, meta = ckpt.restore(init_state)
        start = int(meta["step"]) + 1
        log(f"[loop] resumed from step {meta['step']}")

    history = []
    t0 = time.time()
    for step in range(start, cfg.total_steps):
        batch = next(batches)
        if fail_at is not None and step == fail_at:
            raise RuntimeError(f"injected failure at step {step}")
        state, metrics = step_fn(state, batch)
        if step % cfg.log_every == 0 or step == cfg.total_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **m})
            log(f"[loop] step {step}: " +
                " ".join(f"{k}={v:.5f}" for k, v in m.items()))
        if step % cfg.ckpt_every == 0 and step > 0:
            ckpt.save(step, state)
    ckpt.save(cfg.total_steps - 1, state)
    ckpt.wait()
    log(f"[loop] done {cfg.total_steps - start} steps "
        f"in {time.time() - t0:.1f}s")
    return state, history
