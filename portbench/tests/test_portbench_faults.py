"""A run driven past the look for a card (on the CPU, at the sizes of
each model's ``smoke_build``), with the timed path broken underneath:
``correct`` has to come out false for each fault a cell can have, and
true without one. A scoring cell's faults: an answer altered where it is
produced, and half of a batch's rows left out (filled with copies of the
other half's scores). The cells run on one chip: no exchange to leave
out."""
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import portbench_small as small
from portbench import harness

CPU = torch.device("cpu")
METRICS = [{"name": "req_p95_ms", "unit": "ms"},
           {"name": "cands_per_s", "unit": "cands/s"},
           {"name": "setup_s", "unit": "s"}]


def altered(t):
    t = t.clone()
    t[0] += 0.5
    return t


def half_left_out(t):
    t = t.clone()
    h = t.shape[0] // 2
    t[h:2 * h] = t[:h]
    return t


class Broken:
    """A compiled stage whose outputs ``fault`` rewrites."""

    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, *args, **kw):
        out = self.inner(*args, **kw)
        if isinstance(out, dict):
            return {k: self.fault(v) for k, v in out.items()}
        return self.fault(out)


def run(config, mix, fault=None):
    t_start = time.perf_counter()
    system = harness.make_system(small.config(config), mix, 2**32 + 3, 1.5,
                                 CPU)
    if fault is not None:
        if mix["driver"] == "served":
            eng = system.engine
            eng._stage2_run = Broken(eng._stage2_run, fault)
        else:
            system.serve = Broken(system.serve, fault)
    out, notes = harness.execute(system, METRICS, 1, t_start,
                                 check_modules=False)
    assert notes["checked"] >= 1
    return out, notes


CLOSED = dict(small.SERVED, arrivals={"kind": "closed_loop", "clients": 4,
                                     "max_requests": 100000})
CASES = [("din128", small.SERVED), ("paper", small.SERVED),
         ("din128", small.BULK), ("din128", CLOSED),
         ("din128", dict(small.SERVED, check_sample=2,
                         arrivals={"kind": "closed_loop", "clients": 1,
                                   "max_requests": 100000},
                         pool={"kind": "log_uniform", "lo": 1000,
                               "hi": 1000}))]
IDS = ["din128-served", "paper-served", "din128-bulk", "din128-closed-loop",
       "din128-served-bulk"]


@pytest.mark.parametrize("config,mix", CASES, ids=IDS)
def test_sound_run_is_correct(config, mix):
    out, notes = run(config, mix)
    assert out["correct"], out["checks"]
    # set-up warmed every shape the window reached
    assert notes["compiles_in_window"] in (0, [0, 0])
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) >= {"setup_s", "req_p95_ms"}


@pytest.mark.parametrize("fault", [altered, half_left_out],
                         ids=["answer_altered", "half_left_out"])
@pytest.mark.parametrize("config,mix", CASES, ids=IDS)
def test_broken_path_is_not_correct(config, mix, fault):
    out, _ = run(config, mix, fault)
    assert not out["correct"]
    gap = out["checks"]["score_gap"]
    assert gap["value"] > gap["limit"]


def test_closed_loop_keeps_its_clients_busy():
    """A closed loop of ``clients`` never has more requests in flight,
    reaches that many, and holds its longest finished request to the
    reference beside the seeded sample."""
    system = harness.make_system(small.config("din128"), CLOSED, 2**32 + 5,
                                 1.5, CPU)
    bat, inner = system.batcher, system.batcher.submit
    lock, live, most = threading.Lock(), [0], [0]

    def gone(_):
        with lock:
            live[0] -= 1

    def submit(req):
        with lock:
            live[0] += 1
            most[0] = max(most[0], live[0])
        fut = inner(req)
        fut.add_done_callback(gone)
        return fut

    bat.submit = submit
    run = system.window()
    system.release()
    clients = CLOSED["arrivals"]["clients"]
    assert most[0] == clients
    assert len(run.start) > 4 * clients and run.failed == 0
    assert int(np.argmax(run.rows)) in system.kept
    assert 2 <= len(system.kept) <= CLOSED["check_sample"] + 1


def test_modules_loaded_after_the_window_withhold_the_result(monkeypatch):
    """The look for forbidden modules is made again once the reference and
    the readers have run: a module they load keeps the result back."""
    probe = "portbench_forbidden_probe"
    judge = harness.judge

    def loads_a_module(system, **kw):
        monkeypatch.setitem(sys.modules, probe, types.ModuleType(probe))
        return judge(system, **kw)

    monkeypatch.setattr(harness, "FORBIDDEN", (probe,))
    monkeypatch.setattr(harness, "judge", loads_a_module)
    system = harness.make_system(small.config("din128"), small.BULK,
                                 2**32 + 7, 0.5, CPU)
    out, notes = harness.execute(system, METRICS, 1, time.perf_counter())
    assert out is None and notes["forbidden_modules"] == [probe]
