"""``BENCHMARK.json`` against the benchmark's contract: its keys, names
and units, that every configuration, mix and metric it names has its file
under ``portbench/``, that each cell reports ``setup_s``, another
end-to-end metric and a per-layer metric, that each per-layer metric's
cells report the end-to-end metric it moves, and that a full check of 24
cells fits its time."""
import json
import re

import pytest

from portbench import harness, traffic

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s of compiling
    # a cell, 1200 s spare: 24 cells inside 43200 s
    cells = 24
    total = ((2 + 14 * cells) * (BENCH["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("key", sorted(ENTRY_KEYS))
def test_entries(key):
    names = [e["name"] for e in BENCH[key]]
    assert len(names) == len(set(names))
    for e in BENCH[key]:
        assert set(e) - {"workloads"} == ENTRY_KEYS[key], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for k in ("why", "source", "layer"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]


def test_files_and_cells():
    cfgs = {c["name"]: c for c in BENCH["configs"]}
    for c in cfgs.values():
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        (harness.HERE / "reference" / f"{cfg['model']}.py").stat()
        (harness.HERE / "work" / f"{cfg['model']}.py").stat()
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        traffic.load_mix(w["traffic"])
        used.add(w["config"])
        pairs.add((w["config"], w["traffic"]))
    assert used == set(cfgs)
    assert len(pairs) == len(BENCH["workloads"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        (harness.HERE / "metrics" / f"{m['name']}.py").stat()


def test_each_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        ends = {m["name"] for m in harness.cell_metrics(BENCH, w["name"],
                                                         False)}
        layers = harness.cell_metrics(BENCH, w["name"], True)
        assert "setup_s" in ends and len(ends) >= 2, w["name"]
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in ends, (w["name"], m["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
