"""``repro_torch.launch.cell_turns`` on the CPU: its turn's code runs a
cell end to end (the card's device and calls swapped for the CPU's), and
the tool refuses to time without a card. jax-free."""
import json

import torch

from repro_torch.launch import cell_turns


def test_turn_code_runs_a_cell(capsys, monkeypatch):
    code = (cell_turns.TURN
            .replace('torch.device("cuda", 0)', 'torch.device("cpu")')
            .replace("torch.cuda.synchronize()", "pass")
            .replace("torch.cuda.get_device_name(0)", '"cpu"'))
    assert code.count('"cpu"') == 2 and "torch.cuda" not in code
    monkeypatch.setattr("sys.argv", ["turn", json.dumps(
        ["fm", "serve_p99", [], 2])])
    exec(compile(code, "turn", "exec"), {})
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rec["ms"]) == 2 and rec["p50_ms"] > 0
    assert rec["device_busy_ms"] == 0.0 and rec["device"] == "cpu"
    assert rec["out_sum"] == rec["out_sum"]                  # finite


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        return
    assert cell_turns.main(["--arch", "fm", "--shape", "serve_p99"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
