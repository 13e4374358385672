"""The control on the card, at a size a test run holds: the reference
computed with TF32 on, put in the program's place, fails the limit that
the program's own answers pass (DIN at its ``smoke_build`` sizes but the
published D = 128 and 100 behaviours, so TF32's rounding shows). The
cell-size readings the limits are set from come from
``portbench/control.py``."""
import pytest
import torch

import portbench_small as small
from portbench import harness


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_control_fails_where_the_program_passes(cuda, seed):
    cfg = small.config("din128")
    cfg["build"].update(embed_dim=128, seq_len=100, attn_mlp=[80, 40],
                        mlp=[200, 80], item_vocab=100_000)
    system = harness.make_system(cfg, small.SERVED, seed, 1.5, cuda)
    system.window()
    system.release()
    prog = harness.judge(system)
    ctrl = harness.judge(system, control=True)
    limit = cfg["checks"]["score_gap"]
    assert prog["score_gap"] <= limit < ctrl["score_gap"], (prog, ctrl)
