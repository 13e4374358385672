"""The work counts against numbers worked by hand, one pack or call of
each cell (fp32: 4 bytes a value; peaks 165 TFLOP/s and 3.35 TB/s)."""
import pytest

from portbench import harness

PAPER = harness.load_config("paper")["build"]
DIN = harness.load_config("din128")["build"]
PEAKS = harness.load_json(harness.HERE / "peaks.json")


def least(ops):
    return sum(max(f / PEAKS["flops_per_s"], b / PEAKS["bytes_per_s"])
               for f, b in ops)


def test_paper_expert_fc0_stream_at_4096_rows():
    work = harness.load_file("work", "paper")
    ops = work.kernel_work(PAPER, "two_stage", 4096, 3)["mari_matmul"]
    # q proj, 4 experts' fc0, 2 gates, 2 task towers' fc0
    assert len(ops) == 9
    flops, nbytes = ops[1]
    assert flops == 2 * 4096 * 1064 * 512
    # x 4096 x 1064, W 1064 x 512, 3 user rows and the bias of 512,
    # out 4096 x 512, the row index
    assert nbytes == 4 * (4096 * 1064 + 1064 * 512 + 3 * 512 + 512
                          + 4096 * 512 + 4096)
    # bound by operations: 27.05 us against 8.37 us of bytes
    assert flops / 165e12 == pytest.approx(27.0469e-6, rel=1e-4)
    assert least([ops[1]]) == flops / 165e12
    assert ops[0][0] == 2 * 4096 * 500 * 64          # query projection
    assert ops[5][0] == 2 * 4096 * 1064 * 4          # a gate
    assert ops[7][0] == 2 * 4096 * 256 * 128         # a task tower


def test_paper_model_flops():
    work = harness.load_file("work", "paper")
    # 2*500*64 + 4*2*1064*512 + 2*2*1064*4 + 2*2*256*128 (MaRI sites)
    # + 2*2*128*64 (attention) + 4*2*512*256 (expert fc1)
    # + 2*(2*4*256 + 2*128*64 + 2*64) (mix, tower fc1, logit)
    assert work.candidate_flops(PAPER) == (
        64000 + 4358144 + 17024 + 131072 + 32768 + 1048576 + 37120)
    # tower 2*4000*256 + 2*256*256; keys and values 2*2*128*64*64;
    # profile projection 2*4000*64; user sides of the sites
    # 2*64*64 + 4*2*256*512 + 2*2*256*4 + 2*2*256*128
    assert work.user_flops(PAPER) == (
        2048000 + 131072 + 2097152 + 512000
        + 8192 + 1048576 + 4096 + 131072)


def test_din_two_stage_pack():
    work = harness.load_file("work", "din")
    w = work.kernel_work(DIN, "two_stage", 4096, 2)
    (qt_f, qt_b), (pool_f, pool_b) = w["gather_einsum"]
    assert qt_f == 2 * 4096 * 100 * 128 * 80          # bd,uldh->blh
    assert qt_b == 4 * (4096 * 128 + 2 * 100 * 128 * 80
                        + 4096 * 100 * 80 + 4096)
    assert pool_f == 2 * 4096 * 100 * 128             # bl,uld->bd
    assert pool_b == 4 * (4096 * 100 + 2 * 100 * 128 + 4096 * 128 + 4096)
    # bd,uldh->blh by operations: 50.84 us (bytes: 40.4 us)
    assert least([(qt_f, qt_b)]) == pytest.approx(50.84e-6, rel=1e-3)
    (mm_f, mm_b), = w["mari_matmul"]
    assert mm_f == 2 * 4096 * 268 * 200
    assert mm_b == 4 * (4096 * 268 + 268 * 200 + 2 * 200 + 200
                        + 4096 * 200 + 4096)


def test_din_single_call_at_262144_rows():
    work = harness.load_file("work", "din")
    w = work.kernel_work(DIN, "single_call", 262144, 1)
    (f, b), = w["din_attention"]
    per_row = (2 * 128 * 80 + 2 * 100 * 128 * 80 + 2 * 100 * 80 * 40
               + 2 * 100 * 40 + 2 * 100 * 128)
    assert per_row == 2742080
    assert f == 262144 * per_row + 2 * 100 * 128 * 80
    weights = 512 * 80 + 80 + 80 * 40 + 40 + 40 + 1
    assert b == 4 * (2 * 262144 * 128 + 100 * 128 + weights)
    # 4.357 ms by operations
    assert least([(f, b)]) == pytest.approx(4.3566e-3, rel=1e-4)
    assert work.candidate_flops(DIN) == per_row + 2 * 268 * 200 + (
        2 * 200 * 80 + 2 * 80)
    assert work.user_flops(DIN) == 2 * 100 * 128 * 80 + 2 * 36 * 200
