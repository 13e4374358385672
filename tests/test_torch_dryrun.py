"""The port's dry run (``repro_torch.launch.dryrun``), the counterpart of
``tests/test_dryrun_cell.py``: one real cell traced on the 256-rank
production mesh in a subprocess (a fake process group of that size must
never live in this test process), its record held to the reference's keys
and to the reference's specs; the two counting traps of a DTensor trace;
and ``--all``'s resumable results file.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.core.mari import mari_rewrite as j_mari_rewrite
from repro.data.features import feed_specs as j_feed_specs
from repro.graph.executor import init_graph_params as j_init_graph
from repro.launch import steps as jsteps

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KEYS = {"arch", "shape", "mesh", "opts", "kind", "meta", "devices",
        "scan_factor", "memory", "cost", "collectives", "roofline"}


def _run(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, env=env)


@pytest.fixture(scope="module")
def fm_record():
    p = _run(["-m", "repro_torch.launch.dryrun", "--arch", "fm", "--shape",
              "serve_p99", "--mesh", "single"])
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_single_cell_dryrun_subprocess(fm_record):
    rec = fm_record
    assert KEYS <= rec.keys()
    assert rec["devices"] == 256
    assert rec["kind"] == "serve"
    assert rec["scan_factor"] == 1 and rec["trace_s"] >= 0
    assert rec["roofline"]["bottleneck"] in (
        "compute_s", "memory_s", "collective_s")
    assert rec["cost"]["flops_per_device"] > 0
    assert "mari_rewrites" in rec["meta"]
    assert rec["meta"]["captured"] is False
    # the card's own constants, named in the record
    roof = rec["roofline"]
    assert roof["device"].startswith("NVIDIA H100")
    assert (roof["peak_flops_bf16"], roof["hbm_bw"], roof["link_bw"]) == (
        989e12, 3.35e12, 50e9)
    assert roof["collective_s"] == rec["collectives"]["traffic_bytes"] / 50e9
    c = rec["collectives"]
    assert c["traffic_bytes"] == (2 * c["all-reduce"] + c["all-gather"]
                                  + c["reduce-scatter"] + c["all-to-all"]
                                  + c["broadcast"])


def test_argument_bytes_are_the_local_shards_of_the_reference_specs(
        fm_record):
    """``argument_bytes`` equals the sum over the params and feeds of the
    reference's serve program of ceil(dim / axes' size) per dim."""
    try:
        mesh = AbstractMesh((16, 16), ("data", "model"))
    except TypeError:
        mesh = AbstractMesh((("data", 16), ("model", 16)))
    jprog = jsteps.build_cell("fm", "serve_p99", mesh)
    graph, _ = jconfigs.get_config("fm").BUILD()
    graph = j_mari_rewrite(graph).graph
    params = jax.eval_shape(
        lambda: j_init_graph(graph, jax.random.PRNGKey(0)))
    feeds = j_feed_specs(graph, 512, train=False)
    sizes = {"data": 16, "model": 16}

    def local(shape, spec, itemsize):
        n = 1
        for d, size in enumerate(shape):
            entry = spec[d] if d < len(spec) else None
            axes = (() if entry is None else
                    entry if isinstance(entry, tuple) else (entry,))
            n *= -(-size // int(np.prod([sizes[a] for a in axes])))
        return n * itemsize

    p_specs, f_specs = (s.spec for s in jax.tree_util.tree_leaves(
        jprog.in_shardings[0])), (s.spec for s in jax.tree_util.tree_leaves(
            jprog.in_shardings[1]))
    want = sum(local(x.shape, s, np.dtype(x.dtype).itemsize) for x, s in
               zip(jax.tree_util.tree_leaves(params), p_specs))
    want += sum(local(f.shape, s, f.dtype.itemsize) for f, s in
                zip(jax.tree_util.tree_leaves(feeds), f_specs))
    assert fm_record["memory"]["argument_bytes"] == want
    assert fm_record["memory"]["output_bytes"] == 512 // 16 * 4


TRAPS = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import dryrun
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
dryrun._mark_propagation()
fm = FakeTensorMode()
with fm:
    xl, wl = torch.empty(4, 64), torch.empty(64, 4096)
x = DTensor.from_local(xl, mesh, [Shard(0), Shard(1)], run_check=False)
w = DTensor.from_local(wl, mesh, [Replicate(), Shard(0)], run_check=False)
c = dryrun.DeviceCounter()
with fm, c.mode:
    y = x @ w
    z = y.redistribute(mesh, [Shard(0), Replicate()])
print(json.dumps({"flops": c.flops, "shape": list(y.shape),
                  "placements": [str(p) for p in y.placements],
                  "coll": c.collectives(),
                  "local": list(z.to_local().shape)}))
dist.destroy_process_group()
"""


def test_the_two_counting_traps():
    """A (64, 1024) @ (1024, 4096) matmul sharded [Shard(0), Shard(1)] @
    [Replicate(), Shard(0)] on 16x16: a device multiplies (4, 64) by (64,
    4096) — 2·4·64·4096 FLOPs, not the global shape's 2·64·1024·4096, and
    not that twice (DTensor's sharding propagation runs the op on fake
    tensors at the global shape) — and the row-parallel output's
    all-reduce moves its local (4, 4096) fp32 block."""
    p = _run(["-c", TRAPS])
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["shape"] == [64, 4096] and r["local"] == [4, 4096]
    assert r["flops"] == 2 * 4 * 64 * 4096
    assert r["coll"]["all-reduce"] == 4 * 4096 * 4
    assert r["coll"]["count"] == 1
    assert r["coll"]["traffic_bytes"] == 2 * 4 * 4096 * 4


def test_all_writes_a_resumable_results_file(tmp_path):
    """``--all`` over one cell: a record per mesh kind in ``--out``; a
    second run finds them done and traces nothing."""
    out = tmp_path / "res.json"
    args = ["-m", "repro_torch.launch.dryrun", "--all", "--arch", "fm",
            "--shape", "serve_p99", "--mesh", "single", "--out", str(out)]
    p = _run(args)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    recs = json.loads(out.read_text())
    assert [(r["arch"], r["shape"], r["mesh"]) for r in recs] == [
        ("fm", "serve_p99", "single")]
    assert "error" not in recs[0] and recs[0]["devices"] == 256
    p = _run(args)
    assert p.returncode == 0 and "×" not in p.stdout
    assert json.loads(out.read_text()) == recs


def test_a_cell_fails_without_the_fake_group_hint_being_lost():
    """Without a group of 256 ranks the production mesh refuses, naming
    how the dry run makes its fake group."""
    p = _run(["-c", "from repro_torch.launch.mesh import "
              "make_production_mesh; make_production_mesh(device_type="
              "'cpu')"])
    assert p.returncode != 0 and "FakeStore" in p.stderr


REFUSE = r"""
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.kernels.embedding_bag import embedding_bag_fixed
from repro_torch.kernels.mari_matmul import mari_matmul
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
fm = FakeTensorMode()
with fm:
    table, ids = torch.empty(4096, 8), torch.zeros(2, 3, dtype=torch.int64)
    x, w, u = torch.empty(4, 64), torch.empty(64, 8), torch.empty(1, 8)
t = DTensor.from_local(table, mesh, [Replicate(), Shard(0)], run_check=False)
i = DTensor.from_local(ids, mesh, [Shard(0), Replicate()], run_check=False)
xs = DTensor.from_local(x, mesh, [Shard(0), Replicate()], run_check=False)
wr = DTensor.from_local(w, mesh, [Replicate(), Replicate()], run_check=False)
ws = DTensor.from_local(w, mesh, [Replicate(), Shard(1)], run_check=False)
ur = DTensor.from_local(u, mesh, [Replicate(), Replicate()], run_check=False)
with fm:
    for call in (lambda: embedding_bag_fixed(t, i),
                 lambda: mari_matmul(xs, ws, ur)):
        try:
            call()
        except ValueError as e:
            print("refused:", e)
    out = mari_matmul(xs, wr, ur)
print("ok", list(out.shape), tuple(out.placements) == (Shard(0), Replicate()))
dist.destroy_process_group()
"""


def test_a_kernel_refuses_a_placement_it_cannot_run_shard_local():
    """On 16 x 16 fake ranks: a vocab-sharded table under
    ``embedding_bag_fixed`` and a column-sharded weight under
    ``mari_matmul`` raise naming the op; candidate rows over 'data' with
    replicated weights run shard-local (64 rows, laid out as x)."""
    p = _run(["-c", REFUSE])
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stdout.strip().splitlines()
    refused = [ln for ln in lines if ln.startswith("refused:")]
    assert len(refused) == 2
    assert "embedding_bag_fixed" in refused[0] and "'table'" in refused[0]
    assert "mari_matmul" in refused[1] and "'w'" in refused[1]
    assert lines[-1] == "ok [64, 8] True"
