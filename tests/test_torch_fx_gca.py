"""GCA over a traced PyTorch function (``repro_torch.core.fx_gca``, the
counterpart of ``repro.core.jaxpr_gca``) held against ``detect_in_jaxpr`` on
the same functions written in JAX; the detector over the port's own
executor on the paper model; and the two ported examples
(``repro_torch.examples.gca_demo`` and ``serve_ranking``) run on the CPU as
a user runs them.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.fx.experimental.proxy_tensor import make_fx

from repro.core import detect_in_jaxpr
from repro_torch.core import Color, detect_in_fx, run_gca
from repro_torch.core.fx_gca import MATMUL_OPS, TRANSPARENT_OPS
from repro_torch.data.features import make_recsys_feeds
from repro_torch.examples.gca_demo import my_model as t_my_model
from repro_torch.graph.executor import Executor, init_graph_params
from repro_torch.models.ranking import (PaperRankingConfig,
                                        build_paper_ranking_model)

ROOT = os.path.join(os.path.dirname(__file__), "..")
DOMAINS = {"user_x": "user", "item_x": "item"}


def _j_feeds():
    return {"user_x": jnp.zeros((1, 4)), "item_x": jnp.zeros((5, 4))}


def _t_feeds():
    return {"user_x": torch.zeros(1, 4), "item_x": torch.zeros(5, 4)}


def _j_concat(feeds):
    return jnp.concatenate(
        [jnp.broadcast_to(feeds["user_x"], (feeds["item_x"].shape[0], 4)),
         feeds["item_x"]], -1)


def _t_concat(feeds):
    return torch.cat([feeds["user_x"].expand(feeds["item_x"].shape[0], 4),
                      feeds["item_x"]], -1)


def _same_report(trep, jrep):
    assert len(trep.mixed_concats) == len(jrep.mixed_concats)
    assert len(trep.eligible) == len(jrep.eligible)
    assert [e.rhs_shape for e in trep.eligible] == \
        [e.rhs_shape for e in jrep.eligible]
    assert [e.lhs_shape for e in trep.eligible] == \
        [e.lhs_shape for e in jrep.eligible]
    # jax flattens a dict in sorted key order, torch in insertion order;
    # the two packages' Color enums are distinct classes
    assert sorted(c.name for c in trep.colors_in.values()) == \
        sorted(c.name for c in jrep.colors_in.values())


# -- TestJaxprGCA (tests/test_mari_core.py), written in torch ------------------

def test_detects_matmul():
    jrep = detect_in_jaxpr(lambda p, f: jax.nn.relu(_j_concat(f) @ p["w"]),
                           DOMAINS, {"w": jnp.zeros((8, 3))}, _j_feeds())
    trep = detect_in_fx(lambda p, f: torch.relu(_t_concat(f) @ p["w"]),
                        DOMAINS, {"w": torch.zeros(8, 3)}, _t_feeds())
    _same_report(trep, jrep)
    assert len(trep.mixed_concats) == 1 and len(trep.eligible) == 1
    assert trep.eligible[0].rhs_shape == (8, 3)
    assert trep.eligible[0].op == "aten.mm"
    assert trep.colors_in == {0: Color.UNCOLORED, 1: Color.YELLOW,
                              2: Color.BLUE}


def test_no_false_positive_after_nonlinearity():
    jrep = detect_in_jaxpr(lambda p, f: jax.nn.relu(_j_concat(f)) @ p["w"],
                           DOMAINS, {"w": jnp.zeros((8, 3))}, _j_feeds())
    trep = detect_in_fx(lambda p, f: torch.relu(_t_concat(f)) @ p["w"],
                        DOMAINS, {"w": torch.zeros(8, 3)}, _t_feeds())
    _same_report(trep, jrep)
    assert len(trep.mixed_concats) == 1 and trep.eligible == []


def test_gca_demo_model_both_ways():
    def j_my_model(params, feeds):
        u = jax.nn.relu(feeds["user_vec"] @ params["wu"])
        z = jnp.concatenate(
            [jnp.broadcast_to(u, (feeds["item_vec"].shape[0], u.shape[-1])),
             feeds["item_vec"]], axis=-1)
        return jax.nn.relu(z @ params["w1"]) @ params["w2"]

    shapes = {"wu": (32, 16), "w1": (48, 64), "w2": (64, 1)}
    fshapes = {"user_vec": (1, 32), "item_vec": (100, 32)}
    doms = {"user_vec": "user", "item_vec": "item"}
    jrep = detect_in_jaxpr(j_my_model, doms,
                           {k: jnp.zeros(s) for k, s in shapes.items()},
                           {k: jnp.zeros(s) for k, s in fshapes.items()})
    trep = detect_in_fx(t_my_model, doms,
                        {k: torch.zeros(s) for k, s in shapes.items()},
                        {k: torch.zeros(s) for k, s in fshapes.items()})
    _same_report(trep, jrep)
    assert len(trep.eligible) == 1
    assert trep.eligible[0].rhs_shape == (48, 64)


def test_linear_after_a_mixed_concat_is_eligible_through_addmm():
    """nn.Linear traces to aten.t + aten.addmm; its parameters are get_attr
    nodes (Uncoloured); the rhs reported is the transposed weight."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(8, 3)
    head = torch.nn.Linear(3, 1)
    rep = detect_in_fx(lambda f: head(torch.relu(lin(_t_concat(f)))),
                       DOMAINS, _t_feeds())
    assert len(rep.mixed_concats) == 1
    assert [(e.op, e.lhs_shape, e.rhs_shape) for e in rep.eligible] == \
        [("aten.addmm", (5, 8), (8, 3))]
    assert rep.colors_in == {0: Color.YELLOW, 1: Color.BLUE}


def test_paths_match_jax_keystr():
    """``domains`` keys are path substrings; the port's paths print as the
    reference's ``jax.tree_util.keystr`` does (jax lists a dict's leaves in
    sorted key order, torch in insertion order)."""
    args = ({"w": np.zeros(1)}, {"user_x": np.zeros(1),
                                 "nested": {"item_x": np.zeros(1)}},
            [np.zeros(1)])
    tp = [pytree.keystr(p) for p, _ in pytree.tree_flatten_with_path(args)[0]]
    jp = [jax.tree_util.keystr(p)
          for p, _ in jax.tree_util.tree_flatten_with_path(args)[0]]
    assert sorted(tp) == sorted(jp)


def test_op_sets_are_overload_packets():
    for op in list(TRANSPARENT_OPS) + list(MATMUL_OPS):
        assert isinstance(op, torch._ops.OpOverloadPacket), op


# -- the detector over the port's executor on the paper model ------------------

def _weight_leaves(fn, args, report):
    """The param path of each eligible matmul's weight: the report's node
    indices on the same trace, the rhs walked back to its placeholder."""
    gm = make_fx(lambda *a: fn(*a), tracing_mode="fake",
                 _allow_non_fake_inputs=True)(*args)
    calls = [n for n in gm.graph.nodes if n.op == "call_function"]
    ph = [n for n in gm.graph.nodes if n.op == "placeholder"]
    paths = {n: pytree.keystr(p) for n, (p, _) in
             zip(ph, pytree.tree_flatten_with_path(args)[0])}
    out = []
    for e in report.eligible:
        n = calls[e.node_index]
        rhs = n.args[MATMUL_OPS[n.target.overloadpacket][1]]
        while rhs.op != "placeholder":
            rhs = rhs.args[0]                 # through t / view / expand
        out.append(paths[rhs])
    return out


def test_paper_model_executor_every_eligible_dense_and_nothing_else():
    graph, _ = build_paper_ranking_model(PaperRankingConfig().scaled(0.05))
    params = init_graph_params(graph, seed=0, device="cpu")
    feeds = {k: torch.as_tensor(v) for k, v in
             make_recsys_feeds(graph, 16, np.random.default_rng(0)).items()}
    doms = {f"['{n.name}']": n.attrs["domain"] for n in graph.input_nodes()}
    fn = Executor(graph, "vani", device="cpu").run
    rep = detect_in_fx(fn, doms, params, feeds)
    gca = run_gca(graph)
    assert len(rep.mixed_concats) == len(gca.boundary_concats)
    # each flagged matmul is a GCA-eligible dense's weight, and each
    # eligible dense is flagged once; nothing behind a nonlinearity
    flagged = _weight_leaves(fn, (params, feeds), rep)
    assert sorted(flagged) == sorted(f"[0]['{d}']['w']"
                                     for d in gca.eligible)
    for e in rep.eligible:
        d = flagged[rep.eligible.index(e)].split("'")[1]
        assert e.rhs_shape == tuple(params[d]["w"].shape)


# -- the two examples, as a user runs them on the CPU --------------------------

@pytest.mark.parametrize("argv", [
    ["repro_torch.examples.gca_demo", "--device", "cpu"],
    ["repro_torch.examples.serve_ranking", "--device", "cpu", "--scale",
     "0.03", "--candidates", "256", "--requests", "8", "--users", "3",
     "--max-batch", "512"],
    ["repro_torch.examples.serve_ranking", "--device", "cpu", "--scale",
     "0.03", "--candidates", "256", "--requests", "8", "--users", "3",
     "--max-batch", "512", "--use-pallas"],
], ids=["gca_demo", "serve_ranking", "serve_ranking_use_pallas"])
def test_example_runs_on_the_cpu(argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "✓" in out.stdout
    if argv[0].endswith("gca_demo"):
        assert "exactly the pre-activation matmul is flagged" in out.stdout
    else:
        assert out.stdout.count("✓") == 4
