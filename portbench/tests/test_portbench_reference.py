"""The plain references against the port's CPU path, at the sizes of
each model's ``smoke_build``: the served engine under the benchmark's
plan (both stages, MaRI-rewritten), and for DIN the single-call serve
program too, on weights and feeds drawn by the benchmark."""
import numpy as np
import pytest
import torch

import portbench_small as small
from portbench import harness, inputs

CPU = torch.device("cpu")


def _feeds(ref, build, n, seed):
    g = inputs.generator(seed, inputs.FEATURES_STREAM, CPU)
    uspec, cspec = ref.feed_specs(build)
    return inputs.draw_rows(uspec, 1, g), inputs.draw_rows(cspec, n, g)


def _ref_scores(ref, params, build, user, cand):
    t = {k: torch.as_tensor(v) for k, v in {**user, **cand}.items()}
    return ref.forward(params, {k: t[k] for k in user},
                       {k: t[k] for k in cand}, build).numpy()


@pytest.mark.parametrize("name", ["din128", "paper"])
def test_reference_matches_served_engine(name):
    from repro_torch.serve import ServePlan, ServeRequest, ServingEngine
    cfg = small.config(name)
    ref = harness.load_file("reference", cfg["model"])
    build = cfg["build"]
    params = inputs.draw_params(ref.param_shapes(build), 7, CPU,
                                **cfg["init"])
    plan = ServePlan.preset(cfg["serve"]["preset"]).evolve(
        **cfg["serve"]["plan"])
    graph, _ = harness.build_graph(cfg)
    eng = ServingEngine(graph, params, plan, device=CPU)
    for i, n in enumerate((1, 37, 300)):
        user, cand = _feeds(ref, build, n, 100 + i)
        got = eng.score(ServeRequest(user_id=i, user_feeds=user,
                                     candidate_feeds=cand)).scores
        want = _ref_scores(ref, params, build, user, cand)
        assert got.shape == want.shape == (n, ref.outputs(build))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    eng.close()


def test_reference_matches_single_call_program():
    import types
    from repro_torch.core.mari import convert_params, mari_rewrite
    from repro_torch.launch.steps import _recsys_serve
    cfg = small.config("din128")
    ref = harness.load_file("reference", "din")
    build = cfg["build"]
    params = inputs.draw_params(ref.param_shapes(build), 8, CPU,
                                **cfg["init"])
    graph, _ = harness.build_graph(cfg)
    prog = _recsys_serve(types.SimpleNamespace(
        BUILD=lambda: harness.build_graph(cfg)), 64, opts=frozenset())
    conv_params = convert_params(mari_rewrite(graph), params)
    user, cand = _feeds(ref, build, 64, 5)
    feeds = {k: torch.as_tensor(v) for k, v in {**user, **cand}.items()}
    got = prog.compiled(CPU)(conv_params, feeds).numpy()
    want = _ref_scores(ref, params, build, user, cand)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_reference_sees_each_layer():
    """Scaling any one weight of the model moves the reference's scores:
    the comparison covers every layer, not one easy part. The one
    exception is the unit's last bias, a constant under the softmax."""
    cfg = small.config("din128")
    ref = harness.load_file("reference", "din")
    build = cfg["build"]
    params = inputs.draw_params(ref.param_shapes(build), 9, CPU,
                                **cfg["init"])
    user, cand = _feeds(ref, build, 50, 6)
    base = _ref_scores(ref, params, build, user, cand)
    leaves = list(inputs._leaves(params))
    assert len(leaves) == 14
    for path, leaf in leaves:
        saved = leaf.clone()
        leaf.mul_(1.5)
        moved = np.abs(_ref_scores(ref, params, build, user, cand)
                       - base).max()
        leaf.copy_(saved)
        if path == ("din_attn", "layer_2", "b"):
            assert moved < 1e-6
        else:
            assert moved > 1e-4, path
