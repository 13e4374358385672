"""The port's training slice (``repro_torch.train``, ``ckpt``,
``launch.train``, ``examples``) held against the JAX reference on the
CPU: the same numpy inputs through both packages.

Tolerances: fp32 rtol = atol = 2e-4 (tests/test_kernels.py); gradients
within 2e-4 of each leaf's max |g| (the reference sums in another order);
optimizer updates at rtol = 1e-5, since both run the same elementwise
formulas in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.executor import Executor as JExecutor
from repro.graph.executor import init_graph_params as j_init
from repro.models.recsys import build_din as j_din
from repro.train import losses as jlosses
from repro.train import optim as joptim
from repro_torch.ckpt.manager import CheckpointManager, restore_tree, save_tree
from repro_torch.common import (params_from_numpy, timeit, tree_bytes,
                                tree_leaves, tree_map, tree_size,
                                value_and_grad)
from repro_torch.data.features import make_labels, make_recsys_feeds
from repro_torch.graph.executor import Executor as TExecutor
from repro_torch.models.recsys import build_din as t_din
from repro_torch.train import losses as tlosses
from repro_torch.train import optim as toptim
from repro_torch.train.loop import LoopConfig, train_loop

TOL = dict(rtol=2e-4, atol=2e-4)
OPT_TOL = dict(rtol=1e-5, atol=1e-6)
DIN_SMOKE = dict(embed_dim=8, seq_len=12, attn_mlp=(16, 8), mlp=(24, 12),
                 item_vocab=128)       # configs/din.py smoke_build widths


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_tree_close(got, want, **tol):
    """``got`` a tree of tensors, ``want`` the reference's tree."""
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(tree_leaves(got))
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_allclose(node.detach().numpy(), np.asarray(leaf),
                                   err_msg=jax.tree_util.keystr(path), **tol)


# -- gradients through the executor -----------------------------------------

def test_din_vani_loss_gradient_matches_jax_grad():
    """The VanI BCE loss of DIN (smoke build) and its gradient through the
    port's executor against ``jax.value_and_grad`` of the reference's."""
    jg, tg = j_din(**DIN_SMOKE)[0], t_din(**DIN_SMOKE)[0]
    jp = j_init(jg, jax.random.PRNGKey(0))
    tp = params_from_numpy(_np_tree(jp), "cpu")
    rng = np.random.default_rng(1)
    feeds = make_recsys_feeds(tg, 24, rng, tile_user=True)
    labels = make_labels(24, rng, len(tg.outputs))
    labels[:3] = 1.0                       # both classes present
    jex, tex = JExecutor(jg, "vani"), TExecutor(tg, "vani", device="cpu")

    def j_loss(p):
        out = jex.run(p, {k: jnp.asarray(v) for k, v in feeds.items()})
        return jlosses.bce_with_logits(
            jnp.concatenate([out[o] for o in jg.outputs], -1), labels)

    def t_loss(p):
        out = tex.run(p, feeds)
        return tlosses.bce_with_logits(
            torch.cat([out[o] for o in tg.outputs], -1), _t(labels))

    j_val, j_grads = jax.value_and_grad(j_loss)(jp)
    t_val, t_grads = value_and_grad(t_loss, tp)
    np.testing.assert_allclose(float(t_val), float(j_val), **TOL)
    assert not any(t.requires_grad for t in tree_leaves(tp))
    for path, leaf in jax.tree_util.tree_leaves_with_path(j_grads):
        node = t_grads
        for k in path:
            node = node[k.key]
        want = np.asarray(leaf)
        scale = float(np.abs(want).max())
        err = float(np.abs(node.numpy() - want).max())
        # the softmax over L is shift invariant, so the score bias's exact
        # gradient is 0 and both packages return rounding noise there:
        # 1e-7 (f32 epsilon times the loss) is the floor
        assert err <= 2e-4 * scale + 1e-7, (jax.tree_util.keystr(path), err,
                                            scale)


# -- optimizers ---------------------------------------------------------------

def _opt_case(seed=0, steps=5):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"dense": {"w": f(6, 4), "b": f(4)}, "emb": {"table": f(9, 3)}}
    grads = [tree_map(lambda a: rng.standard_normal(a.shape)
                      .astype(np.float32), params) for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_five_steps_match_reference(momentum):
    params, grads = _opt_case(seed=int(momentum * 10))
    jopt, topt = joptim.sgd(0.05, momentum), toptim.sgd(0.05, momentum)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = joptim.apply_updates(jp, ju)
        tu, ts = topt.update(params_from_numpy(g, "cpu"), ts, tp)
        tp = toptim.apply_updates(tp, tu)
    _assert_tree_close(tp, jp, **OPT_TOL)
    if momentum:
        _assert_tree_close(ts, js, **OPT_TOL)


@pytest.mark.parametrize("kind", ["adam", "adamw", "adamw_master"])
def test_adam_updates_match_reference(kind):
    """Three updates on the same given gradients: updates, moments and the
    step counter, with the reference's bias correction and decoupled
    weight decay."""
    params, grads = _opt_case(seed=3, steps=3)
    make = {"adam": lambda m: m.adam(1e-2),
            "adamw": lambda m: m.adamw(1e-2, weight_decay=0.05),
            "adamw_master": lambda m: m.adamw(1e-2, weight_decay=0.05,
                                              master_weights=True)}[kind]
    jopt, topt = make(joptim), make(toptim)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(params_from_numpy(g, "cpu"), ts, tp)
        _assert_tree_close(tu, ju, **OPT_TOL)
        jp, tp = joptim.apply_updates(jp, ju), toptim.apply_updates(tp, tu)
    _assert_tree_close(ts, js, **OPT_TOL)
    assert int(ts["step"]) == 3 and ts["step"].dtype == torch.int32


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, grads = _opt_case(seed=4, steps=1)
    jc, jn = joptim.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, grads[0]), max_norm)
    tc, tn = toptim.clip_by_global_norm(params_from_numpy(grads[0], "cpu"),
                                        max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **OPT_TOL)
    _assert_tree_close(tc, jc, **OPT_TOL)


# -- losses -------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_bce_with_logits_matches_reference(weighted):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((40, 2)) * 30).astype(np.float32)
    labels = (rng.random((40, 2)) < 0.4).astype(np.float32)
    w = rng.random((40, 2)).astype(np.float32) if weighted else None
    want = jlosses.bce_with_logits(logits, labels, w)
    got = tlosses.bce_with_logits(_t(logits), _t(labels),
                                  None if w is None else _t(w))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    np.testing.assert_allclose(
        float(tlosses.softmax_xent(_t(logits), _t(labels))),
        float(jlosses.softmax_xent(logits, labels)), **TOL)


def _pairwise_auc(scores, labels):
    """P(score_pos > score_neg) + 0.5 P(tie), by brute force."""
    pos, neg = scores[labels == 1], scores[labels == 0]
    d = pos[:, None] - neg[None, :]
    return float(((d > 0) + 0.5 * (d == 0)).mean())


def test_auc_and_valid_task_aucs_match_reference():
    rng = np.random.default_rng(7)
    scores = rng.standard_normal((200, 3))
    labels = (rng.random((200, 3)) < 0.3).astype(np.float32)
    labels[:, 2] = 0.0                                     # single-class task
    for t in range(2):
        got = tlosses.auc(scores[:, t], labels[:, t])
        assert got == pytest.approx(jlosses.auc(scores[:, t], labels[:, t]),
                                    abs=1e-12)
        assert got == pytest.approx(_pairwise_auc(scores[:, t],
                                                  labels[:, t]), abs=1e-12)
    assert np.isnan(tlosses.auc(scores[:, 2], labels[:, 2]))
    got = tlosses.valid_task_aucs(scores, labels)
    want = jlosses.valid_task_aucs(scores, labels)
    assert set(got) == set(want) == {0, 1}
    assert all(got[t] == pytest.approx(want[t], abs=1e-12) for t in got)


def test_auc_averages_tied_ranks():
    """Tied scores take their average rank. (The reference's ``auc``
    indexes the sorted scores' tie groups with ranks in input order, so it
    is exact only without ties; the brute-force count is the oracle.)"""
    rng = np.random.default_rng(8)
    scores = np.round(rng.standard_normal(300), 1)
    labels = (rng.random(300) < 0.3).astype(np.float32)
    assert tlosses.auc(scores, labels) == pytest.approx(
        _pairwise_auc(scores, labels), abs=1e-12)


# -- common helpers -----------------------------------------------------------

def test_tree_size_bytes_labels_and_timeit():
    from repro.common import tree_bytes as j_bytes, tree_size as j_size
    tree = {"a": np.zeros((3, 4), np.float32), "b": [np.zeros(5, np.int32),
                                                     (np.zeros(2),)]}
    ttree = tree_map(torch.from_numpy, tree)
    assert tree_size(ttree) == tree_size(tree) == j_size(tree) == 19
    assert tree_bytes(ttree) == tree_bytes(tree) == j_bytes(tree) == 84
    labels = make_labels(1000, np.random.default_rng(0), 3)
    assert labels.shape == (1000, 3) and labels.dtype == np.float32
    assert set(np.unique(labels)) <= {0.0, 1.0}
    assert 0.15 < labels.mean() < 0.25
    t = timeit(lambda: torch.ones(4).sum(), warmup=1, iters=5)
    assert set(t) == {"mean_us", "std_us", "p50_us", "p99_us", "iters"}
    assert t["iters"] == 5 and 0 < t["p50_us"] <= t["p99_us"]


# -- checkpoints and the loop -------------------------------------------------

def _state_tree():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "half": torch.ones(4, dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "mu": [torch.zeros(3), (torch.full((2,), 2.0),)]}}


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_round_trip_and_retention(tmp_path, async_save):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2,
                            async_save=async_save)
    tree = _state_tree()
    for step in (1, 5, 9, 12):
        tree["params"]["w"] += 1.0          # the next step writes in place
        mgr.save(step, tree, meta={"note": "x"})
    mgr.wait()
    assert mgr.all_steps() == [9, 12] and mgr.latest_step() == 12
    assert not [p for p in tmp_path.iterdir() if p.name.endswith(".tmp")]
    template = tree_map(torch.zeros_like, _state_tree())
    got, meta = mgr.restore(template)
    assert meta == {"note": "x", "step": 12}
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(got["opt"]["mu"][1], tuple)
    older, meta = mgr.restore(template, step=9)
    assert meta["step"] == 9
    torch.testing.assert_close(older["params"]["w"],
                               tree["params"]["w"] - 1.0)


def test_checkpoint_restore_refuses_mismatch(tmp_path):
    save_tree({"w": torch.zeros(3)}, str(tmp_path / "c"))
    with pytest.raises(KeyError, match="missing leaf"):
        restore_tree({"v": torch.zeros(3)}, str(tmp_path / "c"))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_tree({"w": torch.zeros(4)}, str(tmp_path / "c"))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})


def test_crash_and_resume(tmp_path):
    """As tests/test_system.py::TestCheckpointRestart: a crash at step 25
    leaves step 20 as the newest checkpoint; the restart resumes there and
    runs to step 39."""
    opt = toptim.adam(1e-2)
    w0 = {"w": torch.ones(4)}
    state0 = {"params": w0, "opt": opt.init(w0)}

    def step(state, batch):
        loss, grads = value_and_grad(
            lambda p: torch.sum((p["w"] - batch) ** 2), state["params"])
        updates, opt_state = opt.update(grads, state["opt"], state["params"])
        return ({"params": toptim.apply_updates(state["params"], updates),
                 "opt": opt_state}, {"loss": loss})

    def batches():
        while True:
            yield torch.zeros(4)

    cfg = LoopConfig(total_steps=40, ckpt_every=10, log_every=100)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    with pytest.raises(RuntimeError, match="injected failure"):
        train_loop(step, state0, batches(), mgr, cfg, fail_at=25,
                   log=lambda *_: None)
    assert mgr.latest_step() == 20
    logs = []
    state, hist = train_loop(step, state0, batches(), mgr, cfg,
                             log=logs.append)
    assert mgr.latest_step() == 39
    assert logs[0] == "[loop] resumed from step 20"
    assert [h["step"] for h in hist] == [39]
    assert int(state["opt"]["step"]) == 40
    assert float(state["params"]["w"].abs().max()) < 1.0


# -- entry points ---------------------------------------------------------------

def test_launch_train_on_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    hist = main(["--device", "cpu", "--arch", "din", "--steps", "3",
                 "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in hist] == [0, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
    assert "[train] loss" in capsys.readouterr().out
    # the GNN family has no launcher, as in the reference (its cells train
    # through build_cell: tests/test_torch_schnet.py)
    with pytest.raises(SystemExit, match="use examples/train_schnet"):
        main(["--device", "cpu", "--arch", "schnet"])


def test_quickstart_example_on_cpu(capsys):
    from repro_torch.examples.quickstart import main
    err = main(["--device", "cpu", "--use-pallas", "--candidates", "256"])
    assert err <= 2e-4
    out = capsys.readouterr().out
    assert "MaRI: rewrote 1 matmuls (['fc1'])" in out
    assert all(f"{n}:" in out for n in ("VanI", "UOI", "MaRI"))


def test_train_then_convert_example_on_cpu(tmp_path):
    from repro_torch.examples.train_then_convert import main
    res = main(["--device", "cpu", "--use-pallas", "--steps", "25",
                "--scale", "0.03", "--ckpt-dir", str(tmp_path)])
    assert res["max_abs_vani_vs_mari"] <= 2e-4
    assert len(res["auc_deltas"]) == 2
    assert max(res["auc_deltas"]) <= 1e-3
    assert [h["step"] for h in res["history"]] == [0, 24]
    assert set(res["times"]) == {"UOI (prod baseline)", "MaRI"}
