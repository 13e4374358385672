"""The training cells' slice of the port (``train.optim``'s ``adafactor``,
``WarmupCosine`` and in-place updates, ``graph.compiled.CompiledStep``,
``launch.steps``' ``_lm_train`` / ``_recsys_train`` / ``_recsys_serve``
and ``build_cell`` over every cell, and the LM training launcher) held
against the JAX reference on the CPU: the same numpy inputs, drawn from
a seed, through both packages; weights cross with ``params_from_numpy``.

Tolerances, stated per test:
* optimizer updates: rtol = 1e-5, atol = 1e-6 (both packages run the
  same elementwise f32 formulas; tests/test_torch_train.py's bar);
* in-place against functional: atol = 1e-6, rtol = 1e-6 (the same
  arithmetic; a fused multiply-add may move the last bit);
* losses and scores: fp32 rtol = atol = 2e-4 (tests/test_kernels.py); bf16
  serving 2e-2;
* gradients: rtol = 2e-4 plus 2e-4 of the leaf's largest |g| (the two
  autodiffs sum in other orders);
* params after Adam steps: 2e-4 on all but a few elements, and every
  element within 2 · lr per step. Adam's first steps move each element by
  ~lr · sign(g) whatever |g| is, so an element whose gradient is ~1e-9 in
  one package and ~-1e-9 in the other (summation order) moves 2 · lr
  apart; the share allowed such a flip is stated in ``_assert_adam_close``.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import mari as jmari
from repro.data.features import _vocab_for_input as j_vocab
from repro.graph.executor import init_graph_params as j_init_graph
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as jt
from repro.train import optim as joptim
from repro_torch import configs as tconfigs
from repro_torch.common import (params_from_numpy, tree_leaves, tree_map,
                                value_and_grad)
from repro_torch.graph.compiled import CompiledStep
from repro_torch.launch import steps
from repro_torch.models import transformer as tt
from repro_torch.train import optim as toptim

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
OPT_TOL = dict(rtol=1e-5, atol=1e-6)
INPLACE_TOL = dict(rtol=1e-6, atol=1e-6)
RECSYS = ("paper-ranking", "din")
LM_ARCHS = ("mixtral-8x7b", "granite-moe-3b-a800m", "deepseek-67b",
            "qwen3-14b", "yi-9b")
RECSYS_ARCHS = ("dlrm-mlperf", "fm", "din", "deepfm", "paper-ranking")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _get(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _assert_tree(got, want, check):
    """``check(got_leaf as f32 numpy, want_leaf as f32 numpy, name)`` for
    every leaf of the reference's tree ``want`` (paths: torch keeps dicts
    in insertion order, jax sorts them)."""
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(tree_leaves(got))
    for path, leaf in flat:
        g = _get(got, path)
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else g
        check(g, np.asarray(leaf, np.float32), jax.tree_util.keystr(path))


def _assert_tree_close(got, want, **tol):
    _assert_tree(got, want, lambda g, w, name: np.testing.assert_allclose(
        g, w, err_msg=name, **tol))


def _assert_adam_close(got, want, lr, steps, flip_share=1e-3, bf16=False):
    """Every element within 2 · lr · steps + 2e-4 (a sign flip of a
    near-zero gradient at each step), and all but ``flip_share`` of each
    leaf within 2e-4 (see the module docstring). ``bf16``: leaves stored in
    bf16, whose elements are the f32 sum re-rounded, so the packages may
    land one bf16 ulp (<= 2^-7 |w|) apart: that ulp is added to the bound,
    and the share is held at 2^-7 |w| + 1e-6 in place of 2e-4."""
    def check(g, w, name):
        d = np.abs(g - w)
        ulp = 2 ** -7 * np.abs(w) if bf16 else 0.0
        assert (d <= 2 * lr * steps + 2e-4 + ulp).all(), (name, d.max())
        off = d > ((ulp + 1e-6) if bf16
                   else TOL["atol"] + TOL["rtol"] * np.abs(w))
        assert off.mean() <= flip_share, (name, off.sum(), off.size)
    _assert_tree(got, want, check)


def _grad_close(got, want):
    def check(g, w, name):
        np.testing.assert_allclose(
            g, w, rtol=2e-4, atol=2e-4 * max(float(np.abs(w).max()), 1e-12),
            err_msg=name)
    _assert_tree(got, want, check)


# -- optimizers ---------------------------------------------------------------

def _opt_case(seed=0, dtype=np.float32):
    """Leaves of rank 1, 2 and 3 (adafactor factors the last two axes)."""
    rng = np.random.default_rng(seed)
    shapes = {"vec": (7,), "mat": (6, 5), "stack": (3, 4, 6)}
    params = {k: (rng.standard_normal(s) * 0.5).astype(dtype)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(dtype)
              for k, s in shapes.items()} for _ in range(5)]
    return params, grads


def _run_both(jopt, topt, params, grads, inplace=False):
    """Five updates through the reference and through the port (its
    functional ``update``, or ``update_`` in place)."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = params_from_numpy(params, "cpu")
    ts = topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = joptim.apply_updates(jp, ju)
        tg = params_from_numpy(g, "cpu")
        if inplace:
            topt.update_(tg, ts, tp)
        else:
            tu, ts = topt.update(tg, ts, tp)
            tp = toptim.apply_updates(tp, tu)
    return (jp, js), (tp, ts)


def test_adafactor_matches_reference_on_both_ranks_of_leaf():
    """Factored second moments for the rank-2 and rank-3 leaves, a full
    one for the vector; the RMS clip engages (lr 0.3 on unit
    gradients). Five steps, OPT_TOL."""
    params, grads = _opt_case()
    (jp, js), (tp, ts) = _run_both(joptim.adafactor(0.3),
                                   toptim.adafactor(0.3), params, grads)
    _assert_tree_close(tp, jp, **OPT_TOL)
    _assert_tree_close(ts["m"], js["m"], **OPT_TOL)
    assert int(ts["step"]) == int(js["step"]) == 5
    assert set(ts["m"]["mat"]) == {"vr", "vc"} and set(ts["m"]["vec"]) == {"v"}
    assert ts["m"]["stack"]["vr"].shape == (3, 4)
    assert ts["m"]["stack"]["vc"].shape == (3, 6)


@pytest.mark.parametrize("warmup,total", [(2, 5), (10, 100), (0, 4)])
def test_warmup_cosine_matches_reference(warmup, total):
    """Steps 0 .. total + 1 as 0-d int32 tensors; the rate stays a 0-d
    tensor on the step's device (a captured step reads no host value)."""
    jsch = joptim.WarmupCosine(3e-4, warmup, total)
    tsch = toptim.WarmupCosine(3e-4, warmup, total)
    for s in list(range(6)) + [total, total + 1]:
        got = tsch(torch.tensor(s, dtype=torch.int32))
        assert isinstance(got, torch.Tensor) and got.ndim == 0
        np.testing.assert_allclose(float(got), float(jsch(jnp.int32(s))),
                                   rtol=1e-6, atol=1e-12)


def test_adamw_master_weights_bf16_matches_reference():
    """bf16 params, f32 master, mu and nu: five AdamW steps. The master
    and moments at OPT_TOL; the bf16 params at one bf16 ulp (2^-8
    relative), since each is the master re-cast."""
    params, grads = _opt_case(1)
    params = {k: v.astype(jnp.bfloat16) for k, v in params.items()}
    grads = [{k: v.astype(jnp.bfloat16) for k, v in g.items()}
             for g in grads]
    (jp, js), (tp, ts) = _run_both(
        joptim.adamw(1e-2, master_weights=True),
        toptim.adamw(1e-2, master_weights=True), params, grads)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
    assert all(t.dtype == torch.float32 for t in tree_leaves(ts["master"]))
    for k in ("master", "mu", "nu"):
        _assert_tree_close(ts[k], js[k], **OPT_TOL)
    _assert_tree_close(tp, jp, rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("which", ["adam", "adamw", "adamw_master_bf16",
                                   "adafactor"])
def test_inplace_update_matches_functional(which, monkeypatch):
    """``update_`` writes the same params and state into the tensors that
    hold them (addresses kept), over five steps, within INPLACE_TOL.
    ``SLICE`` is cut to 16 elements so the leaves are walked in slices,
    ragged last slice included."""
    monkeypatch.setattr(toptim, "SLICE", 16)
    make = {"adam": lambda: toptim.adam(1e-2),
            "adamw": lambda: toptim.adamw(1e-2, weight_decay=0.1),
            "adamw_master_bf16": lambda: toptim.adamw(
                1e-2, master_weights=True),
            "adafactor": lambda: toptim.adafactor(0.3)}[which]
    params, grads = _opt_case(2)
    dt = torch.bfloat16 if which.endswith("bf16") else torch.float32
    opt = make()
    p_f = tree_map(lambda a: _t(a).to(dt), params)
    s_f = opt.init(p_f)
    p_i = tree_map(torch.clone, p_f)
    s_i = opt.init(p_i)
    ptrs = [t.data_ptr() for t in tree_leaves((p_i, s_i))]
    for g in grads:
        g = tree_map(lambda a: _t(a).to(dt), g)
        u, s_f = opt.update(g, s_f, p_f)
        p_f = toptim.apply_updates(p_f, u)
        # update_ uses an f32 gradient's memory as scratch
        opt.update_(tree_map(torch.clone, g), s_i, p_i)
    assert [t.data_ptr() for t in tree_leaves((p_i, s_i))] == ptrs
    assert int(s_i["step"]) == 5
    for a, b in zip(tree_leaves((p_i, s_i)), tree_leaves((p_f, s_f))):
        if a.dtype == torch.bfloat16:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, **INPLACE_TOL)


def test_inplace_adamw_reads_the_step_on_the_device():
    """The step count and bias corrections stay tensors: a step count of
    one million moves nothing to the host and gives the functional
    form's update."""
    opt = toptim.adamw(1e-3)
    p = {"w": torch.ones(3)}
    s = opt.init(p)
    s["step"].fill_(10 ** 6)
    g = {"w": torch.tensor([1e-3, -2.0, 0.0])}
    u, _ = opt.update(g, tree_map(torch.clone, s), p)
    want = toptim.apply_updates(p, u)
    opt.update_(tree_map(torch.clone, g), s, p)
    torch.testing.assert_close(p["w"], want["w"], **INPLACE_TOL)


# -- the captured step's CPU path ---------------------------------------------

def _smoke_mod(arch):
    """A config module whose BUILD is the smoke build (both packages)."""
    jmod, tmod = jconfigs.get_config(arch), tconfigs.get_config(arch)
    return (types.SimpleNamespace(BUILD=jmod.smoke_build(), FAMILY="recsys"),
            types.SimpleNamespace(BUILD=tmod.smoke_build(), FAMILY="recsys"))


def _lm_cfgs(arch="granite-moe-3b-a800m", **over):
    jcfg = dataclasses.replace(jconfigs.get_config(arch).smoke_config(),
                               dtype="float32", **over)
    return jcfg, tt.LMConfig(**dataclasses.asdict(jcfg))


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}


def test_compiled_train_cell_is_the_eager_step_on_the_cpu():
    """On the CPU ``CellProgram.compiled()`` for a train cell runs the
    in-place step eagerly over static buffers: after N calls the step
    count is N, and the state equals the eager ``step_fn``'s bit for bit
    from the same state and batches."""
    _, tcfg = _lm_cfgs(remat=True)
    prog = steps._lm_train(tcfg, 16, 2)
    step = prog.compiled(device="cpu")
    assert isinstance(step, CompiledStep)
    state = prog.init(seed=1, device="cpu")
    twin = tree_map(torch.clone, state)
    for i in range(4):
        batch = {k: _t(v) for k, v in _tokens(tcfg, 2, 16, i).items()}
        out, m = step(state, batch)
        assert out is state and int(state["opt"]["step"]) == i + 1
        _, me = prog.step_fn(twin, batch)
        assert torch.equal(m["loss"], me["loss"])
    assert step.compilations == 1
    for a, b in zip(tree_leaves(state), tree_leaves(twin)):
        assert torch.equal(a, b)


def test_compiled_step_copies_a_restored_state_into_its_own():
    """A state with other tensors (a restored checkpoint) is copied into
    the captured state; the step goes on from the restored values and
    returns its own state; one entry in all."""
    _, tcfg = _lm_cfgs()
    prog = steps._lm_train(tcfg, 16, 2)
    step = prog.compiled(device="cpu")
    state = prog.init(seed=2, device="cpu")
    batch = {k: _t(v) for k, v in _tokens(tcfg, 2, 16, 0).items()}
    step(state, batch)
    restored = prog.init(seed=3, device="cpu")
    twin = tree_map(torch.clone, restored)
    out, _ = step(restored, batch)
    assert out is state and out is not restored
    prog.step_fn(twin, batch)
    for a, b in zip(tree_leaves(out), tree_leaves(twin)):
        assert torch.equal(a, b)
    assert step.compilations == 1


def test_remat_does_not_change_the_loss_or_gradients():
    """Per-layer checkpointing (``preserve_rng_state=False``: the layer
    draws no random numbers) recomputes the same values: loss and
    gradients bit for bit with remat on and off."""
    _, tcfg = _lm_cfgs()
    params = tt.init_lm_params(tcfg, seed=4, device="cpu")
    batch = {k: _t(v) for k, v in _tokens(tcfg, 2, 16, 1).items()}
    outs = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        outs.append(value_and_grad(lambda p: tt.lm_loss(
            p, cfg, batch["tokens"], batch["labels"]), params))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1])):
        assert torch.equal(a, b)


# -- _lm_train ----------------------------------------------------------------

def test_lm_train_step_matches_reference():
    """granite's smoke config in fp32 with remat on: three steps of
    ``_lm_train`` (lm_loss, AdamW 3e-4 with f32 master weights) against
    ``repro.launch.steps._lm_train`` on a (1, 1) host mesh, from the same
    params and batches. Loss (TOL) and gradients (``_grad_close``) at
    every step, each package on its own trajectory; params and the
    master after the steps by ``_assert_adam_close``."""
    jcfg, tcfg = _lm_cfgs(remat=True)
    seq, b = 16, 2
    mesh = make_host_mesh((1, 1), ("data", "model"))
    jprog = jsteps._lm_train(jcfg, mesh, seq, b)
    tprog = steps._lm_train(tcfg, seq, b)
    jparams = jt.init_lm_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jopt = joptim.adamw(3e-4, master_weights=True)
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    tparams = params_from_numpy(_np(jparams), "cpu")
    tstate = {"params": tparams, "opt": tprog.opt.init(tparams)}
    jstep = jax.jit(jprog.step_fn)
    jgrad = jax.jit(jax.grad(lambda p, t, l: jt.lm_loss(p, jcfg, t, l)))
    for i in range(3):
        nb = _tokens(tcfg, b, seq, 10 + i)
        tb = {k: _t(v) for k, v in nb.items()}
        _grad_close(value_and_grad(lambda p: tt.lm_loss(
            p, tcfg, tb["tokens"], tb["labels"]), tstate["params"])[1],
            jgrad(jstate["params"], nb["tokens"], nb["labels"]))
        jstate, jm = jstep(jstate, nb)
        _, tm = tprog.step_fn(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **TOL)
    assert int(tstate["opt"]["step"]) == 3
    _assert_adam_close(tstate["params"], jstate["params"], 3e-4, 3)
    _assert_adam_close(tstate["opt"]["master"], jstate["opt"]["master"],
                       3e-4, 3)


# -- _recsys_train ------------------------------------------------------------

def _train_feeds(jgraph, batch, seed):
    """Training feeds (every row its own user: ``feed_specs(train=True)``)
    and labels, from a numpy seed."""
    from repro.data.features import feed_specs
    rng = np.random.default_rng(seed)
    feeds = {}
    for name, spec in feed_specs(jgraph, batch, train=True).items():
        dt = np.dtype(spec.dtype)
        if dt.kind == "i":
            feeds[name] = rng.integers(0, j_vocab(jgraph, name) or 1000,
                                       spec.shape, dtype=dt)
        else:
            feeds[name] = rng.standard_normal(spec.shape).astype(dt)
    n_out = len(jgraph.outputs)
    labels = (rng.random((batch, n_out)) < 0.2).astype(np.float32)
    return feeds, labels


@pytest.mark.parametrize("opts", [(), ("grad_bf16",), ("emb_bf16",)],
                         ids=["plain", "grad_bf16", "emb_bf16"])
@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_train_step_matches_reference(arch, opts):
    """Two Adam(1e-3) steps of ``_recsys_train`` on the smoke build
    against ``repro.launch.steps._recsys_train`` on a (1, 1) host mesh:
    the loss at TOL each step, the params after by ``_assert_adam_close``
    (bf16 tables: at one bf16 ulp in place of 2e-4, ``bf16=True``)."""
    jmod, tmod = _smoke_mod(arch)
    B = 32
    mesh = make_host_mesh((1, 1), ("data", "model"))
    jprog = jsteps._recsys_train(jmod, mesh, B, opts=frozenset(opts))
    tprog = steps._recsys_train(tmod, B, opts=frozenset(opts))
    jgraph, *_ = jmod.BUILD()
    jparams = j_init_graph(jgraph, jax.random.PRNGKey(0))
    if "emb_bf16" in opts:
        emb = {n.name for n in jgraph.param_nodes() if n.op == "embedding"}
        jparams = {k: (jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16), v) if k in emb else v)
            for k, v in jparams.items()}
    jopt = joptim.adam(1e-3)
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    tparams = params_from_numpy(_np(jparams), "cpu")
    tstate = {"params": tparams, "opt": tprog.opt.init(tparams)}
    if "emb_bf16" in opts:
        # the paper model has no embedding table: nothing turns bf16
        has_tables = any(n.op == "embedding" for n in jgraph.param_nodes())
        assert has_tables == any(t.dtype == torch.bfloat16
                                 for t in tree_leaves(tparams))
        assert all(t.dtype == torch.float32
                   for t in tree_leaves(tstate["opt"]["mu"]))
    jstep = jax.jit(jprog.step_fn)
    for i in range(2):
        feeds, labels = _train_feeds(jgraph, B, 20 + i)
        jstate, jm = jstep(jstate, feeds, labels)
        _, tm = tprog.step_fn(tstate, {k: _t(v) for k, v in feeds.items()},
                              _t(labels))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **TOL)
    assert int(tstate["opt"]["step"]) == 2
    tables = {n.name for n in jgraph.param_nodes() if n.op == "embedding"
              } if "emb_bf16" in opts else set()
    for part, bf16 in ((tables, True), (set(jstate["params"]) - tables,
                                        False)):
        _assert_adam_close({k: tstate["params"][k] for k in part},
                           {k: jstate["params"][k] for k in part},
                           1e-3, 2, bf16=bf16)


def test_recsys_train_cell_program_shapes_match_reference():
    """``build_cell``'s train programs for the five recsys archs: the
    state's and feeds' shapes and dtypes are the reference's (meta
    tensors; nothing allocated at the published widths)."""
    mesh = make_host_mesh()
    for arch in RECSYS_ARCHS:
        for opts in ((), ("emb_bf16",)):
            jp = jsteps.build_cell(arch, "train_batch", mesh, opts=opts)
            tp = steps.build_cell(arch, "train_batch", opts=opts)
            assert (tp.kind, tp.donate_argnums) == (jp.kind,
                                                    jp.donate_argnums)
            for ours, theirs in zip(tp.args, jp.args):
                assert all(t.device.type == "meta"
                           for t in tree_leaves(ours))
                flat = jax.tree_util.tree_leaves_with_path(theirs)
                for path, leaf in flat:
                    t = _get(ours, path)
                    assert tuple(t.shape) == tuple(leaf.shape), path
                    assert str(t.dtype).split(".")[-1] == str(
                        jnp.dtype(leaf.dtype)), path


# -- _recsys_serve ------------------------------------------------------------

SERVE_CASES = [("paper-ranking", ()), ("paper-ranking", ("serve_uoi",)),
               ("paper-ranking", ("serve_vani",)),
               ("paper-ranking", ("serve_bf16",)),
               ("din", ()), ("din", ("attn_reparam",)),
               ("din", ("serve_uoi",)), ("din", ("serve_vani",)),
               ("din", ("serve_bf16",)), ("din", ("attn_reparam",
                                                  "serve_bf16")),
               ("dlrm-mlperf", ()), ("dlrm-mlperf", ("serve_bf16",))]


def _serve_feeds(jgraph, batch, seed):
    """One request: user feeds at batch 1, candidates at ``batch``."""
    from repro.data.features import feed_specs
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in feed_specs(jgraph, batch, train=False).items():
        dt = np.dtype(spec.dtype)
        if dt.kind == "i":
            out[name] = rng.integers(0, j_vocab(jgraph, name) or 1000,
                                     spec.shape, dtype=dt)
        else:
            out[name] = rng.standard_normal(spec.shape).astype(dt)
    return out


@pytest.mark.parametrize("arch,opts", SERVE_CASES,
                         ids=[f"{a}-{'+'.join(o) or 'mari'}"
                              for a, o in SERVE_CASES])
def test_recsys_serve_matches_reference(arch, opts):
    """``_recsys_serve`` on the smoke build against the reference's, on
    the same params (drawn by the reference for the program's graph: the
    MaRI-rewritten one where MaRI is on) and feeds: the eager ``step_fn``
    and the compiled program through the kernel path (its CPU wrappers
    take the plain versions), at TOL (``serve_bf16``: BF16_TOL)."""
    jmod, tmod = _smoke_mod(arch)
    B = 24
    mesh = make_host_mesh()
    jprog = jsteps._recsys_serve(jmod, mesh, B, opts=frozenset(opts))
    tprog = steps._recsys_serve(tmod, B, opts=frozenset(opts))
    assert tprog.meta == jprog.meta
    jgraph, *_ = jmod.BUILD()
    pgraph = jgraph
    if not {"serve_uoi", "serve_vani"} & set(opts):
        pgraph = jmari.mari_rewrite(
            jgraph, reparam_attention="attn_reparam" in opts).graph
    dtype = jnp.bfloat16 if "serve_bf16" in opts else jnp.float32
    jparams = j_init_graph(pgraph, jax.random.PRNGKey(1), dtype)
    feeds = _serve_feeds(jgraph, B, 5)
    if "serve_bf16" in opts:
        feeds = {k: (v.astype(jnp.bfloat16) if v.dtype == np.float32
                     else v) for k, v in feeds.items()}
    want = np.asarray(jax.jit(jprog.step_fn)(jparams, feeds), np.float32)
    tparams = params_from_numpy(_np(jparams), "cpu")
    tfeeds = params_from_numpy(_np(feeds), "cpu")
    tol = BF16_TOL if "serve_bf16" in opts else TOL
    got = tprog.step_fn(tparams, tfeeds)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    serve = tprog.compiled(device="cpu", use_pallas=True)
    np.testing.assert_allclose(serve(tparams, tfeeds).float().numpy(), want,
                               **tol)
    assert serve.compilations == 1


def spec_paths(tree, pre: str = "") -> dict:
    """A tree of specs (the port's ``P``, or the reference's
    ``NamedSharding`` / ``PartitionSpec``) as {path: spec tuple}."""
    if isinstance(tree, dict):
        return {p: v for k in tree
                for p, v in spec_paths(tree[k], f"{pre}/{k}").items()}
    if type(tree) in (tuple, list):
        return {p: v for i, t in enumerate(tree)
                for p, v in spec_paths(t, f"{pre}/{i}").items()}
    return {pre: tuple(getattr(tree, "spec", tree))}


@pytest.fixture
def torch_mesh():
    """A one-rank gloo mesh (1, 1), its process group destroyed after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh as t_make_host_mesh
    yield t_make_host_mesh((1, 1), device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def test_build_cell_covers_every_train_and_serve_cell(torch_mesh):
    """Every train and serve shape of the five LM and five recsys configs
    that the reference does not skip builds, with the reference's kind and
    donated arguments; skipped cells raise as the reference's do; the
    sharding options build on a mesh, each with the layout the
    reference's builder gives it."""
    mesh = make_host_mesh()
    built = 0
    for arch in LM_ARCHS + RECSYS_ARCHS:
        for shape, spec in tconfigs.get_config(arch).SHAPES.items():
            if spec["kind"] not in ("train", "serve"):
                continue
            if spec.get("skip"):
                with pytest.raises(ValueError, match="skipped"):
                    steps.build_cell(arch, shape)
                continue
            jp = jsteps.build_cell(arch, shape, mesh)
            tp = steps.build_cell(arch, shape)
            assert (tp.arch, tp.shape, tp.kind) == (arch, shape, jp.kind)
            assert tp.donate_argnums == jp.donate_argnums
            assert len(tp.args) == len(jp.args)
            built += 1
    assert built == 5 * 1 + 5 * 4
    for arch, shape, opt in (("din", "train_batch", "table_md"),
                             ("din", "serve_p99", "serve_full_dp"),
                             ("mixtral-8x7b", "train_4k", "moe_local"),
                             ("mixtral-8x7b", "train_4k", "seq_par")):
        jp = jsteps.build_cell(arch, shape, mesh, opts=(opt,))
        tp = steps.build_cell(arch, shape, torch_mesh, opts=(opt,))
        assert tp.mesh is torch_mesh and set(tp.policy_kv) == set(
            jp.policy_kv)
        assert spec_paths(tp.in_shardings) == spec_paths(jp.in_shardings)
        assert spec_paths(tp.out_shardings) == spec_paths(jp.out_shardings)
        assert {k: v for k, v in tp.meta.items() if k != "captured"} == \
            jp.meta


# -- the LM launcher ----------------------------------------------------------

def test_lm_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """``main(["--arch", "granite-moe-3b-a800m", "--device", "cpu"])``:
    the smoke config in fp32, AdamW with master weights, 8 × 32 token
    batches, the reference's ``[train] loss a -> b`` line; a second run
    over the same directory resumes from its newest checkpoint."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.launch.train import main
    argv = ["--arch", "granite-moe-3b-a800m", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    hist = main(argv + ["--steps", "4"])
    assert [h["step"] for h in hist] == [0, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)
    out = capsys.readouterr().out
    assert "[train] loss" in out and "improved" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
    hist = main(argv + ["--steps", "6"])
    assert "[loop] resumed from step 3" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [5]
