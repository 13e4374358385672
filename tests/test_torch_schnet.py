"""SchNet and the GNN family's training cells in the port
(``models/schnet.py``, ``data/sampler.py``, ``configs/schnet.py``,
``configs.all_cells`` and ``launch.steps._gnn_train``) held against the
JAX reference on the CPU: the same numpy inputs, drawn from a seed,
through both packages; weights cross with ``params_from_numpy``.

Tolerances, stated per test:
* outputs and losses: fp32 rtol = atol = 2e-4 (tests/test_kernels.py);
* gradients: rtol = 2e-4 plus 2e-4 of the leaf's largest |g| (the two
  autodiffs sum in other orders; tests/test_torch_train_cells.py);
* params after Adam steps: ``_assert_adam_close`` of the train-cells
  tests (2e-4 on all but 0.1% of each leaf, every element within
  2 · lr per step);
* the generators and the sampler: bit for bit (the same numpy code).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import sampler as jsampler
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import schnet as js
from repro.train import optim as joptim
from repro.train.losses import softmax_xent as j_xent
from repro_torch import configs as tconfigs
from repro_torch.common import (params_from_numpy, tree_leaves, tree_map,
                                value_and_grad)
from repro_torch.data import sampler as tsampler
from repro_torch.graph.compiled import CompiledStep
from repro_torch.launch import steps
from repro_torch.models import schnet as ts
from repro_torch.train.losses import softmax_xent as t_xent
from test_torch_gpu import SMALL_GNN_SPECS as SMALL_SPECS
from test_torch_gpu import small_gnn_batch as _gnn_batch
from test_torch_train_cells import (_assert_adam_close, _assert_tree_close,
                                    _get, _grad_close, _np, _t, spec_paths)

TOL = dict(rtol=2e-4, atol=2e-4)
SEEDS = (0, 1, 7)
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def _cfgs(**over):
    jcfg = dataclasses.replace(jconfigs.get_config("schnet").smoke_config(),
                               **over)
    return jcfg, ts.SchNetConfig(**dataclasses.asdict(jcfg))


def _regime(name):
    """The four regimes of tests/test_models_smoke.py::TestSchNetSmoke:
    (configs, JAX params, numpy forward inputs, graph ids or None)."""
    if name == "molecule":
        jcfg, tcfg = _cfgs(d_feat=0, n_out=1)
        mol = jsampler.batched_molecules(4, 10, 20)
        args = (mol["atom_types"], mol["positions"], mol["senders"],
                mol["receivers"], None)
        return jcfg, tcfg, js.init_schnet_params(jcfg, jax.random.PRNGKey(1)
                                                 ), args, mol
    if name == "d_feat_16":
        jcfg, tcfg = _cfgs(d_feat=16, n_out=4)
        g = jsampler.random_graph(40, 120, 16, n_classes=4)
    else:
        jcfg, tcfg = _cfgs(d_feat=24, n_out=5)
        g = jsampler.random_graph(60, 200, 24, n_classes=5)
    params = js.init_schnet_params(jcfg, jax.random.PRNGKey(0))
    if name == "sampled":
        s = jsampler.NeighborSampler(g["senders"], g["receivers"], 60, (4, 3))
        samp = s.sample(np.arange(8), np.random.default_rng(0))
        args = (g["features"][samp["nodes"]], g["positions"][samp["nodes"]],
                samp["senders"], samp["receivers"], samp["edge_mask"])
        return jcfg, tcfg, params, args, {"labels": g["labels"][
            samp["nodes"]]}
    args = (g["features"], g["positions"], g["senders"], g["receivers"],
            None)
    return jcfg, tcfg, params, args, g


REGIMES = ("full", "sampled", "molecule", "d_feat_16")


def _forward_both(jcfg, tcfg, jparams, args, tparams=None):
    jout = js.schnet_forward(jparams, jcfg, *(None if a is None else
                                              jnp.asarray(a) for a in args))
    tparams = tparams or params_from_numpy(_np(jparams), "cpu")
    tout = ts.schnet_forward(tparams, tcfg, *(None if a is None else _t(a)
                                              for a in args))
    return np.asarray(jout), tout.numpy()


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("regime", REGIMES)
def test_forward_matches_reference(regime):
    """``schnet_forward`` on the reference's params (and, for molecules,
    ``schnet_graph_readout``): fp32 TOL, finite, the reference's shape."""
    jcfg, tcfg, jparams, args, extra = _regime(regime)
    want, got = _forward_both(jcfg, tcfg, jparams, args)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    if regime == "molecule":
        je = js.schnet_graph_readout(jnp.asarray(want),
                                     jnp.asarray(extra["graph_ids"]), 4)
        te = ts.schnet_graph_readout(torch.from_numpy(got),
                                     _t(extra["graph_ids"]), 4)
        assert te.shape == (4, 1)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)


def _losses(jcfg, tcfg, args, extra, regime):
    """(JAX loss of params, port loss of params) for one regime."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = [None if a is None else _t(a) for a in args]
    if regime == "molecule":
        gid, en = extra["graph_ids"], extra["energies"]

        def jl(p):
            e = js.schnet_graph_readout(js.schnet_forward(p, jcfg, *jargs),
                                        jnp.asarray(gid), 4)
            return jnp.mean(jnp.square(e[:, 0] - jnp.asarray(en)))

        def tl(p):
            e = ts.schnet_graph_readout(ts.schnet_forward(p, tcfg, *targs),
                                        _t(gid), 4)
            return torch.mean(torch.square(e[:, 0] - _t(en)))
        return jl, tl
    labels = extra["labels"]
    return (lambda p: j_xent(js.schnet_forward(p, jcfg, *jargs),
                             jnp.asarray(labels)),
            lambda p: t_xent(ts.schnet_forward(p, tcfg, *targs),
                             _t(labels)))


@pytest.mark.parametrize("regime", REGIMES)
def test_loss_gradients_match_reference(regime):
    """The loss and the gradient of every leaf (the stacked interaction
    leaves, the input projection or atom table, the readout) against
    ``jax.value_and_grad``."""
    jcfg, tcfg, jparams, args, extra = _regime(regime)
    jl, tl = _losses(jcfg, tcfg, args, extra, regime)
    jv, jg = jax.value_and_grad(jl)(jparams)
    tv, tg = value_and_grad(tl, params_from_numpy(_np(jparams), "cpu"))
    np.testing.assert_allclose(float(tv), float(jv), **TOL)
    _grad_close(tg, jg)
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(
        tg["interactions"]))


def test_params_tree_matches_reference():
    """``init_schnet_params`` and ``schnet_param_specs`` have the
    reference's tree (input / interactions stacked (T, ...) / readout),
    shapes and dtypes, for both inputs; the draws are glorot-bounded with
    zero biases."""
    for over in (dict(d_feat=0, n_out=1), dict(d_feat=24, n_out=5)):
        jcfg, tcfg = _cfgs(**over)
        jp = js.init_schnet_params(jcfg, jax.random.PRNGKey(0))
        for ours in (ts.init_schnet_params(tcfg, seed=0, device="cpu"),
                     ts.schnet_param_specs(tcfg)):
            flat = jax.tree_util.tree_leaves_with_path(jp)
            assert len(flat) == len(tree_leaves(ours))
            for path, leaf in flat:
                t = _get(ours, path)
                assert tuple(t.shape) == leaf.shape, path
                assert t.dtype == torch.float32
        tp = ts.init_schnet_params(tcfg, seed=0, device="cpu")
        H, R = tcfg.d_hidden, tcfg.n_rbf
        lim = np.sqrt(6.0 / (R + H))
        assert float(tp["interactions"]["filt_w1"].abs().max()) <= lim
        assert not tp["interactions"]["filt_b1"].any()
        assert not torch.equal(tp["interactions"]["in2f"][0],
                               tp["interactions"]["in2f"][1])


# -- the index traps ----------------------------------------------------------

def _mol_case(senders=None, receivers=None, atom_types=None):
    jcfg, tcfg, jparams, args, mol = _regime("molecule")
    at, pos, snd, rcv, _ = args
    snd, rcv, at = snd.copy(), rcv.copy(), at.copy()
    if senders is not None:
        snd[:len(senders)] = senders
    if receivers is not None:
        rcv[:len(receivers)] = receivers
    if atom_types is not None:
        at[:len(atom_types)] = atom_types
    return jcfg, tcfg, jparams, (at, pos, snd, rcv, None)


def test_out_of_range_receiver_is_dropped():
    """``jax.ops.segment_sum`` drops ids outside [0, N), negative ones
    included (no wrap): the port's ``segment_sum`` and the forward agree
    with the reference; ``index_put_`` alone would raise."""
    ids = np.array([0, 3, 4, 7, -1, -4, 2, 3], np.int32)
    data = np.arange(16, dtype=np.float32).reshape(8, 2)
    want = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                               num_segments=4)
    got = ts.segment_sum(_t(data), _t(ids), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jcfg, tcfg, jparams, args = _mol_case(receivers=[40, 41, -1, -40, 1000])
    want, got = _forward_both(jcfg, tcfg, jparams, args)
    np.testing.assert_allclose(got, want, **TOL)


def test_out_of_range_sender_is_clamped():
    """``x[idx]`` in JAX wraps a negative index once, then clamps:
    ``take_rows`` gives the same rows, and the forward agrees."""
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([0, 3, 4, 7, -1, -4, -5, -9], np.int32)
    np.testing.assert_array_equal(
        ts.take_rows(_t(x), _t(idx)).numpy(),
        np.asarray(jnp.asarray(x)[jnp.asarray(idx)]))
    jcfg, tcfg, jparams, args = _mol_case(senders=[40, 41, -1, -2, -41, 999])
    want, got = _forward_both(jcfg, tcfg, jparams, args)
    np.testing.assert_allclose(got, want, **TOL)


def test_out_of_range_atom_type_fills_nan():
    """``jnp.take``'s default mode on the atom-type table: a negative id
    wraps once, an id still out of range gives a NaN row. ``take_fill``
    matches row for row (NaN where the reference has NaN), and the
    gradient to the table from the filled rows is zero in both."""
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([0, 3, 4, 7, -1, -4, -5, -9], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(x), jnp.asarray(idx), axis=0))
    got = ts.take_fill(_t(x), _t(idx)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    jg = jax.grad(lambda t: jnp.nansum(jnp.take(t, jnp.asarray(idx),
                                                axis=0)))(jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    torch.nansum(ts.take_fill(tx, _t(idx))).backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))
    jcfg, tcfg, jparams, args = _mol_case(atom_types=[-1, 99, 100, -101])
    want, got = _forward_both(jcfg, tcfg, jparams, args)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               **TOL)


def test_ssp_matches_reference_for_large_inputs():
    """``ssp`` has no threshold (``F.softplus`` returns x above 20): values
    and gradients agree with ``jax.nn.softplus - log 2`` over [-200, 200],
    0 included (its gradient is 1/2 there)."""
    x = np.concatenate([np.linspace(-200, 200, 4001, dtype=np.float32),
                        np.float32([0.0, 19.9, 20.1, 88.0, 89.0])])
    jv, jvjp = jax.vjp(js.ssp, jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    tv = ts.ssp(tx)
    tv.sum().backward()
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(jvjp(jnp.ones_like(jv))[0]), **TOL)
    assert float(tx.grad[-5]) == 0.5


def test_rbf_expand_matches_reference():
    d = np.random.default_rng(3).uniform(0, 14, 500).astype(np.float32)
    np.testing.assert_allclose(
        ts.rbf_expand(_t(d), 300, 10.0).numpy(),
        np.asarray(js.rbf_expand(jnp.asarray(d), 300, 10.0)), **TOL)


def test_padded_edges_change_nothing():
    """Edges padded to a multiple of 1024 (``pad_edges``: mask False, each
    a self-loop on its own node) leave the forward as it was, bit for bit
    on the CPU; so does re-pointing the sampler's masked edges, which the
    reference's forward gives the same values."""
    _, tcfg, jparams, args, g = _regime("full")
    tparams = params_from_numpy(_np(jparams), "cpu")
    feats, pos, snd, rcv, _ = (None if a is None else _t(a) for a in args)
    want = ts.schnet_forward(tparams, tcfg, feats, pos, snd, rcv)
    b = tsampler.pad_edges(g, 1024)
    assert b["edge_mask"].sum() == 200 and len(b["senders"]) == 1024
    np.testing.assert_array_equal(b["senders"][:200], g["senders"])
    pads = b["senders"][200:]
    assert np.array_equal(pads, b["receivers"][200:])
    assert np.bincount(pads).max() <= -(-1024 // 60)
    got = ts.schnet_forward(tparams, tcfg, feats, pos, _t(b["senders"]),
                            _t(b["receivers"]), _t(b["edge_mask"]))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="do not fit"):
        tsampler.pad_edges(g, 100)
    jcfg, tcfg, jparams, args, _ = _regime("sampled")
    feats, pos, snd, rcv, mask = args
    b = tsampler.pad_edges({"senders": snd, "receivers": rcv,
                            "edge_mask": mask, "positions": pos}, 1024)
    for k in ("senders", "receivers"):
        assert np.bincount(b[k][~b["edge_mask"]]).max() <= -(-1024 // len(pos))
    _, want = _forward_both(jcfg, tcfg, jparams, args)
    _, got = _forward_both(jcfg, tcfg, jparams, (
        feats, pos, b["senders"], b["receivers"], b["edge_mask"]))
    np.testing.assert_array_equal(got, want)


# -- the generators and the sampler ------------------------------------------

def _assert_same_arrays(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("seed", SEEDS)
def test_random_graph_bit_for_bit(seed):
    _assert_same_arrays(tsampler.random_graph(300, 2000, 12, seed, 9),
                        jsampler.random_graph(300, 2000, 12, seed, 9))


@pytest.mark.parametrize("seed", SEEDS)
def test_batched_molecules_bit_for_bit(seed):
    _assert_same_arrays(tsampler.batched_molecules(6, 12, 25, seed),
                        jsampler.batched_molecules(6, 12, 25, seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_neighbor_sampler_bit_for_bit(seed):
    """The CSR over incoming edges and three successive padded samples
    (nodes with no in-edges among the seeds) from one generator each."""
    g = jsampler.random_graph(400, 1500, 4, seed)
    args = (g["senders"], g["receivers"], 400, (5, 3))
    js_, ts_ = jsampler.NeighborSampler(*args), tsampler.NeighborSampler(*args)
    np.testing.assert_array_equal(ts_._offsets, js_._offsets)
    np.testing.assert_array_equal(ts_._src_sorted, js_._src_sorted)
    assert ts_.max_sample_nodes(16) == js_.max_sample_nodes(16) == 16 * 21
    assert ts_.max_sample_edges(16) == js_.max_sample_edges(16) == 16 * 20
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        seeds = jr.choice(400, 16, replace=False)
        assert np.array_equal(seeds, tr.choice(400, 16, replace=False))
        _assert_same_arrays(ts_.sample(seeds, tr), js_.sample(seeds, jr))


def test_sampled_batch_gathers_the_sample_nodes():
    g = tsampler.random_graph(200, 900, 5, 2, 6)
    s = tsampler.NeighborSampler(g["senders"], g["receivers"], 200, (3, 2))
    samp = s.sample(np.arange(4), np.random.default_rng(1))
    b = tsampler.sampled_batch(g, samp)
    np.testing.assert_array_equal(b["features"][:4], g["features"][:4])
    np.testing.assert_array_equal(b["labels"], g["labels"][samp["nodes"]])
    assert b["edge_mask"] is samp["edge_mask"]


# -- configs and the registry -------------------------------------------------

def test_schnet_config_matches_reference():
    jmod, tmod = jconfigs.get_config("schnet"), tconfigs.get_config("schnet")
    assert tmod.FAMILY == jmod.FAMILY == "gnn"
    assert dataclasses.asdict(tmod.CONFIG) == dataclasses.asdict(jmod.CONFIG)
    assert dataclasses.asdict(tmod.smoke_config()) == dataclasses.asdict(
        jmod.smoke_config())
    assert tmod.SHAPES == jmod.SHAPES


@pytest.mark.parametrize("include_paper", [False, True])
def test_all_cells_match_reference(include_paper):
    """The reference's 40 cells (and the paper model's with it), in order,
    with their kinds and skip reasons."""
    ours = tconfigs.all_cells(include_paper)
    theirs = jconfigs.all_cells(include_paper)
    assert [dataclasses.astuple(c) for c in ours] == [
        dataclasses.astuple(c) for c in theirs]
    assert len(ours) == 40 + include_paper * len(
        tconfigs.get_config("paper-ranking").SHAPES)
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert sum(bool(c.skip_reason) for c in ours) == 4


# -- _gnn_train ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "sampled", "molecule"])
def test_gnn_train_step_matches_reference(mode):
    """Three Adam(1e-3) steps of ``_gnn_train`` on the smoke config
    against ``repro.launch.steps._gnn_train`` on a (1, 1) host mesh, from
    the same params and batches: the loss at TOL each step, the params and
    Adam's moments after by ``_assert_adam_close`` / TOL."""
    spec = SMALL_SPECS[mode]
    jcfg, tcfg = _cfgs()
    mesh = make_host_mesh((1, 1), ("data", "model"))
    jprog = jsteps._gnn_train(jcfg, mesh, spec)
    tprog = steps._gnn_train(tcfg, spec)
    jstate_sds, jbatch_sds = jprog.args
    tstate_meta, tbatch_meta = tprog.args
    n_edges = tbatch_meta["senders"].shape[0]
    assert n_edges % 1024 == 0
    scfg = dataclasses.replace(jcfg, d_feat=spec.get("d_feat", 0),
                               n_out=spec.get("n_classes", 1))
    jparams = js.init_schnet_params(scfg, jax.random.PRNGKey(0))
    jstate = {"params": jparams, "opt": joptim.adam(1e-3).init(jparams)}
    tparams = params_from_numpy(_np(jparams), "cpu")
    tstate = {"params": tparams, "opt": tprog.opt.init(tparams)}
    jstep = jax.jit(jprog.step_fn)
    for i in range(3):
        nb = _gnn_batch(spec, n_edges, 30 + i)
        assert {k: (v.shape, v.dtype) for k, v in nb.items()} == {
            k: (v.shape, np.dtype(v.dtype)) for k, v in jbatch_sds.items()}
        jstate, jm = jstep(jstate, nb)
        _, tm = tprog.step_fn(tstate, {k: _t(v) for k, v in nb.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **TOL)
    assert int(tstate["opt"]["step"]) == 3
    _assert_adam_close(tstate["params"], jstate["params"], 1e-3, 3)
    _assert_tree_close(tstate["opt"]["mu"], jstate["opt"]["mu"], **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_gnn_cell_args_match_reference(shape):
    """``build_cell("schnet", shape)``'s state and batch: the reference's
    shapes and dtypes as meta tensors (nothing allocated at the published
    sizes), the reference's kind and donated argument."""
    jp = jsteps.build_cell("schnet", shape, make_host_mesh())
    tp = steps.build_cell("schnet", shape)
    assert (tp.arch, tp.shape, tp.kind, tp.donate_argnums) == (
        "schnet", shape, jp.kind, jp.donate_argnums)
    for ours, theirs in zip(tp.args, jp.args):
        assert all(t.device.type == "meta" for t in tree_leaves(ours))
        flat = jax.tree_util.tree_leaves_with_path(theirs)
        assert len(flat) == len(tree_leaves(ours))
        for path, leaf in flat:
            t = _get(ours, path)
            assert tuple(t.shape) == tuple(leaf.shape), path
            assert str(t.dtype).split(".")[-1] == str(
                jnp.dtype(leaf.dtype)), path


@pytest.fixture
def torch_mesh():
    """A one-rank gloo mesh (1, 1), its process group destroyed after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    yield make_host_mesh((1, 1), device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", ["molecule", "full_graph_sm"])
def test_gnn_cells_on_a_mesh_take_the_references_layout(torch_mesh, shape):
    """On a mesh a GNN cell's state is replicated and its edge arrays lie
    over the DP axes, spec for spec as the reference's ``_gnn_train``; an
    option that the family does not read changes nothing."""
    jp = jsteps.build_cell("schnet", shape, make_host_mesh())
    for opts in ((), ("table_md",)):
        tp = steps.build_cell("schnet", shape, torch_mesh, opts)
        assert tp.mesh is torch_mesh and tp.meta["captured"] is False
        assert spec_paths(tp.in_shardings) == spec_paths(jp.in_shardings)
        assert spec_paths(tp.out_shardings) == spec_paths(jp.out_shardings)


@pytest.mark.parametrize("mode", ["full", "molecule"])
def test_compiled_gnn_step_is_the_eager_step_on_the_cpu(mode):
    """On the CPU ``compiled()`` runs the in-place step eagerly over static
    buffers: after N calls the step count is N, the losses and the state
    equal the eager ``step_fn``'s bit for bit from the same state and
    batches, one entry in all; the loss falls over the steps."""
    spec = SMALL_SPECS[mode]
    _, tcfg = _cfgs()
    prog = steps._gnn_train(tcfg, spec)
    step = prog.compiled(device="cpu")
    assert isinstance(step, CompiledStep)
    state = prog.init(seed=1, device="cpu")
    twin = tree_map(torch.clone, state)
    n_edges = prog.args[1]["senders"].shape[0]
    batch = {k: _t(v) for k, v in _gnn_batch(spec, n_edges, 5).items()}
    losses = []
    for i in range(6):
        out, m = step(state, batch)
        assert out is state and int(state["opt"]["step"]) == i + 1
        _, me = prog.step_fn(twin, batch)
        assert torch.equal(m["loss"], me["loss"])
        losses.append(float(m["loss"]))
    assert step.compilations == 1
    for a, b in zip(tree_leaves(state), tree_leaves(twin)):
        assert torch.equal(a, b)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
