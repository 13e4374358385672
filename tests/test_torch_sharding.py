"""The port's sharding rule sets, placements, meshes and sharded cells
(``repro_torch.dist.sharding``, ``repro_torch.launch.mesh``, the mesh
paths of ``repro_torch.launch.steps``) against the reference.

* every rule set's spec tree equals the reference's leaf for leaf, for
  every config on both production meshes (the reference reads an
  ``AbstractMesh``, so no 256 devices are needed);
* ``placements`` refuses a dim that does not divide; local shard shapes
  are the ceil arithmetic over the reference's specs;
* on a one-rank gloo mesh ``(1, 1)`` every sharded builder — and the
  'moe_local', 'seq_par', 'table_md' and 'serve_full_dp' options — runs
  the mesh-less program's arithmetic: losses, states and scores within
  fp32 2e-4 after two steps, over shrunk configs;
* ``moe_ffn(tp_axis='model')`` on that mesh against the reference's
  ``moe_ffn``.

The one-rank group lives in a module fixture and is destroyed at its
teardown; the 256 / 512-rank fake groups live only in subprocesses
(``tests/test_torch_dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.dist import sharding as jsh
from repro.models import transformer as jt
from repro.models.schnet import init_schnet_params as j_init_schnet
from repro_torch import configs as tconfigs
from repro_torch.common import (feeds_from_numpy, params_from_numpy,
                                tree_leaves)
from repro_torch.data.features import make_recsys_feeds
from repro_torch.dist import policy
from repro_torch.dist import sharding as sh
from repro_torch.launch import steps
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_context)
from repro_torch.models import schnet as tschnet
from repro_torch.models import transformer as tt
from test_torch_gpu import SMALL_GNN_SPECS, small_gnn_batch

TOL = dict(rtol=2e-4, atol=2e-4)
LM_ARCHS = ("qwen3-14b", "yi-9b", "deepseek-67b", "mixtral-8x7b",
            "granite-moe-3b-a800m")
RECSYS_ARCHS = ("dlrm-mlperf", "deepfm", "fm", "din", "paper-ranking")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _abstract(kind):
    shape, names = MESHES[kind]
    try:
        jm = AbstractMesh(shape, names)
    except TypeError:           # older jax: ((name, size), ...)
        jm = AbstractMesh(tuple(zip(names, shape)))
    return jm, sh.AbstractMesh(shape, names)


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{pre}/{k}")
    else:
        yield pre, tree


def _same_specs(ours, theirs):
    a, b = dict(_flat(ours)), dict(_flat(theirs))
    assert a.keys() == b.keys()
    for k in a:
        assert isinstance(a[k], sh.P), k
        assert tuple(a[k]) == tuple(b[k]), (k, a[k], b[k])


# -- the rule sets against the reference --------------------------------------

@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS + RECSYS_ARCHS + ("schnet",))
def test_spec_trees_equal_the_reference(arch, mesh_kind):
    jm, tm = _abstract(mesh_kind)
    jmod, tmod = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert sh.dp_axes(tm) == jsh.dp_axes(jm)
    if tmod.FAMILY == "lm":
        jcfg, tcfg = jmod.CONFIG, tmod.CONFIG
        _same_specs(sh.lm_param_pspecs(tcfg), jsh.lm_param_pspecs(jcfg))
        _same_specs(sh.lm_state_pspecs(tcfg), jsh.lm_state_pspecs(jcfg))
        assert tuple(sh.lm_batch_pspec(tm)) == tuple(jsh.lm_batch_pspec(jm))
        for batch in (1, 32, 128, 256):
            _same_specs(sh.lm_cache_pspecs(tm, batch),
                        jsh.lm_cache_pspecs(jm, batch))
    elif tmod.FAMILY == "recsys":
        jg, _ = jmod.BUILD()
        tg, _ = tmod.BUILD()
        for axes in (("model",), ("model", "data")):
            _same_specs(sh.recsys_param_pspecs(tg, axes),
                        jsh.recsys_param_pspecs(jg, axes))
            _same_specs(sh.recsys_state_pspecs(tg, axes),
                        jsh.recsys_state_pspecs(jg, axes))
        for train in (False, True):
            _same_specs(sh.recsys_feed_pspecs(tg, tm, train),
                        jsh.recsys_feed_pspecs(jg, jm, train))
    else:
        cfg = dataclasses.replace(tmod.CONFIG, d_feat=1433, n_out=7)
        jcfg = dataclasses.replace(jmod.CONFIG, d_feat=1433, n_out=7)
        jshapes = jax.eval_shape(
            lambda: j_init_schnet(jcfg, jax.random.PRNGKey(0)))
        _same_specs(sh.gnn_state_pspecs(tschnet.schnet_param_specs(cfg)),
                    jsh.gnn_state_pspecs(jshapes))


def test_spec_normalises_like_jax():
    from jax.sharding import PartitionSpec as JP
    for parts in ((("data",), None), (("model", "data"), None), ((), "m"),
                  ()):
        assert tuple(sh.P(*parts)) == tuple(JP(*parts))


# -- the reference's TestShardingRules, on the port ---------------------------

class TestShardingRules:
    def test_lm_pspecs_cover_tree(self):
        for arch in ["mixtral-8x7b", "qwen3-14b"]:
            cfg = tconfigs.get_config(arch).CONFIG
            shapes = tt.lm_param_specs(cfg)
            pp = sh.lm_param_pspecs(cfg)
            assert ({k for k, _ in _flat(pp)}
                    == {k for k, _ in _flat(shapes)})
            zp = sh.zero1_pspecs(pp, shapes)
            for _, spec in _flat(zp):
                flat = [a for p in spec if p
                        for a in (p if isinstance(p, tuple) else (p,))]
                assert len(set(flat)) == len(flat), "axis reused in one spec"

    def test_vocab_padding_divisible(self):
        for arch in LM_ARCHS:
            cfg = tconfigs.get_config(arch).CONFIG
            assert cfg.vocab_padded % 256 == 0
            assert cfg.vocab_padded >= cfg.vocab

    def test_recsys_big_tables_sharded(self):
        graph, _ = tconfigs.get_config("dlrm-mlperf").BUILD()
        pp = sh.recsys_param_pspecs(graph)
        big = pp["sparse_0_emb"]["table"]
        small = pp["sparse_5_emb"]["table"]   # vocab 3
        assert big[0] == "model" and small[0] is None


# -- placements ---------------------------------------------------------------

def test_placements_refuse_a_dim_that_does_not_divide():
    _, tm = _abstract("single")
    with pytest.raises(ValueError, match="does not divide"):
        sh.placements(tm, sh.P("model", None), (24, 8))
    with pytest.raises(ValueError, match="does not divide"):
        sh.placements(tm, sh.P(None, ("model", "data")), (8, 128))
    with pytest.raises(ValueError, match="twice"):
        sh.placements(tm, sh.P("model", "model"), (16, 16))
    from torch.distributed.tensor import Replicate, Shard
    assert sh.placements(tm, sh.P(("model", "data"), None), (512, 8)) == (
        Shard(0), Shard(0))
    assert sh.placements(tm, sh.P(None, "model"), (3, 32)) == (
        Replicate(), Shard(1))
    assert sh.named(tm, {"a": sh.P("data"), "b": {"c": sh.P()}}) == {
        "a": (Shard(0), Replicate()), "b": {"c": (Replicate(), Replicate())}}


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-14b"])
def test_local_shapes_are_the_ceil_arithmetic_of_the_reference(arch,
                                                                mesh_kind):
    """Each leaf's local shard shape is ceil(dim / product of its axes'
    sizes) over the reference's spec, for params and ZeRO-1 state; the
    joint ('model', 'data') entry holds the same rows per device (DTensor
    splits it data-major: a deliberate divergence in which block a device
    owns, not in its size)."""
    jm, tm = _abstract(mesh_kind)
    cfg = tconfigs.get_config(arch).CONFIG
    shapes = dict(_flat(tt.lm_param_specs(cfg)))
    specs = jsh.lm_state_pspecs(jconfigs.get_config(arch).CONFIG)
    sizes = dict(zip(tm.mesh_dim_names, tm.shape))
    for part in ("params", "opt/mu", "opt/master"):
        tree = specs
        for k in part.split("/"):
            tree = tree[k]
        for path, jspec in _flat(tree):
            shape = tuple(shapes[path].shape)
            want = []
            for d, size in enumerate(shape):
                entry = jspec[d] if d < len(jspec) else None
                axes = (() if entry is None else
                        entry if isinstance(entry, tuple) else (entry,))
                want.append(-(-size // int(np.prod([sizes[a]
                                                   for a in axes]))))
            assert sh.local_shape(shape, tm, sh.P(*jspec)) == tuple(want), \
                (part, path)


def test_production_mesh_names_the_fake_group_when_the_world_is_small():
    with pytest.raises(RuntimeError, match="fake"):
        make_production_mesh(device_type="cpu")


def test_mesh_context_of_none_is_a_null_context():
    with mesh_context(None):
        assert policy.get("mesh") is None


# -- the sharded cells on a one-rank mesh -------------------------------------

@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist
    m = make_host_mesh((1, 1), device="cpu")
    yield m
    if dist.is_initialized():
        dist.destroy_process_group()


def _lm_cell(kind, opts, mesh, arch="granite-moe-3b-a800m"):
    cfg = tconfigs.get_config(arch).smoke_config()
    if kind == "train":
        return cfg, (steps._lm_train(cfg, 16, 4),
                     steps._lm_train(cfg, 16, 4, mesh, frozenset(opts)))
    if kind == "prefill":
        return cfg, (steps._lm_prefill(cfg, 16, 2),
                     steps._lm_prefill(cfg, 16, 2, mesh, frozenset(opts)))
    return cfg, (steps._lm_decode(cfg, 16, 2), steps._lm_decode(cfg, 16, 2,
                                                                 mesh))


def _close(got, want):
    got = got.full_tensor() if sh.is_dtensor(got) else got
    torch.testing.assert_close(got.float(), want.float(), **TOL)


def _two_steps(plain, sharded, mesh, batches):
    """Two steps of each program from the same seed; losses and every
    state leaf within 2e-4."""
    sa, sb = plain.init(seed=3, device="cpu"), sharded.init(seed=3,
                                                            device="cpu")
    assert all(sh.is_dtensor(t) for t in tree_leaves(sb))
    step = sharded.compiled(device="cpu")
    for batch in batches:
        _, ma = plain.step_fn(sa, *batch)
        dbatch = tuple(sh.distribute(b, mesh, spec) for b, spec in
                       zip(batch, sharded.in_shardings[1:]))
        _, mb = step(sb, *dbatch)
        _close(mb["loss"], ma["loss"])
    for a, b in zip(tree_leaves(sa), tree_leaves(sb)):
        _close(b, a)
    assert sharded.meta["captured"] is False


@pytest.mark.parametrize("opts", [(), ("moe_local",), ("seq_par",),
                                  ("moe_local", "seq_par")])
def test_lm_train_on_a_mesh_is_the_plain_step(mesh, opts):
    cfg, (plain, sharded) = _lm_cell("train", opts, mesh)
    assert sharded.mesh is mesh
    assert ("moe_shard_axes" in sharded.policy_kv) == ("moe_local" in opts)
    assert ("residual" in sharded.policy_kv) == ("seq_par" in opts)
    g = torch.Generator().manual_seed(0)
    batches = []
    for _ in range(2):
        tok = torch.randint(0, cfg.vocab, (4, 16), generator=g,
                            dtype=torch.int32)
        batches.append(({"tokens": tok, "labels": tok.roll(-1, 1)},))
    _two_steps(plain, sharded, mesh, batches)


@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x7b"])
def test_lm_prefill_and_decode_on_a_mesh(mesh, arch):
    cfg, (plain, sharded) = _lm_cell("prefill", (), mesh, arch)
    params = plain.init(seed=1, device="cpu")
    dparams = sharded.init(seed=1, device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 16), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1))
    la, kva = plain.compiled(device="cpu")(params, tok)
    lb, kvb = sharded.compiled(device="cpu")(
        dparams, sh.distribute({"t": tok}, mesh, {"t": sharded.in_shardings[
            1]})["t"])
    _close(lb, la)
    _close(kvb["k"], kva["k"])
    cfg, (plain, sharded) = _lm_cell("decode", (), mesh, arch)
    cache = tt.init_kv_cache(cfg, 2, 16, device="cpu")
    dcache = sh.distribute(tt.init_kv_cache(cfg, 2, 16, device="cpu"), mesh,
                           sharded.in_shardings[1])
    run = sharded.compiled(device="cpu")
    for t in range(3):
        pos = torch.tensor(t, dtype=torch.int32)
        want, _ = plain.step_fn(params, cache, tok[:, t:t + 1], pos)
        args = sh.distribute({"t": tok[:, t:t + 1], "p": pos}, mesh,
                             {"t": sharded.in_shardings[2],
                              "p": sharded.in_shardings[3]})
        got, out = run(dparams, dcache, args["t"], args["p"])
        assert out is dcache
        _close(got, want)


def _recsys_mod(arch):
    """The arch's smoke build, as ``steps``' recsys builders take a
    config module."""
    return types.SimpleNamespace(
        BUILD=tconfigs.get_config(arch).smoke_build(), FAMILY="recsys")


@pytest.mark.parametrize("opts", [(), ("table_md",)])
def test_recsys_train_on_a_mesh_is_the_plain_step(mesh, opts):
    mod = _recsys_mod("dlrm-mlperf")
    plain = steps._recsys_train(mod, 32)
    sharded = steps._recsys_train(mod, 32, mesh, frozenset(opts))
    graph, _ = mod.BUILD()
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        feeds = feeds_from_numpy(make_recsys_feeds(graph, 32, rng,
                                                   tile_user=True),
                                 device="cpu")
        labels = torch.as_tensor(rng.integers(0, 2, (32, 1)),
                                 dtype=torch.float32)
        batches.append((feeds, labels))
    _two_steps(plain, sharded, mesh, batches)


def test_table_md_shards_the_big_tables_over_model_and_data(mesh):
    jgraph, _ = jconfigs.get_config("dlrm-mlperf").BUILD()
    for opts, axes in (((), ("model",)), (("table_md",), ("model", "data"))):
        prog = steps.build_cell("dlrm-mlperf", "train_batch", mesh, opts)
        _same_specs(prog.in_shardings[0],
                    jsh.recsys_state_pspecs(jgraph, axes))
        assert tuple(prog.in_shardings[2]) == ("data", None)


@pytest.mark.parametrize("opts", [(), ("serve_full_dp",)])
@pytest.mark.parametrize("arch", ["paper-ranking", "din"])
def test_recsys_serve_on_a_mesh_is_the_plain_program(mesh, arch, opts):
    mod = _recsys_mod(arch)
    plain = steps._recsys_serve(mod, 300)
    sharded = steps._recsys_serve(mod, 300, mesh=mesh, opts=frozenset(opts))
    batch = 512 if opts else 300
    assert sharded.meta.get("padded_batch") == (512 if opts else None)
    assert {v.shape[0] for v in sharded.args[1].values()} <= {1, batch}
    params = plain.init(seed=4, device="cpu")
    dparams = sharded.init(seed=4, device="cpu")
    g, _ = mod.BUILD()
    feeds = feeds_from_numpy(make_recsys_feeds(g, batch,
                                               np.random.default_rng(1)),
                             device="cpu")
    want = plain.step_fn(params, feeds)
    got = sharded.compiled(device="cpu")(
        dparams, sh.distribute(feeds, mesh, sharded.in_shardings[1]))
    assert tuple(got.placements) == sh.placements(mesh, sharded.out_shardings)
    _close(got, want)


@pytest.mark.parametrize("mode", ["full", "molecule"])
def test_gnn_train_on_a_mesh_is_the_plain_step(mesh, mode):
    cfg = tconfigs.get_config("schnet").smoke_config()
    spec = SMALL_GNN_SPECS[mode]
    plain = steps._gnn_train(cfg, spec)
    sharded = steps._gnn_train(cfg, spec, mesh)
    n_edges = plain.args[1]["senders"].shape[0]
    batches = [({k: torch.as_tensor(v) for k, v in small_gnn_batch(
        spec, n_edges, 7 + i).items()},) for i in range(2)]
    _two_steps(plain, sharded, mesh, batches)


def test_build_cell_takes_a_mesh_and_every_sharded_option(mesh):
    for arch, shape, opts in (
            ("granite-moe-3b-a800m", "train_4k", ("moe_local", "seq_par")),
            ("mixtral-8x7b", "decode_32k", ()),
            ("yi-9b", "prefill_32k", ("seq_par",)),
            ("dlrm-mlperf", "train_batch", ("table_md",)),
            ("paper-ranking", "serve_bulk", ("serve_full_dp",)),
            ("schnet", "molecule", ())):
        prog = steps.build_cell(arch, shape, mesh, opts)
        assert prog.mesh is mesh and prog.in_shardings is not None
        assert prog.meta["captured"] is False
        assert len(prog.in_shardings) == len(prog.args)


# -- moe_local: the shard-local MoE against the reference's ------------------

def test_moe_ffn_tp_axis_on_a_mesh_is_the_references(mesh):
    jcfg = jconfigs.get_config("granite-moe-3b-a800m").smoke_config()
    tcfg = tconfigs.get_config("granite-moe-3b-a800m").smoke_config()
    jp = jt.init_lm_params(jcfg, jax.random.PRNGKey(0))
    ffn_j = {k: v[0] for k, v in jp["layers"]["ffn"].items()}
    ffn_t = params_from_numpy({k: np.asarray(v) for k, v in ffn_j.items()},
                              device="cpu")
    x = np.random.default_rng(0).standard_normal(
        (24, jcfg.d_model)).astype(np.float32)
    want = np.asarray(jt.moe_ffn(jnp.asarray(x), ffn_j, jcfg))
    with mesh_context(mesh):
        got = tt.moe_ffn(torch.as_tensor(x), ffn_t, tcfg, tp_axis="model")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="mesh"):
        tt.moe_ffn(torch.as_tensor(x), ffn_t, tcfg, tp_axis="model")


def test_policy_constrain_redistributes_and_refuses_plain_tensors(mesh):
    from torch.distributed.tensor import Replicate, Shard
    x = sh.distribute({"x": torch.arange(8.0).reshape(2, 4)}, mesh,
                      {"x": sh.P("data", None)})["x"]
    assert policy.constrain(x, "residual") is x
    with policy.use(residual=(mesh, (Replicate(), Shard(1)))):
        y = policy.constrain(x, "residual")
        assert tuple(y.placements) == (Replicate(), Shard(1))
        torch.testing.assert_close(y.full_tensor(), x.full_tensor())
        with pytest.raises(TypeError, match="plain"):
            policy.constrain(torch.ones(3), "residual")


# -- four gloo ranks on a (2, 2) mesh ----------------------------------------

WORKER = r"""
import dataclasses, json, sys, types
import numpy as np, torch, torch.distributed as dist
rank, init = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
torch.set_num_threads(1)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs as tconfigs
from repro_torch.common import feeds_from_numpy, tree_leaves
from repro_torch.data.features import make_recsys_feeds
from repro_torch.dist import sharding as sh
from repro_torch.launch import steps
from repro_torch.models import transformer as tt
from test_torch_gpu import SMALL_GNN_SPECS, small_gnn_batch
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {}

def full(t):
    return t.full_tensor() if sh.is_dtensor(t) else t

def err(a, b):
    return max(float((full(x).float() - full(y).float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))

def two_steps(name, plain, sharded, batches):
    sa, sb = plain.init(seed=3, device="cpu"), sharded.init(seed=3,
                                                            device="cpu")
    step, d = sharded.compiled(device="cpu"), 0.0
    for batch in batches:
        _, ma = plain.step_fn(sa, *batch)
        _, mb = step(sb, *(sh.distribute(b, mesh, s) for b, s in
                           zip(batch, sharded.in_shardings[1:])))
        d = max(d, abs(float(ma["loss"]) - float(mb["loss"])))
    out[name] = max(d, err(sa, sb))

# no capacity drops: 'moe_local' then routes as the global MoE does
cfg = dataclasses.replace(
    tconfigs.get_config("granite-moe-3b-a800m").smoke_config(),
    capacity_factor=100.0)
g = torch.Generator().manual_seed(0)
toks = [torch.randint(0, cfg.vocab, (4, 16), generator=g, dtype=torch.int32)
        for _ in range(2)]
for opts in ((), ("moe_local",), ("seq_par",)):
    two_steps("lm_train" + "+".join(opts), steps._lm_train(cfg, 16, 4),
              steps._lm_train(cfg, 16, 4, mesh, frozenset(opts)),
              [({"tokens": t, "labels": t.roll(-1, 1)},) for t in toks])
plain, sharded = steps._lm_prefill(cfg, 16, 4), steps._lm_prefill(
    cfg, 16, 4, mesh)
p, dp = plain.init(seed=1, device="cpu"), sharded.init(seed=1, device="cpu")
la, kva = plain.step_fn(p, toks[0])
lb, kvb = sharded.step_fn(dp, sh.distribute(toks[0], mesh,
                                            sharded.in_shardings[1]))
out["lm_prefill"] = max(err(la, lb), err(kva, kvb))
plain, sharded = steps._lm_decode(cfg, 16, 4), steps._lm_decode(cfg, 16, 4,
                                                                mesh)
ca = tt.init_kv_cache(cfg, 4, 16, device="cpu")
cb = sh.distribute(tt.init_kv_cache(cfg, 4, 16, device="cpu"), mesh,
                   sharded.in_shardings[1])
d = 0.0
for t in range(3):
    pos = torch.tensor(t, dtype=torch.int32)
    want, _ = plain.step_fn(p, ca, toks[1][:, t:t + 1], pos)
    got, _ = sharded.step_fn(dp, cb, *(sh.distribute(a, mesh, s) for a, s in
                             zip((toks[1][:, t:t + 1], pos),
                                 sharded.in_shardings[2:])))
    d = max(d, err(want, got))
out["lm_decode"] = d

# the smoke tables are small: shard every table whose rows divide by 4
def pspecs(graph, table_axes=("model",)):
    pp = sh.recsys_param_pspecs(graph, table_axes)
    lead = table_axes[0] if len(table_axes) == 1 else tuple(table_axes)
    for n in graph.param_nodes():
        if n.op == "embedding" and n.attrs["vocab"] % 4 == 0:
            pp[n.name]["table"] = sh.P(lead, None)
    return pp
steps.recsys_param_pspecs = pspecs
steps.recsys_state_pspecs = lambda graph, table_axes=("model",): {
    "params": pspecs(graph, table_axes),
    "opt": {"mu": pspecs(graph, table_axes), "nu": pspecs(graph, table_axes),
            "step": sh.P()}}
mod = types.SimpleNamespace(
    BUILD=tconfigs.get_config("dlrm-mlperf").smoke_build(), FAMILY="recsys")
graph, _ = mod.BUILD()
out["sharded_tables"] = len([n for n in graph.param_nodes()
                             if n.op == "embedding"
                             and n.attrs["vocab"] % 4 == 0])
rng = np.random.default_rng(0)
batches = [(feeds_from_numpy(make_recsys_feeds(graph, 32, rng,
                                               tile_user=True), device="cpu"),
            torch.as_tensor(rng.integers(0, 2, (32, 1)), dtype=torch.float32))
           for _ in range(2)]
for opts in ((), ("table_md",)):
    two_steps("recsys_train" + "+".join(opts), steps._recsys_train(mod, 32),
              steps._recsys_train(mod, 32, mesh, frozenset(opts)), batches)
for opts in ((), ("serve_full_dp",)):
    plain = steps._recsys_serve(mod, 304)
    sharded = steps._recsys_serve(mod, 304, mesh=mesh, opts=frozenset(opts))
    batch = sharded.meta.get("padded_batch", 304)
    feeds = feeds_from_numpy(make_recsys_feeds(graph, batch,
                                               np.random.default_rng(1)),
                             device="cpu")
    want = plain.step_fn(plain.init(seed=4, device="cpu"), feeds)
    got = sharded.step_fn(sharded.init(seed=4, device="cpu"),
                          sh.distribute(feeds, mesh, sharded.in_shardings[1]))
    out["recsys_serve" + "+".join(opts)] = err(want, got)
scfg = tconfigs.get_config("schnet").smoke_config()
spec = SMALL_GNN_SPECS["molecule"]
plain, sharded = steps._gnn_train(scfg, spec), steps._gnn_train(scfg, spec,
                                                                 mesh)
n_edges = plain.args[1]["senders"].shape[0]
two_steps("gnn_molecule", plain, sharded,
          [({k: torch.as_tensor(v) for k, v in small_gnn_batch(
              spec, n_edges, 7 + i).items()},) for i in range(2)])
if rank == 0:
    print(json.dumps(out))
dist.destroy_process_group()
"""


def test_every_sharded_program_on_four_ranks_is_the_plain_one(tmp_path):
    """Four gloo ranks as a (2, 2) mesh, each a subprocess (a file://
    rendezvous in ``tmp_path``): LM train (plain, 'moe_local' without
    capacity drops, 'seq_par'), prefill and three decode steps; recsys
    train with the tables over 'model' and with 'table_md', serve with
    and without 'serve_full_dp'; SchNet's molecule step. Every loss,
    state, output and cache within 2e-4 of the one-process plain
    program."""
    import os
    import subprocess
    import sys
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    here = os.path.dirname(__file__)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(here, "..", "src"), here]))
    init = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), init],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    assert res.pop("sharded_tables") > 0
    assert len(res) == 10, res
    assert all(v <= 2e-4 for v in res.values()), res


# -- kernel entries on DTensors ----------------------------------------------

def test_kernel_entries_run_on_local_shards(mesh):
    """A kernel entry given DTensors runs on this rank's tensors and lays
    its output out as its row arguments (on the CPU the entry's plain
    version, as for any CPU tensor)."""
    from repro_torch.kernels.dot_interaction import dot_interaction
    from repro_torch.kernels.mari_matmul import mari_matmul
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(8, 16, generator=g), torch.randn(16, 4, generator=g)
    u = torch.randn(1, 4, generator=g)
    d = sh.distribute({"x": x, "w": w, "u": u}, mesh,
                      {"x": sh.P("data", None), "w": sh.P(None, None),
                       "u": sh.P(None, None)})
    got = mari_matmul(d["x"], d["w"], d["u"], activation="relu")
    assert tuple(got.placements) == sh.placements(mesh, sh.P("data", None))
    torch.testing.assert_close(got.full_tensor(),
                               mari_matmul(x, w, u, activation="relu"))
    f = torch.randn(8, 3, 4, generator=g)
    got = dot_interaction(sh.distribute({"f": f}, mesh, {"f": sh.P(
        ("data", "model"), None, None)})["f"])
    torch.testing.assert_close(got.full_tensor(), dot_interaction(f))
