"""The LM family's serving path in the port (``repro_torch.models.
transformer``, ``nn.layers.rms_norm``, ``dist.policy``, ``data.lm``,
``launch.steps`` and the five LM configs) against the JAX reference, on
the CPU at the smoke configs' widths (fp32).

The same numpy inputs, drawn from a seed, go through both packages;
weights cross with ``params_from_numpy``. Tolerances: rtol = atol = 2e-4
for values (tests/test_kernels.py's fp32 bar); gradients rtol = 2e-4,
atol = 1e-6 (they are ~1e-3 in size, so the value bar's atol would hold
nothing; the two autodiffs differ by ~1e-7).
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import lm as jlm
from repro.dist import policy as jpolicy
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_cell as j_build_cell
from repro.models import transformer as jt
from repro.nn.layers import RMSNorm as JRMSNorm
from repro.nn.layers import rms_norm as j_rms_norm
from repro_torch import configs as tconfigs
from repro_torch.common import params_from_numpy, tree_leaves, value_and_grad
from repro_torch.data import lm as tlm
from repro_torch.dist import policy
from repro_torch.launch.steps import CompiledDecode, build_cell
from repro_torch.models import transformer as tt
from repro_torch.nn.layers import RMSNorm, rms_norm

LM_ARCHS = ("mixtral-8x7b", "granite-moe-3b-a800m", "deepseek-67b",
            "qwen3-14b", "yi-9b")
TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)


# the reference's decode step, compiled once per config (its eager scans
# retrace at every step)
_j_decode = jax.jit(jt.lm_decode_step, static_argnums=1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfgs(arch, **over):
    """The reference's smoke config (with ``over``) and the port's copy."""
    jcfg = jconfigs.get_config(arch).smoke_config()
    if over:
        jcfg = dataclasses.replace(jcfg, **over)
    return jcfg, tt.LMConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, seed=0):
    jp = jt.init_lm_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return jp, params_from_numpy(_np(jp), "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy() if isinstance(
        got, torch.Tensor) else got, np.asarray(want), **tol)


# -- flash attention, RoPE, RMSNorm ----------------------------------------

@pytest.mark.parametrize("s,window,qc,kc", [
    (32, None, 8, 8), (32, 8, 8, 16), (64, 16, 16, 8), (32, None, 32, 32),
])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_flash_attention_matches_reference(s, window, qc, kc, hq, hkv):
    """tests/test_flash_and_parser.py's grid, through both packages."""
    b, hd = 2, 16
    rng = np.random.default_rng(s + hq)
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for h in (hq, hkv, hkv))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    want = jt.flash_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                              causal=True, window=window, q_chunk=qc,
                              kv_chunk=kc)
    got = tt.flash_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                             causal=True, window=window, q_chunk=qc,
                             kv_chunk=kc)
    _close(got, want)


@pytest.mark.parametrize("seed,sq,sk", [(0, 8, 16), (1, 16, 32), (2, 8, 32),
                                        (3, 16, 16)])
def test_flash_attention_decode_style_with_validity(seed, sq, sk):
    """Query shorter than KV, a ring-buffer validity mask (the reference's
    ``test_cross_lengths_with_validity``)."""
    b, hq, hkv, hd = 1, 4, 2, 8
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, hkv, hd)).astype(np.float32)
            for _ in range(2))
    q_pos = np.broadcast_to(np.arange(sk - sq, sk, dtype=np.int32)[None],
                            (b, sq)).copy()
    kv_pos = np.broadcast_to(np.arange(sk, dtype=np.int32)[None],
                             (b, sk)).copy()
    valid = rng.random((b, sk)) < 0.8
    valid[:, -1] = True
    kw = dict(causal=True, window=None, q_chunk=8, kv_chunk=8)
    want = jt.flash_attention(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)),
                              kv_valid=jnp.asarray(valid), **kw)
    got = tt.flash_attention(_t(q), _t(k), _t(v), _t(q_pos), _t(kv_pos),
                             kv_valid=_t(valid), **kw)
    _close(got, want)


def test_flash_attention_refuses_chunks_that_do_not_divide():
    x = torch.zeros(1, 12, 2, 8)
    pos = torch.arange(12)[None]
    with pytest.raises(ValueError, match="chunks must divide"):
        tt.flash_attention(x, x, x, pos, pos, q_chunk=8, kv_chunk=8)


@pytest.mark.parametrize("theta", [1e4, 1e6, 5e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(int(theta) % 97)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 600_000, (2, 5)).astype(np.int32)
    _close(tt._rope(_t(x), _t(pos), theta),
           jt._rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_rms_norm_matches_reference_fp32_and_bf16_bits():
    """fp32 within 2e-4; bf16 bit for bit (rsqrt cast to x.dtype before
    the multiply, then the scale, in the reference's order)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 64)).astype(np.float32) * 3
    sc = rng.standard_normal(64).astype(np.float32)
    _close(rms_norm(_t(x), _t(sc)), j_rms_norm(jnp.asarray(x),
                                               jnp.asarray(sc)))
    jx, js = jnp.asarray(x, jnp.bfloat16), jnp.asarray(sc, jnp.bfloat16)
    want = np.asarray(j_rms_norm(jx, js)).view(np.int16)
    got = rms_norm(params_from_numpy(np.asarray(jx), "cpu"),
                   params_from_numpy(np.asarray(js), "cpu"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want)


def test_rms_norm_layer_matches_reference():
    x = np.random.default_rng(1).standard_normal((3, 32)).astype(np.float32)
    jl, tl = JRMSNorm(32), RMSNorm(32)
    jp = jl.init(jax.random.PRNGKey(0))
    tp = tl.init(device="cpu")
    _close(tp["scale"], jp["scale"])
    _close(tl.apply(tp, _t(x)), jl.apply(jp, jnp.asarray(x)))


# -- MoE --------------------------------------------------------------------

def _drops(cfg, logits, T):
    """Assignments past their expert's capacity, from the routing alone."""
    topi = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.moe_top_k]
    counts = np.bincount(topi.reshape(-1), minlength=cfg.moe_experts)
    return int(np.maximum(counts - tt.moe_capacity(cfg, T), 0).sum())


@pytest.mark.parametrize("arch,T", [("granite-moe-3b-a800m", 24),
                                    ("granite-moe-3b-a800m", 96),
                                    ("mixtral-8x7b", 40)])
def test_moe_ffn_matches_reference_with_capacity_drops(arch, T):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=T)
    ffn_j = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["ffn"])
    ffn_t = {k: v[0] for k, v in tp["layers"]["ffn"].items()}
    rng = np.random.default_rng(T)
    # a shared direction biases the router, so some experts overflow
    x = (rng.standard_normal((T, jcfg.d_model))
         + 2.0 * rng.standard_normal(jcfg.d_model)).astype(np.float32)
    logits = x @ np.asarray(ffn_j["router"])
    assert _drops(jcfg, logits, T) > 0
    _close(tt.moe_ffn(_t(x), ffn_t, tcfg),
           jt.moe_ffn(jnp.asarray(x), ffn_j, jcfg))


@pytest.fixture
def torch_mesh():
    """A one-rank gloo mesh (1, 1), its process group destroyed after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh as t_make_host_mesh
    yield t_make_host_mesh((1, 1), device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def test_moe_ffn_sums_a_tensor_parallel_axis_over_the_mesh(torch_mesh):
    """``tp_axis`` sums the partial output over that axis of the active
    mesh (one rank here: the reference's value); with no mesh active it
    raises."""
    from repro_torch.launch.mesh import mesh_context
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m")
    jp, tp = _params(jcfg)
    ffn_j = {k: v[0] for k, v in jp["layers"]["ffn"].items()}
    ffn = {k: v[0] for k, v in tp["layers"]["ffn"].items()}
    x = np.random.default_rng(3).standard_normal(
        (16, jcfg.d_model)).astype(np.float32)
    with mesh_context(torch_mesh):
        got = tt.moe_ffn(_t(x), ffn, tcfg, tp_axis="model")
    _close(got, jt.moe_ffn(jnp.asarray(x), ffn_j, jcfg))
    with pytest.raises(ValueError, match="mesh"):
        tt.moe_ffn(_t(x), ffn, tcfg, tp_axis="model")


# -- the five archs end to end ------------------------------------------------

def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_logits_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, 2, 16, 1)
    got = tt.lm_logits(tp, tcfg, _t(toks))
    assert got.shape == (2, 16, jcfg.vocab_padded)
    _close(got, jt.lm_logits(jp, jcfg, jnp.asarray(toks)))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_gradients_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, 2, 32, 2)
    labels = np.roll(toks, -1, 1)
    jloss, jgrads = jax.value_and_grad(jt.lm_loss)(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(labels))
    loss, grads = value_and_grad(
        lambda p: tt.lm_loss(p, tcfg, _t(toks), _t(labels)), tp)
    _close(loss, jloss)
    for (path, jg), g in zip(
            jax.tree_util.tree_flatten_with_path(jgrads)[0],
            tree_leaves(tree_sort(grads))):
        assert g.shape == jg.shape, path
        _close(g, jg, GRAD_TOL)


def tree_sort(tree):
    """Dict keys sorted, as jax flattens them."""
    if isinstance(tree, dict):
        return {k: tree_sort(tree[k]) for k in sorted(tree)}
    return tree


def test_remat_under_grad_matches_reference():
    """``cfg.remat`` checkpoints each layer when grad is on; gradients
    equal the reference's ``jax.checkpoint`` run."""
    jcfg, tcfg = _cfgs("qwen3-14b", remat=True)
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, 2, 16, 3)
    labels = np.roll(toks, -1, 1)
    jloss, jgrads = jax.value_and_grad(jt.lm_loss)(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(labels))
    loss, grads = value_and_grad(
        lambda p: tt.lm_loss(p, tcfg, _t(toks), _t(labels)), tp)
    _close(loss, jloss)
    for jg, g in zip(jax.tree_util.tree_leaves(jgrads),
                     tree_leaves(tree_sort(grads))):
        _close(g, jg, GRAD_TOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_six_steps_match_reference(arch):
    """Logits and the whole cache after each of 6 steps; the port writes
    the cache in place and hands back the same dict."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    B = 2
    jc = jt.init_kv_cache(jcfg, B, 32, jnp.float32)
    tc = tt.init_kv_cache(tcfg, B, 32, device="cpu")
    k_tensor = tc["k"]
    toks = _tokens(jcfg, B, 6, 4)
    for t in range(6):
        jl, jc = _j_decode(jp, jcfg, jc, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        tl, out = tt.lm_decode_step(tp, tcfg, tc, _t(toks[:, t:t + 1]),
                                    torch.tensor(t, dtype=torch.int32))
        assert out is tc and out["k"] is k_tensor
        assert tl.shape == (B, 1, jcfg.vocab_padded)
        _close(tl, jl)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])


def test_depth_comes_from_the_params_as_in_the_reference():
    """The reference scans over the stacked params, so a depth-cut tree
    runs under the registry's config: the port loops over the params'
    leading axis, not ``cfg.n_layers``."""
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m", n_layers=3)
    jp, tp = _params(jcfg)
    cut = lambda t: t[:1]                                        # noqa: E731
    jp = {**jp, "layers": jax.tree_util.tree_map(cut, jp["layers"])}
    tp = {**tp, "layers": jax.tree_util.tree_map(cut, tp["layers"])}
    toks = _tokens(jcfg, 2, 8, 7)
    _close(tt.lm_logits(tp, tcfg, _t(toks)),
           jt.lm_logits(jp, jcfg, jnp.asarray(toks)))
    tc = tt.init_kv_cache(dataclasses.replace(tcfg, n_layers=1), 2, 8,
                          device="cpu")
    jc = jt.init_kv_cache(dataclasses.replace(jcfg, n_layers=1), 2, 8,
                          jnp.float32)
    tl, _ = tt.lm_decode_step(tp, tcfg, tc, _t(toks[:, :1]),
                              torch.tensor(0, dtype=torch.int32))
    jl, _ = _j_decode(jp, jcfg, jc, jnp.asarray(toks[:, :1]), jnp.int32(0))
    _close(tl, jl)


def test_ring_buffer_decode_matches_full_and_reference():
    """The port of ``TestMixtralSWA``: SWA ring-buffer decode equals
    full-cache decode once past the window, in the port, and both equal
    the reference's."""
    jcfg, tcfg = _cfgs("mixtral-8x7b", moe_experts=0, moe_top_k=0, window=8)
    jp, tp = _params(jcfg)
    B, T = 1, 24
    toks = _tokens(jcfg, B, T, 1)
    ring = tt.init_kv_cache(tcfg, B, T, device="cpu")
    assert ring["k"].shape[2] == 8
    full = tt.init_kv_cache(dataclasses.replace(tcfg, window=None), B, T,
                            device="cpu")
    jring = jt.init_kv_cache(jcfg, B, T, jnp.float32)
    for t in range(T):
        pos = torch.tensor(t, dtype=torch.int32)
        lr, _ = tt.lm_decode_step(tp, tcfg, ring, _t(toks[:, t:t + 1]), pos)
        lf, _ = tt.lm_decode_step(tp, tcfg, full, _t(toks[:, t:t + 1]), pos)
        jl, jring = _j_decode(jp, jcfg, jring, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t))
    torch.testing.assert_close(lr, lf, rtol=1e-4, atol=1e-4)
    _close(lr, jl)
    _close(ring["k"], jring["k"])


# -- policy -------------------------------------------------------------------

def test_policy_nests_like_the_reference():
    for pol in (policy, jpolicy):
        assert pol.get("a") is None and pol.active() == {}
        with pol.use(a=1, b=2):
            with pol.use(a=3):
                assert pol.get("a") == 3 and pol.get("b") == 2
                assert pol.active() == {"a": 3, "b": 2}
            assert pol.get("a") == 1
        assert pol.get("a", "dflt") == "dflt" and pol.active() == {}


def test_policy_is_thread_local():
    seen = {}
    entered, release = threading.Event(), threading.Event()

    def other():
        with policy.use(a="other"):
            entered.set()
            release.wait(10)
            seen["other"] = policy.get("a")

    th = threading.Thread(target=other)
    with policy.use(a="main"):
        th.start()
        assert entered.wait(10)
        seen["main"] = policy.get("a")
        release.set()
        th.join(10)
    assert not th.is_alive()
    assert seen == {"main": "main", "other": "other"}


def test_policy_constrain_passes_unset_and_lays_out_set_keys(torch_mesh):
    """An unset key passes ``x``; a set key ``(mesh, placements)``
    redistributes a DTensor and refuses a plain tensor."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist import sharding as sh
    x = torch.ones(3)
    assert policy.constrain(x, "residual") is x
    d = sh.distribute({"x": torch.arange(4.0)[None]}, torch_mesh,
                      {"x": sh.P("data", None)})["x"]
    with policy.use(residual=(torch_mesh, (Replicate(), Shard(1)))):
        with pytest.raises(TypeError, match="plain"):
            policy.constrain(x, "residual")
        y = policy.constrain(d, "residual")
        assert tuple(y.placements) == (Replicate(), Shard(1))
        assert policy.constrain(x, "other") is x


def test_model_runs_sharding_policies_on_a_mesh(torch_mesh):
    """'moe_local' and 'seq_par' act on DTensors: the sharded forward
    under each equals the plain forward (one rank), on plain tensors they
    raise, and nothing leaks out of the blocks."""
    from repro_torch.dist import sharding as sh
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m")
    _, tp = _params(jcfg)
    toks = _t(_tokens(jcfg, 2, 8, 0))
    want = tt.lm_forward(tp, tcfg, toks)
    dp = sh.distribute(tp, torch_mesh, sh.lm_param_pspecs(tcfg))
    dtoks = sh.distribute({"t": toks}, torch_mesh,
                          {"t": sh.lm_batch_pspec(torch_mesh)})["t"]
    seq = (torch_mesh, sh.placements(torch_mesh, sh.P("data", "model",
                                                      None)))
    for kv in ({}, {"moe_shard_axes": ("data",)}, {"residual": seq}):
        with policy.use(**kv):
            _close(tt.lm_forward(dp, tcfg, dtoks).full_tensor(), want)
    with policy.use(moe_shard_axes=("data",)):
        with pytest.raises(TypeError, match="moe_shard_axes"):
            tt.lm_logits(tp, tcfg, toks)
    with policy.use(residual=seq):
        with pytest.raises(TypeError, match="residual"):
            tt.lm_logits(tp, tcfg, toks)
    tt.lm_logits(tp, tcfg, toks)          # nothing leaks out of the blocks


# -- registry, specs, params --------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_registry_lm_config_matches_reference(arch):
    jmod, tmod = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert tmod.FAMILY == jmod.FAMILY == "lm"
    assert dataclasses.asdict(tmod.CONFIG) == dataclasses.asdict(jmod.CONFIG)
    assert dataclasses.asdict(tmod.smoke_config()) == dataclasses.asdict(
        jmod.smoke_config())
    assert tmod.SHAPES == jmod.SHAPES
    c = tmod.CONFIG
    assert (c.hd, c.vocab_padded, c.is_moe) == (
        jmod.CONFIG.hd, jmod.CONFIG.vocab_padded, jmod.CONFIG.is_moe)


def test_registry_refuses_only_schnet():
    """Since the SchNet slice the registry refuses no arch of the
    reference's: it holds the same names, in the same order."""
    assert list(tconfigs._ARCH_MODULES) == list(jconfigs._ARCH_MODULES)
    assert set(LM_ARCHS) <= set(tconfigs._ARCH_MODULES)
    assert tconfigs.get_config("schnet").FAMILY == "gnn"


def _shape_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")),
        tree_sort(tree) if isinstance(tree, dict) else tree)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_and_cache_specs_match_reference(arch):
    """Full-width trees on the meta device: the reference's shapes and
    dtypes, nothing allocated."""
    cfg = jconfigs.get_config(arch).CONFIG
    tcfg = tconfigs.get_config(arch).CONFIG
    tspecs = tt.lm_param_specs(tcfg)
    assert all(t.device.type == "meta" for t in tree_leaves(tspecs))
    assert _shape_tree(tspecs) == _shape_tree(jt.lm_param_specs(cfg))
    for batch, max_len in ((128, 32768), (1, 524288)):
        tc = tt.kv_cache_specs(tcfg, batch, max_len)
        assert tc["k"].device.type == "meta"
        assert _shape_tree(tc) == _shape_tree(
            jt.kv_cache_specs(cfg, batch, max_len))


def test_init_lm_params_is_seeded_and_shaped():
    _, tcfg = _cfgs("qwen3-14b")
    a = tt.init_lm_params(tcfg, seed=3, device="cpu")
    b = tt.init_lm_params(tcfg, seed=3, device="cpu")
    c = tt.init_lm_params(tcfg, seed=4, device="cpu")
    assert _shape_tree(a) == _shape_tree(tt.lm_param_specs(tcfg))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.equal(a["layers"]["attn"]["q_norm"],
                       torch.ones(tcfg.n_layers, tcfg.hd))
    assert abs(float(a["embed"].std()) - 0.02) < 2e-3


def test_bf16_params_cross_bit_for_bit():
    """A bf16 ``init_lm_params`` tree from the reference crosses through
    ``params_from_numpy`` with every bit kept (``torch.tensor`` refuses
    ml_dtypes' bfloat16)."""
    cfg = jconfigs.get_config("granite-moe-3b-a800m").smoke_config()
    jp = _np(jt.init_lm_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16))
    tp = params_from_numpy(jp, "cpu")
    for (path, a), t in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            tree_leaves(tree_sort(tp))):
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))


def test_bf16_feeds_cross_bit_for_bit():
    from repro_torch.common import feeds_from_numpy
    a = np.asarray(jnp.linspace(-3, 3, 11, dtype=jnp.bfloat16))
    got = feeds_from_numpy({"x": a}, "cpu")["x"]
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  a.view(np.int16))


def test_token_batch_and_specs():
    g = torch.Generator().manual_seed(0)
    b = tlm.token_batch(g, 3, 10, 50)
    assert b["tokens"].dtype == torch.int32 and b["tokens"].shape == (3, 10)
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 50
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert torch.equal(b["labels"][:, -1], b["tokens"][:, 0])
    jb = jlm.token_batch(jax.random.PRNGKey(0), 3, 10, 50)
    assert _shape_tree(b) == _shape_tree(jb)
    assert _shape_tree(tlm.token_batch_specs(4, 8)) == _shape_tree(
        jlm.token_batch_specs(4, 8))


# -- cell programs ------------------------------------------------------------

@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_build_cell_matches_reference(arch, shape):
    mesh = make_host_mesh()
    try:
        jprog = j_build_cell(arch, shape, mesh)
    except ValueError as e:
        assert "skipped" in str(e)
        with pytest.raises(ValueError, match="skipped"):
            build_cell(arch, shape)
        return
    prog = build_cell(arch, shape)
    assert (prog.arch, prog.shape, prog.kind) == (arch, shape, jprog.kind)
    assert prog.donate_argnums == jprog.donate_argnums
    assert prog.in_shardings is None and prog.mesh is None
    assert prog.policy_kv == {}
    assert len(prog.args) == len(jprog.args)
    for ours, theirs in zip(prog.args, jprog.args):
        assert all(t.device.type == "meta" for t in tree_leaves(ours))
        assert _shape_tree(ours) == _shape_tree(theirs)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_build_cell_lays_train_shapes_on_a_mesh(arch, torch_mesh):
    """A train shape builds without a mesh as before, and on a mesh with
    the reference's state and batch specs (Megatron params, ZeRO-1
    moments and master) and the options' policy entries."""
    from test_torch_train_cells import spec_paths
    prog = build_cell(arch, "train_4k")
    assert prog.kind == "train" and prog.donate_argnums == (0,)
    assert prog.mesh is None and prog.in_shardings is None
    jmesh = make_host_mesh()
    for opts in ((), ("moe_local", "seq_par")):
        jp = j_build_cell(arch, "train_4k", jmesh, opts=opts)
        tp = build_cell(arch, "train_4k", torch_mesh, opts)
        assert tp.mesh is torch_mesh and tp.donate_argnums == (0,)
        assert spec_paths(tp.in_shardings) == spec_paths(jp.in_shardings)
        assert spec_paths(tp.out_shardings) == spec_paths(jp.out_shardings)
        assert set(tp.policy_kv) == set(jp.policy_kv)


def test_build_cell_lays_other_families_and_kinds_on_a_mesh(torch_mesh):
    """Serve, GNN, decode and prefill cells build on a mesh with the
    reference's specs, the option-free programs unchanged without one."""
    from test_torch_train_cells import spec_paths
    assert build_cell("din", "serve_p99").kind == "serve"
    assert build_cell("schnet", "full_graph_sm").kind == "train"
    jmesh = make_host_mesh()
    for arch, shape, opts in (("din", "serve_p99", ("serve_full_dp",)),
                              ("schnet", "full_graph_sm", ()),
                              ("mixtral-8x7b", "decode_32k", ("moe_local",)),
                              ("yi-9b", "prefill_32k", ("seq_par",))):
        jp = j_build_cell(arch, shape, jmesh, opts=opts)
        tp = build_cell(arch, shape, torch_mesh, opts)
        assert tp.kind == jp.kind and tp.meta["captured"] is False
        assert spec_paths(tp.in_shardings) == spec_paths(jp.in_shardings)
        assert spec_paths(tp.out_shardings) == spec_paths(jp.out_shardings)


def _smoke_prog(kind, arch="granite-moe-3b-a800m"):
    """A cell program over the smoke config (the registry's are full
    width), built the way ``build_cell`` builds it."""
    from repro_torch.launch import steps
    _, tcfg = _cfgs(arch)
    return tcfg, (steps._lm_decode(tcfg, 16, 2) if kind == "decode"
                  else steps._lm_prefill(tcfg, 16, 2))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x7b"])
def test_compiled_decode_equals_the_direct_call(arch):
    """``CellProgram.compiled()`` for decode: CompiledRun's static-buffer
    path on the CPU, tokens and pos as feeds, the cache by address and
    updated in place; one entry over every position."""
    tcfg, prog = _smoke_prog("decode", arch)
    decode = prog.compiled(device="cpu")
    assert isinstance(decode, CompiledDecode)
    tp = tt.init_lm_params(tcfg, seed=1, device="cpu")
    ca = tt.init_kv_cache(tcfg, 2, 16, device="cpu")
    cb = tt.init_kv_cache(tcfg, 2, 16, device="cpu")
    toks = _t(_tokens(tcfg, 2, 6, 5))
    for t in range(6):
        pos = torch.tensor(t, dtype=torch.int32)
        got, out = decode(tp, ca, toks[:, t:t + 1], pos)
        assert out is ca
        with torch.inference_mode():
            want, _ = tt.lm_decode_step(tp, tcfg, cb, toks[:, t:t + 1], pos)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(ca["k"], cb["k"]) and torch.equal(ca["v"], cb["v"])
    assert decode.compilations == 1


def test_compiled_prefill_fills_the_cache_decode_continues():
    """Prefill's last-token logits and K/V; decoding on from that cache
    equals the longer sequence's logits (a dense arch: MoE capacity
    depends on the token count)."""
    tcfg, prog = _smoke_prog("prefill", "yi-9b")
    tp = tt.init_lm_params(tcfg, seed=2, device="cpu")
    toks = _t(_tokens(tcfg, 2, 16, 6))
    logits, kv = prog.compiled(device="cpu")(tp, toks[:, :8])
    assert logits.shape == (2, tcfg.vocab_padded)
    assert kv["k"].shape == (tcfg.n_layers, 2, 8, tcfg.n_kv_heads, tcfg.hd)
    with torch.inference_mode():
        full = tt.lm_logits(tp, tcfg, toks)
        cache = tt.init_kv_cache(tcfg, 2, 16, device="cpu")
        cache["k"][:, :, :8] = kv["k"]
        cache["v"][:, :, :8] = kv["v"]
        step, _ = tt.lm_decode_step(tp, tcfg, cache, toks[:, 8:9],
                                    torch.tensor(8, dtype=torch.int32))
    torch.testing.assert_close(logits, full[:, 7], **TOL)
    torch.testing.assert_close(step[:, 0], full[:, 8], **TOL)


def test_compiled_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, prog = _smoke_prog("decode")
    with pytest.raises(RuntimeError, match="is_available"):
        prog.compiled()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_launch_train_refuses_lm_archs_naming_the_next_slice(arch, tmp_path):
    """The LM archs train since the training cells' slice; the launcher
    refuses the GNN arch in the reference's words (it has no GNN
    launcher: SchNet trains through ``build_cell``)."""
    from repro_torch.launch.train import main
    hist = main(["--device", "cpu", "--arch", arch, "--steps", "2",
                 "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    with pytest.raises(SystemExit, match="use examples/train_schnet"):
        main(["--device", "cpu", "--arch", "schnet"])
