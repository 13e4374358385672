"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the reference's Pallas ops run in interpret mode.

Inputs are made from a seed with numpy and handed to both packages.
Tolerance: fp32 rtol = atol = 2e-4, as tests/test_kernels.py.
"""
import numpy as np
import pytest
import torch

from repro.kernels import gather_einsum as jax_gather_einsum
from repro.kernels.din_attention import din_attention as jax_din_attention
from repro.kernels.din_attention.ref import din_attention_ref
from repro.kernels import mari_matmul_fused_groups as jax_fused_groups
from repro.kernels.gather_einsum.kernel import parse_spec as jax_parse_spec
from repro_torch.kernels import din_attention as da
from repro_torch.kernels import gather_einsum as ge
from repro_torch.kernels import mari_matmul as mm
from repro_torch.kernels.gather_einsum import (gather_einsum,
                                               gather_einsum_plain, parse_spec)
from repro_torch.kernels.mari_matmul import (mari_matmul,
                                             mari_matmul_fused_groups,
                                             mari_matmul_plain)

TOL = dict(rtol=2e-4, atol=2e-4)
ACTS = ("identity", "relu", "gelu", "silu", "sigmoid", "tanh")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _groups_case(mode, seed, B=37, Du=24, D1=30, D2=20, d=40, U=5):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    parts = [(f(1, Du), f(Du, d)), (f(B, D1), f(D1, d)), (f(B, D2), f(D2, d))]
    bias = f(d)
    acc0 = uidx = None
    if mode == "rowwise":
        acc0 = f(B, d)
    elif mode == "gather":
        acc0 = f(U, d)
        # out-of-range both ways: the contract clamps to [0, U-1]
        uidx = rng.integers(-2, U + 3, (B,)).astype(np.int32)
    return parts, bias, acc0, uidx


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("mode", ["broadcast", "rowwise", "gather"])
def test_mari_matmul_groups_match_reference(mode, activation):
    parts, bias, acc0, uidx = _groups_case(mode, seed=len(activation))
    want = jax_fused_groups(parts, bias, acc0=acc0, user_index=uidx,
                            activation=activation, interpret=True)
    before = dict(mm.LAUNCHES)
    got = mari_matmul_fused_groups(
        [(_t(x), _t(w)) for x, w in parts], _t(bias),
        acc0=None if acc0 is None else _t(acc0),
        user_index=None if uidx is None else _t(uidx),
        activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert mm.LAUNCHES == before        # CPU tensors never launch a kernel


def test_mari_matmul_groups_no_batched_stream():
    """Every part batch-1 with a gathered table: the init row is the
    output, gathered per row (clamped)."""
    rng = np.random.default_rng(3)
    parts = [(rng.standard_normal((1, 9)).astype(np.float32),
              rng.standard_normal((9, 6)).astype(np.float32))]
    acc0 = rng.standard_normal((3, 6)).astype(np.float32)
    uidx = np.array([0, 2, 5, -1], np.int32)
    want = jax_fused_groups(parts, None, acc0=acc0, user_index=uidx,
                            activation="relu", interpret=True)
    got = mari_matmul_fused_groups([(_t(x), _t(w)) for x, w in parts],
                                   acc0=_t(acc0), user_index=_t(uidx),
                                   activation="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["broadcast", "rowwise", "gather"])
def test_mari_matmul_wrapper_is_plain_on_cpu(mode):
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((19, 13)).astype(np.float32))
    w = _t(rng.standard_normal((13, 7)).astype(np.float32))
    rows = {"broadcast": 1, "rowwise": 19, "gather": 4}[mode]
    u = _t(rng.standard_normal((rows, 7)).astype(np.float32))
    idx = _t(np.arange(19, dtype=np.int32) % 6) if mode == "gather" else None
    assert mm.ops.init_mode(19, u, idx) == mode
    torch.testing.assert_close(mari_matmul(x, w, u, idx, "silu"),
                               mari_matmul_plain(x, w, u, idx, "silu"),
                               rtol=0, atol=0)


def test_mari_matmul_wrapper_rejects():
    x, w = torch.zeros(4, 3), torch.zeros(3, 2)
    with pytest.raises(ValueError, match="rows must be 1 or B"):
        mari_matmul(x, w, torch.zeros(3, 2))
    with pytest.raises(ValueError, match="unsupported epilogue"):
        mari_matmul(x, w, torch.zeros(1, 2), activation="softplus")
    with pytest.raises(ValueError, match="user_index must be"):
        mari_matmul(x, w, torch.zeros(2, 2), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        mari_matmul(x.to("meta"), w.to("meta"), torch.zeros(1, 2,
                                                            device="meta"))


def _ge_case(spec, U, seed, B=23, L=7, D=6, H=5):
    rng = np.random.default_rng(seed)
    x_shape, t_shape = {
        "bd,uldh->blh": ((B, D), (U, L, D, H)),
        "bl,uld->bd": ((B, L), (U, L, D)),
        "blh,uh->bl": ((B, L, H), (U, H)),
    }[spec]
    x = rng.standard_normal(x_shape).astype(np.float32)
    table = rng.standard_normal(t_shape).astype(np.float32)
    uidx = rng.integers(-3, U + 4, (B,)).astype(np.int32)   # out of range too
    return x, table, uidx


@pytest.mark.parametrize("U", [1, 3, 5, pytest.param(4, id="4-D128")])
@pytest.mark.parametrize("spec", ge.KERNEL_SPECS)
def test_gather_einsum_matches_reference(spec, U):
    """The plain version against the TPU kernel in interpret mode; the
    ``4-D128`` case at DIN's public D = 128 (on the card, fp32
    ``bd,uldh->blh`` takes the tensor-core route past D = 40)."""
    x, table, uidx = _ge_case(spec, U, seed=U, **({"D": 128} if U == 4
                                                   else {}))
    want = jax_gather_einsum(spec, x, table, uidx, interpret=True)
    before = dict(ge.LAUNCHES)
    got = gather_einsum(spec, _t(x), _t(table), _t(uidx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ge.LAUNCHES == before
    torch.testing.assert_close(
        got, gather_einsum_plain(spec, _t(x), _t(table), _t(uidx)),
        rtol=0, atol=0)


# specs past the three KERNEL_SPECS (the generic route on CUDA): a row
# contraction, a per-row vector product, an elementwise product, a dot, a
# batched small matmul, an outer product, a permuted output; a dim summed in
# x alone, one summed in the table alone, and a multi-head target
# attention's scores and pool (together every role: S, M, N, K, Kx, Kt)
OTHER_SPECS = ["bi,uij->bj", "bij,uj->bi", "bl,ul->bl", "bd,ud->b",
               "bdk,ukh->bdh", "bx,uy->bxy", "bd,uldh->bhl", "bij,uj->b",
               "bi,uij->bi", "bhd,ulhd->bhl", "bhl,ulhd->bhd"]
DIM_SIZES = dict(i=4, j=5, l=6, d=7, k=3, h=5, x=4, y=3)


def _other_case(spec, B=6, U=3, seed=7):
    """x, table and an index with out-of-range values both ways."""
    x_sub, t_sub, _, _ = parse_spec(spec)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B,) + tuple(DIM_SIZES[c] for c in x_sub[1:]))
    table = rng.standard_normal((U,) + tuple(DIM_SIZES[c]
                                             for c in t_sub[1:]))
    uidx = rng.integers(-2, U + 3, (B,)).astype(np.int32)
    uidx[:2] = (-1, U + 4)
    return x.astype(np.float32), table.astype(np.float32), uidx


@pytest.mark.parametrize("spec", OTHER_SPECS)
def test_gather_einsum_other_spec_runs_plain_on_cpu(spec):
    """A spec parse_spec accepts past the three KERNEL_SPECS (the generic
    route on CUDA) runs through the plain version on CPU tensors, as the
    reference's kernel in interpret mode computes it."""
    x, table, uidx = _other_case(spec)
    want = jax_gather_einsum(spec, x, table, uidx, interpret=True)
    before = dict(ge.LAUNCHES)
    got = gather_einsum(spec, _t(x), _t(table), _t(uidx))
    assert ge.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _plan_eval(spec, x, table, idx):
    """The generic route's index arithmetic on its plan, in plain torch:
    each output element's offsets from its index over the output dims
    (row-major), the summed offsets over the summed dims in the kernel's
    walk order, the clamped row of the table, and the products summed."""
    plan = ge.ops.generic_plan(spec, x.shape, table.shape)
    B, U = x.shape[0], table.shape[0]

    def offsets(dims, n_strides):
        n = int(np.prod([d[0] for d in dims]))
        rem, offs = torch.arange(n), [torch.zeros(n, dtype=torch.long)
                                      for _ in range(n_strides)]
        for d in reversed(dims):
            c = rem % d[0]
            rem = rem // d[0]
            for k in range(n_strides):
                offs[k] += c * d[1 + k]
        return offs

    xo, to, oo = offsets(plan["out"], 3)
    xs, ts = offsets(plan["sum"], 2)
    b = torch.arange(B)[:, None, None]
    u = idx.long().clamp(0, U - 1)[:, None, None]
    xi = b * plan["x_row"] + xo[None, :, None] + xs[None, None, :]
    ti = u * plan["t_row"] + to[None, :, None] + ts[None, None, :]
    vals = (x.reshape(-1)[xi] * table.reshape(-1)[ti]).sum(-1)
    shape = ge.ops.out_shape(spec, x, table, idx)
    out = torch.zeros(int(np.prod(shape)), dtype=x.dtype)
    out[(torch.arange(B)[:, None] * plan["out_row"] + oo[None, :])
        .reshape(-1)] = vals.reshape(-1)
    return out.reshape(shape)


@pytest.mark.parametrize("spec", OTHER_SPECS + list(ge.KERNEL_SPECS))
def test_gather_einsum_generic_plan_walks_to_einsum(spec):
    """The generic plan evaluated by its strides (the kernel's index
    arithmetic) equals torch.einsum on the gathered rows, out-of-range and
    negative indices clamped."""
    x, table, uidx = _other_case(spec, B=5, U=4, seed=len(spec))
    x, table, idx = _t(x).double(), _t(table).double(), _t(uidx)
    want = torch.einsum(parse_spec(spec)[3], x,
                        table[idx.long().clamp(0, table.shape[0] - 1)])
    torch.testing.assert_close(_plan_eval(spec, x, table, idx), want,
                               rtol=1e-12, atol=1e-12)


def test_gather_einsum_generic_plan_merges_and_bounds():
    """Adjacent dims contiguous on every operand merge (size-1 dims drop),
    a dim absent from an operand has stride 0 there, and a spec past the
    plan's 8 dims of a role is refused naming the bound."""
    plan = ge.ops.generic_plan("bij,uij->b", (5, 3, 4), (2, 3, 4))
    assert plan["out"] == [] and plan["sum"] == [(12, 1, 1)]
    plan = ge.ops.generic_plan("bx,uy->bxy", (5, 4), (2, 3))
    assert plan["out"] == [(4, 1, 0, 3), (3, 0, 1, 1)]
    assert (plan["x_row"], plan["t_row"], plan["out_row"]) == (4, 3, 12)
    plan = ge.ops.generic_plan("bd,uldh->bhl", (5, 7), (2, 6, 7, 1))
    assert plan["out"] == [(6, 0, 7, 1)] and plan["sum"] == [(7, 1, 1)]
    many = "acdefghij"
    with pytest.raises(ValueError, match="generic route's 8 of each"):
        ge.ops.generic_plan(f"b{many},u->b{many[::-1]}", (1,) + (2,) * 9,
                            (3,))


# each spec's roles at DIM_SIZES (x (B, ...), table (U, ...) strides):
# output dims S (x and table), M (x only), N (table only); summed dims K,
# Kx (x only), Kt (table only)
ROLES = {
    "bhd,ulhd->bhl": dict(S=[(5, 7, 7, 6)], N=[(6, 0, 35, 1)],
                          K=[(7, 1, 1)]),
    "bi,uij->bi": dict(S=[(4, 1, 5, 1)], Kt=[(5, 0, 1)]),
    "bhl,ulhd->bhd": dict(S=[(5, 6, 7, 7)], N=[(7, 0, 1, 1)],
                          K=[(6, 1, 35)]),
    "bij,uj->b": dict(Kx=[(4, 5, 0)], K=[(5, 1, 1)]),
    "bdk,ukh->bdh": dict(M=[(7, 3, 0, 5)], N=[(5, 0, 1, 1)],
                         K=[(3, 1, 5)]),
    "bl,ul->bl": dict(S=[(6, 1, 1, 1)]),
}


@pytest.mark.parametrize("spec", sorted(ROLES))
def test_gather_einsum_generic_roles(spec):
    """Each merged dim of the plan takes its role from its zero strides:
    an output dim in x and the table is S, in x alone M, in the table alone
    N; a summed dim in both is K, in x alone Kx, in the table alone Kt."""
    x, table, _ = _other_case(spec, B=5, U=4)
    roles = ge.ops.generic_roles(spec, x.shape, table.shape)
    want = dict.fromkeys(("S", "M", "N", "K", "Kx", "Kt"), [])
    assert roles == dict(want, **ROLES[spec])


def _tile_eval(spec, x, table, idx, sms=132):
    """The generic route's tiling (``generic_tile``'s struct) evaluated by
    its lists in plain torch: every (row, G, A, N) output at its out offset,
    summed over the K list, the table at the row's clamped user; GROUPED's
    A list walks M alone beside the S dims it fixes a block (G)."""
    c, t = ge.ops.generic_tile(spec, tuple(x.shape), tuple(table.shape),
                               x.element_size(), sms)

    def offsets(n, size, *strides):
        count = int(np.prod([size[i] for i in range(n)]))
        rem = torch.arange(count)
        outs = [torch.zeros(count, dtype=torch.long) for _ in strides]
        for d in reversed(range(n)):
            cd = rem % size[d]
            rem = rem // size[d]
            for o, s_ in zip(outs, strides):
                o += cd * s_[d]
        return outs

    ax, at, ao = offsets(c.n_a, c.a_size, c.a_x, c.a_t, c.a_o)
    gx, gt, go = offsets(c.n_g, c.g_size, c.g_x, c.g_t, c.g_o)
    nt, no = offsets(c.n_n, c.n_size, c.n_t, c.n_o)
    kx, kt = offsets(c.n_k, c.k_size, c.k_x, c.k_t)
    assert (len(ax), len(gx), len(nt), len(kx)) == (
        c.a_count, c.g_count, c.n_count, c.k_count)
    B, U = x.shape[0], table.shape[0]
    b = torch.arange(B).view(B, 1, 1, 1, 1)
    u = idx.long().clamp(0, U - 1).view(B, 1, 1, 1, 1)
    xo = (b * c.x_row + gx.view(1, -1, 1, 1, 1) + ax.view(1, 1, -1, 1, 1)
          + kx.view(1, 1, 1, 1, -1))
    to = (u * c.t_row + gt.view(1, -1, 1, 1, 1) + at.view(1, 1, -1, 1, 1)
          + nt.view(1, 1, 1, -1, 1) + kt.view(1, 1, 1, 1, -1))
    vals = (x.reshape(-1)[xo] * table.reshape(-1)[to]).sum(-1)
    oo = (b[..., 0] * c.out_row + go.view(1, -1, 1, 1)
          + ao.view(1, 1, -1, 1) + no.view(1, 1, 1, -1))
    shape = ge.ops.out_shape(spec, x, table, idx)
    out = torch.full((int(np.prod(shape)),), float("nan"), dtype=x.dtype)
    out[oo.reshape(-1)] = vals.reshape(-1)
    return out.reshape(shape), c, t


@pytest.mark.parametrize("B,U", [(5, 4), (2, 1), (9, 64)])
@pytest.mark.parametrize("spec", OTHER_SPECS)
def test_gather_einsum_generic_tile_walks_to_einsum(spec, B, U):
    """The tiling the wrapper hands the kernel covers every output once and
    equals torch.einsum on the gathered rows; a mode's promise holds: one
    table slice serves every A coordinate of a block (USERS, GROUPED: the A
    list carries no table stride), ROWS and P only where N is empty."""
    x, table, uidx = _other_case(spec, B=B, U=U, seed=len(spec) + B)
    x, table, idx = _t(x).double(), _t(table).double(), _t(uidx)
    got, c, t = _tile_eval(spec, x, table, idx)
    want = torch.einsum(parse_spec(spec)[3], x,
                        table[idx.long().clamp(0, table.shape[0] - 1)])
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    if t["mode"] in ("users", "grouped"):
        assert all(c.a_t[i] == 0 for i in range(c.n_a))
    if t["mode"] != "grouped":
        assert c.n_g == 0
    assert (t["kind"] in (1, 3)) == (c.n_n > 0)
    assert t["mode"] != "rows" or t["kind"] == 0
    if t["kind"] == 2:      # every output dim, e its own out offset
        assert t["mode"] == "flat" and c.out_row == c.a_count
    assert t["kind"] != 1 or t["mode"] == "grouped"   # W staged
    assert t["kind"] != 0 or t["mode"] != "grouped"   # P
    assert 1 <= t["kc"] <= ge.ops.GT_MAX_KC
    assert t["smem"] <= ge.ops.GT_MAX_SMEM


# the tilings at chip_smoke.py's generic shapes (B 4096, U 8): what each
# mode and layout is for
SMOKE_DIMS = dict(i=128, j=80, l=100, d=18, k=8, h=80, x=40, y=30)
SMOKE_TILES = {"bd,uldh->bhl": ("grouped", 1), "bhd,ulhd->bhl": ("grouped", 1),
               "bhl,ulhd->bhd": ("grouped", 3), "bij,uj->bi": ("users", 0),
               "bij,uj->b": ("users", 0), "bi,uij->bi": ("flat", 2),
               "bl,ul->bl": ("flat", 2), "bd,ud->b": ("flat", 2),
               "bx,uy->bxy": ("flat", 2), "bdk,ukh->bdh": ("users", 3),
               "bi,uij->bj": ("flat", 2)}


@pytest.mark.parametrize("spec", sorted(SMOKE_TILES))
def test_gather_einsum_generic_tile_modes(spec):
    """At B 4096, U 8, fp32: the heavy contractions (590 M products) group
    rows by user (a short sum staged, a long one beside resident slices);
    where N is empty and x streams, a ring staged by the copy engine with
    every user's slices beside it; every user's slices resident where they
    fit; short sums, sums whose reads coalesce and sums on one x value take
    the flat layout. At bf16 too the tiling fits the card's shared
    memory."""
    xs, ts, _, _ = parse_spec(spec)
    x_shape = (4096,) + tuple(SMOKE_DIMS[c] for c in xs[1:])
    t_shape = (8,) + tuple(SMOKE_DIMS[c] for c in ts[1:])
    _, t = ge.ops.generic_tile(spec, x_shape, t_shape, 4, 132)
    assert (t["mode"], t["kind"]) == SMOKE_TILES[spec]
    for esize in (4, 2):
        _, t = ge.ops.generic_tile(spec, x_shape, t_shape, esize, 132)
        assert t["smem"] <= ge.ops.GT_MAX_SMEM
        if t["mode"] == "grouped":
            assert t["nr"] % (t["ta"] // t["a_blk"]) == 0


def test_gather_einsum_generic_magic_division():
    """The walks divide by magic numbers (CUTLASS's FastDivmod rule): for
    every dividend and divisor below 2^31, (n * mul >> 32) >> shr == n //
    d."""
    rng = np.random.default_rng(0)
    ds = list(range(1, 2000)) + list(rng.integers(1, 2 ** 31, 2000)) + [
        2 ** 31 - 1, 2 ** 30, 2 ** 30 + 1]
    for d in map(int, ds):
        mul, shr = ge.ops.magic(d)
        assert 0 <= mul < 2 ** 32
        ns = [0, 1, d - 1, d, d + 1, 2 ** 31 - 1] + list(
            map(int, rng.integers(0, 2 ** 31, 20)))
        for n in ns:
            q = n if d == 1 else (n * mul >> 32) >> shr
            assert q == n // d, (n, d)


BAD_SPECS = ["bd,uldh", "bd->blh", "xd,uldh->blh", "bd,xldh->blh",
             "bd,uldh->xlh", "bud,uldh->blh", "bd,uldh->bu", "bd,ubld->bl",
             "bdd,uldh->blh", "bd,uldh->blz"]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_spec_rejects_like_reference(spec):
    with pytest.raises(ValueError) as ref:
        jax_parse_spec(spec)
    with pytest.raises(ValueError) as port:
        parse_spec(spec)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("spec", ge.KERNEL_SPECS)
def test_parse_spec_accepts_like_reference(spec):
    assert parse_spec(spec) == jax_parse_spec(spec)


def test_gather_einsum_shape_checks():
    x, table, uidx = (torch.zeros(4, 6), torch.zeros(2, 7, 6, 5),
                      torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="operand ranks"):
        gather_einsum("bd,uldh->blh", x[:, :, None], table, uidx)
    with pytest.raises(ValueError, match="dim 'd' is 6 on x but 5"):
        gather_einsum("bd,uldh->blh", x, torch.zeros(2, 7, 5, 5), uidx)
    with pytest.raises(ValueError, match="user_index must be"):
        gather_einsum("bd,uldh->blh", x, table, uidx[:3])


def test_launch_counts_survive_concurrent_threads():
    """The serving batchers launch kernels from one thread per scenario:
    concurrent increments of one launch counter must not be lost."""
    import sys
    import threading

    from repro_torch.kernels import build

    counts = {"k": 0}
    n_threads, n_each = 16, 2000

    def work():
        for _ in range(n_each):
            build.count_launch(counts, "k")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counts["k"] == n_threads * n_each


def _din_case(B, L, D, h1=16, h2=8, seed=0):
    """tests/test_kernels.py::TestDinAttention's inputs, from numpy: a
    mask with zeros (position 0 kept) and nonzero biases."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = rng.random(L) < 0.8
    mask[0] = True
    return (f(B, D), f(L, D), mask, f(4 * D, h1) * 0.2, f(h1) * 0.1,
            f(h1, h2) * 0.2, f(h2) * 0.1, f(h2, 1) * 0.2, f(1) * 0.1)


@pytest.mark.parametrize("B,L,D,h1,h2", [(5, 9, 72, 136, 72),
                                         (3, 11, 130, 20, 9),
                                         (4, 100, 18, 2048, 1024)])
def test_din_attention_wide_units_match_reference(B, L, D, h1, h2):
    """Units past the CUDA kernel's register tiles (its wide route on the
    card): the plain version against the reference's Pallas kernel in
    interpret mode, which takes any width; (18, 2048, 1024) at
    ``_din_case``'s 0.2-scale weights, where scores reach the hundreds."""
    args = _din_case(B, L, D, h1, h2, seed=D)
    got = da.din_attention(*(_t(a) for a in args)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_din_attention(*args, interpret=True)), **TOL)


@pytest.mark.parametrize("B,L,D", [(4, 5, 8), (33, 20, 18), (128, 100, 18)])
def test_din_attention_matches_reference(B, L, D):
    """The wrapper on CPU tensors (its plain version) against the
    reference's oracle and its Pallas kernel in interpret mode."""
    args = _din_case(B, L, D, seed=B + L)
    before = dict(da.LAUNCHES)
    got = da.din_attention(*(_t(a) for a in args)).numpy()
    assert da.LAUNCHES == before        # CPU tensors never launch a kernel
    np.testing.assert_allclose(got, np.asarray(din_attention_ref(*args)),
                               **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_din_attention(*args, interpret=True)), **TOL)


def test_din_attention_matches_nn_target_attention():
    """As TestDinAttention::test_matches_nn_target_attention: the fused unit
    equals the port's whole target_attention over batch-1 keys."""
    from repro_torch.nn.attention import target_attention
    args = [_t(a) for a in _din_case(9, 7, 6, h1=12, h2=5, seed=3)]
    q, keys, mask, w1, b1, w2, b2, w3, b3 = args

    def mlp(x):
        x = torch.relu(x @ w1 + b1)
        x = torch.relu(x @ w2 + b2)
        return x @ w3 + b3

    want = target_attention(q, keys[None], mask[None], mlp)
    np.testing.assert_allclose(da.din_attention(*args).numpy(),
                               want.numpy(), **TOL)


def test_din_attention_shape_checks_and_limits():
    args = [_t(a) for a in _din_case(4, 5, 8)]
    with pytest.raises(ValueError, match="4D -> h1 -> h2 -> 1"):
        da.din_attention(args[0], args[1][:, :7], *args[2:])
    with pytest.raises(ValueError, match="4D -> h1 -> h2 -> 1"):
        da.din_attention(*args[:7], args[7][:, :1].repeat(1, 2), args[8])
    with pytest.raises(ValueError, match="unsupported device"):
        da.din_attention(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="4D -> h1 -> h2 -> 1"):
        da.din_attention(args[0][0], *args[1:])

    def unit(B, L, D, h1, h2):
        return [torch.empty(s, device="meta") for s in (
            (B, D), (L, D), (L,), (4 * D, h1), (h1,), (h1, h2), (h2,),
            (h2, 1), (1,))]

    # a unit's shapes are checked before its device: a meta unit of
    # consistent shapes reaches the device check, one of mixed widths not
    for good in (unit(4096, 100, 18, 80, 40), unit(8, 100, 18, 200, 40)):
        with pytest.raises(ValueError, match="unsupported device"):
            da.din_attention(*good)
    with pytest.raises(ValueError, match="4D -> h1 -> h2 -> 1"):
        da.din_attention(*unit(8, 100, 18, 80, 40)[:3],
                         *unit(8, 100, 17, 80, 40)[3:])
    # off CUDA the plain version takes any unit, wider than the kernel's
    # register tiles too; the kernel's own limits are held on the card
    # (tests/test_torch_gpu.py)
    wide = [_t(a) for a in _din_case(3, 5, 8, h1=200, h2=70, seed=1)]
    assert torch.equal(da.din_attention(*wide),
                       da.din_attention_plain(*wide))
