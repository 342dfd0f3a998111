"""Mesh-sharding tests on the 8-virtual-device CPU mesh.

The reference has no distributed layer (SURVEY.md §2: parallelism
inventory); these tests cover the scale-out design —
bank-sharded construction and query-sharded evaluation — plus the driver
dry-run entry.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D
from ndarray_interp_tpu.parallel import (
    make_mesh,
    shard_interp1d,
    shard_queries,
    sharded_eval_1d,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return make_mesh(8)


def build_bank(n=32, bank=16, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(np.linspace(0.0, 1.0, n))
    data = jnp.asarray(rng.normal(size=(n, bank)))
    return (
        Interp1D.builder(data)
        .x(x)
        .strategy(CubicSpline().extrapolate(True))
        .build()
    )


def test_mesh_factorization(mesh):
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "query": 2,
        "bank": 4,
    }
    m1 = make_mesh(8, axis_names=("data",))
    assert m1.devices.shape == (8,)


def test_sharded_eval_matches_replicated(mesh):
    interp = build_bank()
    q = jnp.asarray(np.random.default_rng(1).uniform(0, 1, 64))
    expect = interp.interp_array(q)

    sharded = shard_interp1d(interp, mesh)
    got = sharded_eval_1d(sharded, q, mesh)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect), atol=1e-14)
    # output is actually sharded over both mesh axes
    assert got.sharding.spec == P("query", "bank")


def test_bank_sharded_build(mesh):
    """Coefficient construction under pjit with the bank axis sharded."""
    rng = np.random.default_rng(2)
    n, bank = 16, 8
    x = jnp.asarray(np.linspace(0.0, 1.0, n))
    data = jax.device_put(
        jnp.asarray(rng.normal(size=(n, bank))),
        NamedSharding(mesh, P(None, "bank")),
    )
    strat = CubicSpline().extrapolate(True)

    @jax.jit
    def build_ab(data):
        s = strat.build(x, data)
        return s.a, s.b

    a, b = build_ab(data)
    # sharding propagates through the scan-based Thomas solve
    assert "bank" in str(a.sharding) or a.sharding.is_fully_replicated is False

    eager = strat.build(x, jax.device_put(data, jax.devices("cpu")[0]))
    np.testing.assert_allclose(np.asarray(a), np.asarray(eager.a), atol=1e-14)
    np.testing.assert_allclose(np.asarray(b), np.asarray(eager.b), atol=1e-14)


def test_shard_queries_roundtrip(mesh):
    q = jnp.arange(32.0)
    qs = shard_queries(q, mesh)
    assert qs.sharding.spec == P("query")
    np.testing.assert_array_equal(np.asarray(qs), np.asarray(q))


def test_dryrun_multichip():
    # reduced sizes: the driver invokes the full-size default (2k knots,
    # 4k bank, 64k queries, ~2 min on the virtual CPU mesh) separately
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8, n_knots=256, bank=512, n_q=8192)


# -- the eval routes under a mesh (GSPMD partitions the plain XLA forms) -----


def _f32_bank(n=24, bank=32, seed=7):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(np.cumsum(rng.uniform(0.1, 1.0, n)).astype(np.float32))
    data = jnp.asarray(rng.normal(size=(n, bank)).astype(np.float32))
    itp = (
        Interp1D.builder(data).x(x)
        .strategy(CubicSpline().extrapolate(True)).build()
    )
    lo, hi = float(x[0]), float(x[-1])
    q = jnp.asarray(rng.uniform(lo - 1.0, hi + 1.0, 1024).astype(np.float32))
    return itp, q


def test_lower_index_under_mesh():
    """The interval search partitions over the query axis: sharded result
    equals the unsharded one and keeps the query sharding."""
    from ndarray_interp_tpu.ops.searchsorted import get_lower_index

    itp, q = _f32_bank()
    mesh1 = make_mesh(8, axis_names=("query",))
    qs = jax.device_put(q, NamedSharding(mesh1, P("query")))
    out = jax.jit(lambda qq: get_lower_index(itp.x, qq))(qs)
    assert out.sharding.spec == P("query")
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(get_lower_index(itp.x, q))
    )


def test_gathered_route_under_mesh(mesh):
    """The f32 bank route (search + one stacked row gather + Hermite)
    partitions query x bank with zero communication: a bank-sharded
    table and query-sharded queries give the unsharded values, sharded
    over both axes."""
    itp, q = _f32_bank()
    want = jax.jit(lambda t, qq: t(qq))(itp, q)
    sharded = shard_interp1d(itp, mesh)
    got = sharded_eval_1d(sharded, q, mesh)
    assert got.sharding.spec == P("query", "bank")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_banked_vmap_flattens_queries():
    """vmap over a batch of query vectors equals the flat evaluation."""
    itp, q = _f32_bank()
    f = jax.jit(lambda t, qq: t(qq))
    out = jax.vmap(lambda qq: itp(qq))(q.reshape(4, 256))
    want = np.asarray(f(itp, q)).reshape(4, 256, -1)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-6, atol=1e-6)


def test_graft_entry_compiles():
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (128, 8)
    assert bool(jnp.isfinite(out).all())


def test_sharded_eval_2d_matches_replicated(mesh):
    from ndarray_interp_tpu.interp2d import Interp2D
    from ndarray_interp_tpu.parallel import shard_interp2d, sharded_eval_2d

    rng = np.random.default_rng(9)
    nx, ny, bank = 12, 10, 8
    x = jnp.asarray(np.linspace(0.0, 1.0, nx))
    y = jnp.asarray(np.linspace(0.0, 2.0, ny))
    data = jnp.asarray(rng.normal(size=(nx, ny, bank)))
    itp = Interp2D.builder(data).x(x).y(y).build()
    qx = jnp.asarray(rng.uniform(0, 1, 64))
    qy = jnp.asarray(rng.uniform(0, 2, 64))
    expect = itp.interp_array(qx, qy)

    sharded = shard_interp2d(itp, mesh)
    got = sharded_eval_2d(sharded, qx, qy, mesh)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(expect), atol=1e-14
    )
    assert got.sharding.spec == P("query", "bank")


def test_df_kernel_under_mesh():
    """The scalar double-float route with query-sharded inputs: both hi
    and lo outputs keep the query sharding and equal the unsharded
    route."""
    from ndarray_interp_tpu.ops.df import df_from_f64, df_to_f64
    from ndarray_interp_tpu.ops.df_eval import eval_xla_df

    rng = np.random.default_rng(13)
    n, nq = 128, 2048
    x64 = np.cumsum(rng.uniform(0.05, 1.0, n))
    d64 = rng.normal(size=n)
    a64 = rng.normal(size=n - 1)
    b64 = rng.normal(size=n - 1)
    q64 = rng.uniform(x64[0], x64[-1], nq)
    args = []
    for v in (x64, d64, a64, b64, q64):
        args.extend(df_from_f64(v))

    mesh1 = make_mesh(8, axis_names=("query",))
    q_sh = NamedSharding(mesh1, P("query"))
    sharded_args = list(args)
    sharded_args[8] = jax.device_put(args[8], q_sh)
    sharded_args[9] = jax.device_put(args[9], q_sh)
    hi, lo = jax.jit(eval_xla_df)(*sharded_args)
    assert hi.sharding.spec == P("query")
    want = df_to_f64(*jax.jit(eval_xla_df)(*args))
    got = df_to_f64(np.asarray(hi), np.asarray(lo))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_df_gather_routes_under_mesh(mesh):
    """The DF gather routes with replicated tables and query-sharded
    queries: outputs stay query-sharded and equal the unsharded XLA
    formulation."""
    from ndarray_interp_tpu.ops.df import df_from_f64, df_to_f64
    from ndarray_interp_tpu.ops.df_eval import (
        eval_xla_df_2d,
        eval_xla_df_banked,
        gathered_bank_eval_df_packed,
        gathered_bank_eval_f48_packed,
        gathered_bilinear_eval_df_packed,
        gathered_bilinear_eval_f48_packed,
        pack_bank_rows_df,
        pack_bank_rows_f48,
        pack_bilinear_rows_df,
        pack_bilinear_rows_f48,
    )

    rng = np.random.default_rng(71)
    mesh1 = make_mesh(8, axis_names=("query",))
    q_sh = NamedSharding(mesh1, P("query"))

    # banked
    n, bank, nq = 64, 16, 2048
    x64 = np.linspace(0.0, 1.0, n)
    d64 = rng.normal(size=(n, bank))
    a64 = rng.normal(size=(n - 1, bank))
    b64 = rng.normal(size=(n - 1, bank))
    q64 = rng.uniform(-0.1, 1.1, nq)
    pairs = []
    for v in (x64, d64, a64, b64):
        pairs.extend(jnp.asarray(w) for w in df_from_f64(v))
    packed = pack_bank_rows_df(*pairs[2:8])
    qh, ql = (jnp.asarray(w) for w in df_from_f64(q64))
    qh_s = jax.device_put(qh, q_sh)
    ql_s = jax.device_put(ql, q_sh)
    hi, lo = jax.jit(
        lambda *a: gathered_bank_eval_df_packed(*a[:3], bank, *a[3:])
    )(pairs[0], pairs[1], packed, qh_s, ql_s)
    assert hi.sharding.spec[0] == "query", hi.sharding
    whi, wlo = eval_xla_df_banked(*pairs, qh, ql)
    np.testing.assert_allclose(
        df_to_f64(hi, lo), df_to_f64(whi, wlo), rtol=1e-5, atol=1e-5
    )
    # the banked f48 tier shares the operand structure (6bp rows)
    packed48 = pack_bank_rows_f48(*pairs[2:8])
    hi48, lo48 = jax.jit(
        lambda *a: gathered_bank_eval_f48_packed(*a[:3], bank, *a[3:])
    )(pairs[0], pairs[1], packed48, qh_s, ql_s)
    assert hi48.sharding.spec[0] == "query", hi48.sharding
    np.testing.assert_allclose(
        df_to_f64(hi48, lo48), df_to_f64(whi, wlo), rtol=1e-5, atol=1e-5
    )

    # bilinear
    nx, ny = 48, 40
    x64 = np.cumsum(rng.uniform(0.1, 1.0, nx))
    y64 = np.cumsum(rng.uniform(0.1, 1.0, ny))
    z64 = rng.normal(size=(nx, ny))
    qx64 = rng.uniform(x64[0], x64[-1], nq)
    qy64 = rng.uniform(y64[0], y64[-1], nq)
    p2 = []
    for v in (x64, y64, z64):
        p2.extend(jnp.asarray(w) for w in df_from_f64(v))
    packed2 = pack_bilinear_rows_df(p2[4], p2[5])
    qxp = [jax.device_put(jnp.asarray(w), q_sh) for w in df_from_f64(qx64)]
    qyp = [jax.device_put(jnp.asarray(w), q_sh) for w in df_from_f64(qy64)]
    hi2, lo2 = jax.jit(
        lambda *a: gathered_bilinear_eval_df_packed(*a[:5], ny, 1, *a[5:])
    )(p2[0], p2[1], p2[2], p2[3], packed2, *qxp, *qyp)
    assert hi2.sharding.spec[0] == "query", hi2.sharding
    w2h, w2l = eval_xla_df_2d(
        *p2, *(jnp.asarray(w) for w in df_from_f64(qx64)),
        *(jnp.asarray(w) for w in df_from_f64(qy64)),
    )
    np.testing.assert_allclose(
        df_to_f64(hi2, lo2).ravel(), df_to_f64(w2h, w2l).ravel(),
        rtol=1e-5, atol=1e-5,
    )
    # the bilinear f48 tier shares the operand structure
    packed2f = pack_bilinear_rows_f48(p2[4], p2[5])
    h2f, l2f = jax.jit(
        lambda *a: gathered_bilinear_eval_f48_packed(*a[:5], ny, 1, *a[5:])
    )(p2[0], p2[1], p2[2], p2[3], packed2f, *qxp, *qyp)
    assert h2f.sharding.spec[0] == "query", h2f.sharding
    np.testing.assert_allclose(
        df_to_f64(h2f, l2f).ravel(), df_to_f64(w2h, w2l).ravel(),
        rtol=1e-5, atol=1e-5,
    )


def test_df_bicubic_route_under_mesh():
    """The bicubic DF cell route with query-sharded inputs (the
    banked/bilinear routes have their own case above)."""
    from ndarray_interp_tpu.ops.df import df_from_f64, df_to_f64
    from ndarray_interp_tpu.ops.df_eval import (
        gathered_bicubic_eval_df,
        gathered_bicubic_eval_df_packed,
        gathered_bicubic_eval_f48_packed,
        pack_bicubic_rows_df,
        pack_bicubic_rows_f48,
    )

    rng = np.random.default_rng(73)
    mesh1 = make_mesh(8, axis_names=("query",))
    q_sh = NamedSharding(mesh1, P("query"))
    nx, ny, r, nq = 40, 32, 3, 2048
    x64 = np.cumsum(rng.uniform(0.1, 1.0, nx))
    y64 = np.cumsum(rng.uniform(0.1, 1.0, ny))
    # pre-scaled cell rows in f64 (as the evaluator feeds them)
    rows64 = rng.normal(size=((nx - 1) * (ny - 1), 16 * r))
    qx64 = rng.uniform(x64[0], x64[-1], nq)
    qy64 = rng.uniform(y64[0], y64[-1], nq)
    pairs = []
    for v in (x64, y64):
        pairs.extend(jnp.asarray(w) for w in df_from_f64(v))
    rows_pair = tuple(jnp.asarray(w) for w in df_from_f64(rows64))
    packed = pack_bicubic_rows_df(*rows_pair, r)
    qxp = [jax.device_put(jnp.asarray(w), q_sh) for w in df_from_f64(qx64)]
    qyp = [jax.device_put(jnp.asarray(w), q_sh) for w in df_from_f64(qy64)]
    hi, lo = jax.jit(
        lambda *a: gathered_bicubic_eval_df_packed(*a, r=r)
    )(*pairs, packed, *qxp, *qyp)
    assert hi.sharding.spec[0] == "query", hi.sharding
    whi, wlo = gathered_bicubic_eval_df(
        *pairs, *rows_pair,
        *(jnp.asarray(w) for w in df_from_f64(qx64)),
        *(jnp.asarray(w) for w in df_from_f64(qy64)),
        r=r,
    )
    np.testing.assert_allclose(
        df_to_f64(hi, lo), df_to_f64(whi, wlo), rtol=1e-5, atol=1e-5
    )
    # the f48 tier shares the operand structure (24bp rows)
    packed48 = pack_bicubic_rows_f48(*rows_pair, r)
    hi48, lo48 = jax.jit(
        lambda *a: gathered_bicubic_eval_f48_packed(*a, r=r)
    )(*pairs, packed48, *qxp, *qyp)
    assert hi48.sharding.spec[0] == "query", hi48.sharding
    np.testing.assert_allclose(
        df_to_f64(hi48, lo48), df_to_f64(whi, wlo), rtol=1e-5, atol=1e-5
    )


def test_df_bicubic_node_route_under_mesh():
    """The memory-frugal bicubic DF NODE route with query-sharded
    inputs vs the unsharded route."""
    from ndarray_interp_tpu.ops.df import df_from_f64, df_to_f64
    from ndarray_interp_tpu.ops.df_eval import (
        gathered_bicubic_nodes_eval_df,
        pack_bicubic_nodes_df,
    )

    rng = np.random.default_rng(74)
    mesh1 = make_mesh(8, axis_names=("query",))
    q_sh = NamedSharding(mesh1, P("query"))
    nx, ny, r, nq = 24, 20, 3, 2048
    x64 = np.cumsum(rng.uniform(0.1, 1.0, nx))
    y64 = np.cumsum(rng.uniform(0.1, 1.0, ny))
    # raw node rows [f | kx | ky | kxy | x | y] in f64 (as the
    # evaluator feeds them from the node-layout strategy table)
    rows64 = rng.normal(size=(nx * ny, 4 * r + 2))
    rows64[:, 4 * r + 0] = np.repeat(x64, ny)
    rows64[:, 4 * r + 1] = np.tile(y64, nx)
    qx64 = rng.uniform(x64[0], x64[-1], nq)
    qy64 = rng.uniform(y64[0], y64[-1], nq)
    pairs = []
    for v in (x64, y64):
        pairs.extend(jnp.asarray(w) for w in df_from_f64(v))
    packed = pack_bicubic_nodes_df(
        *(jnp.asarray(w) for w in df_from_f64(rows64))
    )
    qxp = [jax.device_put(jnp.asarray(w), q_sh) for w in df_from_f64(qx64)]
    qyp = [jax.device_put(jnp.asarray(w), q_sh) for w in df_from_f64(qy64)]
    hi, lo = jax.jit(
        lambda *a: gathered_bicubic_nodes_eval_df(*a, r=r)
    )(*pairs, packed, *qxp, *qyp)
    assert hi.sharding.spec[0] == "query", hi.sharding
    whi, wlo = gathered_bicubic_nodes_eval_df(
        *pairs, packed,
        *(jnp.asarray(w) for w in df_from_f64(qx64)),
        *(jnp.asarray(w) for w in df_from_f64(qy64)),
        r=r,
    )
    np.testing.assert_allclose(
        df_to_f64(hi, lo), df_to_f64(whi, wlo), rtol=1e-5, atol=1e-5
    )


def test_df_nd_route_under_mesh():
    """The ND DF route (k axes) with query-sharded inputs vs the
    unsharded route — tensor-product cubic (nbasis=4) on a 3-axis grid
    with a trailing dim."""
    from ndarray_interp_tpu.ops.df import df_from_f64, df_to_f64
    from ndarray_interp_tpu.ops.df_eval import (
        gathered_nd_eval_df_packed,
        pack_rows_nd_df,
        pack_rows_nd_f48,
    )

    rng = np.random.default_rng(75)
    mesh1 = make_mesh(8, axis_names=("query",))
    q_sh = NamedSharding(mesh1, P("query"))
    k, r, nq = 3, 2, 2048
    sizes = (9, 8, 7)
    axes64 = [np.cumsum(rng.uniform(0.1, 1.0, n)) for n in sizes]
    ncells = int(np.prod([n - 1 for n in sizes]))
    rows64 = rng.normal(size=(ncells, (4**k) * r))
    rows_pair = tuple(jnp.asarray(w) for w in df_from_f64(rows64))
    packed = pack_rows_nd_df(*rows_pair, 4**k, r)
    pairs = []
    for a in axes64:
        pairs.extend(jnp.asarray(w) for w in df_from_f64(a))
    qs64 = [rng.uniform(a[0], a[-1], nq) for a in axes64]
    q_flat, q_shard = [], []
    for q in qs64:
        for w in df_from_f64(q):
            q_flat.append(jnp.asarray(w))
            q_shard.append(jax.device_put(jnp.asarray(w), q_sh))
    route = gathered_nd_eval_df_packed(k, sizes, r, nbasis=4)
    hi, lo = jax.jit(route)(*pairs, packed, *q_shard)
    assert hi.sharding.spec[0] == "query", hi.sharding
    whi, wlo = jax.jit(route)(*pairs, packed, *q_flat)
    np.testing.assert_allclose(
        df_to_f64(hi, lo), df_to_f64(whi, wlo), rtol=1e-5, atol=1e-5
    )
    # the ND f48 tier shares the operand structure
    packed48 = pack_rows_nd_f48(*rows_pair, 4**k, r)
    hi48, lo48 = jax.jit(
        gathered_nd_eval_df_packed(k, sizes, r, nbasis=4, tier="f48")
    )(*pairs, packed48, *q_shard)
    assert hi48.sharding.spec[0] == "query", hi48.sharding
    np.testing.assert_allclose(
        df_to_f64(hi48, lo48), df_to_f64(whi, wlo), rtol=1e-5, atol=1e-5
    )
