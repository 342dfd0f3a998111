"""Knot-axis sharding tests.

The knot/coefficient axis splits over a mesh in contiguous shards with a
one-knot halo; ownership masks partition the query space and one psum
combines.  Checked against the replicated single-device oracle on the
8-device CPU mesh, including a 16.8M-knot axis.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ndarray_interp_tpu.ops.knotshard import (
    pack_knot_shards,
    place_knot_shards,
    shard_geometry,
    sharded_knot_eval,
)
from ndarray_interp_tpu.ops.searchsorted import get_lower_index


def make_interval_table(x, data, a=None, b=None):
    """Per-interval channels ``[x_l, x_r, y_l, y_r, a, b]`` (linear:
    a = b = 0, which collapses the Hermite form to the lerp)."""
    za = jnp.zeros_like(data[:-1]) if a is None else a
    zb = jnp.zeros_like(data[:-1]) if b is None else b
    return jnp.stack([x[:-1], x[1:], data[:-1], data[1:], za, zb], axis=-1)


def _eval_xla(knots, tbl, q):
    """Single-device oracle: search, one row gather, the symmetric
    Hermite of ``cubic_spline.rs:818-828`` with the ±inf lerp guard."""
    idx = get_lower_index(knots, q)
    rows = tbl[idx]
    x_l, x_r, y_l, y_r, a, b = (rows[..., i] for i in range(6))
    t = (q - x_l) / (x_r - x_l)
    base = (1 - t) * y_l + t * y_r + t * (1 - t) * (a * (1 - t) + b * t)
    lin_inf = jnp.isinf(t) & (a == 0) & (b == 0)
    return jnp.where(lin_inf, y_l + t * (y_r - y_l), base)


def _mesh():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.asarray(devs[:8]), ("knot",))


def _problem(n, nq, seed=0, uniform=False):
    rng = np.random.default_rng(seed)
    if uniform:
        x = np.linspace(0.0, 1.0, n, dtype=np.float32)
    else:
        x = np.cumsum(rng.uniform(0.05, 1.0, n)).astype(np.float32)
    d = rng.normal(size=n).astype(np.float32)
    a = rng.normal(size=n - 1).astype(np.float32)
    b = rng.normal(size=n - 1).astype(np.float32)
    lo, hi = float(x[0]), float(x[-1])
    q = np.r_[
        rng.uniform(lo - 2, hi + 2, nq - 6).astype(np.float32),
        np.float32([lo, hi, -np.inf, np.inf, x[n // 2], np.nan]),
    ]
    return (jnp.asarray(v) for v in (x, d, a, b, q))


@pytest.mark.parametrize("n", [1000, 1003])
def test_matches_replicated_oracle(n):
    mesh = _mesh()
    x, d, a, b, q = _problem(n, 4096, seed=n)
    shards = pack_knot_shards(x, d, a, b, 8)
    got = np.asarray(
        jax.jit(
            lambda *s: sharded_knot_eval(*s, mesh=mesh, n=n, axis="knot")
        )(*shards, q)
    )
    want = np.asarray(
        jax.jit(_eval_xla)(x, make_interval_table(x, d, a, b), q)
    )
    nan = np.isnan(want)
    assert np.isnan(got[nan]).all()
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=2e-6, atol=1e-5)


def test_tiny_axis_with_empty_pad_shards():
    # n=10 over 8 shards: S=2, the last shards are pure padding and must
    # own nothing
    mesh = _mesh()
    n = 10
    x, d, a, b, q = _problem(n, 512, seed=1)
    shards = pack_knot_shards(x, d, a, b, 8)
    got = np.asarray(
        jax.jit(
            lambda *s: sharded_knot_eval(*s, mesh=mesh, n=n, axis="knot")
        )(*shards, q)
    )
    want = np.asarray(
        jax.jit(_eval_xla)(x, make_interval_table(x, d, a, b), q)
    )
    nan = np.isnan(want)
    assert np.isnan(got[nan]).all()
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=2e-6, atol=1e-5)


def test_ownership_partitions_queries():
    # constant data, zero coefficients: every query must be owned exactly
    # once, so the psum returns ~1.0 (2.0 would mean double ownership,
    # 0.0 an orphan) — including at shard boundaries and the axis ends
    mesh = _mesh()
    n = 1000
    rng = np.random.default_rng(3)
    x = jnp.asarray(np.cumsum(rng.uniform(0.05, 1.0, n)).astype(np.float32))
    d = jnp.ones((n,), jnp.float32)
    a = jnp.zeros((n - 1,), jnp.float32)
    b = jnp.zeros((n - 1,), jnp.float32)
    s, _ = shard_geometry(n, 8)
    boundary_knots = np.asarray(x)[s::s]
    q = jnp.asarray(
        np.r_[
            np.asarray(x)[:: n // 200],
            boundary_knots,
            boundary_knots - 1e-4,
            boundary_knots + 1e-4,
            np.float32([float(x[0]), float(x[-1])]),
            rng.uniform(float(x[0]) - 3, float(x[-1]) + 3, 512),
        ].astype(np.float32)
    )
    shards = pack_knot_shards(x, d, a, b, 8)
    got = np.asarray(
        jax.jit(
            lambda *sh: sharded_knot_eval(*sh, mesh=mesh, n=n, axis="knot")
        )(*shards, q)
    )
    np.testing.assert_allclose(got, 1.0, rtol=1e-6)


def test_beyond_single_device_cap():
    """A 16.8M-knot axis on the 8-device mesh: each shard searches its
    own 2.1M knots."""
    mesh = _mesh()
    n = 2 * 65535 * 128 + 7
    nq = 32768
    rng = np.random.default_rng(9)
    x = np.linspace(0.0, 1000.0, n, dtype=np.float32)
    d = rng.normal(size=n).astype(np.float32)
    a = rng.normal(size=n - 1).astype(np.float32)
    b = rng.normal(size=n - 1).astype(np.float32)
    q = np.r_[
        rng.uniform(-5.0, 1005.0, nq - 4).astype(np.float32),
        np.float32([-np.inf, np.inf, 0.0, 1000.0]),
    ]
    shards = pack_knot_shards(
        jnp.asarray(x), jnp.asarray(d), jnp.asarray(a), jnp.asarray(b), 8
    )
    got = np.asarray(
        jax.jit(
            lambda *s: sharded_knot_eval(*s, mesh=mesh, n=n, axis="knot")
        )(*shards, jnp.asarray(q))
    )
    # numpy f64 oracle (no single-device jax path exists at this n)
    idx = np.clip(np.searchsorted(x, q, side="right") - 1, 0, n - 2)
    x64 = x.astype(np.float64)
    t = (q.astype(np.float64) - x64[idx]) / (x64[idx + 1] - x64[idx])
    want = (
        (1 - t) * d[idx]
        + t * d[idx + 1]
        + t * (1 - t) * (a[idx] * (1 - t) + b[idx] * t)
    )
    fin = np.isfinite(want)  # ±inf queries: cubic extrapolation is NaN/inf
    assert not np.isfinite(got[~fin]).any()
    scale = np.maximum(np.abs(want[fin]), 1e-2)
    rel = np.abs(got[fin] - want[fin]) / scale
    assert rel.max() < 1e-4, rel.max()


def test_placed_shards_stay_local():
    # the partition-rule leg: placed shard arrays are sharded over the
    # knot axis (each device holds 1/8th + halo), and the eval runs
    # without resharding them
    mesh = _mesh()
    n = 4001
    x, d, a, b, q = _problem(n, 1024, seed=4)
    shards = place_knot_shards(pack_knot_shards(x, d, a, b, 8), mesh)
    for v in shards:
        assert not v.sharding.is_fully_replicated
        assert len(v.addressable_shards) == 8
        assert v.addressable_shards[0].data.shape[0] == 1
    got = np.asarray(
        jax.jit(
            lambda *s: sharded_knot_eval(*s, mesh=mesh, n=n, axis="knot")
        )(*shards, q)
    )
    want = np.asarray(
        jax.jit(_eval_xla)(x, make_interval_table(x, d, a, b), q)
    )
    nan = np.isnan(want)
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=2e-6, atol=1e-5)


def test_banked_trailing_dims():
    # trailing (bank) dims: the bank replicates within each knot shard
    mesh = _mesh()
    n, bank = 1000, 12
    rng = np.random.default_rng(17)
    x = jnp.asarray(np.cumsum(rng.uniform(0.05, 1.0, n)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(n, bank)).astype(np.float32))
    a = jnp.asarray(rng.normal(size=(n - 1, bank)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(n - 1, bank)).astype(np.float32))
    q = jnp.asarray(
        np.r_[
            rng.uniform(float(x[0]) - 2, float(x[-1]) + 2, 500),
            [float(x[0]), float(x[-1])],
        ].astype(np.float32)
    )
    shards = pack_knot_shards(x, d, a, b, 8)
    got = np.asarray(
        jax.jit(
            lambda *s: sharded_knot_eval(*s, mesh=mesh, n=n, axis="knot")
        )(*shards, q)
    )
    assert got.shape == (502, bank)
    # oracle: banked Hermite, numpy
    xn = np.asarray(x)
    idx = np.clip(np.searchsorted(xn, np.asarray(q), "right") - 1, 0, n - 2)
    t = ((np.asarray(q) - xn[idx]) / (xn[idx + 1] - xn[idx]))[:, None]
    dn, an, bn = np.asarray(d), np.asarray(a), np.asarray(b)
    want = (
        (1 - t) * dn[idx]
        + t * dn[idx + 1]
        + t * (1 - t) * (an[idx] * (1 - t) + bn[idx] * t)
    )
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


def test_shard_interp1d_knots_convenience():
    from ndarray_interp_tpu.models.interp1d import Interp1D
    from ndarray_interp_tpu.models.strategies.cubic import CubicSpline
    from ndarray_interp_tpu.ops.knotshard import shard_interp1d_knots

    mesh = _mesh()
    rng = np.random.default_rng(19)
    n, bank = 600, 6
    data = jnp.asarray(rng.normal(size=(n, bank)).astype(np.float32))
    x = jnp.asarray(np.cumsum(rng.uniform(0.1, 1.0, n)).astype(np.float32))
    itp = (
        Interp1D.builder(data)
        .x(x)
        .strategy(CubicSpline().extrapolate(True))
        .build()
    )
    ev = shard_interp1d_knots(itp, mesh)
    q = jnp.asarray(
        rng.uniform(float(x[0]), float(x[-1]), 300).astype(np.float32)
    )
    got = np.asarray(jax.jit(ev)(q))
    want = np.asarray(itp.interp_array(q))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)

    # Linear (no a/b on the strategy): a = b = 0 path
    itp_lin = Interp1D.builder(data).x(x).build()
    ev2 = shard_interp1d_knots(itp_lin, mesh)
    got2 = np.asarray(jax.jit(ev2)(q))
    want2 = np.asarray(itp_lin.interp_array(q))
    np.testing.assert_allclose(got2, want2, rtol=2e-5, atol=1e-4)


def test_grad_flows_through_sharded_eval():
    # shard_map autodiff: gradients wrt queries and shard stacks flow
    # through the ownership masks and psum
    mesh = _mesh()
    n = 500
    x, d, a, b, _ = _problem(n, 8, seed=31)
    rng = np.random.default_rng(32)
    q = jnp.asarray(
        rng.uniform(float(x[0]), float(x[-1]), 256).astype(np.float32)
    )
    shards = pack_knot_shards(x, d, a, b, 8)

    def loss_sharded(q, dsh):
        out = sharded_knot_eval(
            shards[0], dsh, shards[2], shards[3], q, mesh=mesh, n=n,
            axis="knot",
        )
        return jnp.sum(out**2)

    gq, gd = jax.jit(jax.grad(loss_sharded, argnums=(0, 1)))(q, shards[1])
    assert np.isfinite(np.asarray(gq)).all()
    assert np.isfinite(np.asarray(gd)).all()
    assert gd.shape == shards[1].shape

    def loss_oracle(q):
        out = _eval_xla(x, make_interval_table(x, d, a, b), q)
        return jnp.sum(out**2)

    gq_want = jax.jit(jax.grad(loss_oracle))(q)
    np.testing.assert_allclose(
        np.asarray(gq), np.asarray(gq_want), rtol=2e-4, atol=1e-3
    )


def test_f64_axis_on_cpu():
    # non-f32 dtypes route the local search through searchsorted (the
    # big-route one-hot fetch is f32-only); exercised in f64 on CPU
    mesh = _mesh()
    n = 2000
    rng = np.random.default_rng(41)
    x = jnp.asarray(np.cumsum(rng.uniform(0.05, 1.0, n)))
    d = jnp.asarray(rng.normal(size=n))
    a = jnp.asarray(rng.normal(size=n - 1))
    b = jnp.asarray(rng.normal(size=n - 1))
    if x.dtype != jnp.float64:
        pytest.skip("x64 disabled")
    q = jnp.asarray(rng.uniform(float(x[0]), float(x[-1]), 500))
    shards = pack_knot_shards(x, d, a, b, 8)
    got = np.asarray(
        jax.jit(
            lambda *s: sharded_knot_eval(*s, mesh=mesh, n=n, axis="knot")
        )(*shards, q)
    )
    want = np.asarray(
        jax.jit(_eval_xla)(x, make_interval_table(x, d, a, b), q)
    )
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_boundary_aligned_pad_shard_owns_nothing():
    """Round-3 review regression: when (n-1) % S == 0 with spare pad
    shards, the first pad shard's window STARTS at x[n-1] — its value
    range must not overlap the d_last shard's right-clamp ownership
    (previously double-counted every query >= x[n-1])."""
    mesh = _mesh()
    n = 13  # S = 2, d_last = 5, shard 6 starts exactly at x[12] = x[n-1]
    rng = np.random.default_rng(61)
    x = jnp.asarray(np.cumsum(rng.uniform(0.2, 1.0, n)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=n).astype(np.float32))
    a = jnp.asarray(rng.normal(size=n - 1).astype(np.float32))
    b = jnp.asarray(rng.normal(size=n - 1).astype(np.float32))
    q = jnp.asarray(
        np.float32(
            [float(x[-1]), float(x[-1]) + 1.0, float(x[-1]) - 1e-3,
             float(x[0]), float(x[n // 2])]
        )
    )
    shards = pack_knot_shards(x, d, a, b, 8)
    got = np.asarray(
        jax.jit(
            lambda *s: sharded_knot_eval(*s, mesh=mesh, n=n, axis="knot")
        )(*shards, q)
    )
    want = np.asarray(
        jax.jit(_eval_xla)(x, make_interval_table(x, d, a, b), q)
    )
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-5)


def test_mesh_size_mismatch_rejected():
    mesh = _mesh()
    x, d, a, b, q = _problem(100, 16, seed=63)
    shards = pack_knot_shards(x, d, a, b, 4)  # packed for 4, mesh has 8
    with pytest.raises(AssertionError, match="packed for 4"):
        sharded_knot_eval(*shards, q, mesh=mesh, n=100, axis="knot")


def _mesh2():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.asarray(devs[:8]).reshape(4, 2), ("knot", "query"))


def test_two_axis_mesh_knot_by_query():
    """Round-4: the capacity axis (knots) and the throughput axis
    (queries) compose on one 2-D mesh — each query sub-batch evaluates
    against every knot shard, the psum rides only the knot axis, and
    the result stays query-sharded."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = _mesh2()
    n, nq = 4001, 4096
    x, d, a, b, q = _problem(n, nq, seed=51)
    shards = place_knot_shards(pack_knot_shards(x, d, a, b, 4), mesh)
    qp = jax.device_put(q, NamedSharding(mesh, P("query")))
    got_arr = jax.jit(
        lambda *s: sharded_knot_eval(
            *s, mesh=mesh, n=n, axis="knot", query_axis="query"
        )
    )(*shards, qp)
    # the result never gathers: it stays sharded over the query axis
    assert got_arr.sharding.spec[0] == "query", got_arr.sharding
    got = np.asarray(got_arr)
    want = np.asarray(
        jax.jit(_eval_xla)(x, make_interval_table(x, d, a, b), q)
    )
    nan = np.isnan(want)
    assert np.isnan(got[nan]).all()
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=2e-6, atol=1e-5)


def test_two_axis_mesh_banked():
    """2-D mesh with trailing bank dims: the query-sharded result keeps
    its bank axis unsharded."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = _mesh2()
    n, bank, nq = 1000, 6, 1024
    rng = np.random.default_rng(53)
    x = jnp.asarray(np.cumsum(rng.uniform(0.05, 1.0, n)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(n, bank)).astype(np.float32))
    a = jnp.asarray(rng.normal(size=(n - 1, bank)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(n - 1, bank)).astype(np.float32))
    q = jnp.asarray(
        rng.uniform(float(x[0]), float(x[-1]), nq).astype(np.float32)
    )
    shards = place_knot_shards(pack_knot_shards(x, d, a, b, 4), mesh)
    qp = jax.device_put(q, NamedSharding(mesh, P("query")))
    got = np.asarray(
        jax.jit(
            lambda *s: sharded_knot_eval(
                *s, mesh=mesh, n=n, axis="knot", query_axis="query"
            )
        )(*shards, qp)
    )
    assert got.shape == (nq, bank)
    xn = np.asarray(x)
    idx = np.clip(np.searchsorted(xn, np.asarray(q), "right") - 1, 0, n - 2)
    t = ((np.asarray(q) - xn[idx]) / (xn[idx + 1] - xn[idx]))[:, None]
    dn, an, bn = np.asarray(d), np.asarray(a), np.asarray(b)
    want = (
        (1 - t) * dn[idx]
        + t * dn[idx + 1]
        + t * (1 - t) * (an[idx] * (1 - t) + bn[idx] * t)
    )
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


def test_oob_nan_mask_matches_driver_contract():
    """oob='nan': strictly-OOB queries return NaN (the pure-path
    extrapolate=False contract), edge-exact queries stay finite."""
    mesh = _mesh()
    n = 1000
    x, d, a, b, _ = _problem(n, 8, seed=59)
    rng = np.random.default_rng(60)
    lo, hi = float(x[0]), float(x[-1])
    q = jnp.asarray(
        np.r_[
            rng.uniform(lo - 2, hi + 2, 1000),
            [lo, hi, lo - 1e-3, hi + 1e-3, -np.inf, np.inf],
        ].astype(np.float32)
    )
    shards = pack_knot_shards(x, d, a, b, 8)
    got = np.asarray(
        jax.jit(
            lambda *s: sharded_knot_eval(
                *s, mesh=mesh, n=n, axis="knot", oob="nan"
            )
        )(*shards, q)
    )
    qn = np.asarray(q)
    bad = (qn < lo) | (qn > hi)
    assert np.isnan(got[bad]).all()
    want = np.asarray(
        jax.jit(_eval_xla)(x, make_interval_table(x, d, a, b), q)
    )
    np.testing.assert_allclose(got[~bad], want[~bad], rtol=2e-6, atol=1e-5)
    with pytest.raises(ValueError, match="oob"):
        sharded_knot_eval(
            *shards, q, mesh=mesh, n=n, axis="knot", oob="mask"
        )
