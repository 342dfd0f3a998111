"""N-D rectilinear interpolation (`InterpND`) — beyond the reference.

The reference crate stops at two interpolated axes
(``/root/reference/src/interp2d/mod.rs:29-32``); `InterpND` generalizes
the driver conventions (query dims leading, output dims ``M + N - k``,
matching query shapes, OOB raise / NaN mask — ``mod.rs:175-211``) to the
leading-``k``-axes case.  Oracle: SciPy ``RegularGridInterpolator``,
consistent with the reference's own SciPy-as-ground-truth test strategy
(``tests/cubic_spline_strat.rs``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ndarray_interp_tpu.errors import (
    MonotonicError,
    NotEnoughDataError,
    OutOfBoundsError,
    ShapeError,
)
from ndarray_interp_tpu.interpnd import InterpND, InterpNDBuilder

scipy_interp = pytest.importorskip("scipy.interpolate")


def _grid_case(k, trailing=(), seed=0, sizes=None):
    rng = np.random.default_rng(seed)
    sizes = sizes or [5, 4, 6, 3, 4][:k]
    axes = [np.sort(rng.uniform(-4.0, 4.0, n)) for n in sizes]
    data = rng.normal(size=tuple(sizes) + tuple(trailing))
    return axes, data, rng


def _queries(axes, rng, n=64, shape=None):
    qs = [rng.uniform(ax[0], ax[-1], n) for ax in axes]
    if shape is not None:
        qs = [q.reshape(shape) for q in qs]
    return qs


# ---------------------------------------------------------------------------
# SciPy oracle parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_scipy_oracle(k, method):
    axes, data, rng = _grid_case(k, seed=k)
    itp = InterpND.builder(data).points(*axes).method(method).build()
    qs = _queries(axes, rng)
    got = np.asarray(itp.interp_array(*qs))
    rgi = scipy_interp.RegularGridInterpolator(axes, data, method=method)
    want = rgi(np.stack(qs, axis=-1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("k", [2, 3])
def test_scipy_oracle_trailing_dims(k):
    axes, data, rng = _grid_case(k, trailing=(3, 2), seed=10 + k)
    itp = InterpND.builder(data).points(*axes).build()
    qs = _queries(axes, rng, n=40)
    got = np.asarray(itp.interp_array(*qs))
    assert got.shape == (40, 3, 2)
    rgi = scipy_interp.RegularGridInterpolator(axes, data)
    want = rgi(np.stack(qs, axis=-1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_matches_interp2d_bilinear():
    # InterpND(k=2, linear) must agree with the reference-parity Bilinear
    from ndarray_interp_tpu.interp2d import Interp2D

    axes, data, rng = _grid_case(2, trailing=(3,), seed=3)
    nd = InterpND.builder(data).points(*axes).build()
    i2 = (
        Interp2D.builder(data)
        .x(jnp.asarray(axes[0]))
        .y(jnp.asarray(axes[1]))
        .build()
    )
    xs, ys = _queries(axes, rng, n=32)
    np.testing.assert_allclose(
        np.asarray(nd.interp_array(xs, ys)),
        np.asarray(i2.interp_array(jnp.asarray(xs), jnp.asarray(ys))),
        rtol=0,
        atol=1e-13,
    )


def test_grid_nodes_exact():
    # every grid node reproduces its data value exactly
    axes, data, _ = _grid_case(3, seed=5)
    itp = InterpND.builder(data).points(*axes).build()
    mesh = np.meshgrid(*axes, indexing="ij")
    got = np.asarray(itp.interp_array(*(m.ravel() for m in mesh)))
    np.testing.assert_allclose(
        got, data.ravel(), rtol=0, atol=1e-13
    )


# ---------------------------------------------------------------------------
# Driver conventions (shapes, defaults, errors)
# ---------------------------------------------------------------------------


def test_output_shape_m_plus_n_minus_k():
    # query dims leading; output dims M + N - k (mod.rs:175-211 convention)
    axes, data, rng = _grid_case(3, trailing=(2,), seed=7)
    itp = InterpND.builder(data).points(*axes).build()
    qs = _queries(axes, rng, n=24, shape=(2, 3, 4))
    out = itp.interp_array(*qs)
    assert out.shape == (2, 3, 4, 2)
    assert itp.get_buffer_shape((2, 3, 4)) == (2, 3, 4, 2)
    # scalar-point interp -> trailing shape
    pt = [float(0.5 * (a[0] + a[-1])) for a in axes]
    assert itp.interp(*pt).shape == (2,)


def test_interp_array_into():
    axes, data, rng = _grid_case(2, trailing=(2,), seed=71)
    itp = InterpND.builder(data).points(*axes).build()
    qs = _queries(axes, rng, n=12, shape=(3, 4))
    buf = np.zeros((3, 4, 2))
    out = itp.interp_array_into(*qs, buffer=buf)
    assert out is buf
    np.testing.assert_allclose(
        buf, np.asarray(itp.interp_array(*qs)), rtol=0, atol=0
    )
    with pytest.raises(ValueError, match="buffer shape mismatch"):
        itp.interp_array_into(*qs, buffer=np.zeros((3, 4)))
    # all-or-nothing on OOB (PARITY.md D2): buffer untouched
    bad = [q.copy() for q in qs]
    bad[0].flat[0] = axes[0][-1] + 5.0
    buf2 = np.full((3, 4, 2), -1.0)
    with pytest.raises(OutOfBoundsError):
        itp.interp_array_into(*bad, buffer=buf2)
    np.testing.assert_array_equal(buf2, -1.0)


def test_default_axes_are_indices():
    data = np.arange(24.0).reshape(2, 3, 4)
    itp = InterpND.builder(data).build()
    assert itp.k == 3
    np.testing.assert_allclose(
        np.asarray(itp.interp(0.5, 1.0, 2.5)),
        np.asarray(
            scipy_interp.RegularGridInterpolator(
                [np.arange(2.0), np.arange(3.0), np.arange(4.0)], data
            )([0.5, 1.0, 2.5])[0]
        ),
    )


def test_query_shape_mismatch():
    axes, data, _ = _grid_case(2)
    itp = InterpND.builder(data).points(*axes).build()
    with pytest.raises(ValueError, match="do not match"):
        itp.interp_array(np.zeros(3), np.zeros(4))


def test_query_arity_mismatch():
    axes, data, _ = _grid_case(2)
    itp = InterpND.builder(data).points(*axes).build()
    with pytest.raises(ValueError, match="expected 2 coordinate arrays"):
        itp.interp_array(np.zeros(3))


def test_out_of_bounds_raises_eagerly():
    axes, data, _ = _grid_case(2)
    itp = InterpND.builder(data).points(*axes).build()
    with pytest.raises(OutOfBoundsError, match="axis 1"):
        itp.interp(axes[0][0], axes[1][-1] + 1.0)


def test_out_of_bounds_masks_to_nan_in_pure_path():
    # docs/PARITY.md D1: the pure jittable path masks OOB to NaN
    axes, data, _ = _grid_case(2)
    itp = InterpND.builder(data).points(*axes).build()
    out = itp(np.array([axes[0][0], axes[0][0]]),
              np.array([axes[1][0], axes[1][-1] + 1.0]))
    assert np.isfinite(out[0])
    assert np.isnan(out[1])


def test_extrapolate_extends_edge_cells():
    # linear data extrapolates exactly when extrapolate=True
    ax = [np.array([0.0, 1.0, 2.0]), np.array([0.0, 1.0])]
    x, y = np.meshgrid(*ax, indexing="ij")
    data = 2.0 * x + 3.0 * y + 1.0
    itp = (
        InterpND.builder(data).points(*ax).extrapolate().build()
    )
    got = itp.interp(3.5, -1.0)
    np.testing.assert_allclose(float(got), 2 * 3.5 + 3 * (-1.0) + 1.0)
    # nearest extrapolation clamps to the edge node
    itn = (
        InterpND.builder(data)
        .points(*ax)
        .method("nearest")
        .extrapolate()
        .build()
    )
    np.testing.assert_allclose(float(itn.interp(9.0, 9.0)), data[-1, -1])


def test_nan_query_raises():
    axes, data, _ = _grid_case(2)
    itp = InterpND.builder(data).points(*axes).build()
    with pytest.raises(ValueError, match="NaN"):
        itp.interp(np.nan, axes[1][0])


# ---------------------------------------------------------------------------
# Builder validation (mirrors the 2-D builder, mod.rs:468-518)
# ---------------------------------------------------------------------------


def test_builder_errors():
    axes, data, _ = _grid_case(2)
    with pytest.raises(NotEnoughDataError, match="0-dimension"):
        InterpND.builder(np.zeros((1, 4))).points(
            np.zeros(1), axes[1]
        ).build()
    with pytest.raises(ShapeError, match="axis 0 and data-0"):
        InterpND.builder(data).points(np.arange(3.0), axes[1]).build()
    with pytest.raises(MonotonicError, match="axis 1"):
        InterpND.builder(data).points(
            axes[0], axes[1][::-1].copy()
        ).build()
    with pytest.raises(ShapeError, match="one-dimensional"):
        InterpND.builder(data).points(
            axes[0].reshape(-1, 1), axes[1]
        ).build()
    with pytest.raises(ShapeError, match="at least 2"):
        InterpND.builder(np.zeros(5)).points(
            np.arange(5.0), np.arange(3.0)
        ).build()
    with pytest.raises(ValueError, match="unknown InterpND method"):
        InterpND.builder(data).method("quintic")


def test_builder_type_and_chaining():
    axes, data, _ = _grid_case(2)
    b = InterpND.builder(data)
    assert isinstance(b, InterpNDBuilder)
    itp = b.points(*axes).method("nearest").extrapolate().build()
    assert itp.method == "nearest"
    assert itp.extrapolates


# ---------------------------------------------------------------------------
# Transforms: jit / vmap / grad / pytree
# ---------------------------------------------------------------------------


def test_jit_vmap_grad():
    axes, data, rng = _grid_case(3, seed=11)
    itp = InterpND.builder(data).points(*axes).build()
    qs = [jnp.asarray(q) for q in _queries(axes, rng, n=16)]

    jitted = jax.jit(lambda i, *q: i(*q))
    np.testing.assert_allclose(
        np.asarray(jitted(itp, *qs)),
        np.asarray(itp.interp_array(*qs)),
        rtol=0,
        atol=1e-13,
    )

    vm = jax.vmap(lambda a, b, c: itp(a, b, c))
    np.testing.assert_allclose(
        np.asarray(vm(*qs)).ravel(),
        np.asarray(itp.interp_array(*qs)).ravel(),
        rtol=0,
        atol=1e-13,
    )

    # gradient w.r.t. the query point: piecewise-multilinear slope
    ax = [np.array([0.0, 1.0, 2.0]), np.array([0.0, 2.0])]
    x, y = np.meshgrid(*ax, indexing="ij")
    lin = 2.0 * x + 3.0 * y
    ilin = InterpND.builder(lin).points(*ax).build()
    g = jax.grad(
        lambda x_, y_: ilin(x_.reshape(1), y_.reshape(1)).sum()
    )(jnp.asarray(0.6), jnp.asarray(1.1))
    np.testing.assert_allclose(float(g), 2.0, atol=1e-13)


def test_pytree_roundtrip():
    axes, data, _ = _grid_case(2, trailing=(2,))
    itp = (
        InterpND.builder(data)
        .points(*axes)
        .method("nearest")
        .extrapolate()
        .build()
    )
    leaves, treedef = jax.tree_util.tree_flatten(itp)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.method == "nearest"
    assert back.extrapolates
    assert back.k == 2
    np.testing.assert_array_equal(
        np.asarray(back.data), np.asarray(itp.data)
    )


def test_checkpoint_roundtrip(tmp_path):
    from ndarray_interp_tpu.utils import checkpoint

    axes, data, rng = _grid_case(3, trailing=(2,), seed=21)
    itp = (
        InterpND.builder(data)
        .points(*axes)
        .method("nearest")
        .extrapolate()
        .build()
    )
    path = tmp_path / "nd.npz"
    checkpoint.save(path, itp)
    back = checkpoint.load(path)
    assert isinstance(back, InterpND)
    assert back.method == "nearest"
    assert back.extrapolates
    assert back.k == 3
    qs = _queries(axes, rng, n=16)
    np.testing.assert_array_equal(
        np.asarray(back.interp_array(*qs)),
        np.asarray(itp.interp_array(*qs)),
    )


def test_sharded_queries_match_replicated():
    # queries shard over the mesh (each touches only its own cell);
    # axes/data replicate — a zero-communication layout
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs a multi-device mesh")
    axes, data, rng = _grid_case(3, trailing=(2,), seed=31)
    itp = InterpND.builder(data).points(*axes).build()
    qs = [jnp.asarray(q) for q in _queries(axes, rng, n=16 * len(devs))]
    want = np.asarray(itp.interp_array(*qs))

    mesh = Mesh(np.array(devs), ("q",))
    qsh = NamedSharding(mesh, P("q"))
    rep = NamedSharding(mesh, P())
    itp_r = jax.device_put(itp, rep)
    qs_s = [jax.device_put(q, qsh) for q in qs]
    out = jax.jit(
        lambda i, *q: i.eval_unchecked(*q),
        out_shardings=NamedSharding(mesh, P("q", None)),
    )(itp_r, *qs_s)
    np.testing.assert_allclose(np.asarray(out), want, rtol=0, atol=1e-13)


def test_packed_route_matches_unpacked():
    # the packed corner table is a pure performance route: same values
    from ndarray_interp_tpu import config

    axes, data, rng = _grid_case(3, trailing=(2,), seed=41)
    packed = InterpND.builder(data).points(*axes).build()
    assert packed.table is not None
    assert packed.table.shape == (4 * 3 * 5, 8 * 2)
    old = config.interpnd_pack_max_elems
    try:
        config.interpnd_pack_max_elems = 0
        unpacked = InterpND.builder(data).points(*axes).build()
    finally:
        config.interpnd_pack_max_elems = old
    assert unpacked.table is None
    qs = _queries(axes, rng, n=200)
    np.testing.assert_allclose(
        np.asarray(packed.interp_array(*qs)),
        np.asarray(unpacked.interp_array(*qs)),
        rtol=0,
        atol=1e-13,
    )


# ---------------------------------------------------------------------------
# method="cubic": tensor-product C^2 cubic spline
# ---------------------------------------------------------------------------

_BC_TO_SCIPY = {
    "not_a_knot": "not-a-knot",
    "natural": "natural",
    "clamped": "clamped",
    "periodic": "periodic",
}


def _seq_cubic_oracle(axes, data, pts, bcs):
    """The exact tensor-product spline: sequential 1-D SciPy solves
    (spline interpolation is linear in the data, so axis order is
    irrelevant).  NOTE SciPy's own ``RegularGridInterpolator
    (method="cubic")`` deviates from this exact tensor product by
    ~5e-3 on random k=3 grids (measured, SciPy 1.17); this oracle is
    the ground truth both agree on in the k<=2 cases."""
    out = []
    k = len(axes)
    for pt in zip(*pts):
        g = data
        for d in reversed(range(k)):
            g = scipy_interp.CubicSpline(
                axes[d], g, axis=d, bc_type=_BC_TO_SCIPY[bcs[d]]
            )(pt[d])
        out.append(g)
    return np.array(out)


@pytest.mark.parametrize("bc", ["not_a_knot", "natural", "clamped"])
def test_cubic_k1_matches_scipy(bc):
    rng = np.random.default_rng(51)
    x = np.sort(rng.uniform(0, 10, 9))
    y = rng.normal(size=9)
    itp = (
        InterpND.builder(y).points(x).method("cubic").boundary(bc).build()
    )
    q = rng.uniform(x[0], x[-1], 100)
    ref = scipy_interp.CubicSpline(x, y, bc_type=_BC_TO_SCIPY[bc])(q)
    np.testing.assert_allclose(
        np.asarray(itp.interp_array(q)), ref, rtol=0, atol=1e-12
    )


def test_cubic_k2_matches_bicubic():
    from ndarray_interp_tpu.interp2d import Interp2D
    from ndarray_interp_tpu.models.strategies.bicubic import Bicubic

    rng = np.random.default_rng(52)
    axes = [np.sort(rng.uniform(0, 5, 8)), np.sort(rng.uniform(-2, 2, 7))]
    data = rng.normal(size=(8, 7, 3))
    nd = InterpND.builder(data).points(*axes).method("cubic").build()
    b2 = (
        Interp2D.builder(data)
        .x(jnp.asarray(axes[0]))
        .y(jnp.asarray(axes[1]))
        .strategy(Bicubic())
        .build()
    )
    qx, qy = [rng.uniform(a[0], a[-1], 60) for a in axes]
    np.testing.assert_allclose(
        np.asarray(nd.interp_array(qx, qy)),
        np.asarray(b2.interp_array(jnp.asarray(qx), jnp.asarray(qy))),
        rtol=0,
        atol=1e-12,
    )


@pytest.mark.parametrize(
    "bcs",
    [
        ("not_a_knot",) * 3,
        ("natural",) * 3,
        ("clamped", "not_a_knot", "natural"),
    ],
)
def test_cubic_k3_matches_tensor_product_oracle(bcs):
    rng = np.random.default_rng(53)
    axes = [np.sort(rng.uniform(0, 1, n)) for n in (6, 7, 5)]
    data = rng.normal(size=(6, 7, 5))
    itp = (
        InterpND.builder(data)
        .points(*axes)
        .method("cubic")
        .boundary(*bcs)
        .build()
    )
    qs = [rng.uniform(a[0], a[-1], 40) for a in axes]
    ref = _seq_cubic_oracle(axes, data, qs, bcs)
    np.testing.assert_allclose(
        np.asarray(itp.interp_array(*qs)), ref, rtol=0, atol=1e-11
    )


def test_cubic_k3_trailing_dims():
    rng = np.random.default_rng(54)
    axes = [np.sort(rng.uniform(0, 1, n)) for n in (5, 6, 7)]
    data = rng.normal(size=(5, 6, 7, 2))
    itp = InterpND.builder(data).points(*axes).method("cubic").build()
    qs = [rng.uniform(a[0], a[-1], 25) for a in axes]
    ref = _seq_cubic_oracle(axes, data, qs, ("not_a_knot",) * 3)
    got = np.asarray(itp.interp_array(*qs))
    assert got.shape == (25, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-11)


def test_cubic_periodic_axis_wraps():
    rng = np.random.default_rng(55)
    axes = [np.linspace(0, 2 * np.pi, 9), np.sort(rng.uniform(0, 1, 6))]
    data = rng.normal(size=(9, 6))
    data[-1] = data[0]  # periodic axis 0
    itp = (
        InterpND.builder(data)
        .points(*axes)
        .method("cubic")
        .boundary("periodic", "not_a_knot")
        .build()
    )
    qx = rng.uniform(0, 2 * np.pi, 30)
    qy = rng.uniform(axes[1][0], axes[1][-1], 30)
    base = np.asarray(itp.interp_array(qx, qy))
    # queries one period away land on the same values, with no OOB
    shifted = np.asarray(itp.interp_array(qx + 2 * np.pi, qy))
    np.testing.assert_allclose(shifted, base, rtol=0, atol=1e-10)
    # values match the sequential periodic oracle
    ref = _seq_cubic_oracle(
        axes, data, [qx, qy], ("periodic", "not_a_knot")
    )
    np.testing.assert_allclose(base, ref, rtol=0, atol=1e-11)
    # eager path: periodic axis never raises OOB
    itp.interp(100.0, float(axes[1][2]))


def test_cubic_node_layout_matches_cell():
    from ndarray_interp_tpu import config

    rng = np.random.default_rng(56)
    axes = [np.sort(rng.uniform(0, 1, n)) for n in (6, 5, 7)]
    data = rng.normal(size=(6, 5, 7, 2))
    cell = InterpND.builder(data).points(*axes).method("cubic").build()
    assert cell.layout == "cell"
    old = config.interpnd_pack_max_elems
    try:
        config.interpnd_pack_max_elems = 0
        node = InterpND.builder(data).points(*axes).method("cubic").build()
    finally:
        config.interpnd_pack_max_elems = old
    assert node.layout == "node"
    assert node.table.shape == (6 * 5 * 7, 8 * 2 + 3)
    qs = _queries(axes, rng, n=50)
    np.testing.assert_allclose(
        np.asarray(node.interp_array(*qs)),
        np.asarray(cell.interp_array(*qs)),
        rtol=0,
        atol=1e-11,
    )


def test_cubic_extrapolates_edge_polynomial():
    # the edge cell's cubic extends: matches SciPy extrapolation (k=1)
    rng = np.random.default_rng(57)
    x = np.sort(rng.uniform(0, 10, 8))
    y = rng.normal(size=8)
    itp = (
        InterpND.builder(y)
        .points(x)
        .method("cubic")
        .extrapolate()
        .build()
    )
    q = np.array([x[0] - 1.5, x[-1] + 2.0])
    ref = scipy_interp.CubicSpline(x, y)(q)
    np.testing.assert_allclose(
        np.asarray(itp.interp_array(q)), ref, rtol=0, atol=1e-10
    )


def test_cubic_jit_grad():
    rng = np.random.default_rng(58)
    axes = [np.sort(rng.uniform(0, 1, 6)) for _ in range(2)]
    data = rng.normal(size=(6, 6))
    itp = InterpND.builder(data).points(*axes).method("cubic").build()
    qs = [jnp.asarray(rng.uniform(a[0], a[-1], 10)) for a in axes]
    np.testing.assert_allclose(
        np.asarray(jax.jit(lambda i, *q: i(*q))(itp, *qs)),
        np.asarray(itp.interp_array(*qs)),
        rtol=0,
        atol=1e-12,
    )
    # grad w.r.t. query = the analytic partial (finite-diff check)
    f = lambda x_, y_: itp(x_.reshape(1), y_.reshape(1)).sum()
    x0, y0 = jnp.asarray(0.41), jnp.asarray(0.57)
    g = jax.grad(f, argnums=(0, 1))(x0, y0)
    eps = 1e-6
    fd_x = (f(x0 + eps, y0) - f(x0 - eps, y0)) / (2 * eps)
    fd_y = (f(x0, y0 + eps) - f(x0, y0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g[0]), float(fd_x), rtol=1e-4)
    np.testing.assert_allclose(float(g[1]), float(fd_y), rtol=1e-4)


def test_cubic_checkpoint_roundtrip(tmp_path):
    from ndarray_interp_tpu.utils import checkpoint

    rng = np.random.default_rng(59)
    axes = [np.sort(rng.uniform(0, 1, 6)) for _ in range(2)]
    data = rng.normal(size=(6, 6))
    itp = (
        InterpND.builder(data)
        .points(*axes)
        .method("cubic")
        .boundary("natural", "clamped")
        .build()
    )
    path = tmp_path / "ndc.npz"
    checkpoint.save(path, itp)
    back = checkpoint.load(path)
    assert back.method == "cubic"
    assert back.bcs == ("natural", "clamped")
    assert back.layout == "cell"
    qs = _queries(axes, rng, n=20)
    np.testing.assert_allclose(
        np.asarray(back.interp_array(*qs)),
        np.asarray(itp.interp_array(*qs)),
        rtol=0,
        atol=1e-13,
    )


def test_derivative_cubic_matches_bicubic():
    from ndarray_interp_tpu.interp2d import Interp2D
    from ndarray_interp_tpu.models.strategies.bicubic import Bicubic

    rng = np.random.default_rng(61)
    axes = [np.sort(rng.uniform(0, 5, 8)), np.sort(rng.uniform(-2, 2, 7))]
    data = rng.normal(size=(8, 7))
    nd = InterpND.builder(data).points(*axes).method("cubic").build()
    b2 = (
        Interp2D.builder(data)
        .x(jnp.asarray(axes[0]))
        .y(jnp.asarray(axes[1]))
        .strategy(Bicubic())
        .build()
    )
    qx, qy = [rng.uniform(a[0], a[-1], 50) for a in axes]
    for dx, dy in [(1, 0), (0, 1), (1, 1), (2, 0), (2, 1), (3, 3)]:
        a = np.asarray(nd.derivative(qx, qy, orders=(dx, dy)))
        b = np.asarray(
            b2.derivative(jnp.asarray(qx), jnp.asarray(qy), dx=dx, dy=dy)
        )
        scale = max(1.0, np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 * scale)


def test_derivative_matches_grad():
    rng = np.random.default_rng(62)
    axes = [np.sort(rng.uniform(0, 1, 6)) for _ in range(3)]
    lo = max(a[0] for a in axes) + 0.01
    hi = min(a[-1] for a in axes) - 0.01
    data = rng.normal(size=(6, 6, 6))
    pt = [jnp.asarray(v) for v in rng.uniform(lo, hi, 3)]
    units = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    for method in ("cubic", "linear"):
        itp = InterpND.builder(data).points(*axes).method(method).build()
        g = jax.grad(
            lambda a, b, c: itp(
                a.reshape(1), b.reshape(1), c.reshape(1)
            ).sum(),
            argnums=(0, 1, 2),
        )(*pt)
        for gi, o in zip(g, units):
            di = itp.derivative(
                *(np.array([float(p)]) for p in pt), orders=o
            )
            np.testing.assert_allclose(
                float(gi), float(di[0]), rtol=1e-10
            )


def test_derivative_linear_higher_orders_zero():
    rng = np.random.default_rng(63)
    axes, data, _ = _grid_case(2, seed=63)
    itp = InterpND.builder(data).points(*axes).build()
    qs = _queries(axes, rng, n=20)
    np.testing.assert_array_equal(
        np.asarray(itp.derivative(*qs, orders=(2, 0))), 0.0
    )


def test_derivative_node_layout_and_trailing():
    from ndarray_interp_tpu import config

    rng = np.random.default_rng(64)
    axes = [np.sort(rng.uniform(0, 1, n)) for n in (6, 5, 7)]
    data = rng.normal(size=(6, 5, 7, 2))
    cell = InterpND.builder(data).points(*axes).method("cubic").build()
    old = config.interpnd_pack_max_elems
    try:
        config.interpnd_pack_max_elems = 0
        node = InterpND.builder(data).points(*axes).method("cubic").build()
    finally:
        config.interpnd_pack_max_elems = old
    qs = _queries(axes, rng, n=30)
    for orders in [(1, 0, 0), (0, 1, 1), (2, 1, 0)]:
        a = np.asarray(cell.derivative(*qs, orders=orders))
        b = np.asarray(node.derivative(*qs, orders=orders))
        assert a.shape == (30, 2)
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 * scale)


def test_derivative_errors():
    axes, data, _ = _grid_case(2)
    lin = InterpND.builder(data).points(*axes).build()
    with pytest.raises(ValueError, match="expected 2 derivative orders"):
        lin.derivative(np.zeros(2) + axes[0][1], np.zeros(2) + axes[1][1],
                       orders=(1,))
    with pytest.raises(ValueError, match="non-negative"):
        lin.derivative(np.zeros(2) + axes[0][1], np.zeros(2) + axes[1][1],
                       orders=(-1, 0))
    near = InterpND.builder(data).points(*axes).method("nearest").build()
    with pytest.raises(TypeError, match="nearest does not support"):
        near.derivative(np.zeros(1), np.zeros(1), orders=(1, 0))


def test_integrate_cubic_matches_sequential_scipy():
    rng = np.random.default_rng(81)
    for k in (1, 2, 3):
        axes = [np.sort(rng.uniform(0, 1, n)) for n in (6, 7, 5)[:k]]
        data = rng.normal(size=tuple(a.shape[0] for a in axes))
        itp = InterpND.builder(data).points(*axes).method("cubic").build()
        box = [(a[0] + 0.05, a[-1] - 0.07) for a in axes]
        # sequential 1-D spline integration, axis k-1 inward
        g = data
        for d in reversed(range(k)):
            g = scipy_interp.CubicSpline(axes[d], g, axis=d).integrate(
                *box[d]
            )
        np.testing.assert_allclose(
            float(itp.integrate(*box)), float(g), rtol=0, atol=1e-12
        )


def test_integrate_trailing_and_signed():
    rng = np.random.default_rng(82)
    axes = [np.sort(rng.uniform(0, 1, 6)), np.sort(rng.uniform(0, 1, 7))]
    data = rng.normal(size=(6, 7, 2))
    itp = InterpND.builder(data).points(*axes).method("cubic").build()
    box = [(axes[0][0] + 0.02, axes[0][-1] - 0.02),
           (axes[1][0] + 0.03, axes[1][-1] - 0.01)]
    g = scipy_interp.CubicSpline(axes[1], data, axis=1).integrate(*box[1])
    ref = scipy_interp.CubicSpline(axes[0], g, axis=0).integrate(*box[0])
    got = np.asarray(itp.integrate(*box))
    assert got.shape == (2,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    # swapping one axis's bounds negates
    np.testing.assert_allclose(
        np.asarray(itp.integrate((box[0][1], box[0][0]), box[1])),
        -got,
        rtol=0,
        atol=1e-13,
    )


def test_integrate_linear_exact_on_plane():
    # integral of an affine function over a box is exact for multilinear
    ax = [np.array([0.0, 1.0, 3.0]), np.array([0.0, 2.0])]
    x, y = np.meshgrid(*ax, indexing="ij")
    data = 2.0 * x + 3.0 * y + 1.0
    itp = InterpND.builder(data).points(*ax).build()
    # ∫0..3 ∫0..2 (2x+3y+1) dy dx = [x^2+ x]*2 over x + 3*2 (y part)
    # = ∫0..3 (4x + 6 + 2) dx = 2*9 + 8*3 = 42
    np.testing.assert_allclose(
        float(itp.integrate((0.0, 3.0), (0.0, 2.0))), 42.0, atol=1e-12
    )


def test_integrate_extrapolated_bounds():
    rng = np.random.default_rng(83)
    x = np.sort(rng.uniform(0, 10, 8))
    y = rng.normal(size=8)
    itp = (
        InterpND.builder(y).points(x).method("cubic").extrapolate().build()
    )
    lo, hi = x[0] - 2.0, x[-1] + 1.0
    ref = scipy_interp.CubicSpline(x, y).integrate(lo, hi)
    np.testing.assert_allclose(
        float(itp.integrate((lo, hi))), ref, rtol=0, atol=1e-10
    )


def test_integrate_matches_interp1d():
    from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D

    rng = np.random.default_rng(84)
    x = np.sort(rng.uniform(0, 10, 9))
    y = rng.normal(size=9)
    nd = InterpND.builder(y).points(x).method("cubic").build()
    i1 = (
        Interp1D.builder(jnp.asarray(y))
        .x(jnp.asarray(x))
        .strategy(CubicSpline())
        .build()
    )
    lo, hi = x[0] + 0.5, x[-1] - 0.5
    np.testing.assert_allclose(
        float(nd.integrate((lo, hi))),
        float(i1.integrate(lo, hi)),
        rtol=0,
        atol=1e-12,
    )


def test_integrate_errors():
    rng = np.random.default_rng(85)
    axes = [np.sort(rng.uniform(0, 1, 6)), np.sort(rng.uniform(0, 1, 6))]
    data = rng.normal(size=(6, 6))
    itp = InterpND.builder(data).points(*axes).method("cubic").build()
    with pytest.raises(OutOfBoundsError, match="bounds"):
        itp.integrate((axes[0][0] - 1.0, axes[0][-1]), (0.5, 0.6))
    with pytest.raises(ValueError, match="expected 2"):
        itp.integrate((0.1, 0.2))
    near = InterpND.builder(data).points(*axes).method("nearest").build()
    with pytest.raises(TypeError, match="nearest does not support"):
        near.integrate((0.1, 0.2), (0.1, 0.2))
    per = np.concatenate([data[:-1], data[:1]], axis=0)
    itp_p = (
        InterpND.builder(per)
        .points(*axes)
        .method("cubic")
        .boundary("periodic", "natural")
        .build()
    )
    with pytest.raises(ValueError, match="periodic"):
        itp_p.integrate((0.1, 0.2), (0.1, 0.2))


def test_cubic_builder_errors():
    rng = np.random.default_rng(60)
    axes = [np.sort(rng.uniform(0, 1, 5)) for _ in range(2)]
    data = rng.normal(size=(5, 5))
    with pytest.raises(ValueError, match="method\\('cubic'\\) only"):
        InterpND.builder(data).points(*axes).boundary("natural").build()
    with pytest.raises(ValueError, match="unknown boundary"):
        InterpND.builder(data).method("cubic").boundary("nak")
    with pytest.raises(ShapeError, match="expected 2 boundary"):
        InterpND.builder(data).points(*axes).method("cubic").boundary(
            "natural", "natural", "natural"
        ).build()
    with pytest.raises(NotEnoughDataError, match="Required: 3"):
        InterpND.builder(np.zeros((2, 5))).points(
            np.arange(2.0), axes[1]
        ).method("cubic").build()
    with pytest.raises(ValueError, match="periodic axis 0"):
        InterpND.builder(data).points(*axes).method("cubic").boundary(
            "periodic", "natural"
        ).build()


def test_int_data_promotes_to_float():
    data = np.arange(12, dtype=np.int32).reshape(3, 4)
    itp = InterpND.builder(data).build()
    out = itp.interp(0.5, 0.5)
    assert jnp.issubdtype(out.dtype, jnp.inexact)
    np.testing.assert_allclose(float(out), (0 + 1 + 4 + 5) / 4.0)


# ---------------------------------------------------------------------------
# Layout choice + forced-layout dispatch
# ---------------------------------------------------------------------------


def test_route_cost_model_cell_dominates(monkeypatch):
    """Auto-dispatch picks the cell table whenever it fits the cap (one
    row gather: measured faster than every node layout) and the plain
    node table otherwise — exactly at the cap boundary."""
    from ndarray_interp_tpu import config

    axes, data, _ = _grid_case(3, seed=78, sizes=[6, 5, 4])
    cell_elems = 5 * 4 * 3 * 4**3
    monkeypatch.setattr(config, "interpnd_pack_max_elems", cell_elems)
    fit = InterpND.builder(data).points(*axes).method("cubic").build()
    assert fit.layout == "cell"
    monkeypatch.setattr(config, "interpnd_pack_max_elems", cell_elems - 1)
    over = InterpND.builder(data).points(*axes).method("cubic").build()
    assert over.layout == "node"


def test_layout_dispatch_by_cap_and_force():
    from ndarray_interp_tpu import config

    axes, data, rng = _grid_case(3, seed=77, sizes=[9, 8, 7])
    # small grid: auto picks cell
    auto = InterpND.builder(data).points(*axes).method("cubic").build()
    assert auto.layout == "cell"
    # force node on the same grid: identical interpolant, 2^k gathers
    node = (
        InterpND.builder(data)
        .points(*axes)
        .method("cubic")
        .layout("node")
        .build()
    )
    assert node.layout == "node"
    qs = _queries(axes, rng, n=200)
    np.testing.assert_allclose(
        np.asarray(node.interp_array(*qs)),
        np.asarray(auto.interp_array(*qs)),
        rtol=1e-12,
        atol=1e-12,
    )
    # shrink the cap: auto falls back to node
    old = config.interpnd_pack_max_elems
    try:
        config.interpnd_pack_max_elems = 100
        small = (
            InterpND.builder(data).points(*axes).method("cubic").build()
        )
        assert small.layout == "node"
    finally:
        config.interpnd_pack_max_elems = old
    with pytest.raises(ValueError, match="layout"):
        InterpND.builder(data).method("cubic").layout("packed")
