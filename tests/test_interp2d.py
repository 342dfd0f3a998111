"""Ports of the reference 2-D integration tests.

Reference: ``/root/reference/tests/interp2d.rs`` plus the inline dimension
sweep in ``src/interp2d/mod.rs:521-589`` and the crate-root 2-D doctests
(``src/lib.rs:74-115``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ndarray_interp_tpu.errors import (
    MonotonicError,
    NotEnoughDataError,
    OutOfBoundsError,
    ShapeError,
)
from ndarray_interp_tpu.interp2d import Bilinear, Interp2D, Interp2DBuilder


def data_i32():
    return jnp.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]])


def data_f64():
    return jnp.array(
        [[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0], [9.0, 10.0, 11.0, 12.0]]
    )


def test_crate_doctest_2d():
    # src/lib.rs:74-89
    data = jnp.array([[1.0, 2.0, 2.5], [3.0, 4.0, 3.5]])
    interp = Interp2D.builder(data).build()
    assert interp.interp_scalar(0.0, 0.5) == 1.5
    np.testing.assert_array_equal(
        interp.interp_array(jnp.array([0.0, 1.0]), jnp.array([0.5, 2.0])),
        [1.5, 3.5],
    )


def test_crate_doctest_2d_multidim():
    # src/lib.rs:91-115
    data = jnp.array(
        [
            [[1.0, -1.0], [2.0, -2.0], [3.0, -3.0]],
            [[4.0, -4.0], [5.0, -5.0], [6.0, -6.0]],
            [[7.0, -7.0], [8.0, -8.0], [9.0, -9.0]],
            [[7.5, -7.5], [8.5, -8.5], [9.5, -9.5]],
        ]
    )
    interp = (
        Interp2D.builder(data)
        .x(jnp.array([1.0, 2.0, 3.0, 4.0]))
        .y(jnp.array([1.0, 2.0, 3.0]))
        .build()
    )
    np.testing.assert_array_equal(interp.interp(1.5, 2.0), [3.5, -3.5])
    np.testing.assert_array_equal(
        interp.interp_array(jnp.array([1.5, 1.5]), jnp.array([2.0, 2.5])),
        [[3.5, -3.5], [4.0, -4.0]],
    )


def test_corners_only_data_no_axis():
    # tests/interp2d.rs:26-34 — i32 element type
    interp = Interp2D.builder(data_i32()).build()
    assert int(interp.interp_scalar(0, 0)) == 1
    assert int(interp.interp_scalar(2, 3)) == 12
    assert int(interp.interp_scalar(2, 0)) == 9
    assert int(interp.interp_scalar(0, 3)) == 4


def test_corners_only_x_axis():
    # :36-47
    interp = Interp2D.builder(data_i32()).x(jnp.array([1, 2, 3])).build()
    assert int(interp.interp_scalar(1, 0)) == 1
    assert int(interp.interp_scalar(3, 3)) == 12
    assert int(interp.interp_scalar(3, 0)) == 9
    assert int(interp.interp_scalar(1, 3)) == 4


def test_corners_only_y_axis():
    # :49-60
    interp = (
        Interp2D.builder(data_f64())
        .y(jnp.array([-3.0, -2.0, -1.0, 0.0]))
        .build()
    )
    assert interp.interp_scalar(0.0, -3.0) == 1.0
    assert interp.interp_scalar(2.0, 0.0) == 12.0
    assert interp.interp_scalar(2.0, -3.0) == 9.0
    assert interp.interp_scalar(0.0, 0.0) == 4.0


def test_extrapolate_errors():
    # :62-82
    interp = Interp2D.builder(data_i32()).build()
    for qx, qy in [(-1, 1), (1, -1), (3, 1), (1, 4)]:
        with pytest.raises(OutOfBoundsError):
            interp.interp(qx, qy)


def test_interpolate_array_meshgrid():
    # :84-238 — 11×11 meshgrid against a hardcoded matrix; we regenerate the
    # oracle analytically: data = linspace(0, 8).reshape(3,3) is a plane, so
    # bilinear interp is exact: f(x, y) = 3*(x-1) + (y-4)
    data = jnp.linspace(0.0, 8.0, 9).reshape(3, 3)
    x = jnp.array([1.0, 2.0, 3.0])
    y = jnp.array([4.0, 5.0, 6.0])
    res_n = 11
    qx = jnp.repeat(jnp.linspace(1.0, 3.0, res_n), res_n).reshape(res_n, res_n)
    qy = jnp.tile(jnp.linspace(4.0, 6.0, res_n), res_n).reshape(res_n, res_n)
    interp = Interp2D.builder(data).x(x).y(y).build()
    res = interp.interp_array(qx, qy)
    expect = 3.0 * (np.asarray(qx) - 1.0) + (np.asarray(qy) - 4.0)
    np.testing.assert_allclose(res, expect, atol=4.5e-15)
    # spot-check the reference's own first/last entries
    assert abs(float(res[0, 0]) - 0.0) < 1e-15
    assert abs(float(res[10, 10]) - 8.0) < 1e-14


def test_interp_nd_data():
    # :240-265
    data = jnp.array(
        [
            [[[1.0, 10.0], [-1.0, -10.0]], [[2.0, 20.0], [-2.0, -20.0]]],
            [[[3.0, 30.0], [-3.0, -30.0]], [[5.0, 50.0], [-5.0, -50.0]]],
        ]
    )
    interp = Interp2DBuilder(data).build()
    res = interp.interp(0.0, 0.5)
    np.testing.assert_allclose(
        res, [[1.5, 15.0], [-1.5, -15.0]], atol=1e-15
    )
    qx = jnp.array([0.0, 0.5])
    qy = jnp.array([0.5, 1.0])
    expect = [[[1.5, 15.0], [-1.5, -15.0]], [[3.5, 35.0], [-3.5, -35.0]]]
    np.testing.assert_allclose(interp.interp_array(qx, qy), expect, atol=1e-15)


def test_interp_array_with_unmatched_axis():
    # :267-277
    data = jnp.linspace(0.0, 8.0, 9).reshape(3, 3)
    interp = Interp2D.builder(data).build()
    with pytest.raises(ValueError, match="do not match"):
        interp.interp_array(jnp.array([0.0, 1.0]), jnp.array([0.0, 1.0, 2.0]))


def test_builder_errors():
    # :279-329
    with pytest.raises(NotEnoughDataError):
        Interp2D.builder(jnp.array([[1]])).build()
    with pytest.raises(NotEnoughDataError):
        Interp2D.builder(jnp.array([[1, 2]])).build()
    with pytest.raises(NotEnoughDataError):
        Interp2D.builder(jnp.array([[1], [2]])).build()
    with pytest.raises(ShapeError):
        Interp2D.builder(jnp.array([[1, 2], [3, 4]])).x(jnp.array([1])).build()
    with pytest.raises(ShapeError):
        Interp2D.builder(jnp.array([[1, 2], [3, 4]])).x(
            jnp.array([1, 2, 3])
        ).build()
    with pytest.raises(ShapeError):
        Interp2D.builder(jnp.array([[1, 2], [3, 4]])).y(jnp.array([1])).build()
    with pytest.raises(ShapeError):
        Interp2D.builder(jnp.array([[1, 2], [3, 4]])).y(
            jnp.array([1, 2, 3])
        ).build()
    with pytest.raises(MonotonicError):
        Interp2D.builder(jnp.array([[1, 2], [3, 4]])).x(
            jnp.array([2, 2])
        ).build()
    with pytest.raises(MonotonicError):
        Interp2D.builder(jnp.array([[1, 2], [3, 4]])).y(
            jnp.array([2, 2])
        ).build()


# --- dimension sweep (src/interp2d/mod.rs:541-576) --------------------------
def rand_arr(shape, seed=64):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(0.0, 1.0, size=shape))


@pytest.mark.parametrize("ndim", [2, 3, 4, 5, 6, 7, 8])
def test_dim_sweep(ndim):
    interp = Interp2D.builder(rand_arr((4,) * ndim)).build()

    res = interp.interp(2.2, 2.2)
    assert res.ndim == ndim - 2

    buf = np.zeros(res.shape)
    interp.interp_into(2.2, 2.2, buf)
    np.testing.assert_allclose(buf, res, atol=2.3e-16)

    x_query = jnp.array([[0.5, 1.0], [1.5, 2.0]])
    y_query = jnp.array([[1.5, 2.0], [2.5, 3.0]])
    res = interp.interp_array(x_query, y_query)
    assert res.ndim == ndim - 2 + x_query.ndim

    buf = np.zeros(res.shape)
    interp.interp_array_into(x_query, y_query, buf)
    np.testing.assert_allclose(buf, res, atol=2.3e-16)


def test_interp2d_2d_scalar_type():
    interp = Interp2D.builder(rand_arr((4, 4))).build()
    assert np.asarray(interp.interp_scalar(2.2, 2.2)).shape == ()


def test_jit_vmap_2d():
    """Addition beyond the reference: jit + vmap through the 2-D pytree."""
    import jax

    interp = (
        Interp2D.builder(rand_arr((8, 8, 3)))
        .strategy(Bilinear().extrapolate(True))
        .build()
    )
    qx = jnp.linspace(0.0, 7.0, 32)
    qy = jnp.linspace(7.0, 0.0, 32)
    f = jax.jit(lambda t, a, b: t(a, b))
    np.testing.assert_allclose(
        f(interp, qx, qy), interp.interp_array(qx, qy), atol=1e-15
    )
    v = jax.vmap(lambda a, b: interp(a, b))(
        qx.reshape(4, 8), qy.reshape(4, 8)
    )
    np.testing.assert_allclose(
        v, interp.interp_array(qx.reshape(4, 8), qy.reshape(4, 8)), atol=1e-15
    )


def test_custom_2d_pointwise_strategy():
    """2-D analogue of the custom-strategy extension point."""
    from jax.tree_util import register_pytree_node_class

    from ndarray_interp_tpu.interp2d import PointwiseStrategy2D

    @register_pytree_node_class
    class Nearest2D(PointwiseStrategy2D):
        MINIMUM_DATA_LENGTH = 2
        extrapolates = True

        def eval_point(self, interp, x, y):
            xi = jnp.round(
                jnp.clip(x, 0, interp.data.shape[0] - 1)
            ).astype(jnp.int32)
            yi = jnp.round(
                jnp.clip(y, 0, interp.data.shape[1] - 1)
            ).astype(jnp.int32)
            return interp.data[xi, yi]

    data = jnp.arange(12.0).reshape(3, 4)
    itp = Interp2D.builder(data).strategy(Nearest2D()).build()
    qx = jnp.array([0.2, 1.6, 2.9])
    qy = jnp.array([0.4, 2.5, 3.2])
    # jnp.round is round-half-even: round(2.5) == 2
    np.testing.assert_array_equal(
        np.asarray(itp.interp_array(qx, qy)),
        [data[0, 0], data[2, 2], data[2, 3]],
    )
