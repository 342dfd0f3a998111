"""Ports of the reference cubic-spline integration tests.

Reference: ``/root/reference/tests/cubic_spline_strat.rs``.  The expected
value tables there were generated with ``scipy.interpolate.CubicSpline``
and compared with ``max_relative = 0.001``; since SciPy is available here
we check both the ported tables (at the table precision) and SciPy itself
(at near machine precision).
"""

import numpy as np
import pytest
import scipy.interpolate as si

import jax.numpy as jnp

from ndarray_interp_tpu.errors import (
    BuilderValueError,
    NotEnoughDataError,
    OutOfBoundsError,
    ShapeError,
)
from ndarray_interp_tpu.interp1d import Interp1D, Interp1DBuilder
from ndarray_interp_tpu.interp1d.cubic_spline import (
    BoundaryCondition,
    CubicSpline,
    RowBoundary,
    SingleBoundary,
)

DATA12 = jnp.array(
    [1.0, 2.0, 2.5, 2.5, 3.0, 2.0, 1.0, -2.0, 3.0, 5.0, 6.3, 8.0]
)
Q30 = jnp.linspace(-3.0, 15.0, 30)


def build(data, strat, x=None):
    b = Interp1D.builder(data)
    if x is not None:
        b = b.x(x)
    return b.strategy(strat).build()


def test_wikipedia_doctest():
    # cubic_spline.rs:55-83
    y = jnp.array([0.5, 0.0, 3.0])
    x = jnp.array([-1.0, 0.0, 3.0])
    interp = build(y, CubicSpline(), x=x)
    res = interp.interp_array(jnp.linspace(-1.0, 3.0, 10))
    expect = [
        0.5,
        0.1851851851851852,
        0.01851851851851853,
        -5.551115123125783e-17,
        0.12962962962962965,
        0.40740740740740755,
        0.8333333333333331,
        1.407407407407407,
        2.1296296296296293,
        3.0,
    ]
    np.testing.assert_allclose(res, expect, atol=1e-13)


def test_interp_natural():
    # cubic_spline_strat.rs:10-27
    data = jnp.array(
        [1.0, 2.0, 3.0, 4.0, 3.0, 2.0, 1.0, 0.0, 2.0, 4.0, 6.0, 8.0]
    )
    interp = build(data, CubicSpline().boundary(BoundaryCondition.Natural))
    q = jnp.linspace(0.0, 11.0, 30)
    res = np.asarray(interp.interp_array(q))
    expect = [
        1., 1.39170823, 1.77091526, 2.125721, 2.47352006, 2.87359686,
        3.36922189, 3.82291953, 3.99824026, 3.75923077, 3.27970993,
        2.78813427, 2.3908915, 2.05692316, 1.74411903, 1.38442937,
        0.89919307, 0.32738558, -0.0156797, 0.20564422, 0.96539094,
        1.91643779, 2.75736868, 3.48596188, 4.19763049, 4.94786851,
        5.71920918, 6.4877215, 7.24638389, 8.,
    ]
    np.testing.assert_allclose(res, expect, rtol=0.001, atol=1e-7)
    oracle = si.CubicSpline(np.arange(12.0), np.asarray(data), bc_type="natural")
    np.testing.assert_allclose(res, oracle(np.asarray(q)), atol=1e-12)


def test_too_little_data():
    # :29-35
    with pytest.raises(NotEnoughDataError):
        build(jnp.array([1.0, 2.0]), CubicSpline())


def test_enough_data():
    # :37-43
    build(jnp.array([1.0, 2.0, 1.0]), CubicSpline())


def test_extrapolate_false():
    # :45-55
    interp = build(jnp.array([1.0, 2.0, 1.0]), CubicSpline())
    with pytest.raises(OutOfBoundsError):
        interp.interp(-0.5)
    with pytest.raises(OutOfBoundsError):
        interp.interp(3.5)


@pytest.mark.parametrize(
    "bc_ours,bc_scipy",
    [
        (BoundaryCondition.Natural, "natural"),
        (BoundaryCondition.Clamped, "clamped"),
        (BoundaryCondition.NotAKnot, "not-a-knot"),
    ],
)
def test_extrapolate_uniform_boundaries_vs_scipy(bc_ours, bc_scipy):
    # :57-105 (natural), :257-305 (clamped), :108-154 (not-a-knot, f32)
    data = (
        jnp.array([1.0, 2.0, 2.5, 2.5, 3.0, 2.0, 1.0, -2.0, 3.0, 5.0, 6.3, 8.0])
        if bc_scipy != "natural"
        else jnp.array(
            [1.0, 2.0, 2.5, 2.5, 3.0, 2.0, 1.0, -2.0, 3.0, 5.0, 6.3, 8.0]
        )
    )
    interp = build(data, CubicSpline().extrapolate(True).boundary(bc_ours))
    res = np.asarray(interp.interp_array(Q30))
    oracle = si.CubicSpline(np.arange(12.0), np.asarray(data), bc_type=bc_scipy)
    np.testing.assert_allclose(res, oracle(np.asarray(Q30)), atol=1e-11)


def test_extrapolate_not_a_knot_f32():
    # :108-154 — the reference runs this one in f32
    data = DATA12.astype(jnp.float32)
    interp = build(data, CubicSpline().extrapolate(True))
    res = np.asarray(interp.interp_array(Q30.astype(jnp.float32)))
    oracle = si.CubicSpline(
        np.arange(12.0), np.asarray(data, np.float64), bc_type="not-a-knot"
    )
    np.testing.assert_allclose(
        res, oracle(np.asarray(Q30)), rtol=2e-4, atol=2e-4
    )


def test_not_a_knot_3_values():
    # :157-188
    interp = build(
        jnp.array([1.0, 2.0, 0.0]),
        CubicSpline().boundary(BoundaryCondition.NotAKnot).extrapolate(True),
    )
    res = interp.interp_array(jnp.linspace(-1.0, 3.0, 15))
    expect = [
        -3., -1.55102041, -0.34693878, 0.6122449, 1.32653061, 1.79591837,
        2.02040816, 2., 1.73469388, 1.2244898, 0.46938776, -0.53061224,
        -1.7755102, -3.26530612, -5.,
    ]
    np.testing.assert_allclose(res, expect, rtol=0.001, atol=1e-7)


def test_multidim_multi_bounds():
    # :191-255
    y = jnp.array([[0.5, 1.0], [0.0, 1.5], [3.0, 0.5]])
    x = jnp.array([-1.0, 0.0, 3.0])
    boundaries = BoundaryCondition.Individual(
        np.array(
            [[
                RowBoundary.Natural,
                RowBoundary.Mixed(
                    SingleBoundary.NotAKnot, SingleBoundary.FirstDeriv(0.5)
                ),
            ]],
            dtype=object,
        )
    )
    strat = CubicSpline().boundary(boundaries).extrapolate(True)
    interp = build(y, strat, x=x)
    res = np.asarray(interp.interp_array(jnp.linspace(-2.0, 4.0, 15)))
    col0 = [
        1., 0.85787172, 0.59766764, 0.30794461, 0.07725948, -0.00655977,
        0.10058309, 0.375, 0.78717201, 1.30758017, 1.90670554, 2.55502915,
        3.22303207, 3.88119534, 4.5,
    ]
    col1 = [
        -1.13194444, 0.02834467, 0.81235828, 1.27749433, 1.48115079,
        1.48072562, 1.33361678, 1.09722222, 0.82893991, 0.5861678,
        0.42630385, 0.40674603, 0.58489229, 1.01814059, 1.76388889,
    ]
    np.testing.assert_allclose(res[:, 0], col0, rtol=0.001, atol=1e-7)
    np.testing.assert_allclose(res[:, 1], col1, rtol=0.001, atol=1e-7)


@pytest.mark.parametrize("deriv,bc", [(1, "FirstDeriv"), (2, "SecondDeriv")])
def test_extrapolate_deriv_boundaries(deriv, bc):
    # :308-411
    mk = getattr(SingleBoundary, bc)
    boundaries = BoundaryCondition.Individual(
        np.array([RowBoundary.Mixed(mk(-0.1), mk(-0.5))], dtype=object)
    )
    interp = build(
        DATA12, CubicSpline().extrapolate(True).boundary(boundaries)
    )
    res = np.asarray(interp.interp_array(Q30))
    oracle = si.CubicSpline(
        np.arange(12.0),
        np.asarray(DATA12),
        bc_type=((deriv, -0.1), (deriv, -0.5)),
    )
    np.testing.assert_allclose(res, oracle(np.asarray(Q30)), atol=1e-11)


def test_bounds_shape_error1():
    # :413-426
    y = jnp.array([[0.5, 1.0], [0.0, 1.5], [3.0, 0.5]])
    boundaries = BoundaryCondition.Individual(
        np.array(
            [[RowBoundary.Natural, RowBoundary.Clamped, RowBoundary.NotAKnot]],
            dtype=object,
        )
    )
    with pytest.raises(ShapeError, match=r"Expected: \[1, 2\], got: \[1, 3\]"):
        build(y, CubicSpline().boundary(boundaries))


def test_bounds_shape_error2():
    # :428-440
    y = jnp.array([[0.5, 1.0], [0.0, 1.5], [3.0, 0.5]])
    boundaries = BoundaryCondition.Individual(
        np.array(
            [
                [RowBoundary.Natural, RowBoundary.NotAKnot],
                [RowBoundary.Natural, RowBoundary.NotAKnot],
            ],
            dtype=object,
        )
    )
    with pytest.raises(ShapeError, match=r"Expected: \[1, 2\], got: \[2, 2\]"):
        build(y, CubicSpline().boundary(boundaries))


def test_periodic_wrong_values():
    # :442-452
    y = jnp.array([[0.5, 1.0], [0.0, 1.5], [0.5, 1.1]])
    with pytest.raises(
        BuilderValueError, match="first and last value must be equal"
    ):
        build(y, CubicSpline().boundary(BoundaryCondition.Periodic))


def test_extrapolate_periodic():
    # :455-501
    data = jnp.array(
        [1.0, 2.0, 2.5, 2.5, 3.0, 2.0, 1.0, -2.0, 3.0, 5.0, 6.3, 1.0]
    )
    interp = build(
        data,
        CubicSpline().extrapolate(True).boundary(BoundaryCondition.Periodic),
    )
    res = np.asarray(interp.interp_array(Q30))
    expect = [
        3., 4.45171164, 5.5978812, 6.54905092, 3.79486808, 0.76011398,
        1.36656494, 2.4432986, 2.50822019, 2.40158688, 2.63514361,
        3.01451693, 2.59950279, 1.96267846, 1.65029582, -0.22831889,
        -2.04318459, 0.41031552, 3.63201944, 4.66215778, 6.05245899,
        6.19632834, 2.68818585, 0.64246067, 1.77979077, 2.52789822,
        2.46676892, 2.41681682, 2.76866398, 3.,
    ]
    np.testing.assert_allclose(res, expect, rtol=0.001, atol=1e-7)
    oracle = si.CubicSpline(
        np.arange(12.0), np.asarray(data), bc_type="periodic"
    )
    np.testing.assert_allclose(
        res, oracle(np.mod(np.asarray(Q30), 11.0)), atol=1e-12
    )


def test_extrapolate_periodic_multidim():
    # :504-537
    y = jnp.array([[0.5, 1.0], [0.0, 1.5], [0.0, 1.5], [0.5, 1.0]])
    x = jnp.array([-1.0, 0.0, 2.0, 3.0])
    interp = build(
        y,
        CubicSpline().extrapolate(True).boundary(BoundaryCondition.Periodic),
        x=x,
    )
    res = np.asarray(interp.interp_array(jnp.linspace(-1.5, 3.5, 15)))
    expect = [
        [0.325, 1.175], [0.48279883, 1.01720117], [0.46260933, 1.03739067],
        [0.28075802, 1.21924198], [0.04424198, 1.45575802],
        [-0.14693878, 1.64693878], [-0.26173469, 1.76173469], [-0.3, 1.8],
        [-0.26173469, 1.76173469], [-0.14693878, 1.64693878],
        [0.04424198, 1.45575802], [0.28075802, 1.21924198],
        [0.46260933, 1.03739067], [0.48279883, 1.01720117], [0.325, 1.175],
    ]
    np.testing.assert_allclose(res, expect, rtol=0.001, atol=1e-7)


def test_extrapolate_periodic_len3():
    # :540-573
    y = jnp.array([0.5, 0.0, 0.5])
    x = jnp.array([-1.0, 0.0, 3.0])
    interp = build(
        y,
        CubicSpline().extrapolate(True).boundary(BoundaryCondition.Periodic),
        x=x,
    )
    res = np.asarray(interp.interp_array(jnp.linspace(-1.5, 3.5, 15)))
    expect = [
        0.55555556, 0.53773891, 0.40889213, 0.20845481, 0.02623907,
        -0.05701328, -0.03717201, 0.05555556, 0.19080013, 0.33819242,
        0.46736314, 0.54794299, 0.54956268, 0.44314869, 0.25,
    ]
    np.testing.assert_allclose(res, expect, rtol=0.001, atol=1e-7)


def test_extrapolate_periodic_len3_multidim():
    # :576-609
    y = jnp.array([[0.5, 1.0], [0.0, 2.5], [0.5, 1.0]])
    x = jnp.array([-1.0, 0.0, 3.0])
    interp = build(
        y,
        CubicSpline().extrapolate(True).boundary(BoundaryCondition.Periodic),
        x=x,
    )
    res = np.asarray(interp.interp_array(jnp.linspace(-1.5, 3.5, 15)))
    expect = [
        [0.55555556, 0.83333333], [0.53773891, 0.88678328],
        [0.40889213, 1.27332362], [0.20845481, 1.87463557],
        [0.02623907, 2.4212828], [-0.05701328, 2.67103984],
        [-0.03717201, 2.61151603], [0.05555556, 2.33333333],
        [0.19080013, 1.92759961], [0.33819242, 1.48542274],
        [0.46736314, 1.09791059], [0.54794299, 0.85617104],
        [0.54956268, 0.85131195], [0.44314869, 1.17055394], [0.25, 1.75],
    ]
    np.testing.assert_allclose(res, expect, rtol=0.001, atol=1e-7)


# --- additions with no reference analogue ------------------------------------
def test_batched_individual_matches_per_row_solve():
    """The vectorized Individual path must equal solving each row alone."""
    rng = np.random.default_rng(7)
    y = jnp.asarray(rng.normal(size=(8, 3)))
    x = jnp.asarray(np.sort(rng.uniform(0, 10, size=8)))
    rows = np.array(
        [[
            RowBoundary.Natural,
            RowBoundary.Mixed(
                SingleBoundary.FirstDeriv(1.5), SingleBoundary.SecondDeriv(-2.0)
            ),
            RowBoundary.NotAKnot,
        ]],
        dtype=object,
    )
    interp = build(
        y,
        CubicSpline()
        .extrapolate(True)
        .boundary(BoundaryCondition.Individual(rows)),
        x=x,
    )
    q = jnp.linspace(-1.0, 11.0, 23)
    batched = np.asarray(interp.interp_array(q))

    for col in range(3):
        single = build(
            y[:, col],
            CubicSpline()
            .extrapolate(True)
            .boundary(
                BoundaryCondition.Individual(
                    np.array([rows[0, col]], dtype=object)
                )
            ),
            x=x,
        )
        # not bitwise: XLA fuses the batched and single-row programs
        # differently (FMA contraction), so allow a few ULP
        np.testing.assert_allclose(
            batched[:, col],
            np.asarray(single.interp_array(q)),
            rtol=1e-14,
            atol=1e-14,
        )


def test_build_under_jit():
    """Spline construction itself is jittable (uniform boundaries)."""
    import jax

    x = jnp.linspace(0.0, 1.0, 16)

    @jax.jit
    def make_and_eval(data, q):
        strat = CubicSpline().extrapolate(True).build(x, data)
        itp = Interp1D.new_unchecked(x, data, strat)
        return itp(q)

    rng = np.random.default_rng(3)
    data = jnp.asarray(rng.normal(size=(16, 4)))
    q = jnp.linspace(0.0, 1.0, 11)
    got = np.asarray(make_and_eval(data, q))

    eager = build(data, CubicSpline().extrapolate(True), x=x)
    np.testing.assert_allclose(got, eager.interp_array(q), atol=1e-14)


def test_periodic_build_under_jit():
    """Periodic construction is jittable too: the first==last value check
    is data-dependent, so under jit it is skipped (caller vouches, like
    new_unchecked) rather than raising TracerArrayConversionError."""
    import jax

    x = jnp.linspace(0.0, 1.0, 12)
    rng = np.random.default_rng(7)
    data = np.asarray(rng.normal(size=(12, 3)))
    data[-1] = data[0]
    data = jnp.asarray(data)

    @jax.jit
    def make_and_eval(data, q):
        strat = (
            CubicSpline()
            .extrapolate(True)
            .boundary(BoundaryCondition.Periodic)
            .build(x, data)
        )
        itp = Interp1D.new_unchecked(x, data, strat)
        return itp(q)

    q = jnp.linspace(-0.3, 1.3, 9)
    got = np.asarray(make_and_eval(data, q))
    eager = build(
        data,
        CubicSpline().extrapolate(True).boundary(BoundaryCondition.Periodic),
        x=x,
    )
    np.testing.assert_allclose(got, eager.interp_array(q), atol=1e-14)


def test_individual_boundaries_build_under_jit():
    """Per-row boundaries build inside jit via the precompiled kind/value
    array form (BoundaryCondition.IndividualArrays) and match the eager
    object-array Individual path exactly."""
    import jax

    x = jnp.linspace(0.0, 2.0, 10)
    rng = np.random.default_rng(11)
    data = jnp.asarray(rng.normal(size=(10, 4)))

    rows = np.empty((1, 4), dtype=object)
    rows[0, 0] = RowBoundary.NotAKnot
    rows[0, 1] = RowBoundary.Natural
    rows[0, 2] = RowBoundary.Mixed(
        SingleBoundary.FirstDeriv(0.5), SingleBoundary.SecondDeriv(-1.0)
    )
    rows[0, 3] = RowBoundary.Clamped
    eager = build(
        data,
        CubicSpline()
        .extrapolate(True)
        .boundary(BoundaryCondition.Individual(rows)),
        x=x,
    )

    # same encoding as arrays: 0=NAK, 1=first-deriv, 2=second-deriv
    lk = jnp.array([0, 2, 1, 1], jnp.int32)
    lv = jnp.array([0.0, 0.0, 0.5, 0.0])
    rk = jnp.array([0, 2, 2, 1], jnp.int32)
    rv = jnp.array([0.0, 0.0, -1.0, 0.0])

    @jax.jit
    def make_and_eval(data, lv, rv, q):
        strat = (
            CubicSpline()
            .extrapolate(True)
            .boundary(BoundaryCondition.IndividualArrays(lk, lv, rk, rv))
            .build(x, data)
        )
        itp = Interp1D.new_unchecked(x, data, strat)
        return itp(q)

    q = jnp.linspace(-0.2, 2.2, 13)
    got = np.asarray(make_and_eval(data, lv, rv, q))
    np.testing.assert_allclose(got, eager.interp_array(q), atol=1e-14)


def test_individual_arrays_shape_error():
    x = jnp.linspace(0.0, 1.0, 5)
    data = jnp.ones((5, 3))
    bc = BoundaryCondition.IndividualArrays(
        jnp.zeros((2,), jnp.int32),
        jnp.zeros((2,)),
        jnp.zeros((2,), jnp.int32),
        jnp.zeros((2,)),
    )
    with pytest.raises(ShapeError, match="wrong shape"):
        CubicSpline().boundary(bc).build(x, data)


def test_grad_through_build_and_eval():
    import jax

    x = jnp.linspace(0.0, 1.0, 8)

    def loss(data):
        strat = CubicSpline().extrapolate(True).build(x, data)
        itp = Interp1D.new_unchecked(x, data, strat)
        return jnp.sum(itp(jnp.linspace(0.1, 0.9, 5)) ** 2)

    data = jnp.asarray(np.random.default_rng(0).normal(size=8))
    g = jax.grad(loss)(data)
    # finite-difference check
    eps = 1e-6
    d0 = np.asarray(data, np.float64).copy()
    fd = np.zeros_like(d0)
    for i in range(8):
        dp, dm = d0.copy(), d0.copy()
        dp[i] += eps
        dm[i] -= eps
        fd[i] = (loss(jnp.asarray(dp)) - loss(jnp.asarray(dm))) / (2 * eps)
    np.testing.assert_allclose(np.asarray(g), fd, rtol=1e-5, atol=1e-8)
