"""The f32 evaluation routes (search → one stacked row gather → Hermite
tail) against float64 SciPy / NumPy oracles: knot families × sizes, bank
widths that are not multiples of anything, NaN / ±inf queries, long knot
axes, and gradients."""

import numpy as np
import pytest
import scipy.interpolate as si

import jax
import jax.numpy as jnp

from ndarray_interp_tpu.interp1d import Akima, CubicSpline, Interp1D, Linear, Pchip
from ndarray_interp_tpu.ops.searchsorted import get_lower_index

# f32 route vs f64 oracle, scale-relative per leg.  Out of range the
# queries here reach ~40 first-interval widths past the axis (log
# spacing), where t^3 amplifies the f32 coefficient rounding ~10x.
TOL = 1e-5
TOL_OUT = 1e-4


def _knots(n, spacing, rng):
    if spacing == "linspace":
        kn = np.linspace(0.0, 100.0, n)
    elif spacing == "log":
        kn = np.logspace(0.0, 2.0, n)
    else:
        kn = np.sort(rng.uniform(0, 100, n))
        kn[0], kn[-1] = 0.0, 100.0
    return kn.astype(np.float32)


def _serve(itp, q):
    return np.asarray(jax.jit(lambda t, qq: t(qq))(itp, jnp.asarray(q)))


def _gate(got, want, inside):
    for leg, tol in ((inside, TOL), (~inside, TOL_OUT)):
        if leg.any():
            err = np.abs(got[leg] - want[leg]).max()
            assert err <= tol * np.abs(want[leg]).max(), err


@pytest.mark.parametrize("n", [4, 33, 67, 1000, 2048])
@pytest.mark.parametrize("spacing", ["linspace", "nonuniform", "log"])
def test_cubic_route_matches_scipy(n, spacing):
    rng = np.random.default_rng(n)
    x = _knots(n, spacing, rng)
    y = rng.normal(size=n).astype(np.float32)
    itp = (
        Interp1D.builder(y).x(x)
        .strategy(CubicSpline().extrapolate(True)).build()
    )
    q = np.concatenate(
        [rng.uniform(-2, 102, 1500), x[: min(97, n)]]
    ).astype(np.float32)
    got = _serve(itp, np.concatenate([q, [np.nan]]).astype(np.float32))
    assert np.isnan(got[-1])  # NaN query -> NaN on the pure path
    want = si.CubicSpline(
        x.astype(np.float64), y.astype(np.float64), bc_type="not-a-knot"
    )(q.astype(np.float64))
    _gate(got[:-1], want, (q >= x[0]) & (q <= x[-1]))


def test_linear_inf_queries_extrapolate_to_inf():
    """±inf on a linear table extrapolates to ±inf (calc_frac semantics,
    ``linear.rs:29-37``), and huge finite queries stay on the edge
    lines."""
    x = np.linspace(0.0, 10.0, 16, dtype=np.float32)
    itp = (
        Interp1D.builder(3.0 * x).x(x)
        .strategy(Linear().extrapolate(True)).build()
    )
    got = _serve(itp, np.array([np.inf, -np.inf, 1e30, -1e30], np.float32))
    assert got[0] == np.inf and got[1] == -np.inf
    np.testing.assert_allclose(got[2:], [3e30, -3e30], rtol=1e-6)


@pytest.mark.parametrize("bank", [1, 7, 128, 130])
def test_bank_widths(bank):
    """Banks of any width take the one stacked-row gather; every column
    matches its own SciPy spline."""
    rng = np.random.default_rng(bank)
    n = 40
    x = np.cumsum(rng.uniform(0.1, 1.0, n)).astype(np.float32)
    y = rng.normal(size=(n, bank)).astype(np.float32)
    itp = (
        Interp1D.builder(y).x(x)
        .strategy(CubicSpline().extrapolate(True)).build()
    )
    q = rng.uniform(x[0] - 1, x[-1] + 1, 700).astype(np.float32)
    got = _serve(itp, q)
    assert got.shape == (700, bank)
    want = si.CubicSpline(x.astype(np.float64), y.astype(np.float64))(
        q.astype(np.float64)
    )
    inside = (q >= x[0]) & (q <= x[-1])
    _gate(got.max(axis=1), want.max(axis=1), inside)
    _gate(got, want, inside)


def test_grad_matches_f64_route():
    """The gradient rule is XLA's own VJP of the gather route: the f32
    gradient w.r.t. the data equals the f64 one to f32 rounding."""
    rng = np.random.default_rng(5)
    n, bank = 24, 6
    x = np.cumsum(rng.uniform(0.2, 1.0, n))
    y = rng.normal(size=(n, bank))
    q = rng.uniform(x[0], x[-1], 300)

    def loss(data, dtype):
        itp = Interp1D.new_unchecked(
            jnp.asarray(x, dtype), data,
            CubicSpline().extrapolate(True).build(jnp.asarray(x, dtype), data),
        )
        return jnp.sum(itp(jnp.asarray(q, dtype)) ** 2)

    g32 = jax.grad(lambda d: loss(d, jnp.float32))(jnp.asarray(y, jnp.float32))
    g64 = jax.grad(lambda d: loss(d, jnp.float64))(jnp.asarray(y))
    np.testing.assert_allclose(
        np.asarray(g32), np.asarray(g64), rtol=1e-4,
        atol=1e-4 * float(np.abs(g64).max()),
    )


# -- long knot axes: the same search at any n ---------------------------------


@pytest.mark.parametrize("n", [65537, 262144, 1_000_003])
def test_lower_index_matches_numpy_at_large_n(n):
    rng = np.random.default_rng(n)
    x = np.cumsum(rng.uniform(0.5, 1.5, n)).astype(np.float32)
    q = np.concatenate(
        [rng.uniform(x[0] - 5, x[-1] + 5, 20000), x[::max(1, n // 997)],
         [-np.inf, np.inf]]
    ).astype(np.float32)
    got = np.asarray(jax.jit(get_lower_index)(jnp.asarray(x), jnp.asarray(q)))
    want = np.clip(np.searchsorted(x, q, side="right") - 1, 0, n - 2)
    np.testing.assert_array_equal(got, want)


def test_cubic_eval_matches_scipy_at_large_n():
    rng = np.random.default_rng(11)
    n = 200_003
    x = np.cumsum(rng.uniform(0.5, 1.5, n)).astype(np.float32)
    y = np.sin(np.arange(n) * 0.01).astype(np.float32)
    itp = (
        Interp1D.builder(y).x(x)
        .strategy(CubicSpline().extrapolate(True)).build()
    )
    q = rng.uniform(x[0] - 3, x[-1] + 3, 50_000).astype(np.float32)
    got = _serve(itp, q)
    want = si.CubicSpline(x.astype(np.float64), y.astype(np.float64))(
        q.astype(np.float64)
    )
    _gate(got, want, (q >= x[0]) & (q <= x[-1]))


def test_nan_query_and_inf_at_large_n():
    n = 100_000
    x = np.arange(n, dtype=np.float32)
    itp = (
        Interp1D.builder(2.0 * x).x(x)
        .strategy(Linear().extrapolate(True)).build()
    )
    got = _serve(itp, np.array([np.nan, np.inf, -np.inf, 77.25], np.float32))
    assert np.isnan(got[0])
    assert got[1] == np.inf and got[2] == -np.inf
    assert got[3] == np.float32(154.5)


@pytest.mark.parametrize("strategy", [Akima, Pchip])
def test_hermite_strategies_at_large_n(strategy):
    """Akima / Pchip share the cubic route's gather + tail at any n: at
    knots they reproduce the data exactly, in between they stay within
    the local data range (both are local, Pchip monotone)."""
    rng = np.random.default_rng(13)
    n = 70_001
    x = np.cumsum(rng.uniform(0.5, 1.5, n)).astype(np.float32)
    y = np.cumsum(rng.uniform(0.0, 1.0, n)).astype(np.float32)  # rising
    itp = Interp1D.builder(y).x(x).strategy(strategy()).build()
    idx = rng.integers(0, n - 1, 5000)
    at_knots = _serve(itp, x[idx])
    np.testing.assert_allclose(at_knots, y[idx], rtol=1e-6)
    mid = (0.5 * (x[idx] + x[idx + 1])).astype(np.float32)
    between = _serve(itp, mid)
    lo = np.minimum(y[idx], y[idx + 1]) - 1e-3
    hi = np.maximum(y[idx], y[idx + 1]) + 1e-3
    if strategy is Pchip:
        assert ((between >= lo) & (between <= hi)).all()
    assert np.isfinite(between).all()
