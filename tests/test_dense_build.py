"""Dense-operator spline build (the off-CPU route for wide banks on
short knot axes).

For a shared knot axis and a uniform boundary family the build map
``data -> (a, b)`` is linear, so ``cubic._dense_ab`` probes it once on an
identity bank and applies it as one matmul (``n <=
cubic._DENSE_BUILD_MAX_N``).  The route is the non-CPU arm of a
``lax.platform_dependent``; these tests pin, on the CPU backend:

* operator-vs-elimination agreement for every uniform boundary family
  (incl. periodic and the n==3 not-a-knot parabola / periodic closed
  form) at f64 grade — linearity is exact, so only rounding separates
  the probed operator from the sequential solve;
* the per-axis ``_dense_k`` twin used by the 2-D/N-D builds;
* gradients through the dense route;
* the public CPU build is untouched (the CPU arm = the reference-order
  scan, ``cubic_spline.rs:678-721``), while the program exported for
  CUDA carries the dense matmul;
* the static eligibility predicate.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ndarray_interp_tpu.models.strategies.cubic import (
    _FIRST_DERIV,
    _NOT_A_KNOT,
    _SECOND_DERIV,
    _dense_ab,
    _dense_build_ok,
    _dense_k,
    _periodic_ab,
    _uniform_ab,
)

KINDS = [
    ("not_a_knot", _NOT_A_KNOT),
    ("natural", _SECOND_DERIV),
    ("clamped", _FIRST_DERIV),
]


def _axis(n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    x[1:] += 1e-3  # guarantee strict rise
    return jnp.asarray(np.cumsum(np.diff(x, prepend=0.0)).astype(dtype))


def _bank(n, bank, seed=1, dtype=np.float64, periodic=False):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n, bank)).astype(dtype)
    if periodic:
        y[-1] = y[0]
    return jnp.asarray(y)


class TestDenseAB:
    @pytest.mark.parametrize("name,kind", KINDS)
    @pytest.mark.parametrize("n", [3, 8, 64])
    def test_matches_elimination_f64(self, name, kind, n):
        x = _axis(n)
        y = _bank(n, 2 * n)
        a_ref, b_ref = jax.jit(lambda x, y: _uniform_ab(x, y, kind))(x, y)
        a_d, b_d = jax.jit(
            lambda x, y: _dense_ab(x, y, kind, periodic=False)
        )(x, y)
        scale = max(float(jnp.max(jnp.abs(a_ref))), 1.0)
        assert float(jnp.max(jnp.abs(a_d - a_ref))) / scale < 1e-11, name
        assert float(jnp.max(jnp.abs(b_d - b_ref))) / scale < 1e-11, name

    @pytest.mark.parametrize("n", [3, 8, 64])
    def test_matches_elimination_periodic(self, n):
        x = _axis(n, seed=3)
        y = _bank(n, 2 * n, seed=4, periodic=True)
        a_ref, b_ref = jax.jit(_periodic_ab)(x, y)
        a_d, b_d = jax.jit(
            lambda x, y: _dense_ab(x, y, 0, periodic=True)
        )(x, y)
        scale = max(float(jnp.max(jnp.abs(a_ref))), 1.0)
        assert float(jnp.max(jnp.abs(a_d - a_ref))) / scale < 1e-11
        assert float(jnp.max(jnp.abs(b_d - b_ref))) / scale < 1e-11

    def test_f32_grade(self):
        n = 64
        x = _axis(n, dtype=np.float32)
        y = _bank(n, 256, dtype=np.float32)
        a_ref, b_ref = jax.jit(
            lambda x, y: _uniform_ab(x, y, _NOT_A_KNOT)
        )(x, y)
        a_d, _ = jax.jit(
            lambda x, y: _dense_ab(x, y, _NOT_A_KNOT, periodic=False)
        )(x, y)
        scale = float(jnp.max(jnp.abs(a_ref)))
        assert float(jnp.max(jnp.abs(a_d - a_ref))) / scale < 1e-5

    def test_grad_matches_elimination_route(self):
        n = 16
        x = _axis(n, seed=7)
        y = _bank(n, n + 2, seed=8)

        def loss_dense(y):
            a, b = _dense_ab(x, y, _NOT_A_KNOT, periodic=False)
            return jnp.sum(a * a) + jnp.sum(jnp.sin(b))

        def loss_ref(y):
            a, b = _uniform_ab(x, y, _NOT_A_KNOT)
            return jnp.sum(a * a) + jnp.sum(jnp.sin(b))

        g_d = jax.grad(loss_dense)(y)
        g_r = jax.grad(loss_ref)(y)
        scale = max(float(jnp.max(jnp.abs(g_r))), 1.0)
        assert float(jnp.max(jnp.abs(g_d - g_r))) / scale < 1e-9


class TestDenseK:
    @pytest.mark.parametrize("name,kind", KINDS)
    def test_matches_solve_multi_trailing(self, name, kind):
        from ndarray_interp_tpu.models.strategies.cubic import _solve_for_k

        n = 32
        x = _axis(n, seed=5)
        rng = np.random.default_rng(6)
        grid = jnp.asarray(rng.normal(size=(n, 5, 3)))
        k_ref = _solve_for_k(x, grid, kind, 0.0, kind, 0.0)
        k_d = jax.jit(
            lambda x, g: _dense_k(x, g, kind, periodic=False)
        )(x, grid)
        scale = max(float(jnp.max(jnp.abs(k_ref))), 1.0)
        assert k_d.shape == k_ref.shape
        assert float(jnp.max(jnp.abs(k_d - k_ref))) / scale < 1e-11, name


class TestDispatch:
    def test_eligibility(self):
        from ndarray_interp_tpu.models.strategies.cubic import (
            _DENSE_BUILD_MAX_N,
        )

        assert _dense_build_ok(64, 1000)
        assert not _dense_build_ok(64, 8)  # probe wider than the bank
        assert _dense_build_ok(_DENSE_BUILD_MAX_N, 10**6)
        assert not _dense_build_ok(_DENSE_BUILD_MAX_N + 1, 10**6)

    def test_cpu_build_keeps_reference_order(self):
        """On the CPU platform the dispatch's CPU arm runs, so the
        public build stays BIT-identical to the scan solver even for
        dense-eligible banks; the program exported for CUDA carries the
        dense matmul instead of the scan loop."""
        from jax import export

        from ndarray_interp_tpu.interp1d import Interp1D
        from ndarray_interp_tpu.interp1d.cubic_spline import CubicSpline

        n, bank = 16, 64
        x = _axis(n, seed=9)
        y = _bank(n, bank, seed=10)
        assert _dense_build_ok(n, bank)  # the dispatch IS reached
        built = Interp1D.builder(y).x(x).strategy(CubicSpline()).build()
        a_ref, b_ref = jax.jit(
            lambda x, y: _uniform_ab(x, y, _NOT_A_KNOT)
        )(x, y)
        np.testing.assert_array_equal(
            np.asarray(built.strategy.a), np.asarray(a_ref)
        )
        np.testing.assert_array_equal(
            np.asarray(built.strategy.b), np.asarray(b_ref)
        )
        build = jax.jit(lambda x, y: CubicSpline().build(x, y).a)
        cuda = export.export(build, platforms=["cuda"])(x, y).mlir_module()
        assert "dot_general" in cuda and "stablehlo.while" not in cuda
