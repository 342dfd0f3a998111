"""Ports of the reference's axis-utility unit tests.

Reference: ``/root/reference/src/vector_extensions.rs:200-403``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ndarray_interp_tpu.ops.searchsorted import get_lower_index
from ndarray_interp_tpu.utils.monotonic import (
    MonotonicKind,
    monotonic_prop,
)


def linspace_axis():
    return jnp.linspace(0.0, 10.0, 11)


def exp_axis():
    return jnp.array([2.0**i for i in range(11)])


def log_axis():
    return jnp.array([np.log1p(float(i)) for i in range(11)])


class TestGetLowerIndex:
    # vector_extensions.rs:221-239
    def test_outside_left(self):
        assert get_lower_index(linspace_axis(), -1.0) == 0

    def test_outside_right(self):
        assert get_lower_index(linspace_axis(), 25.0) == 9

    def test_left_border(self):
        assert get_lower_index(linspace_axis(), 0.0) == 0

    def test_right_border(self):
        assert get_lower_index(linspace_axis(), 10.0) == 9

    def test_exact_index(self):
        # :241-246
        axis = linspace_axis()
        for i in range(10):
            assert get_lower_index(axis, float(i)) == i

    def test_index(self):
        # :248-255
        axis = linspace_axis()
        for i in range(100):
            assert get_lower_index(axis, i / 10.0) == i // 10

    def test_pos_inf(self):
        # :257-260
        assert get_lower_index(linspace_axis(), np.inf) == 9

    def test_neg_inf(self):
        # :262-265
        assert get_lower_index(linspace_axis(), -np.inf) == 0

    def test_exponential_exact_index(self):
        # :273-278
        axis = exp_axis()
        for i in range(10):
            assert get_lower_index(axis, 2.0**i) == i

    def test_exponential_index(self):
        # :280-285
        axis = exp_axis()
        for xi in range(100):
            assert get_lower_index(axis, 2.0 ** (xi / 10.0)) == xi // 10

    def test_exponential_borders(self):
        # :287-295
        assert get_lower_index(exp_axis(), 1024.0) == 9
        assert get_lower_index(exp_axis(), 1.0) == 0

    def test_log(self):
        # :297-302
        axis = log_axis()
        for xi in range(100):
            assert get_lower_index(axis, np.log1p(xi / 10.0)) == xi // 10

    def test_vectorized_matches_scalar(self):
        # Addition beyond the reference: the batched path is the hot path.
        axis = exp_axis()
        q = jnp.linspace(-1.0, 2000.0, 257)
        batched = np.asarray(get_lower_index(axis, q))
        scalar = np.array([get_lower_index(axis, x) for x in q])
        np.testing.assert_array_equal(batched, scalar)


class TestMonotonic:
    # vector_extensions.rs:317-403; each case also checked on a reversed
    # view where the reference does.
    def check(self, arr, kind, strict=None):
        m = monotonic_prop(np.asarray(arr))
        assert m.kind is kind
        if strict is not None:
            assert m.strict == strict

    def test_strict_rising_f64(self):
        self.check([1.1, 2.0, 3.123, 4.5], MonotonicKind.RISING, True)

    def test_rising_f64(self):
        self.check([1.1, 2.0, 3.123, 3.123, 4.5], MonotonicKind.RISING, False)

    def test_strict_falling_f64(self):
        self.check([5.8, 4.123, 3.1, 2.0, 1.0], MonotonicKind.FALLING, True)

    def test_falling_f64(self):
        self.check(
            [5.8, 4.123, 3.1, 3.1, 2.0, 1.0], MonotonicKind.FALLING, False
        )

    def test_not_monotonic_f64(self):
        self.check([1.1, 2.0, 3.123, 3.120, 4.5], MonotonicKind.NOT_MONOTONIC)

    def test_strict_rising_i32(self):
        self.check([1, 2, 3, 4, 5], MonotonicKind.RISING, True)

    def test_rising_i32(self):
        self.check([1, 2, 3, 3, 4, 5], MonotonicKind.RISING, False)

    def test_strict_falling_i32(self):
        self.check([5, 4, 3, 2, 1], MonotonicKind.FALLING, True)

    def test_falling_i32(self):
        self.check([5, 4, 3, 3, 2, 1], MonotonicKind.FALLING, False)

    def test_not_monotonic_i32(self):
        self.check([1, 2, 3, 2, 4, 5], MonotonicKind.NOT_MONOTONIC)

    def test_ordered_view_on_unordered_array(self):
        # :379-384 — reversed view of a falling array is strictly rising
        data = np.array([5, 4, 3, 2, 1])[::-1]
        self.check(data, MonotonicKind.RISING, True)

    def test_starting_flat(self):
        self.check([1, 1, 2, 3, 4, 5], MonotonicKind.RISING, False)

    def test_flat(self):
        self.check([1, 1, 1], MonotonicKind.NOT_MONOTONIC)

    def test_one_element(self):
        self.check([1], MonotonicKind.NOT_MONOTONIC)

    def test_non_1d_rejected(self):
        with pytest.raises(ValueError):
            monotonic_prop(np.zeros((2, 2)))


def _hermite_oracle(x, d, a, b, q):
    """NumPy twin of the cubic route: interval search, then the
    symmetric Hermite of ``cubic_spline.rs:818-828``."""
    idx = np.clip(np.searchsorted(x, q, side="right") - 1, 0, x.shape[0] - 2)
    t = (q - x[idx]) / (x[idx + 1] - x[idx])
    t = t.reshape(t.shape + (1,) * (d.ndim - 1))
    return (
        (1 - t) * d[idx] + t * d[idx + 1]
        + t * (1 - t) * (a[idx] * (1 - t) + b[idx] * t)
    )


class TestRowGather:
    """The cubic eval route fetches ``[y_l, y_r, a, b]`` with ONE stacked
    row gather; it must equal the per-quantity formula for every table
    shape and dtype."""

    def _check(self, n, trailing, nq, dtype, rtol, seed):
        from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D

        rng = np.random.default_rng(seed)
        x = np.cumsum(rng.uniform(0.1, 1.0, n)).astype(dtype)
        d = (
            rng.normal(size=(n,) + trailing)
            * 10.0 ** rng.integers(-6, 6, (n,) + trailing)
        ).astype(dtype)
        itp = (
            Interp1D.builder(jnp.asarray(d)).x(jnp.asarray(x))
            .strategy(CubicSpline().extrapolate(True)).build()
        )
        q = rng.uniform(x[0] - 1, x[-1] + 1, nq).astype(dtype)
        got = np.asarray(jax.jit(lambda t, qq: t(qq))(itp, jnp.asarray(q)))
        a = np.asarray(itp.strategy.a)
        b = np.asarray(itp.strategy.b)
        want = _hermite_oracle(x, d, a, b, q)
        assert got.shape == (nq,) + trailing
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)

    def test_f32_bank(self):
        self._check(257, (33,), 4096, np.float32, 2e-6, 0)

    def test_f64_bank(self):
        self._check(64, (9,), 333, np.float64, 1e-13, 1)

    def test_long_axis_large_query(self):
        self._check(8192, (8,), 40_000, np.float32, 2e-6, 2)

    def test_nd_trailing(self):
        self._check(31, (3, 5), 17, np.float32, 2e-6, 3)
