"""Documented semantics matrix: NaN/±inf behavior and dtypes across paths.

Pins the behavior promised in README ("Known divergences") and DESIGN
("Error semantics under jit") so future rounds can't silently regress it.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ndarray_interp_tpu.errors import OutOfBoundsError
from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D, Linear


@pytest.fixture
def lin():
    return Interp1D.builder(np.array([1.0, 2.0, 4.0])).build()


@pytest.fixture
def lin_ex():
    return (
        Interp1D.builder(np.array([1.0, 2.0, 4.0]))
        .strategy(Linear().extrapolate(True))
        .build()
    )


class TestNaNAndInf:
    def test_eager_nan_no_extrapolate_is_oob(self, lin):
        # reference: range check precedes the NaN-cast panic
        with pytest.raises(OutOfBoundsError):
            lin.interp(float("nan"))

    def test_eager_nan_with_extrapolate_raises(self, lin_ex):
        # reference: panics "failed to convert NaN to usize"
        with pytest.raises(ValueError, match="NaN"):
            lin_ex.interp(float("nan"))

    def test_pure_nan_propagates(self, lin_ex):
        out = jax.jit(lambda t, q: t(q))(lin_ex, jnp.array([0.5, jnp.nan]))
        assert np.isfinite(np.asarray(out)[0])
        assert np.isnan(np.asarray(out)[1])

    def test_pure_oob_masks_nan_only_without_extrapolation(self, lin, lin_ex):
        q = jnp.array([1.0, 99.0])
        masked = np.asarray(lin(q))
        assert np.isnan(masked[1]) and masked[0] == 2.0  # data[x=1] == 2
        extr = np.asarray(lin_ex(q))
        assert np.isfinite(extr).all()

    def test_inf_clamps_to_edge_intervals(self, lin_ex):
        # vector_extensions tests :257-265 — ±inf use first/last interval
        out = np.asarray(lin_ex(jnp.array([jnp.inf, -jnp.inf])))
        assert out[0] == np.inf or out[0] > 1e30
        assert out[1] == -np.inf or out[1] < -1e30

    def test_eager_inf_oob_raises_without_extrapolation(self, lin):
        with pytest.raises(OutOfBoundsError):
            lin.interp_array(np.array([0.5, np.inf]))


class TestDtypes:
    def test_f32_stays_f32(self):
        itp = (
            Interp1D.builder(np.linspace(0, 1, 8).astype(np.float32))
            .strategy(CubicSpline().extrapolate(True))
            .build()
        )
        out = itp(jnp.linspace(0.0, 7.0, 5, dtype=jnp.float32))
        assert out.dtype == jnp.float32

    def test_int_data_truncating_division(self):
        # tests/interp1d.rs:15-18 — integer casts truncate
        itp = Interp1D.builder(np.array([0, 3, 10])).build()
        # midpoint of [0, 3]: (3-0)/1 truncation semantics per element
        v = int(itp(jnp.array(1))[()])
        assert v == 3

    def test_cubic_rejects_int(self):
        with pytest.raises(TypeError, match="floating"):
            Interp1D.builder(np.array([1, 2, 3])).strategy(
                CubicSpline()
            ).build()

    def test_x_data_dtype_promotion(self):
        itp = (
            Interp1D.builder(np.array([1.0, 2.0, 3.0], np.float64))
            .x(np.array([0, 1, 2]))
            .build()
        )
        assert itp.x.dtype == itp.data.dtype


class TestNonFiniteData:
    """Non-finite DATA values (not queries) stay local: every route
    fetches rows by gather, so a NaN/inf datum reaches only the queries
    whose interval (or bank column) contains it (docs/PARITY.md D5)."""

    def test_builder_flags_nan_data(self):
        # a NaN in one bank column of a cubic bank leaves the other
        # columns finite everywhere (the per-column solve is independent)
        d = np.arange(24.0).reshape(8, 3) ** 1.5
        d[4, 1] = np.nan
        itp = Interp1D.builder(d).strategy(CubicSpline().extrapolate(True)).build()
        out = np.asarray(itp.interp_array(np.linspace(-1.0, 8.0, 37)))
        assert np.isfinite(out[:, [0, 2]]).all()
        assert np.isnan(out[:, 1]).all()

    def test_builder_flags_inf_data_cubic(self):
        # f32 bank: same column locality on the single-precision route
        d = (np.arange(40.0).reshape(10, 4) ** 1.2).astype(np.float32)
        d[3, 2] = np.inf
        itp = Interp1D.builder(d).strategy(CubicSpline().extrapolate(True)).build()
        out = np.asarray(itp.interp_array(np.linspace(0.0, 9.0, 19, dtype=np.float32)))
        assert np.isfinite(out[:, [0, 1, 3]]).all()
        assert not np.isfinite(out[:, 2]).all()

    def test_builder_keeps_finite_flag_true(self):
        # pytree treedefs written with a second (routing-hint) aux entry
        # still unflatten
        from ndarray_interp_tpu.interp1d.cubic_spline import (
            CubicSplineStrategy,
        )

        a = jnp.zeros((3,))
        s = CubicSplineStrategy.tree_unflatten(("yes", False), (a, a))
        assert s.mode == "yes"
        assert Linear.tree_unflatten((True, False), ()).extrapolates

    def test_nan_datum_localizes_on_gather_path(self):
        # linear: a NaN datum must only affect its two adjacent intervals
        d = np.array([0.0, 1.0, np.nan, 3.0, 4.0])
        itp = Interp1D.builder(d).strategy(Linear().extrapolate(True)).build()
        out = np.asarray(itp.interp_array(np.array([0.5, 3.5, 1.5, 2.5])))
        assert np.isfinite(out[:2]).all()
        assert np.isnan(out[2:]).all()

    def test_onehot_gather_requires_finite(self):
        # bilinear (packed corner rows): a NaN node poisons only the up to
        # four cells that share it
        from ndarray_interp_tpu.interp2d import Interp2D

        z = np.arange(36.0, dtype=np.float32).reshape(6, 6)
        z[1, 1] = np.nan
        itp = Interp2D.builder(z).build()
        qx = np.array([0.5, 1.5, 4.5, 3.5], np.float32)
        qy = np.array([0.5, 0.5, 4.5, 2.5], np.float32)
        out = np.asarray(itp.interp_array(qx, qy))
        assert np.isnan(out[:2]).all()
        assert np.isfinite(out[2:]).all()

    def test_finite_flag_survives_pytree_roundtrip(self):
        import jax

        d = np.array([0.0, np.nan, 2.0, 3.0])
        itp = Interp1D.builder(d).strategy(Linear().extrapolate(True)).build()
        leaves, treedef = jax.tree_util.tree_flatten(itp)
        back = jax.tree_util.tree_unflatten(treedef, leaves)
        out = np.asarray(back.interp_array(np.array([2.5, 0.5])))
        assert np.isfinite(out[0]) and np.isnan(out[1])


class TestAbortSemantics:
    def test_any_oob_aborts_whole_call(self, lin):
        # mod.rs:321 — one bad point fails the entire interp_array
        with pytest.raises(OutOfBoundsError):
            lin.interp_array(np.array([1.0, 1.5, -7.0, 2.0]))

    def test_error_reports_first_offender(self, lin):
        with pytest.raises(OutOfBoundsError, match="-7"):
            lin.interp_array(np.array([1.0, -7.0, 99.0]))
