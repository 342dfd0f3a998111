"""Two-dimensional interpolator and builder.

Reference: ``/root/reference/src/interp2d/mod.rs``.  Semantics preserved:

* interpolation along the first two axes; trailing axes vectorized,
* default x/y = axis indices, default strategy ``Bilinear``
  (``mod.rs:388-405``),
* ``interp_array(xs, ys)`` requires ``xs.shape == ys.shape`` and yields
  dims ``M + N - 2`` with the query dims leading (``mod.rs:175-211``),
* builder validation order and messages (``mod.rs:468-518``).

The design mirrors :mod:`.interp1d`: the interpolator is a pytree,
the pure ``__call__`` is jittable, the eager API adds host-side checks.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class

from ..errors import (
    MonotonicError,
    NotEnoughDataError,
    OutOfBoundsError,
    ShapeError,
)
from ..ops.searchsorted import get_lower_index, is_in_range
from ..utils.monotonic import monotonic_prop
from .interp1d import _host_view, _is_traced
from .strategies.base2d import Interp2DStrategyBuilder
from .strategies.bilinear import Bilinear


from .interp1d import _promote_queries


@jax.jit
def _eval_flat(interp, xflat, yflat):
    return interp.strategy.eval(
        interp, _promote_queries(interp, xflat), _promote_queries(interp, yflat)
    )


@jax.jit
def _eval_flat_masked(interp, xflat, yflat):
    xflat = _promote_queries(interp, xflat)
    yflat = _promote_queries(interp, yflat)
    out = interp.strategy.eval(interp, xflat, yflat)
    # a periodic (wrapping) axis is never out of range
    wx = getattr(interp.strategy, "wraps_x", False)
    wy = getattr(interp.strategy, "wraps_y", False)
    if (
        not interp.strategy.extrapolates
        and not (wx and wy)
        and jnp.issubdtype(out.dtype, jnp.inexact)
    ):
        ok = jnp.ones(xflat.shape, bool)
        if not wx:
            ok = ok & is_in_range(interp.x, xflat)
        if not wy:
            ok = ok & is_in_range(interp.y, yflat)
        out = jnp.where(ok.reshape(ok.shape + (1,) * (out.ndim - 1)), out, jnp.nan)
    return out


@register_pytree_node_class
class Interp2D:
    """Two dimensional interpolator (pytree), ``mod.rs:36-48``."""

    def __init__(self, x, y, data, strategy):
        self.x = x
        self.y = y
        self.data = data
        self.strategy = strategy

    # -- construction --------------------------------------------------------
    @classmethod
    def builder(cls, data) -> "Interp2DBuilder":
        return Interp2DBuilder(data)

    @classmethod
    def new_unchecked(cls, x, y, data, strategy) -> "Interp2D":
        """No-validation constructor (``mod.rs:323-342``)."""
        return cls(x, y, data, strategy)

    # -- pure, jittable core ---------------------------------------------------
    def __call__(self, xs, ys):
        """Evaluate at ``(xs, ys)`` (any matching shape).  Pure/jittable;
        out-of-range → NaN when the strategy does not extrapolate."""
        xs = jnp.asarray(xs)
        ys = jnp.asarray(ys)
        if xs.shape != ys.shape:
            raise ValueError("`xs.shape` and `ys.shape` do not match")
        out = _eval_flat_masked(self, xs.reshape(-1), ys.reshape(-1))
        return out.reshape(xs.shape + self.data.shape[2:])

    def eval_unchecked(self, xs, ys):
        xs = jnp.asarray(xs)
        ys = jnp.asarray(ys)
        if xs.shape != ys.shape:
            raise ValueError("`xs.shape` and `ys.shape` do not match")
        out = _eval_flat(self, xs.reshape(-1), ys.reshape(-1))
        return out.reshape(xs.shape + self.data.shape[2:])

    def eval_checked(self, xs, ys):
        """Jit-compatible checked evaluation via ``checkify``; returns
        ``(error, values)`` (see ``Interp1D.eval_checked``)."""
        from jax.experimental import checkify

        def run(interp, xs, ys):
            xs = jnp.asarray(xs)
            ys = jnp.asarray(ys)
            xf = _promote_queries(interp, xs.reshape(-1))
            yf = _promote_queries(interp, ys.reshape(-1))
            if not interp.strategy.extrapolates:
                if not getattr(interp.strategy, "wraps_x", False):
                    checkify.check(
                        jnp.all(is_in_range(interp.x, xf)),
                        "an x query point is not in range",
                    )
                if not getattr(interp.strategy, "wraps_y", False):
                    checkify.check(
                        jnp.all(is_in_range(interp.y, yf)),
                        "a y query point is not in range",
                    )
            return interp.eval_unchecked(xs, ys)

        return checkify.checkify(run)(self, xs, ys)

    # -- strategy helpers (``mod.rs:344-379``) --------------------------------
    def index_point(self, x_idx, y_idx):
        """``(x, y, data)`` coordinate at the given index pair."""
        return self.x[x_idx], self.y[y_idx], self.data[x_idx, y_idx]

    def get_index_left_of(self, x, y):
        return get_lower_index(self.x, x), get_lower_index(self.y, y)

    def is_in_x_range(self, x):
        return is_in_range(self.x, x)

    def is_in_y_range(self, y):
        return is_in_range(self.y, y)

    # -- eager API -------------------------------------------------------------
    def _range_host(self):
        cached = getattr(self, "_range_cache", None)
        if cached is None:
            hi = getattr(self, "_host_inputs", None)
            if hi is not None:
                x_np, y_np = hi[0], hi[1]
            else:
                x_np = _host_view(self.x)
                y_np = _host_view(self.y)
            if x_np is not None and y_np is not None:
                cached = (
                    float(x_np[0]),
                    float(x_np[-1]),
                    float(y_np[0]),
                    float(y_np[-1]),
                )
            else:  # at most four scalar device fetches, once
                cached = (
                    float(self.x[0]),
                    float(self.x[-1]),
                    float(self.y[0]),
                    float(self.y[-1]),
                )
            self._range_cache = cached
        return cached

    def _check_queries(self, xs_flat, ys_flat):
        # a wrapping (periodic) axis behaves like an extrapolating one:
        # never out of range, but NaN still refuses to index
        wraps = (
            getattr(self.strategy, "wraps_x", False),
            getattr(self.strategy, "wraps_y", False),
        )
        if self.strategy.extrapolates or all(wraps):
            for name, q in (("x", xs_flat), ("y", ys_flat)):
                qh = np.asarray(q)
                if np.issubdtype(qh.dtype, np.floating) and np.isnan(qh).any():
                    raise ValueError("failed to convert NaN to an index")
            return
        # reference checks x then y per point (bilinear.rs:71-80)
        x0, xn, y0, yn = self._range_host()
        for name, q, (lo, hi), wrap in (
            ("x", xs_flat, (x0, xn), wraps[0]),
            ("y", ys_flat, (y0, yn), wraps[1]),
        ):
            qh = np.asarray(q)
            if wrap:
                if np.issubdtype(qh.dtype, np.floating) and np.isnan(qh).any():
                    raise ValueError("failed to convert NaN to an index")
                continue
            ok = (lo <= qh) & (qh <= hi)
            if not ok.all():
                bad = qh[~ok][0] if qh.ndim else qh
                raise OutOfBoundsError(f"{name} = {bad} is not in range")

    def _native_state(self):
        """Cached numpy views for the C++ host runtime (Bilinear only)."""
        cached = getattr(self, "_host_cache", None)
        if cached is not None:
            return cached if cached != () else None
        state = None
        try:
            from .. import config
            from ..native import HAVE_NATIVE
            from .strategies.bilinear import Bilinear as _Bil

            if (
                HAVE_NATIVE
                and getattr(config, "use_native_host", True)
                and isinstance(self.strategy, _Bil)
                and np.dtype(self.data.dtype) in (np.float32, np.float64)
            ):
                hi = getattr(self, "_host_inputs", None)
                if hi is not None:
                    x_np, y_np, d_np = hi
                else:
                    x_np = _host_view(self.x)
                    y_np = _host_view(self.y)
                    d_np = _host_view(self.data)
                if x_np is not None and y_np is not None and d_np is not None:
                    state = (
                        x_np,
                        y_np,
                        d_np,
                        bool(self.strategy.extrapolates),
                    )
        except Exception:
            state = None
        self._host_cache = state if state is not None else ()
        return state

    def _native_eval(self, x, y):
        state = self._native_state()
        if state is None:
            return None
        from ..native import eval_bilinear

        x_np, y_np, z_np, extrap = state
        qx = np.asarray(x, dtype=x_np.dtype)
        qy = np.asarray(y, dtype=x_np.dtype)
        for q in (qx, qy):
            if np.issubdtype(q.dtype, np.floating) and np.isnan(q).any():
                if extrap:
                    raise ValueError("failed to convert NaN to an index")
                raise OutOfBoundsError("x = nan is not in range")
        out, rc = eval_bilinear(x_np, y_np, z_np, qx, qy, extrap)
        if rc > 0:
            bad = qx.reshape(-1)[rc - 1]
            raise OutOfBoundsError(f"x = {bad} is not in range")
        if rc < 0:
            bad = qy.reshape(-1)[-rc - 1]
            raise OutOfBoundsError(f"y = {bad} is not in range")
        return out

    def interp_scalar(self, x, y):
        """One point of 2-D data → 0-d value (``mod.rs:107-113``)."""
        if self.data.ndim != 2:
            raise ShapeError(
                "interp_scalar requires 2-D data; use interp() instead"
            )
        if not (
            _is_traced(x)
            or _is_traced(y)
            or hasattr(x, "devices")
            or hasattr(y, "devices")
        ):
            fast = self._scalar_evaluator()
            if (
                fast is not None
                and isinstance(x, (int, float))
                and isinstance(y, (int, float))
            ):
                v, err = fast(float(x), float(y))
                if err == 0:
                    return v
                if err == 2:
                    if self.strategy.extrapolates:
                        raise ValueError(
                            "failed to convert NaN to an index"
                        )
                    raise OutOfBoundsError("x = nan is not in range")
                if err == 1:
                    raise OutOfBoundsError(f"x = {x} is not in range")
                raise OutOfBoundsError(f"y = {y} is not in range")
            out = self._native_eval(x, y)
            if out is not None:
                return out[()]
        return self.interp(x, y)[()]

    def _scalar_evaluator(self):
        fast = getattr(self, "_scalar_eval", None)
        if fast is not None:
            return fast if fast is not False else None
        fast = False
        state = self._native_state()
        if state is not None and state[0].dtype == np.float64:
            from ..native import ScalarEval2D

            x_np, y_np, d_np, extrap = state
            fast = ScalarEval2D(x_np, y_np, d_np, extrap)
        self._scalar_eval = fast
        return fast if fast is not False else None

    def interp(self, x, y):
        """Interpolated values at scalar ``(x, y)``; shape = data shape
        minus the first two axes (``mod.rs:132-146``)."""
        x = jnp.asarray(x)
        y = jnp.asarray(y)
        if not (_is_traced(x) or _is_traced(y)):
            self._check_queries(x.reshape(-1), y.reshape(-1))
        return self.eval_unchecked(x, y)

    def interp_into(self, x, y, buffer):
        """``interp`` into a numpy buffer (``mod.rs:160-167``)."""
        expect = tuple(self.data.shape[2:])
        if tuple(buffer.shape) != expect:
            raise ValueError(
                f"buffer shape mismatch expected: {list(expect)}, "
                f"got: {list(buffer.shape)}"
            )
        if not (
            _is_traced(x)
            or _is_traced(y)
            or hasattr(x, "devices")
            or hasattr(y, "devices")
        ):
            out = self._native_eval(x, y)
            if out is not None:
                buffer[...] = out
                return buffer
        buffer[...] = np.asarray(self.interp(x, y))
        return buffer

    def interp_array(self, xs, ys):
        """Batched interpolation (``mod.rs:175-196``).

        Output dims = ``xs.ndim + data.ndim - 2`` with query dims leading;
        ``xs.shape`` must equal ``ys.shape``.
        """
        if np.shape(xs) != np.shape(ys):
            raise ValueError("`xs.shape` and `ys.shape` do not match")
        tr_size = 1
        for s in self.data.shape[2:]:
            tr_size *= s
        if (
            not (_is_traced(xs) or _is_traced(ys))
            and not (hasattr(xs, "devices") or hasattr(ys, "devices"))
            and np.dtype(self.data.dtype) == np.float64
            and np.size(xs) * tr_size <= 1_000_000
        ):
            out = self._native_eval(np.asarray(xs), np.asarray(ys))
            if out is not None:
                return out
        xs = jnp.asarray(xs)
        ys = jnp.asarray(ys)
        if not (_is_traced(xs) or _is_traced(ys)):
            self._check_queries(xs.reshape(-1), ys.reshape(-1))
        return self.eval_unchecked(xs, ys)

    def interp_array_into(self, xs, ys, buffer):
        """``interp_array`` into a numpy buffer (``mod.rs:215-285``)."""
        expect = self.get_buffer_shape(np.shape(xs))
        if tuple(buffer.shape) != expect:
            raise ValueError(
                f"buffer shape mismatch expected: {list(expect)}, "
                f"got: {list(buffer.shape)}"
            )
        if np.shape(xs) != np.shape(ys):
            raise ValueError("`xs.shape` and `ys.shape` do not match")
        if not (
            _is_traced(xs)
            or _is_traced(ys)
            or hasattr(xs, "devices")
            or hasattr(ys, "devices")
        ):
            out = self._native_eval(np.asarray(xs), np.asarray(ys))
            if out is not None:
                buffer[...] = out
                return buffer
        buffer[...] = np.asarray(self.interp_array(xs, ys))
        return buffer

    def get_buffer_shape(self, query_shape) -> tuple:
        """Query dims ++ data dims[2:] (``mod.rs:310-321``)."""
        return tuple(query_shape) + tuple(self.data.shape[2:])

    # -- calculus (beyond reference; SciPy-style surface) ---------------------
    def derivative(self, xs, ys, dx=0, dy=0):
        """Partial derivative ``∂^{dx+dy} z / ∂x^dx ∂y^dy`` at query
        pairs — the analytic derivative of the strategy's surface
        (SciPy ``RectBivariateSpline.ev(xs, ys, dx, dy)`` surface; no
        reference analogue).  Output dims ``M + N - 2`` like
        ``interp_array``; ``xs.shape`` must equal ``ys.shape``; OOB
        raises unless the strategy extrapolates.  Supported by
        ``Bicubic`` (orders 0–3 per axis) and ``Bilinear`` (orders
        0–1 exact; higher are zero); jittable with traced queries."""
        fn = getattr(self.strategy, "eval_derivative", None)
        if fn is None:
            raise TypeError(
                f"{type(self.strategy).__name__} does not support "
                "derivative()"
            )
        if np.shape(xs) != np.shape(ys):
            raise ValueError("`xs.shape` and `ys.shape` do not match")
        xs = jnp.asarray(xs)
        ys = jnp.asarray(ys)
        if not (_is_traced(xs) or _is_traced(ys)):
            self._check_queries(xs.reshape(-1), ys.reshape(-1))
        out = fn(
            self,
            _promote_queries(self, xs.reshape(-1)),
            _promote_queries(self, ys.reshape(-1)),
            dx=dx,
            dy=dy,
        )
        return out.reshape(xs.shape + self.data.shape[2:])

    def integrate(self, xlo, xhi, ylo, yhi):
        """Exact definite integral ``∫∫ z dx dy`` over the rectangle
        ``[xlo, xhi] × [ylo, yhi]`` per trailing element — analytic
        per-cell polynomial quadrature, no sampling (SciPy
        ``RectBivariateSpline.integral`` surface; no reference
        analogue; ``Interp1D.integrate`` lifted to the 2-D driver).
        Signed per axis (``lo > hi`` negates that axis).  OOB bounds
        raise unless the strategy extrapolates (then the edge cells'
        polynomials extend).  Supported by ``Bilinear`` and
        ``Bicubic`` (non-periodic axes); returns shape
        ``data.shape[2:]``; jittable with traced bounds."""
        fn = getattr(self.strategy, "eval_integrate_box", None)
        if fn is None:
            raise TypeError(
                f"{type(self.strategy).__name__} does not support "
                "integrate()"
            )
        bounds = (xlo, xhi, ylo, yhi)
        if not any(_is_traced(jnp.asarray(b)) for b in bounds):
            self._check_queries(
                np.asarray([xlo, xhi], dtype=np.float64),
                np.asarray([ylo, yhi], dtype=np.float64),
            )
        return fn(self, xlo, xhi, ylo, yhi)

    # -- pytree -------------------------------------------------------------
    def tree_flatten(self):
        return (self.x, self.y, self.data, self.strategy), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux
        return cls(*children)

    def __repr__(self):
        return (
            f"Interp2D(x={self.x.shape}, y={self.y.shape}, "
            f"data={self.data.shape}, strategy={self.strategy!r})"
        )


class Interp2DBuilder:
    """Create and configure an :class:`Interp2D` (``mod.rs:50-64``)."""

    def __init__(self, data):
        self._data_host = _host_view(data)
        data = jnp.asarray(data)
        self._data = data
        if data.ndim >= 2:
            dt = np.dtype(data.dtype)
            self._x = jnp.arange(data.shape[0], dtype=data.dtype)
            self._y = jnp.arange(data.shape[1], dtype=data.dtype)
            self._x_host = np.arange(data.shape[0], dtype=dt)
            self._y_host = np.arange(data.shape[1], dtype=dt)
        else:
            self._x = self._y = None
            self._x_host = self._y_host = None
        self._strategy = Bilinear()

    def x(self, x) -> "Interp2DBuilder":
        self._x_host = _host_view(x)
        self._x = jnp.asarray(x)
        return self

    def y(self, y) -> "Interp2DBuilder":
        self._y_host = _host_view(y)
        self._y = jnp.asarray(y)
        return self

    def strategy(self, strategy: Interp2DStrategyBuilder) -> "Interp2DBuilder":
        self._strategy = strategy
        return self

    def build(self) -> Interp2D:
        """Validation order and messages follow ``mod.rs:468-518``."""
        data, x, y, strat = self._data, self._x, self._y, self._strategy

        if data.ndim < 2:
            raise ShapeError("data dimension needs to be at least 2")
        min_len = strat.MINIMUM_DATA_LENGTH
        if data.shape[0] < min_len:
            raise NotEnoughDataError(
                "The 0-dimension has not enough data for the chosen "
                f"interpolation strategy. Provided: {data.shape[0]}, "
                f"Required: {min_len}"
            )
        if data.shape[1] < min_len:
            raise NotEnoughDataError(
                "The 1-dimension has not enough data for the chosen "
                f"interpolation strategy. Provided: {data.shape[1]}, "
                f"Required: {min_len}"
            )
        if x.shape[0] != data.shape[0]:
            raise ShapeError(
                "Lengths of x-axis and data-0-axis need to match. "
                f"Got x: {x.shape[0]}, data-0: {data.shape[0]}"
            )
        if y.shape[0] != data.shape[1]:
            raise ShapeError(
                "Lengths of y-axis and data-1-axis need to match. "
                f"Got y: {y.shape[0]}, data-1: {data.shape[1]}"
            )
        x_host = self._x_host if self._x_host is not None else np.asarray(x)
        y_host = self._y_host if self._y_host is not None else np.asarray(y)
        if not monotonic_prop(x_host).is_strict_rising:
            raise MonotonicError(
                "The x-axis needs to be strictly monotonic rising"
            )
        if not monotonic_prop(y_host).is_strict_rising:
            raise MonotonicError(
                "The y-axis needs to be strictly monotonic rising"
            )

        ct = jnp.result_type(x.dtype, y.dtype, data.dtype)
        x = x.astype(ct)
        y = y.astype(ct)
        data = data.astype(ct)

        finished = strat.build(x, y, data)
        interp = Interp2D(x, y, data, finished)
        if self._data_host is not None:
            ct_np = np.dtype(ct)
            interp._host_inputs = (
                x_host.astype(ct_np, copy=False),
                y_host.astype(ct_np, copy=False),
                self._data_host.astype(ct_np, copy=False),
            )
        return interp
