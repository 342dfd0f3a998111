"""One-dimensional interpolator and builder.

Reference: ``/root/reference/src/interp1d/mod.rs``.  Semantics preserved:

* interpolation happens along axis 0 of ``data``; trailing axes are
  vectorized (``mod.rs:39-51``),
* default x-axis is ``0..n`` indices, default strategy ``Linear``
  (``mod.rs:399-410``),
* ``interp_array(xs)`` output has dims ``M + N - 1`` with the query dims
  leading (``mod.rs:219-226``),
* any out-of-bounds query aborts the whole call (``mod.rs:321``),
* builder validation order and error messages (``mod.rs:443-476``).

Design: ``Interp1D`` is a registered pytree (leaves: knots,
data, strategy state; everything static lives in aux).  The pure
evaluation core ``__call__`` is jit/vmap/pjit-compatible; the eager
methods (``interp``, ``interp_array``, …) wrap it with the reference's
value-dependent error checks, which must run host-side.  Where the
reference iterates query points on the CPU, every entry point here
evaluates the whole query batch as one fused XLA computation
(bucketize → gather → polynomial), so multi-point queries are a single
device program rather than a loop.
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
from .strategies.base import Interp1DStrategyBuilder
from .strategies.linear import Linear


def _is_traced(x) -> bool:
    import jax.core

    return isinstance(x, jax.core.Tracer)


def _host_view(arr):
    """A numpy view of ``arr`` if obtainable without touching an
    accelerator, else None.

    Device→host transfers cost a synchronization each, so the eager paths
    only ever use host copies captured at build time or arrays already
    backed by host memory.
    """
    if arr is None or _is_traced(arr):
        return None
    if isinstance(arr, np.ndarray):
        return arr
    devices = getattr(arr, "devices", None)
    if devices is None:
        return np.asarray(arr)  # list/scalar/etc.
    try:
        if all(d.platform == "cpu" for d in devices()):
            return np.asarray(arr)
    except Exception:
        pass
    return None


def _promote_queries(interp, flat):
    """Queries promote to the knot dtype (e.g. bf16 queries against an f32
    bank, BASELINE.json config 5) so every strategy/kernel sees one dtype."""
    if flat.dtype != interp.x.dtype and jnp.issubdtype(
        interp.x.dtype, jnp.inexact
    ):
        return flat.astype(interp.x.dtype)
    return flat


@jax.jit
def _eval_flat(interp, flat):
    """Jitted strategy dispatch.

    The strategy's static configuration (kind, extrapolation mode) lives in
    pytree aux data, so the jit cache is keyed on it automatically; repeated
    eager calls with the same shapes reuse the compiled program.
    """
    return interp.strategy.eval(interp, _promote_queries(interp, flat))


@jax.jit
def _eval_flat_masked(interp, flat):
    flat = _promote_queries(interp, flat)
    out = interp.strategy.eval(interp, flat)
    if not interp.strategy.extrapolates and jnp.issubdtype(
        out.dtype, jnp.inexact
    ):
        ok = is_in_range(interp.x, flat).reshape(
            flat.shape + (1,) * (out.ndim - 1)
        )
        out = jnp.where(ok, out, jnp.nan)
    return out


@register_pytree_node_class
class Interp1D:
    """One dimensional interpolator (pytree).

    Construct via :meth:`builder` (validating) or :meth:`new_unchecked`
    (cheap, no validation — the pytree-unflatten analogue of
    ``Interp1D::new_unchecked``, ``mod.rs:356-365``).
    """

    def __init__(self, x, data, strategy):
        self.x = x
        self.data = data
        self.strategy = strategy

    # -- construction -------------------------------------------------------
    @classmethod
    def builder(cls, data) -> "Interp1DBuilder":
        """Get the builder (``mod.rs:79-81``)."""
        return Interp1DBuilder(data)

    @classmethod
    def new_unchecked(cls, x, data, strategy) -> "Interp1D":
        """Create an interpolator without any data validation.

        Assumed but not checked (``mod.rs:356-365``): ``x`` strictly
        monotonic rising, ``data.shape[0] == len(x)``, strategy built.
        """
        return cls(x, data, strategy)

    # -- pure, jittable core -------------------------------------------------
    def __call__(self, xs):
        """Evaluate at ``xs`` (any shape, incl. scalar). Pure and jittable.

        Returns shape ``xs.shape + data.shape[1:]``.  When the strategy does
        not extrapolate, out-of-range results are masked to NaN (inexact
        dtypes only) — the jit-safe stand-in for the reference's
        ``Err(OutOfBounds)``.
        """
        xs = jnp.asarray(xs)
        out = _eval_flat_masked(self, xs.reshape(-1))
        return out.reshape(xs.shape + self.data.shape[1:])

    def eval_unchecked(self, xs):
        """Like ``__call__`` but without the out-of-range NaN mask: queries
        outside the knot range use the edge intervals (i.e. extrapolate)."""
        xs = jnp.asarray(xs)
        out = _eval_flat(self, xs.reshape(-1))
        return out.reshape(xs.shape + self.data.shape[1:])

    def eval_checked(self, xs):
        """Jit-compatible checked evaluation via ``checkify``.

        Returns ``(error, values)``; the error is set when any query is out
        of range and the strategy does not extrapolate (the functional
        stand-in for the reference's ``Err(OutOfBounds)`` under ``jit`` —
        call ``error.throw()`` host-side to raise).
        """
        from jax.experimental import checkify

        def run(interp, xs):
            xs = jnp.asarray(xs)
            flat = xs.reshape(-1)
            if not interp.strategy.extrapolates:
                ok = is_in_range(interp.x, _promote_queries(interp, flat))
                checkify.check(jnp.all(ok), "a query point is not in range")
            return interp.eval_unchecked(xs)

        return checkify.checkify(run)(self, xs)

    # -- helpers available to strategies (``mod.rs:367-386``) ----------------
    def index_point(self, index):
        """``(x, data)`` coordinate at the given index; index may be traced."""
        return self.x[index], jnp.take(self.data, index, axis=0)

    def get_index_left_of(self, x):
        """Index of a known value left of, or at, ``x``; never the last
        index, so ``index_point(idx + 1)`` is always safe."""
        return get_lower_index(self.x, x)

    def is_in_range(self, x):
        return is_in_range(self.x, x)

    # -- eager API (reference parity; raises on bad values) ------------------
    def _check_queries(self, xs_flat):
        """Reference error contract: OutOfBounds unless extrapolating
        (``linear.rs:80-84``); NaN queries are rejected like the
        reference's NaN-cast panic (``vector_extensions.rs:267-271``)."""
        xs_host = np.asarray(xs_flat)
        if not self.strategy.extrapolates:
            x0, xn = self._range_host()
            ok = (x0 <= xs_host) & (xs_host <= xn)
            if not ok.all():
                bad = xs_host[~ok][0] if xs_host.ndim else xs_host
                raise OutOfBoundsError(f"x = {bad} is not in range")
        elif np.issubdtype(xs_host.dtype, np.floating) and np.isnan(
            xs_host
        ).any():
            raise ValueError("failed to convert NaN to an index")

    def _range_host(self):
        """``(x[0], x[-1])`` as host scalars, cached; at most two scalar
        device fetches when no host copy of the axis exists."""
        cached = getattr(self, "_range_cache", None)
        if cached is None:
            hi = getattr(self, "_host_inputs", None)
            x_np = hi[0] if hi is not None else _host_view(self.x)
            if x_np is not None:
                cached = (float(x_np[0]), float(x_np[-1]))
            else:
                cached = (float(self.x[0]), float(self.x[-1]))
            self._range_cache = cached
        return cached

    # -- native host fast path ------------------------------------------------
    def _native_state(self):
        """Cached numpy views + strategy lowering for the C++ host runtime.

        Returns None when the strategy has no native lowering or dtypes are
        unsupported; callers fall back to the JAX path.  This is the
        host-side analogue of the reference's allocation-free scalar path
        (``interp_scalar`` got ~-50%% in v0.4.1, CHANGELOG.md:21-22).
        """
        cached = getattr(self, "_host_cache", None)
        if cached is not None:
            return cached if cached != () else None
        state = None
        try:
            from .. import config
            from ..native import HAVE_NATIVE

            if HAVE_NATIVE and getattr(config, "use_native_host", True):
                state = self._build_native_state()
        except Exception:
            state = None
        self._host_cache = state if state is not None else ()
        return state

    def _build_native_state(self):
        from .strategies.cubic import CubicSplineStrategy
        from .strategies.linear import Linear as _Lin

        if np.dtype(self.data.dtype) not in (np.float32, np.float64):
            return None

        hi = getattr(self, "_host_inputs", None)
        if hi is not None:
            x_np, d_np, strat_builder = hi
        else:
            x_np = _host_view(self.x)
            d_np = _host_view(self.data)
            strat_builder = None
        if x_np is None or d_np is None:
            return None

        if isinstance(self.strategy, _Lin):
            return ("linear", x_np, d_np, bool(self.strategy.extrapolates))
        if isinstance(self.strategy, CubicSplineStrategy):
            mode = {"no": 0, "yes": 1, "periodic": 2}[self.strategy.mode]
            a_np = _host_view(self.strategy.a)
            b_np = _host_view(self.strategy.b)
            if (a_np is None or b_np is None) and strat_builder is not None:
                # coefficients live on an accelerator; rebuild them on the
                # host rather than transferring — natively for uniform
                # cubic boundaries, via the CPU backend otherwise
                from .strategies.cubic import CubicSpline as _CS

                kind_codes = {"not_a_knot": 0, "clamped": 1, "natural": 2}
                if (
                    isinstance(strat_builder, _CS)
                    and strat_builder._boundary.kind in kind_codes
                ):
                    from ..native import cubic_build

                    code = kind_codes[strat_builder._boundary.kind]
                    a_np, b_np = cubic_build(x_np, d_np, code, 0.0, code, 0.0)
                else:
                    import jax

                    cpu = jax.devices("cpu")[0]
                    with jax.default_device(cpu):
                        s2 = strat_builder.build(
                            jnp.asarray(x_np), jnp.asarray(d_np)
                        )
                    a_np = np.asarray(s2.a)
                    b_np = np.asarray(s2.b)
            if a_np is None or b_np is None:
                return None
            return ("hermite", x_np, d_np, a_np, b_np, mode)
        return None

    def _native_eval(self, xs):
        """Evaluate via the native runtime; returns None on ineligibility."""
        state = self._native_state()
        if state is None:
            return None
        from ..native import eval_hermite, eval_linear

        xs_np = np.asarray(xs, dtype=state[1].dtype)
        if np.issubdtype(xs_np.dtype, np.floating) and np.isnan(xs_np).any():
            if state[0] == "linear":
                extrap = state[3]
            else:
                extrap = state[5] != 0
            if extrap:
                raise ValueError("failed to convert NaN to an index")
            bad = xs_np[np.isnan(xs_np)][0]
            raise OutOfBoundsError(f"x = {bad} is not in range")
        if state[0] == "linear":
            _, x_np, d_np, extrap = state
            out, rc = eval_linear(x_np, d_np, xs_np, extrap)
        else:
            _, x_np, d_np, a_np, b_np, mode = state
            out, rc = eval_hermite(x_np, d_np, a_np, b_np, xs_np, mode)
        if rc != 0:
            bad = xs_np.reshape(-1)[rc - 1]
            raise OutOfBoundsError(f"x = {bad} is not in range")
        return out

    def interp_scalar(self, x):
        """Interpolate one point of 1-D data, returning a 0-d value
        (``mod.rs:108-114``)."""
        if self.data.ndim != 1:
            raise ShapeError(
                "interp_scalar requires 1-D data; use interp() instead"
            )
        if not _is_traced(x) and not hasattr(x, "devices"):
            fast = self._scalar_evaluator()
            if fast is not None and isinstance(x, (int, float)):
                v, err = fast(float(x))
                if err == 0:
                    return v
                if err == 1:
                    raise OutOfBoundsError(f"x = {x} is not in range")
                if self.strategy.extrapolates:
                    raise ValueError("failed to convert NaN to an index")
                raise OutOfBoundsError(f"x = {x} is not in range")
            out = self._native_eval(x)
            if out is not None:
                return out[()]
        return self.interp(x)[()]

    def _scalar_evaluator(self):
        """Prebound C scalar evaluator (f64 1-D data only — f32 stays on
        the batch path so its arithmetic dtype matches the reference)."""
        fast = getattr(self, "_scalar_eval", None)
        if fast is not None:
            return fast if fast is not False else None
        fast = False
        state = self._native_state()
        if state is not None and state[1].dtype == np.float64:
            from ..native import ScalarEval1D

            if state[0] == "linear":
                _, x_np, d_np, extrap = state
                fast = ScalarEval1D(x_np, d_np, mode=int(extrap))
            else:
                _, x_np, d_np, a_np, b_np, mode = state
                fast = ScalarEval1D(x_np, d_np, a_np, b_np, mode=mode)
        self._scalar_eval = fast
        return fast if fast is not False else None

    def interp(self, x):
        """Interpolated values at scalar ``x``; shape = data shape minus
        axis 0 (``mod.rs:150-156``)."""
        x = jnp.asarray(x)
        if not _is_traced(x):
            self._check_queries(x.reshape(-1))
        return self.eval_unchecked(x)

    def interp_into(self, x, buffer):
        """``interp`` into a caller-provided numpy buffer (``mod.rs:169-175``).

        The buffer must have the data shape with the first axis removed;
        a wrong shape raises ``ValueError`` mirroring the reference panic
        contract (``mod.rs:167``).
        """
        expect = tuple(self.data.shape[1:])
        if tuple(buffer.shape) != expect:
            raise ValueError(
                f"buffer shape mismatch expected: {list(expect)}, "
                f"got: {list(buffer.shape)}"
            )
        if not _is_traced(x) and not hasattr(x, "devices"):
            out = self._native_eval(x)
            if out is not None:
                buffer[...] = out
                return buffer
        result = self.interp(x)
        buffer[...] = np.asarray(result)
        return buffer

    def interp_array(self, xs):
        """Interpolated values at all points in ``xs``; output dims
        ``M + N - 1`` with query dims leading (``mod.rs:197-211``).

        Host-side f64 queries (numpy/lists) evaluate on the native C++
        runtime and return numpy; device arrays / f32 use the JAX path.
        """
        tr_size = 1
        for s in self.data.shape[1:]:
            tr_size *= s
        if (
            not _is_traced(xs)
            and not hasattr(xs, "devices")
            and np.dtype(self.data.dtype) == np.float64
            # small-batch regime: device dispatch latency dominates there;
            # large host batches are better off on the accelerator
            and np.size(xs) * tr_size <= 1_000_000
        ):
            out = self._native_eval(np.asarray(xs))
            if out is not None:
                return out
        xs = jnp.asarray(xs)
        if not _is_traced(xs):
            self._check_queries(xs.reshape(-1))
        return self.eval_unchecked(xs)

    def interp_array_into(self, xs, buffer):
        """``interp_array`` into a caller-provided numpy buffer
        (``mod.rs:272-324``)."""
        expect = self.get_buffer_shape(np.shape(xs))
        if tuple(buffer.shape) != expect:
            raise ValueError(
                f"buffer shape mismatch expected: {list(expect)}, "
                f"got: {list(buffer.shape)}"
            )
        if not _is_traced(xs) and not hasattr(xs, "devices"):
            out = self._native_eval(np.asarray(xs))
            if out is not None:
                buffer[...] = out
                return buffer
        result = self.interp_array(jnp.asarray(xs))
        buffer[...] = np.asarray(result)
        return buffer

    def get_buffer_shape(self, query_shape) -> tuple:
        """Required buffer shape for ``interp_array_into``
        (``mod.rs:346-354``): query dims ++ data dims[1:]."""
        return tuple(query_shape) + tuple(self.data.shape[1:])

    # -- calculus (beyond reference; SciPy-style surface) ---------------------
    def derivative(self, xs, order=1):
        """``order``-th derivative ``d^o y/dx^o`` at ``xs`` — the
        analytic derivative of the strategy's piecewise polynomial
        (SciPy ``CubicSpline(...).derivative(order)(xs)`` surface; no
        reference analogue).  Output dims ``M + N - 1`` like
        ``interp_array``; OOB raises unless the strategy extrapolates.
        Supported by the cubic-Hermite family (``CubicSpline``/
        ``Akima``/``Makima``/``Pchip``, orders 1–3) and ``Linear``
        (order 1; higher orders are zero); jittable with traced
        queries."""
        fn = getattr(self.strategy, "eval_derivative", None)
        if fn is None:
            raise TypeError(
                f"{type(self.strategy).__name__} does not support "
                "derivative()"
            )
        xs = jnp.asarray(xs)
        flat = xs.reshape(-1)
        if not _is_traced(xs):
            self._check_queries(flat)
        out = fn(self, _promote_queries(self, flat), order=order)
        return out.reshape(xs.shape + self.data.shape[1:])

    def integrate(self, lo, hi):
        """Definite integral ``∫_lo^hi y dx`` per trailing element —
        exact per-interval polynomial quadrature, no sampling (SciPy
        ``CubicSpline.integrate`` surface; no reference analogue).
        Signed: ``lo > hi`` negates.  Periodic splines integrate the
        periodic extension (whole periods + wrapped remainder); other
        extrapolating strategies integrate the edge polynomials.  OOB
        bounds raise unless the strategy extrapolates.  Returns shape
        ``data.shape[1:]``; jittable with traced bounds."""
        fn = getattr(self.strategy, "eval_integrate", None)
        if fn is None:
            raise TypeError(
                f"{type(self.strategy).__name__} does not support "
                "integrate()"
            )
        if not (_is_traced(lo) or _is_traced(hi)):
            self._check_queries(np.asarray([lo, hi], dtype=np.float64))
        return fn(self, lo, hi)

    def solve(self, y=0.0, *, max_roots=None):
        """All real solutions of ``interp(x) == y`` (SciPy
        ``CubicSpline.solve`` surface; no reference analogue).  Returns
        a NaN-padded, ascending-sorted array of shape
        ``(3*(n_knots-1),) + data.shape[1:]`` — the static per-interval
        root bound keeps the whole solve one fixed-shape batched
        computation (jittable/vmappable; see ``ops/cubicroots.py``).
        ``y`` may be a scalar or broadcast over the trailing dims.
        Extrapolating strategies also report roots of the extended edge
        polynomials; periodic splines report the base-domain roots.
        ``max_roots`` statically trims the padded axis to its first
        ``max_roots`` rows.  Supported by the cubic-Hermite family and
        ``Linear``."""
        fn = getattr(self.strategy, "eval_solve", None)
        if fn is None:
            raise TypeError(
                f"{type(self.strategy).__name__} does not support solve()"
            )
        out = fn(self, y)
        if max_roots is not None:
            out = out[:max_roots]
        return out

    def roots(self, *, max_roots=None):
        """Real zero crossings — ``solve(0.0)`` (SciPy
        ``CubicSpline.roots`` surface)."""
        return self.solve(0.0, max_roots=max_roots)

    # -- pytree ---------------------------------------------------------------
    def tree_flatten(self):
        return (self.x, self.data, self.strategy), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux
        return cls(*children)

    def __repr__(self):
        return (
            f"Interp1D(x={self.x.shape}, data={self.data.shape}, "
            f"strategy={self.strategy!r})"
        )


class Interp1DBuilder:
    """Create and configure an :class:`Interp1D` (``mod.rs:53-70``).

    Defaults: strategy ``Linear(extrapolate=False)``, x = axis-0 indices.
    """

    def __init__(self, data):
        self._data_host = _host_view(data)
        data = jnp.asarray(data)
        self._data = data
        n = data.shape[0] if data.ndim >= 1 else 0
        # default x = 0..n cast to the data's dtype (mod.rs:399-410)
        self._x = jnp.arange(n, dtype=data.dtype) if data.ndim >= 1 else None
        self._x_host = (
            np.arange(n, dtype=np.dtype(data.dtype)) if data.ndim >= 1 else None
        )
        self._strategy = Linear()

    def x(self, x) -> "Interp1DBuilder":
        """Set a custom x axis; must be strictly monotonic rising and match
        the data's axis-0 length (``mod.rs:424-430``)."""
        self._x_host = _host_view(x)
        self._x = jnp.asarray(x)
        return self

    def strategy(self, strategy: Interp1DStrategyBuilder) -> "Interp1DBuilder":
        """Set the interpolation strategy (``mod.rs:434-440``)."""
        self._strategy = strategy
        return self

    def build(self) -> Interp1D:
        """Validate input data and create the configured interpolator.

        Validation order and messages follow ``mod.rs:443-476``.
        """
        data, x, strat = self._data, self._x, self._strategy

        if data.ndim < 1:
            raise ShapeError("data dimension is 0, needs to be at least 1")
        if data.shape[0] < strat.MINIMUM_DATA_LENGTH:
            raise NotEnoughDataError(
                "The chosen Interpolation strategy needs at least "
                f"{strat.MINIMUM_DATA_LENGTH} data points"
            )
        x_host = self._x_host if self._x_host is not None else np.asarray(x)
        if not monotonic_prop(x_host).is_strict_rising:
            raise MonotonicError(
                "Values in the x axis need to be strictly monotonic rising"
            )
        if x.shape[0] != data.shape[0]:
            raise ShapeError(
                "Lengths of x and data axis need to match. "
                f"Got x: {x.shape[0]}, data: {data.shape[0]}"
            )

        # unify dtypes (the reference enforces Sx::Elem == Sd::Elem at the
        # type level; we promote instead)
        ct = jnp.result_type(x.dtype, data.dtype)
        x = x.astype(ct)
        data = data.astype(ct)

        finished = strat.build(x, data)
        interp = Interp1D(x, data, finished)
        # capture host copies for the native scalar path and range checks —
        # the eager API must never depend on a device→host array transfer
        if self._data_host is not None:
            ct_np = np.dtype(ct)
            interp._host_inputs = (
                x_host.astype(ct_np, copy=False),
                self._data_host.astype(ct_np, copy=False),
                strat,
            )
        return interp
