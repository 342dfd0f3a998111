"""Piecewise-linear interpolation strategy.

Reference: ``/root/reference/src/interp1d/strategies/linear.rs``.  The
strategy is stateless configuration (``extrapolate`` flag); ``build`` is a
no-op (``linear.rs:54-63``).  Evaluation is one bucketize → 2-point
gather → lerp over the whole query batch (the reference does the same math
per query point, ``linear.rs:73-98``).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class

from ...ops.lerp import calc_frac
from .base import Interp1DStrategy, Interp1DStrategyBuilder


@register_pytree_node_class
class Linear(Interp1DStrategy, Interp1DStrategyBuilder):
    """Linear interpolation with optional extrapolation.

    Chainable configuration mirrors the reference builder
    (``linear.rs:16-27``)::

        Linear()                   # no extrapolation (default)
        Linear().extrapolate(True) # extrapolate using the edge intervals
    """

    MINIMUM_DATA_LENGTH = 2  # linear.rs:52

    def __init__(self, extrapolate: bool = False):
        self.extrapolates = bool(extrapolate)

    def extrapolate(self, yes: bool = True) -> "Linear":
        """Return a copy with extrapolation enabled/disabled (chainable)."""
        return Linear(extrapolate=yes)

    # -- strategy protocol -------------------------------------------------
    def build(self, x, data) -> "Linear":
        return self

    def eval(self, interp, xq):
        from ...ops.searchsorted import get_lower_index

        idx = get_lower_index(interp.x, xq)
        # single stacked gather for both interval endpoints (see cubic.py)
        xg = jnp.stack([interp.x[:-1], interp.x[1:]], axis=-1)[idx]
        x1, x2 = xg[..., 0], xg[..., 1]
        yg = jnp.stack([interp.data[:-1], interp.data[1:]], axis=-1)[idx]
        y1, y2 = yg[..., 0], yg[..., 1]
        expand = xq.shape + (1,) * (interp.data.ndim - 1)
        return calc_frac(
            x1.reshape(expand), y1, x2.reshape(expand), y2, xq.reshape(expand)
        )

    # -- calculus (beyond reference; SciPy-style surface) --------------------
    def _interval_quantities(self, interp, p):
        from ...ops.searchsorted import get_lower_index

        x = interp.x
        data = interp.data
        idx = get_lower_index(x, p)
        xg = jnp.stack([x[:-1], x[1:]], axis=-1)[idx]
        dx = xg[..., 1] - xg[..., 0]
        t = (p - xg[..., 0]) / dx
        yg = jnp.stack([data[:-1], data[1:]], axis=-1)[idx]
        expand = p.shape + (1,) * (data.ndim - 1)
        return (
            idx,
            dx.reshape(expand),
            t.reshape(expand),
            yg[..., 0],
            yg[..., 1],
        )

    def eval_derivative(self, interp, xq, order=1):
        """Piecewise-constant slope ``(y_r - y_l)/dx`` of the active
        interval (the edge interval when extrapolating).  At interior
        knots the right interval's slope is reported (the lower-index
        clamp contract).  Orders 2/3 are identically zero (away from
        the knots, where the distributional derivative is undefined)."""
        if order not in (1, 2, 3):
            raise ValueError(
                f"derivative order must be 1, 2, or 3; got {order}"
            )
        _, dx, _, y_l, y_r = self._interval_quantities(interp, xq)
        if order > 1:
            return jnp.zeros_like(y_l)
        return (y_r - y_l) / dx

    def _antideriv(self, interp, p):
        """F(p) = ∫_{x[0]}^{p}: exact trapezoid cumsum + the partial
        ``dx·[y_l t + (y_r - y_l) t²/2]`` (polynomial outside the range
        — the edge-interval linear extension)."""
        x = interp.x
        data = interp.data
        tr = data.ndim - 1
        dxk = (x[1:] - x[:-1]).reshape((-1,) + (1,) * tr)
        full = dxk * 0.5 * (data[:-1] + data[1:])
        csum = jnp.concatenate(
            [jnp.zeros_like(full[:1]), jnp.cumsum(full, axis=0)], axis=0
        )
        idx, dx, t, y_l, y_r = self._interval_quantities(interp, p)
        part = y_l * t + (y_r - y_l) * (0.5 * t * t)
        return csum[idx] + dx * part

    def eval_integrate(self, interp, lo, hi):
        """∫_lo^hi y dx per trailing element (signed; exact)."""
        dtype = jnp.result_type(interp.x.dtype, interp.data.dtype)
        bounds = jnp.stack(
            [jnp.asarray(lo, dtype), jnp.asarray(hi, dtype)]
        )
        f = self._antideriv(interp, bounds)
        return f[1] - f[0]

    def eval_solve(self, interp, y=0.0):
        """Real roots of ``lerp(x) - y``: one linear crossing per
        interval, collected through the shared static-shape machinery
        (``ops/cubicroots.py``) so the padded output shape
        ``(3(n-1), *trailing)`` matches the spline family's.  A segment
        identically equal to ``y`` contributes its left knot as one
        representative root; extrapolating interpolators also report
        crossings of the extended edge segments."""
        from ...ops.cubicroots import interval_roots_to_x, real_cubic_roots

        data = interp.data
        dtype = jnp.result_type(interp.x.dtype, data.dtype, jnp.float32)
        yq = jnp.asarray(y, dtype)
        y_l = data[:-1].astype(dtype)
        y_r = data[1:].astype(dtype)
        c0 = y_l - yq
        c1 = y_r - y_l
        zero = jnp.zeros_like(c0)
        t = real_cubic_roots(c0, c1, zero, zero)
        const0 = (c0 == 0) & (c1 == 0)
        t = t.at[..., 0].set(jnp.where(const0, 0.0, t[..., 0]))
        return interval_roots_to_x(
            interp.x.astype(dtype), t, extrapolate=self.extrapolates
        )

    # -- pytree -------------------------------------------------------------
    def tree_flatten(self):
        return (), (self.extrapolates,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        del children
        # older pickled treedefs carry a second (routing-hint) aux entry
        return cls(extrapolate=aux[0])

    def __repr__(self):
        return f"Linear(extrapolate={self.extrapolates})"
