"""Bilinear interpolation strategy on a rectilinear grid.

Reference: ``/root/reference/src/interp2d/strategies/bilinear.rs``.
Stateless config in the reference; evaluation per point is: two range
checks, two searchsorteds, four corner lookups, then two x-direction
lerps followed by one y-direction lerp (``bilinear.rs:64-98``).  Here the
whole query batch does this at once: two bucketizes + one 4-corner gather
+ three fused lerps.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class

from ...ops.lerp import calc_frac
from .base2d import Interp2DStrategy, Interp2DStrategyBuilder


@register_pytree_node_class
class Bilinear(Interp2DStrategy, Interp2DStrategyBuilder):
    MINIMUM_DATA_LENGTH = 2  # bilinear.rs:41

    def __init__(self, extrapolate: bool = False):
        self.extrapolates = bool(extrapolate)

    def extrapolate(self, yes: bool = True) -> "Bilinear":
        """Chainable config (``bilinear.rs:20-23``)."""
        return Bilinear(extrapolate=yes)

    def build(self, x, y, data):
        return self

    def eval(self, interp, xq, yq):
        from ...ops.searchsorted import get_lower_index

        x, y, data = interp.x, interp.y, interp.data
        xi = get_lower_index(x, xq)
        yi = get_lower_index(y, yq)
        # 4-corner gather, (Q, *data.shape[2:]) each.  A packed per-cell
        # corner-row table (one row gather per query, 5x the grid's
        # memory) was slower on an H100: 0.41 vs 0.35 ms per 1M queries
        # on a (1024, 1024, 4) f32 grid.
        z11 = data[xi, yi]
        z12 = data[xi, yi + 1]
        z21 = data[xi + 1, yi]
        z22 = data[xi + 1, yi + 1]
        x1 = x[xi].astype(data.dtype)
        x2 = x[xi + 1].astype(data.dtype)
        y1 = y[yi].astype(data.dtype)
        y2 = y[yi + 1].astype(data.dtype)

        expand = xq.shape + (1,) * (data.ndim - 2)

        def e(v):
            return v.reshape(expand)

        # same lerp composition/order as bilinear.rs:88-97
        z1 = calc_frac(e(x1), z11, e(x2), z21, e(xq))
        z2 = calc_frac(e(x1), z12, e(x2), z22, e(xq))
        return calc_frac(e(y1), z1, e(y2), z2, e(yq))

    # -- calculus (beyond reference; SciPy-style surface) ---------------------
    def eval_derivative(self, interp, xq, yq, dx=0, dy=0):
        """Analytic partials of the bilinear surface: per-cell constant
        slopes along each axis, the mixed (1,1) twist term
        ``(z22 - z21 - z12 + z11)/(Δx·Δy)``, and identically zero for
        any order ≥ 2 (away from the grid lines, where the
        distributional derivative is undefined).  Plain 4-corner XLA
        gathers — the derivative path is not the hot eval route."""
        if dx not in (0, 1, 2, 3) or dy not in (0, 1, 2, 3):
            raise ValueError(
                f"derivative orders must be in 0..3; got dx={dx}, dy={dy}"
            )
        from ...ops.searchsorted import get_lower_index

        x, y, data = interp.x, interp.y, interp.data
        xi = get_lower_index(x, xq)
        yi = get_lower_index(y, yq)
        z11 = data[xi, yi]
        z12 = data[xi, yi + 1]
        z21 = data[xi + 1, yi]
        z22 = data[xi + 1, yi + 1]
        expand = xq.shape + (1,) * (data.ndim - 2)

        def e(v):
            return v.reshape(expand)

        x1, x2 = e(x[xi]), e(x[xi + 1])
        y1, y2 = e(y[yi]), e(y[yi + 1])
        dxv = x2 - x1
        dyv = y2 - y1
        if dx == 0 and dy == 0:
            z1 = calc_frac(x1, z11, x2, z21, e(xq))
            z2 = calc_frac(x1, z12, x2, z22, e(xq))
            return calc_frac(y1, z1, y2, z2, e(yq))
        if dx == 1 and dy == 0:
            return calc_frac(
                y1, (z21 - z11) / dxv, y2, (z22 - z12) / dxv, e(yq)
            )
        if dx == 0 and dy == 1:
            z1 = calc_frac(x1, z11, x2, z21, e(xq))
            z2 = calc_frac(x1, z12, x2, z22, e(xq))
            return (z2 - z1) / dyv
        if dx == 1 and dy == 1:
            return (z22 - z21 - z12 + z11) / (dxv * dyv)
        return jnp.zeros_like((z11 - z11) / dxv)  # any order >= 2

    def eval_integrate_box(self, interp, xlo, xhi, ylo, yhi):
        """Exact ``∫∫ z dx dy`` over ``[xlo,xhi]×[ylo,yhi]`` per
        trailing element: the per-axis integral weights of the
        tensor-product linear basis contracted against the data grid
        (the ``InterpND`` box-quadrature machinery at ``k=2``).  Signed
        per axis; extrapolating strategies integrate the extended edge
        cells."""
        from ..interpnd import _integrate_fn

        x, y = interp.x, interp.y
        # force an inexact type: integer grids (a supported eval path)
        # would otherwise truncate fractional bounds and crash in the
        # antiderivative-weight machinery (jnp.finfo on an int dtype)
        bt = jnp.result_type(x.dtype, y.dtype, jnp.float32)
        los = jnp.stack(
            [jnp.asarray(xlo).astype(bt), jnp.asarray(ylo).astype(bt)]
        )
        his = jnp.stack(
            [jnp.asarray(xhi).astype(bt), jnp.asarray(yhi).astype(bt)]
        )
        fn = _integrate_fn(2, None, "linear", self.extrapolates)
        data = interp.data
        if not jnp.issubdtype(data.dtype, jnp.inexact):
            data = data.astype(bt)
        return fn((x.astype(bt), y.astype(bt)), data, los, his)

    def tree_flatten(self):
        return (), (self.extrapolates,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        del children
        return cls(extrapolate=aux[0])

    def __repr__(self):
        return f"Bilinear(extrapolate={self.extrapolates})"
