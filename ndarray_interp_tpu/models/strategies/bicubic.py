"""Bicubic (tensor-product cubic spline) interpolation on a rectilinear
grid — a beyond-reference strategy (the reference crate ships only
``Bilinear``; its README lists more interpolators as planned).

A tensor-product not-a-knot cubic spline through ``data[(nx, ny, ...)]``
is, piecewise, a bicubic Hermite patch whose corner state is the value
plus the three spline derivative grids:

* ``kx``  — d/dx knot derivatives: one batched 1-D spline solve along
  axis 0 (the same tridiagonal machinery as ``CubicSpline``,
  ``cubic.py:_solve_for_k``),
* ``ky``  — d/dy: the solve along axis 1,
* ``kxy`` — the cross derivative: the y-solve applied to ``kx``.

Evaluation at ``(x, y)`` is then three 1-D Hermite evaluations in the
same symmetric form as the 1-D kernel (``cubic_spline.rs:818-828``):
interpolate ``f`` and ``ky`` along x at both bracketing y-knots (using
``kx``/``kxy`` as their x-derivatives), then Hermite along y.  Agrees
with SciPy's ``RegularGridInterpolator(method="cubic")`` (tensor
not-a-knot) to oracle tolerance — see ``tests/test_bicubic.py``.

Evaluation layout: the 16-corner state — derivatives PRE-SCALED by
their cell's interval widths, so the row needs no endpoint channels — is
packed into ONE gathered row per query.  Grids whose cell table would
exceed ``config.bicubic_pack_max_elems`` (~17x data memory) build a
memory-frugal node table instead (~4x, 4 corner gathers/query).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class

from .base2d import Interp2DStrategy, Interp2DStrategyBuilder
from .cubic import (
    _FIRST_DERIV,
    _NOT_A_KNOT,
    _SECOND_DERIV,
    _dense_build_ok,
    _dense_k,
    _solve_for_k,
    _solve_periodic_core,
    _validate_periodic_data,
)

# per-axis boundary kinds (a subset of the 1-D families that is uniform
# along the axis — per-row mixing has no tensor-product analogue)
_AXIS_KINDS = {
    "not_a_knot": (_NOT_A_KNOT, 0.0),
    "natural": (_SECOND_DERIV, 0.0),
    "clamped": (_FIRST_DERIV, 0.0),
    "periodic": None,
}


def _solve_axis0(x, grid, bc, validate=False):
    """Spline derivative solve along axis 0 with a named boundary kind.

    Off the CPU, wide grids on short axes take the dense-operator route
    (``cubic._dense_k``: the solve probed once on an identity bank,
    applied as one ``Precision.HIGHEST`` matmul — every axis kind here is
    uniform with zero payload, so the map is linear; see
    ``cubic._DENSE_BUILD_MAX_N``).  The CPU keeps the reference-order
    scan solver."""
    periodic = bc == "periodic"
    if periodic and validate:
        _validate_periodic_data(grid)
    kind, val = (0, 0.0) if periodic else _AXIS_KINDS[bc]
    n = x.shape[0]
    tsize = int(np.prod(grid.shape[1:])) if grid.ndim > 1 else 0
    if _dense_build_ok(n, tsize):
        return jax.lax.platform_dependent(
            x,
            grid,
            cpu=functools.partial(_k_xla, kind=kind, periodic=periodic),
            default=functools.partial(
                _dense_k, kind=kind, periodic=periodic
            ),
        )
    if periodic:
        return _solve_periodic_core(x, grid)
    return _solve_for_k(x, grid, kind, val, kind, val)


def _k_xla(x, grid, kind, periodic):
    """Non-dense twin of the per-axis k-solve (the CPU route)."""
    if periodic:
        return _solve_periodic_core(x, grid)
    return _solve_for_k(x, grid, kind, 0.0, kind, 0.0)


def _hermite(y_l, y_r, k_l, k_r, dx, t):
    """Value-derivative Hermite cubic in the symmetric reference form:
    a = k_l*dx - dy, b = -k_r*dx + dy (``cubic_spline.rs:350-367``)."""
    dy = y_r - y_l
    a = k_l * dx - dy
    b = dy - k_r * dx
    one = jnp.ones((), t.dtype)
    return (one - t) * y_l + t * y_r + t * (one - t) * (
        a * (one - t) + b * t
    )


def _solve_axis1(x, grid, bc="not_a_knot", validate=False):
    """Batched spline solve along axis 1 of (nx, ny, ...)."""
    moved = jnp.moveaxis(grid, 1, 0)  # (ny, nx, ...)
    k = _solve_axis0(x, moved, bc, validate=validate)
    return jnp.moveaxis(k, 0, 1)


def _hermite_scaled(y_l, y_r, K_l, K_r, t):
    """Hermite with pre-scaled derivatives ``K = k*dx``: the same
    symmetric form with ``a = K_l - dy``, ``b = dy - K_r`` — the dx
    multiply moved to pack time (identical arithmetic, the row then
    needs no interval endpoints)."""
    dy = y_r - y_l
    a = K_l - dy
    b = dy - K_r
    one = jnp.ones((), t.dtype)
    return (one - t) * y_l + t * y_r + t * (one - t) * (
        a * (one - t) + b * t
    )


def _hermite_scaled_d(y_l, y_r, K_l, K_r, t, order):
    """``d^order/dt^order`` of the scaled symmetric Hermite form
    (``order`` 0–3; the same analytic forms as the 1-D calculus,
    ``cubic.py:eval_derivative``).  ``order`` 0 is the value."""
    dy = y_r - y_l
    a = K_l - dy
    b = dy - K_r
    one = jnp.ones((), t.dtype)
    if order == 0:
        return (one - t) * y_l + t * y_r + t * (one - t) * (
            a * (one - t) + b * t
        )
    if order == 1:
        return (
            dy
            + (one - 2 * t) * (a * (one - t) + b * t)
            + t * (one - t) * (b - a)
        )
    if order == 2:
        return a * (6 * t - 4) + b * (2 - 6 * t)
    return (6 * (a - b)) + 0.0 * t  # order 3: piecewise constant


def _cell_tail_nested_d(g, tx, ty, r, ox, oy):
    """Partial-derivative variant of :func:`_cell_tail_nested`: the
    nested tensor-product Hermite is linear in its corner state, so
    ``∂^{ox+oy}/∂tx^ox ∂ty^oy`` is the same nesting with the inner
    x-Hermites at order ``ox`` and the outer y-Hermite at order ``oy``
    (the caller divides by ``dx^ox · dy^oy`` to land in coordinate
    units).  Not the hot eval path — kept separate so the perf-pinned
    order-(0,0) tail stays untouched."""

    def block(i):
        base = 4 * r * i
        return tuple(
            g[:, base + c * r : base + (c + 1) * r] for c in range(4)
        )

    f11, f12, f21, f22 = block(0)
    kx11, kx12, kx21, kx22 = block(1)
    ky11, ky12, ky21, ky22 = block(2)
    kxy11, kxy12, kxy21, kxy22 = block(3)
    f_y1 = _hermite_scaled_d(f11, f21, kx11, kx21, tx, ox)
    f_y2 = _hermite_scaled_d(f12, f22, kx12, kx22, tx, ox)
    g_y1 = _hermite_scaled_d(ky11, ky21, kxy11, kxy21, tx, ox)
    g_y2 = _hermite_scaled_d(ky12, ky22, kxy12, kxy22, tx, ox)
    return _hermite_scaled_d(f_y1, f_y2, g_y1, g_y2, ty, oy)


def _cell_tail_nested(g, tx, ty, r):
    """Nested scaled-Hermite tail on flat gathered cell rows ``(Q, 16r)``
    with ``tx``/``ty`` of shape ``(Q, 1)`` — the reference-ordered
    arithmetic of the cell layout (elementwise identical to evaluating
    on query-shaped arrays)."""

    def block(i):  # corner quantity i, corners [11, 12, 21, 22]
        base = 4 * r * i
        return tuple(
            g[:, base + c * r : base + (c + 1) * r] for c in range(4)
        )

    f11, f12, f21, f22 = block(0)
    kx11, kx12, kx21, kx22 = block(1)
    ky11, ky12, ky21, ky22 = block(2)
    kxy11, kxy12, kxy21, kxy22 = block(3)
    # interpolate f and ky*dy along x at both bracketing y-knots
    # (kx*dx and kxy*dx*dy supply their pre-scaled x-derivatives),
    # then Hermite along y
    f_y1 = _hermite_scaled(f11, f21, kx11, kx21, tx)
    f_y2 = _hermite_scaled(f12, f22, kx12, kx22, tx)
    g_y1 = _hermite_scaled(ky11, ky21, kxy11, kxy21, tx)
    g_y2 = _hermite_scaled(ky12, ky22, kxy12, kxy22, tx)
    return _hermite_scaled(f_y1, f_y2, g_y1, g_y2, ty)


def _index_frac(knots, q):
    """``(get_lower_index(q), t)`` with the ``calc_frac`` operand order
    (``t = (q - x_l) / (x_r - x_l)``)."""
    from ...ops.searchsorted import get_lower_index

    idx = get_lower_index(knots, q)
    x_l = knots[idx]
    x_r = knots[idx + 1]
    return idx, (q - x_l) / (x_r - x_l)


def bicubic_node_grids(x, y, data, bc_x="not_a_knot", bc_y="not_a_knot"):
    """The bicubic node state ``(kx, ky, kxy)`` for ``data[(nx, ny, ...)]``
    — the same batched spline solves ``Bicubic.build`` runs (d/dx along
    axis 0, d/dy along axis 1, and the y-solve applied to ``kx`` for the
    cross derivative).  Public so callers feeding the native host path
    (``native.eval_bicubic``) or custom packers build the grids in ONE
    place instead of re-deriving the solve order."""
    kx = _solve_axis0(x, data, bc_x)
    ky = _solve_axis1(y, data, bc_y)
    kxy = _solve_axis1(y, kx, bc_y)
    return kx, ky, kxy


def pack_bicubic_rows(x, y, data, kx, ky, kxy):
    """Per-cell rows: the 16-value corner state (4 quantities x 4
    corners, trailing-flattened) with derivatives PRE-SCALED by their
    cell's interval widths (``kx*dx``, ``ky*dy``, ``kxy*dx*dy``) —
    everything one query needs in ONE gathered row, with no endpoint
    channels (``t`` comes from the bucketize pass): 16r channels."""
    nx, ny = data.shape[0], data.shape[1]
    r = 1
    for s in data.shape[2:]:
        r *= s
    dx = (x[1:] - x[:-1]).astype(data.dtype).reshape(nx - 1, 1, 1)
    dy = (y[1:] - y[:-1]).astype(data.dtype).reshape(1, ny - 1, 1)

    def corners(g):
        return jnp.stack(
            [g[:-1, :-1], g[:-1, 1:], g[1:, :-1], g[1:, 1:]], axis=2
        ).reshape(nx - 1, ny - 1, 4 * r)

    blocks = [
        corners(data),
        corners(kx) * dx,
        corners(ky) * dy,
        corners(kxy) * dx * dy,
    ]
    return jnp.concatenate(blocks, axis=-1).reshape(
        (nx - 1) * (ny - 1), 16 * r
    )


def pack_bicubic_nodes(x, y, data, kx, ky, kxy):
    """Memory-frugal node table ``(nx*ny, 4r+2)``: the raw (unscaled)
    corner state ``[f | kx | ky | kxy]`` plus the node's own ``(x, y)``
    — 4 corner-row gathers per query instead of 1 cell-row gather, but
    ~4x the data's memory instead of ~17x (the per-cell table stores
    every interior node 4 times).  Used when the cell table would exceed
    ``config.bicubic_pack_max_elems``."""
    nx, ny = data.shape[0], data.shape[1]
    r = 1
    for s in data.shape[2:]:
        r *= s
    flat = [g.reshape(nx, ny, r) for g in (data, kx, ky, kxy)]
    coords = jnp.stack(
        [
            jnp.broadcast_to(x[:, None], (nx, ny)),
            jnp.broadcast_to(y[None, :], (nx, ny)),
        ],
        axis=-1,
    ).astype(data.dtype)
    return jnp.concatenate(flat + [coords], axis=-1).reshape(
        nx * ny, 4 * r + 2
    )


@register_pytree_node_class
class Bicubic(Interp2DStrategy, Interp2DStrategyBuilder):
    """Tensor-product cubic spline (builder form).

    Chainable configuration like the other strategies::

        Bicubic()                                # NAK, no extrapolation
        Bicubic().extrapolate(True)
        Bicubic().boundary("natural", "clamped")  # per-axis families
        Bicubic().boundary("periodic", "not_a_knot")

    Per-axis boundary kinds: ``not_a_knot`` (default), ``natural``,
    ``clamped``, ``periodic`` (requires ``data[0] == data[-1]`` along
    that axis; queries wrap on it, mirroring the 1-D
    ``Extrapolate::Periodic`` contract ``cubic_spline.rs:804-809``).
    """

    MINIMUM_DATA_LENGTH = 3  # cubic needs 3 knots per axis (NAK parabola)

    def __init__(
        self,
        extrapolate: bool = False,
        bc_x: str = "not_a_knot",
        bc_y: str = "not_a_knot",
    ):
        for bc in (bc_x, bc_y):
            if bc not in _AXIS_KINDS:
                raise ValueError(
                    f"unknown bicubic boundary kind {bc!r}; choose from "
                    f"{sorted(_AXIS_KINDS)}"
                )
        self.extrapolates = bool(extrapolate)
        self.bc_x = bc_x
        self.bc_y = bc_y

    def extrapolate(self, yes: bool = True) -> "Bicubic":
        return Bicubic(extrapolate=yes, bc_x=self.bc_x, bc_y=self.bc_y)

    def boundary(self, bc_x: str, bc_y: str = None) -> "Bicubic":
        """Per-axis boundary families (``bc_y`` defaults to ``bc_x``)."""
        return Bicubic(
            extrapolate=self.extrapolates,
            bc_x=bc_x,
            bc_y=bc_x if bc_y is None else bc_y,
        )

    def build(self, x, y, data):
        from ... import config

        # periodic axes validate data[0] == data[-1] eagerly (the check is
        # data-dependent, so jit builds skip it — new_unchecked semantics)
        kx = _solve_axis0(x, data, self.bc_x, validate=True)
        ky = _solve_axis1(y, data, self.bc_y, validate=True)
        # cross derivative: the y-solve applied to kx.  For periodic y the
        # kx columns inherit data's first==last equality, so the same
        # solve applies (validation already ran on data itself).
        kxy = _solve_axis1(y, kx, self.bc_y)
        r = 1
        for s in data.shape[2:]:
            r *= s
        cell_elems = (data.shape[0] - 1) * (data.shape[1] - 1) * 16 * r
        if cell_elems <= config.bicubic_pack_max_elems:
            rows = pack_bicubic_rows(x, y, data, kx, ky, kxy)
            mode = "cell"
        else:
            rows = pack_bicubic_nodes(x, y, data, kx, ky, kxy)
            mode = "node"
        return BicubicStrategy(
            rows,
            self.extrapolates,
            bc_x=self.bc_x,
            bc_y=self.bc_y,
            layout=mode,
        )

    def eval(self, interp, xq, yq):  # pragma: no cover - builder never eval'd
        return self.build(interp.x, interp.y, interp.data).eval(
            interp, xq, yq
        )

    def tree_flatten(self):
        return (), (self.extrapolates, self.bc_x, self.bc_y)

    @classmethod
    def tree_unflatten(cls, aux, children):
        del children
        return cls(extrapolate=aux[0], bc_x=aux[1], bc_y=aux[2])

    def __repr__(self):
        return (
            f"Bicubic(extrapolate={self.extrapolates}, "
            f"bc_x={self.bc_x!r}, bc_y={self.bc_y!r})"
        )


@register_pytree_node_class
class BicubicStrategy(Interp2DStrategy):
    """Finished bicubic strategy: packed per-cell corner-state rows."""

    MINIMUM_DATA_LENGTH = 3

    def __init__(
        self,
        rows,
        extrapolate: bool = False,
        bc_x: str = "not_a_knot",
        bc_y: str = "not_a_knot",
        layout: str = "cell",
    ):
        self.rows = rows
        self.extrapolates = bool(extrapolate)
        self.bc_x = bc_x
        self.bc_y = bc_y
        self.layout = layout  # "cell" (1 gather) | "node" (memory-frugal)

    @property
    def wraps_x(self):
        """Queries wrap (rem_euclid) on a periodic x axis — never OOB."""
        return self.bc_x == "periodic"

    @property
    def wraps_y(self):
        return self.bc_y == "periodic"

    def eval(self, interp, xq, yq):
        x, y, data = interp.x, interp.y, interp.data
        if self.wraps_x:  # rem_euclid wrap, cubic_spline.rs:804-809
            xq = jnp.mod(xq - x[0], x[-1] - x[0]) + x[0]
        if self.wraps_y:
            yq = jnp.mod(yq - y[0], y[-1] - y[0]) + y[0]
        trailing = data.shape[2:]
        xi, tx = _index_frac(x, xq)
        yi, ty = _index_frac(y, yq)
        expand = xq.shape + (1,) * len(trailing)
        if self.layout == "cell":
            return self._eval_cell(
                data, xi, yi, tx.reshape(expand), ty.reshape(expand),
                xq.shape,
            )
        return self._eval_node(
            data, xi, yi, tx.reshape(expand), ty.reshape(expand), xq.shape
        )

    def _eval_cell(self, data, xi, yi, tx, ty, qshape):
        """ONE pre-scaled 16r-channel row gather + nested Hermite tail."""
        ny = data.shape[1]
        trailing = data.shape[2:]
        r = 1
        for s in trailing:
            r *= s
        out_shape = qshape + trailing
        cell = (xi * (ny - 1) + yi).reshape(-1)
        out = _cell_tail_nested(
            jnp.take(self.rows, cell, axis=0),
            tx.reshape(-1)[:, None], ty.reshape(-1)[:, None], r,
        )
        return out.reshape(out_shape)

    def _eval_node(self, data, xi, yi, tx, ty, qshape):
        """Memory-frugal route: 4 corner gathers from the node table."""
        ny = data.shape[1]
        trailing = data.shape[2:]
        r = 1
        for s in trailing:
            r *= s
        out_shape = qshape + trailing
        expand = qshape + (1,) * len(trailing)

        def node(ix, iy):
            g = jnp.take(self.rows, ix * ny + iy, axis=0)  # (Q, 4r+2)
            return (
                g[:, 0 * r : 1 * r].reshape(out_shape),  # f
                g[:, 1 * r : 2 * r].reshape(out_shape),  # kx
                g[:, 2 * r : 3 * r].reshape(out_shape),  # ky
                g[:, 3 * r : 4 * r].reshape(out_shape),  # kxy
                g[:, 4 * r + 0].reshape(expand),  # x_node
                g[:, 4 * r + 1].reshape(expand),  # y_node
            )

        f11, kx11, ky11, kxy11, x1, y1 = node(xi, yi)
        f12, kx12, ky12, kxy12, _, y2 = node(xi, yi + 1)
        f21, kx21, ky21, kxy21, x2, _ = node(xi + 1, yi)
        f22, kx22, ky22, kxy22, _, _ = node(xi + 1, yi + 1)
        dx = x2 - x1
        dy = y2 - y1
        f_y1 = _hermite(f11, f21, kx11, kx21, dx, tx)
        f_y2 = _hermite(f12, f22, kx12, kx22, dx, tx)
        ky_y1 = _hermite(ky11, ky21, kxy11, kxy21, dx, tx)
        ky_y2 = _hermite(ky12, ky22, kxy12, kxy22, dx, tx)
        return _hermite(f_y1, f_y2, ky_y1, ky_y2, dy, ty)

    # -- calculus (beyond reference; SciPy RectBivariateSpline.ev surface) ----
    def eval_derivative(self, interp, xq, yq, dx=0, dy=0):
        """Analytic ``∂^{dx+dy} z / ∂x^dx ∂y^dy`` of the tensor-product
        spline (orders 0–3 per axis; order 3 is piecewise constant).
        The nested Hermite is linear in the corner state, so the partial
        is the same nesting with each axis's Hermite at its order,
        divided by the cell widths ``dx_cell^dx · dy_cell^dy``
        (pre-scaled rows live in t-space).  Both layouts supported;
        periodic axes wrap like ``eval``."""
        if dx not in (0, 1, 2, 3) or dy not in (0, 1, 2, 3):
            raise ValueError(
                f"derivative orders must be in 0..3; got dx={dx}, dy={dy}"
            )
        x, y, data = interp.x, interp.y, interp.data
        if self.wraps_x:
            xq = jnp.mod(xq - x[0], x[-1] - x[0]) + x[0]
        if self.wraps_y:
            yq = jnp.mod(yq - y[0], y[-1] - y[0]) + y[0]
        ny = data.shape[1]
        trailing = data.shape[2:]
        r = 1
        for s in trailing:
            r *= s
        out_shape = xq.shape + trailing
        xi, tx = _index_frac(x, xq)
        yi, ty = _index_frac(y, yq)
        xif = xi.reshape(-1)
        yif = yi.reshape(-1)
        txf = tx.reshape(-1)[:, None]
        tyf = ty.reshape(-1)[:, None]
        dxg = (x[xif + 1] - x[xif]).astype(data.dtype)[:, None]
        dyg = (y[yif + 1] - y[yif]).astype(data.dtype)[:, None]
        if self.layout == "cell":
            g = jnp.take(self.rows, xif * (ny - 1) + yif, axis=0)
        else:
            # assemble the scaled 16r cell row from 4 node gathers
            # (channel order matches pack_bicubic_rows: quantity-major,
            # corners [11, 12, 21, 22])
            def node(ix, iy):
                gg = jnp.take(self.rows, ix * ny + iy, axis=0)
                return [gg[:, i * r : (i + 1) * r] for i in range(4)]

            n11 = node(xif, yif)
            n12 = node(xif, yif + 1)
            n21 = node(xif + 1, yif)
            n22 = node(xif + 1, yif + 1)
            corners = (n11, n12, n21, n22)
            scales = (1.0, dxg, dyg, dxg * dyg)
            g = jnp.concatenate(
                [c[i] * scales[i] for i in range(4) for c in corners],
                axis=-1,
            )
        out = _cell_tail_nested_d(g, txf, tyf, r, dx, dy)
        return (out / (dxg**dx * dyg**dy)).reshape(out_shape)

    def eval_integrate_box(self, interp, xlo, xhi, ylo, yhi):
        """Exact ``∫∫ z dx dy`` of the bicubic surface over
        ``[xlo,xhi]×[ylo,yhi]`` per trailing element: per-axis Hermite
        antiderivative weights contracted against the four
        mixed-derivative node grids (the ``InterpND`` box-quadrature
        machinery at ``k=2``; the grids re-solve from ``data`` — the
        build-cost path, not the hot eval route).  Signed per axis;
        extrapolation extends the edge cells; periodic axes are
        unsupported (wrap-around boxes are ambiguous)."""
        if self.wraps_x or self.wraps_y:
            raise ValueError(
                "integrate() does not support periodic axes"
            )
        from ..interpnd import _integrate_fn

        x, y = interp.x, interp.y
        # force an inexact type (integer grids are a supported eval path;
        # see the matching promotion in Bilinear.eval_integrate_box)
        bt = jnp.result_type(x.dtype, y.dtype, jnp.float32)
        los = jnp.stack(
            [jnp.asarray(xlo).astype(bt), jnp.asarray(ylo).astype(bt)]
        )
        his = jnp.stack(
            [jnp.asarray(xhi).astype(bt), jnp.asarray(yhi).astype(bt)]
        )
        fn = _integrate_fn(
            2, (self.bc_x, self.bc_y), "cubic", self.extrapolates
        )
        data = interp.data
        if not jnp.issubdtype(data.dtype, jnp.inexact):
            data = data.astype(bt)
        return fn(
            (x.astype(bt), y.astype(bt)), data, los, his
        )

    def tree_flatten(self):
        return (self.rows,), (
            self.extrapolates, self.bc_x, self.bc_y, self.layout,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(
            children[0], extrapolate=aux[0], bc_x=aux[1], bc_y=aux[2],
            layout=aux[3],
        )

    def __repr__(self):
        return (
            f"BicubicStrategy(rows={getattr(self.rows, 'shape', None)}, "
            f"extrapolate={self.extrapolates}, bc_x={self.bc_x!r}, "
            f"bc_y={self.bc_y!r}, layout={self.layout!r})"
        )
