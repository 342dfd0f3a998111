"""N-dimensional rectilinear-grid interpolation (beyond the reference).

The reference crate stops at two interpolated axes
(``/root/reference/src/interp2d/mod.rs:29-32``); this module covers the
leading-``k``-axes case with the SciPy ``RegularGridInterpolator``
surface (methods ``"linear"``, ``"nearest"``, and ``"cubic"`` — the
tensor-product C² cubic spline, with per-axis boundary families) so its
users can switch.  The driver conventions carry over from the 1-D/2-D drivers:
query dims leading with output dims ``M + N - k``
(``mod.rs:175-211``), matching query shapes enforced, OOB raises
eagerly / masks to NaN in the pure jittable path (docs/PARITY.md D1),
extrapolation extends the edge cells.

Design: per-axis clamped bucketize (the shared searchsorted op), then
ONE row gather per query: the builder packs a per-cell corner table
(all ``2^k`` corner blocks contiguous per cell), so evaluation is a single
``jnp.take`` of ``2^k·r``-channel rows plus a multiplicative-weight
full reduce.  Grids whose table would exceed
``config.interpnd_pack_max_elems`` (the table is ``2^k``× the data's
memory) fall back to the unpacked ``2^k``-corner gather.  Everything is
static-shape, jittable, and vmappable; queries shard trivially over a
mesh (each query touches only its own cell).
"""

from __future__ import annotations

import functools
import itertools

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
from ..ops.searchsorted import is_in_range
from ..utils.monotonic import monotonic_prop
from .interp1d import _host_view, _is_traced
from .strategies.bicubic import _AXIS_KINDS, _index_frac, _solve_axis0

_METHODS = ("linear", "nearest", "cubic")
_BCS = tuple(_AXIS_KINDS)  # not_a_knot / natural / clamped / periodic


def pack_corner_rows_nd(data, k):
    """Per-cell packed rows: the ``2^k`` corner blocks of each cell laid
    out contiguously (corner-major, each block ``r = prod(trailing)``
    channels, in :func:`itertools.product` corner order — the weight
    order of the eval).  One row gather then feeds the whole
    multilinear blend; the :func:`~..strategies.bilinear.pack_corner_rows`
    idiom generalized to ``k`` axes (no endpoint channels — ``t`` comes
    from the bucketize pass)."""
    grid = data.shape[:k]
    trailing = data.shape[k:]
    r = 1
    for s in trailing:
        r *= s
    cells = tuple(n - 1 for n in grid)
    ncells = 1
    for c in cells:
        ncells *= c
    blocks = [
        data[
            tuple(slice(1, None) if d else slice(None, -1) for d in c)
        ].reshape(cells + (r,))
        for c in itertools.product((0, 1), repeat=k)
    ]
    table = jnp.stack(blocks, axis=k)  # cells + (2^k, r)
    return table.reshape(ncells, (2**k) * r)


def _linear_basis_d(t, order):
    """Per-axis multilinear basis ``[w_left, w_right]`` at t-derivative
    ``order`` (0: ``[1-t, t]``; 1: ``[-1, 1]``; ≥2: zeros — the blend
    is affine per cell)."""
    one = jnp.ones_like(t)
    if order == 0:
        return [one - t, t]
    if order == 1:
        return [-one, one]
    z = jnp.zeros_like(t)
    return [z, z]


def _corner_weights(ts, k, orders=None):
    """(Q, 2^k) multilinear weights in ``itertools.product`` corner
    order (matches :func:`pack_corner_rows_nd`'s block order);
    ``orders`` selects the per-axis basis t-derivative (the ``1/dx``
    chain factors are applied by the caller)."""
    orders = orders or (0,) * k
    bases = [_linear_basis_d(t, o) for t, o in zip(ts, orders)]
    w = []
    for c in itertools.product((0, 1), repeat=k):
        wc = bases[0][c[0]]
        for d in range(1, k):
            wc = wc * bases[d][c[d]]
        w.append(wc)
    return jnp.stack(w, axis=-1)


def _dx_chain_factor(axes, idx, orders, dtype):
    """``∏_d dx_d^{-o_d}`` per query — the chain-rule factor turning
    t-derivatives into x-derivatives (``None`` when all orders are 0)."""
    f = None
    for d, o in enumerate(orders):
        if o:
            dx = (axes[d][idx[d] + 1] - axes[d][idx[d]]).astype(dtype)
            g = dx ** (-o)
            f = g if f is None else f * g
    return f


def interpnd_node_grids(axes, data, k, bcs):
    """All ``2^k`` mixed-derivative node grids of the tensor-product
    cubic spline: ``grids[mask]`` (bit ``d`` ↔ axis ``d``) holds
    ``∂^{|mask|} data / ∏_{d∈mask} ∂x_d`` at the grid nodes, computed
    by the batched 1-D spline solve applied along each axis in
    ascending order (``bicubic_node_grids``' ``kxy = solve_y(kx)``
    composition generalized; the tensor-product interpolant is
    axis-order independent)."""
    grids = {0: data}
    for d in range(k):
        for e in sorted(grids):
            g = grids[e]
            moved = jnp.moveaxis(g, d, 0)
            kd = _solve_axis0(axes[d], moved, bcs[d])
            grids[e | (1 << d)] = jnp.moveaxis(kd, 0, d)
    return grids


def _cubic_digit_channels(k):
    """Static channel enumeration for the cubic routes: one base-4
    digit per axis (axis 0 most significant), ``digit = 2*deriv +
    side``.  Matches the weight order of :func:`_cubic_weights`."""
    return list(itertools.product(range(4), repeat=k))


def pack_cubic_rows_nd(axes, data, k, grids):
    """Per-cell packed rows for the tensor-product cubic: the full
    ``4^k``-quantity corner state (every mixed derivative at every
    corner, trailing-flattened) with derivatives PRE-SCALED by their
    cell's interval widths — ONE gathered row feeds the whole
    ``k``-fold Hermite blend (``pack_bicubic_rows`` generalized; no
    endpoint channels, ``t`` comes from the bucketize pass)."""
    grid = data.shape[:k]
    trailing = data.shape[k:]
    r = 1
    for s in trailing:
        r *= s
    cells = tuple(n - 1 for n in grid)
    ncells = 1
    for c in cells:
        ncells *= c
    dxs = [
        (ax[1:] - ax[:-1]).astype(data.dtype) for ax in axes
    ]  # (n_d - 1,)
    blocks = []
    for digits in _cubic_digit_channels(k):
        mask = 0
        for d, dig in enumerate(digits):
            if dig >= 2:
                mask |= 1 << d
        sl = tuple(slice(1, None) if dig & 1 else slice(None, -1)
                   for dig in digits)
        block = grids[mask][sl].reshape(cells + (r,))
        for d, dig in enumerate(digits):
            if dig >= 2:
                shape = [1] * (k + 1)
                shape[d] = cells[d]
                block = block * dxs[d].reshape(shape)
        blocks.append(block)
    table = jnp.stack(blocks, axis=k)  # cells + (4^k, r)
    return table.reshape(ncells, (4**k) * r)


def pack_cubic_nodes_nd(axes, data, k, grids, pairs=0):
    """Memory-frugal node table ``(prod(n), 2^m·2^k·r + k + m)``: the
    raw (unscaled) mixed-derivative state per node plus the node's own
    coordinates — ``2^(k-m)`` corner-row gathers per query instead of 1
    cell-row gather, at ``~2^m·2^k``× the data's memory instead of
    ``~4^k``× (``pack_bicubic_nodes`` generalized).  State block order
    = subset masks ascending (mask bit ``d`` ↔ axis ``d``).

    ``pairs`` = m: the node's row additionally carries the state of its
    ``2^m - 1`` neighbors along the LAST m axes (edge nodes duplicate —
    those rows are never the base of a gather) plus the m next-node
    coordinates: 2× memory per pairing level for half the gathers.  On
    an H100 the pairing gained 0-15% at 128³×1 and 64³×4, inside the
    spread between runs, so the automatic choice never picks it; it
    stays available as a forced layout.  Row layout: ``2^m`` state
    blocks (neighbor offsets in
    ``itertools.product`` order over the last m axes), k own coords,
    m next coords."""
    grid = data.shape[:k]
    trailing = data.shape[k:]
    m = pairs
    r = 1
    for s in trailing:
        r *= s
    nnodes = 1
    for n in grid:
        nnodes *= n
    state = jnp.concatenate(
        [grids[e].reshape(grid + (r,)) for e in range(2**k)], axis=-1
    )  # grid + (2^k * r,)

    def shift_edge(g, axis):
        n = g.shape[axis]
        return jnp.concatenate(
            [
                jax.lax.slice_in_dim(g, 1, n, axis=axis),
                jax.lax.slice_in_dim(g, n - 1, n, axis=axis),
            ],
            axis=axis,
        )

    blocks = []
    for delta in itertools.product((0, 1), repeat=m):
        g = state
        for j, bit in enumerate(delta):
            if bit:
                g = shift_edge(g, k - m + j)
        blocks.append(g)
    coords = jnp.meshgrid(
        *[ax.astype(data.dtype) for ax in axes], indexing="ij"
    )
    blocks += [c[..., None] for c in coords]
    for j in range(m):
        blocks.append(shift_edge(coords[k - m + j], k - m + j)[..., None])
    return jnp.concatenate(blocks, axis=-1).reshape(
        nnodes, (2**m) * (2**k) * r + k + m
    )


def _linear_antider(t):
    """Antiderivatives ``[B0, B1]`` of the multilinear basis
    ``[1-t, t]``."""
    return [t - 0.5 * t * t, 0.5 * t * t]


def _cubic_antider(t):
    """Antiderivatives ``[H00, H01, H10, H11]`` of the Hermite basis
    (:func:`_cubic_basis`, order 0)."""
    t2 = t * t
    t3 = t2 * t
    t4 = t2 * t2
    return [
        0.5 * t4 - t3 + t,
        t3 - 0.5 * t4,
        0.25 * t4 - (2.0 / 3.0) * t3 + 0.5 * t2,
        0.25 * t4 - t3 / 3.0,
    ]


def _axis_integral_weights(x, lo, hi, method, extrapolate):
    """Per-cell integral weights for one axis: ``W[i, digit] =
    dx_i^{1+deriv} · (H_digit(t1_i) − H_digit(t0_i))`` over the
    overlap of ``[lo, hi]`` with cell ``i`` (exact polynomial
    quadrature — the 1-D ``integrate`` machinery per axis).  When
    extrapolating, the edge cells' polynomials extend beyond the
    domain (no clip at the outer faces)."""
    dx = x[1:] - x[:-1]
    nc = dx.shape[0]
    t0 = (lo - x[:-1]) / dx
    t1 = (hi - x[:-1]) / dx
    i = jnp.arange(nc)
    big = jnp.asarray(jnp.finfo(x.dtype).max, x.dtype)
    lo_clip = jnp.where(
        (i == 0) & extrapolate, -big, jnp.zeros((), x.dtype)
    )
    hi_clip = jnp.where(
        (i == nc - 1) & extrapolate, big, jnp.ones((), x.dtype)
    )
    t0c = jnp.clip(t0, lo_clip, hi_clip)
    t1c = jnp.clip(t1, lo_clip, hi_clip)
    anti = _cubic_antider if method == "cubic" else _linear_antider
    h0 = anti(t0c)
    h1 = anti(t1c)
    if method == "cubic":
        cols = [
            dx * (h1[0] - h0[0]),
            dx * (h1[1] - h0[1]),
            dx * dx * (h1[2] - h0[2]),  # deriv channels: raw k · dx^2
            dx * dx * (h1[3] - h0[3]),
        ]
    else:
        cols = [dx * (h1[0] - h0[0]), dx * (h1[1] - h0[1])]
    return jnp.stack(cols, axis=-1)  # (n-1, nb)


def _axis_node_weights(w, deriv):
    """Scatter per-cell side weights onto nodes: node ``m`` collects
    the left-side weight of cell ``m`` and the right-side weight of
    cell ``m−1``."""
    z = jnp.zeros((1,), w.dtype)
    left = jnp.concatenate([w[:, 2 * deriv + 0], z])
    right = jnp.concatenate([z, w[:, 2 * deriv + 1]])
    return left + right  # (n,)


@functools.lru_cache(maxsize=None)
def _integrate_fn(k, bcs, method, extrapolate):
    """Jitted exact box integral over ``k`` axes: per-axis integral
    weights contracted against the (mixed-derivative) node grids —
    ``2^k`` tensor contractions, no sampling."""

    def fn(axes, data, los, his):
        if method == "cubic":
            grids = interpnd_node_grids(axes, data, k, bcs)
        else:
            grids = {0: data}
        ws = [
            _axis_integral_weights(
                ax, los[d], his[d], method, extrapolate
            )
            for d, ax in enumerate(axes)
        ]
        out = None
        for mask in sorted(grids):
            g = grids[mask]
            for d in reversed(range(k)):
                u = _axis_node_weights(ws[d], (mask >> d) & 1)
                # promote instead of casting weights down (int data)
                dt = jnp.result_type(g.dtype, u.dtype)
                g = jnp.tensordot(
                    g.astype(dt), u.astype(dt), axes=([d], [0])
                )
            out = g if out is None else out + g
        return out

    return jax.jit(fn)


# pairing degree m per cubic table layout (gathers per query = 2^(k-m))
_NODE_PAIRS = {"node": 0, "node2": 1, "node4": 2}


@functools.lru_cache(maxsize=None)
def _cubic_pack_fn(k, bcs, layout):
    """Jitted (and cached per ``(k, bcs, layout)``) cubic state
    derivation: the ``2^k`` mixed-derivative solves + the pack."""

    def fn(axes, data):
        grids = interpnd_node_grids(axes, data, k, bcs)
        if layout == "cell":
            return pack_cubic_rows_nd(axes, data, k, grids)
        return pack_cubic_nodes_nd(
            axes, data, k, grids, pairs=_NODE_PAIRS[layout]
        )

    return jax.jit(fn)


def _cubic_basis(t, order=0):
    """(Q, 4) Hermite basis ``[h00, h01, h10, h11]`` (or its
    ``order``-th t-derivative, orders 0–3; >3 is zero) for pre-scaled
    derivatives (``K = k·dx``): the weight form of the symmetric
    reference Hermite (``cubic_spline.rs:818-828`` expanded in the
    corner state — identical interpolant, the per-axis-separable op
    order the tensor blend needs)."""
    one = jnp.ones((), t.dtype)
    if order == 0:
        omt = one - t
        cols = (
            omt * omt * (one + 2 * t),
            t * t * (3 * one - 2 * t),
            t * omt * omt,
            -t * t * omt,
        )
    elif order == 1:
        cols = (
            6 * t * t - 6 * t,
            6 * t - 6 * t * t,
            3 * t * t - 4 * t + one,
            3 * t * t - 2 * t,
        )
    elif order == 2:
        cols = (12 * t - 6, 6 - 12 * t, 6 * t - 4, 6 * t - 2)
    elif order == 3:
        z12 = jnp.full_like(t, 12.0)
        cols = (z12, -z12, jnp.full_like(t, 6.0), jnp.full_like(t, 6.0))
    else:
        z = jnp.zeros_like(t)
        cols = (z, z, z, z)
    return jnp.stack(jnp.broadcast_arrays(*cols), axis=-1)


def _cubic_weights(ts, k, orders=None):
    """(Q, 4^k) tensor-product Hermite weights in
    :func:`_cubic_digit_channels` order (axis 0 most significant,
    per-axis digit ``2*deriv + side``); ``orders`` selects per-axis
    basis t-derivatives (``1/dx`` chain factors applied by the
    caller)."""
    orders = orders or (0,) * k
    w = jnp.ones(ts[0].shape + (1,), ts[0].dtype)
    for t, o in zip(ts, orders):
        b = _cubic_basis(t, o)  # (Q, 4)
        w = (w[:, :, None] * b[:, None, :]).reshape(w.shape[0], -1)
    return w


def _eval_cubic(interp, idx, ts, trailing, orders=None):
    """Tensor-product cubic eval given per-axis ``(idx, t)``: one
    packed cell-row gather (cell layout) or ``2^k`` node-row gathers
    (node layout).  ``orders`` evaluates the mixed partial
    ``∂^{Σo} / ∏ ∂x_d^{o_d}`` instead (per-axis basis derivative +
    ``1/dx`` chain factors)."""
    k = interp.k
    grid = interp.data.shape[:k]
    r = 1
    for s in trailing:
        r *= s
    q = idx[0].shape[0]
    w = _cubic_weights(ts, k, orders)  # (Q, 4^k)
    if orders is not None:
        f = _dx_chain_factor(interp.axes, idx, orders, w.dtype)
        if f is not None:
            w = w * f[:, None]

    if interp.layout == "cell":
        cstrides = [1] * k
        for d in range(k - 2, -1, -1):
            cstrides[d] = cstrides[d + 1] * (grid[d + 1] - 1)
        cell = sum(i * s for i, s in zip(idx, cstrides))
        rows = jnp.take(interp.table, cell, axis=0)  # (Q, 4^k * r)
        rows = rows.reshape(q, 4**k, r)
        out = jnp.sum(rows * w[:, :, None], axis=1)
        return out.reshape((q,) + trailing)

    # node layouts: 2^(k-m) corner gathers of raw
    # (2^m·2^k·r + k + m)-channel rows; m = pairing over the last m
    # axes ("node" 0, "node2" 1, "node4" 2 — see pack_cubic_nodes_nd).
    # The blend accumulates in the SAME (s_corner, mask) order with the
    # same values for every m, so all node layouts are bit-identical.
    m = _NODE_PAIRS[interp.layout]
    sb = (2**k) * r  # one state block
    cbase = (2**m) * sb  # coordinate channels start
    nstrides = [1] * k
    for d in range(k - 2, -1, -1):
        nstrides[d] = nstrides[d + 1] * grid[d + 1]
    base = sum(i * s for i, s in zip(idx, nstrides))
    corner_rows = {}
    for s_low in itertools.product((0, 1), repeat=k - m):
        off = sum(d * st for d, st in zip(s_low, nstrides[: k - m]))
        corner_rows[s_low] = jnp.take(interp.table, base + off, axis=0)
    # interval widths from the coordinate channels: gathered axes from
    # the all-ones corner row, paired axes from the stored next-node
    # coordinate of the base row
    lo = corner_rows[(0,) * (k - m)]
    hi = corner_rows[(1,) * (k - m)]
    dxs = [
        (hi[:, cbase + d] - lo[:, cbase + d])[:, None]
        for d in range(k - m)
    ] + [
        (lo[:, cbase + k + j] - lo[:, cbase + (k - m) + j])[:, None]
        for j in range(m)
    ]
    out = jnp.zeros((q, r), lo.dtype)
    for s_corner in itertools.product((0, 1), repeat=k):
        g = corner_rows[s_corner[: k - m]]
        p = 0
        for bit in s_corner[k - m:]:
            p = 2 * p + bit  # in-row neighbor block (product order)
        for mask in range(2**k):
            # channel of (deriv-set=mask, side=s_corner) in the weight
            # order: per-axis digit 2*deriv + side, axis 0 MSB
            ch = 0
            for d in range(k):
                ch = ch * 4 + 2 * ((mask >> d) & 1) + s_corner[d]
            scale = w[:, ch][:, None]
            for d in range(k):
                if (mask >> d) & 1:
                    scale = scale * dxs[d]
            out = out + scale * g[:, p * sb + mask * r : p * sb + (mask + 1) * r]
    return out.reshape((q,) + trailing)


def _eval_core(interp, flats, orders=None):
    """Evaluate at flat query vectors (one per interpolated axis);
    ``orders`` (static per-axis ints) evaluates the mixed partial
    instead of the value."""
    axes = interp.axes
    data = interp.data
    k = len(axes)
    grid = data.shape[:k]
    trailing = data.shape[k:]

    idx = []
    ts = []
    for d, (ax, q) in enumerate(zip(axes, flats)):
        if interp.wraps_axis(d):  # rem_euclid wrap, cubic_spline.rs:804-809
            q = jnp.mod(q - ax[0], ax[-1] - ax[0]) + ax[0]
        i, t = _index_frac(ax, q)  # i clamped to [0, n-2]
        idx.append(i)
        ts.append(t)

    if interp.method == "cubic":
        return _eval_cubic(interp, idx, ts, trailing, orders)

    if interp.method == "nearest":
        # per-axis nearest node, ties toward the lower node (the step
        # family's "nearest" convention); the clamped interval makes
        # out-of-range queries pick the edge node
        strides = [1] * k
        for d in range(k - 2, -1, -1):
            strides[d] = strides[d + 1] * grid[d + 1]
        flat = sum(
            jnp.where(t <= 0.5, i, i + 1) * s
            for i, t, s in zip(idx, ts, strides)
        )
        return jnp.take(data.reshape((-1,) + trailing), flat, axis=0)

    w = _corner_weights(ts, k, orders)  # (Q, 2^k)
    if orders is not None:
        f = _dx_chain_factor(axes, idx, orders, w.dtype)
        if f is not None:
            w = w * f[:, None]

    if interp.table is not None:
        # packed route: ONE row gather + a full-channel weighted reduce
        # (the shape XLA fuses into the gather; r>1 pays one re-stream)
        cstrides = [1] * k
        for d in range(k - 2, -1, -1):
            cstrides[d] = cstrides[d + 1] * (grid[d + 1] - 1)
        cell = sum(i * s for i, s in zip(idx, cstrides))
        r = 1
        for s in trailing:
            r *= s
        rows = jnp.take(interp.table, cell, axis=0)  # (Q, 2^k * r)
        rows = rows.reshape(rows.shape[0], 2**k, r)
        out = jnp.sum(rows * w[:, :, None], axis=1)
        return out.reshape(out.shape[:1] + trailing)

    # unpacked route: 2^k corner rows via one flat multi-index gather
    strides = [1] * k
    for d in range(k - 2, -1, -1):
        strides[d] = strides[d + 1] * grid[d + 1]
    base = sum(i * s for i, s in zip(idx, strides))  # (Q,)
    offsets = jnp.asarray(
        [
            sum(d * s for d, s in zip(c, strides))
            for c in itertools.product((0, 1), repeat=k)
        ],
        dtype=base.dtype,
    )
    g = jnp.take(
        data.reshape((-1,) + trailing), base[:, None] + offsets[None, :],
        axis=0,
    )
    expand = w.shape + (1,) * len(trailing)
    return jnp.sum(g * w.reshape(expand), axis=1)


@jax.jit
def _eval_flat(interp, *flats):
    flats = tuple(
        f.astype(interp.axes[d].dtype) for d, f in enumerate(flats)
    )
    return _eval_core(interp, flats)


@functools.partial(jax.jit, static_argnums=1)
def _eval_flat_deriv(interp, orders, *flats):
    flats = tuple(
        f.astype(interp.axes[d].dtype) for d, f in enumerate(flats)
    )
    return _eval_core(interp, flats, orders)


@jax.jit
def _eval_flat_masked(interp, *flats):
    flats = tuple(
        f.astype(interp.axes[d].dtype) for d, f in enumerate(flats)
    )
    out = _eval_core(interp, flats)
    if not interp.extrapolates and jnp.issubdtype(out.dtype, jnp.inexact):
        ok = jnp.ones(flats[0].shape, bool)
        for d, (ax, q) in enumerate(zip(interp.axes, flats)):
            if not interp.wraps_axis(d):  # periodic axes are never OOB
                ok = ok & is_in_range(ax, q)
        out = jnp.where(
            ok.reshape(ok.shape + (1,) * (out.ndim - 1)), out, jnp.nan
        )
    return out


@register_pytree_node_class
class InterpND:
    """Interpolator over the leading ``k`` axes of ``data`` (pytree).

    Construct via :meth:`builder` (validating) or :meth:`new_unchecked`.
    ``method``: ``"linear"`` (multilinear, ``2^k``-corner cell blend) or
    ``"nearest"`` (nearest grid node, per-axis ties toward the lower
    node, extrapolation clamps).
    """

    def __init__(
        self,
        axes,
        data,
        method="linear",
        extrapolate=False,
        table=None,
        bcs=None,
        layout=None,
    ):
        self.axes = tuple(axes)
        self.data = data
        self.method = method
        self.extrapolates = bool(extrapolate)
        self.table = table
        self.bcs = tuple(bcs) if bcs is not None else None
        self.layout = layout  # cubic: "cell" (1 gather) | "node"

    def wraps_axis(self, d: int) -> bool:
        """Queries wrap (rem_euclid) on a periodic cubic axis — never
        OOB (``cubic_spline.rs:804-809`` semantics per axis)."""
        return self.bcs is not None and self.bcs[d] == "periodic"

    @property
    def k(self) -> int:
        return len(self.axes)

    # -- construction ----------------------------------------------------------
    @classmethod
    def builder(cls, data) -> "InterpNDBuilder":
        return InterpNDBuilder(data)

    @classmethod
    def new_unchecked(
        cls,
        axes,
        data,
        method="linear",
        extrapolate=False,
        table=None,
        bcs=None,
        layout=None,
    ) -> "InterpND":
        """No-validation constructor (pytree unflatten).  ``table`` is
        the packed corner/node table (derived state; required for
        ``method="cubic"`` together with ``layout``) — use
        :meth:`build_state` to derive it, or leave ``None`` for the
        linear/nearest unpacked gather routes."""
        return cls(axes, data, method, extrapolate, table, bcs, layout)

    @staticmethod
    def build_state(axes, data, k, method, bcs=None, layout=None):
        """Derived packed state for the given config: ``(table,
        layout)``.

        ``linear``: the ``2^k``-corner cell table under
        ``config.interpnd_pack_max_elems`` (else ``(None, None)`` — the
        unpacked gather route).  ``cubic``: the mixed-derivative solves
        (:func:`interpnd_node_grids`) packed per ``layout`` — forced
        when given, else the cell table when it fits
        ``config.interpnd_pack_max_elems`` and the memory-frugal node
        table otherwise (the cell route is the faster one: on an H100,
        1M queries took 0.55 vs 0.78 ms at 128³×1 and 0.90 vs 1.07 ms at
        64³×4).  ``nearest`` needs no state."""
        from .. import config

        if method == "linear":
            if not jnp.issubdtype(data.dtype, jnp.floating):
                return None, None
            if data.size * (2**k) > config.interpnd_pack_max_elems:
                return None, None
            return pack_corner_rows_nd(data, k), None
        if method == "cubic":
            bcs_eff = bcs or ("not_a_knot",) * k
            cells = 1
            for n in data.shape[:k]:
                cells *= n - 1
            r = data.size // max(
                1, int(np.prod(data.shape[:k], dtype=np.int64))
            )
            if layout is None:
                fits = cells * (4**k) * r <= config.interpnd_pack_max_elems
                layout = "cell" if fits else "node"
            elif layout not in ("cell",) + tuple(_NODE_PAIRS):
                raise ValueError(
                    "layout must be 'cell', 'node', 'node2', or "
                    f"'node4', got {layout!r}"
                )
            elif layout != "cell" and _NODE_PAIRS[layout] >= k:
                raise ValueError(
                    f"layout {layout!r} pairs {_NODE_PAIRS[layout]} "
                    f"axes; needs k > {_NODE_PAIRS[layout]} (got {k})"
                )
            # the solves + pack run jitted: built eagerly they are
            # hundreds of small dispatches
            table = _cubic_pack_fn(k, bcs_eff, layout)(tuple(axes), data)
            return table, layout
        return None, None

    # -- pure, jittable core -----------------------------------------------------
    def __call__(self, *coords):
        """Evaluate at ``k`` coordinate arrays of one common shape.
        Pure/jittable; out-of-range → NaN when not extrapolating."""
        coords = self._as_query(coords)
        out = _eval_flat_masked(self, *(c.reshape(-1) for c in coords))
        return out.reshape(coords[0].shape + self.data.shape[self.k :])

    def eval_unchecked(self, *coords):
        """Pure eval with no OOB mask (edge-cell extrapolation)."""
        coords = self._as_query(coords)
        out = _eval_flat(self, *(c.reshape(-1) for c in coords))
        return out.reshape(coords[0].shape + self.data.shape[self.k :])

    # -- eager API ---------------------------------------------------------------
    def interp(self, *coords):
        """Eager scalar-point eval → ``data.shape[k:]`` array; raises
        ``OutOfBoundsError`` per axis unless extrapolating."""
        arrs = tuple(jnp.asarray(c) for c in coords)
        self._check_arity(arrs)
        if not any(_is_traced(c) for c in arrs):
            self._check_queries([c.reshape(-1) for c in arrs])
        return self.eval_unchecked(*arrs).reshape(self.data.shape[self.k :])

    def interp_array(self, *coords):
        """Batched eval; output dims ``M + N - k`` with query dims
        leading; all coordinate arrays must share one shape."""
        coords = self._as_query(coords)
        if not any(_is_traced(c) for c in coords):
            self._check_queries([c.reshape(-1) for c in coords])
        return self.eval_unchecked(*coords)

    def interp_array_into(self, *coords, buffer):
        """``interp_array`` into a caller-provided numpy buffer (the
        1-D/2-D ``*_into`` contract, ``mod.rs:272-324``: shape-checked
        eagerly, all-or-nothing on OOB — docs/PARITY.md D2).  With
        ``k`` positional coordinate arrays, ``buffer`` is
        keyword-only."""
        arrs = tuple(jnp.asarray(c) for c in coords)
        self._check_arity(arrs)
        expect = self.get_buffer_shape(np.shape(coords[0]))
        if tuple(buffer.shape) != expect:
            raise ValueError(
                f"buffer shape mismatch expected: {list(expect)}, "
                f"got: {list(buffer.shape)}"
            )
        buffer[...] = np.asarray(self.interp_array(*arrs))
        return buffer

    def derivative(self, *coords, orders):
        """Mixed partial ``∂^{Σo} f / ∏ ∂x_d^{o_d}`` at the query
        points — the analytic derivative of the interpolant
        (``Interp2D.derivative`` generalized to ``k`` axes; SciPy
        ``RegularGridInterpolator`` has no derivative surface).
        ``orders``: one non-negative int per axis.  ``"cubic"``
        supports orders 0–3 per axis (higher are zero); ``"linear"``
        orders 0–1 (higher are zero); ``"nearest"`` raises.  Output
        dims ``M + N - k``; OOB raises unless extrapolating; jittable
        with traced queries."""
        if self.method == "nearest":
            raise TypeError("nearest does not support derivative()")
        orders = tuple(int(o) for o in orders)
        if len(orders) != self.k:
            raise ValueError(
                f"expected {self.k} derivative orders (one per axis), "
                f"got {len(orders)}"
            )
        if any(o < 0 for o in orders):
            raise ValueError("derivative orders must be non-negative")
        coords = self._as_query(coords)
        if not any(_is_traced(c) for c in coords):
            self._check_queries([c.reshape(-1) for c in coords])
        out = _eval_flat_deriv(
            self, orders, *(c.reshape(-1) for c in coords)
        )
        return out.reshape(coords[0].shape + self.data.shape[self.k :])

    def integrate(self, *bounds):
        """Exact integral of the interpolant over the axis-aligned box
        ``∏_d [lo_d, hi_d]`` → ``data.shape[k:]`` array (the 1-D
        ``Interp1D.integrate`` generalized; SciPy
        ``RectBivariateSpline.integral`` surface at k=2).  Analytic
        per-cell polynomial quadrature — no sampling; signed per-axis
        bounds (``lo > hi`` negates); out-of-domain bounds raise
        unless extrapolating (then the edge cells' polynomials
        extend).  ``"cubic"`` and ``"linear"`` only; periodic axes
        are unsupported (wrap-around boxes are ambiguous)."""
        if self.method == "nearest":
            raise TypeError("nearest does not support integrate()")
        if len(bounds) != self.k:
            raise ValueError(
                f"expected {self.k} (lo, hi) bound pairs (one per "
                f"axis), got {len(bounds)}"
            )
        if any(self.wraps_axis(d) for d in range(self.k)):
            raise ValueError(
                "integrate() does not support periodic axes"
            )
        sign = 1.0
        los, his = [], []
        for d, (lo, hi) in enumerate(bounds):
            lo = jnp.asarray(lo)
            hi = jnp.asarray(hi)
            if not (_is_traced(lo) or _is_traced(hi)):
                flo, fhi = float(lo), float(hi)
                if flo > fhi:
                    lo, hi = hi, lo
                    sign = -sign
                if not self.extrapolates:
                    a0, a1 = self._range_host()[d]
                    if min(float(lo), float(hi)) < a0 or max(
                        float(lo), float(hi)
                    ) > a1:
                        raise OutOfBoundsError(
                            f"axis {d}: integration bounds "
                            f"[{float(lo)}, {float(hi)}] are not in "
                            f"range"
                        )
            los.append(lo.astype(self.axes[d].dtype))
            his.append(hi.astype(self.axes[d].dtype))
        bcs = self.bcs or (("not_a_knot",) * self.k
                           if self.method == "cubic" else None)
        fn = _integrate_fn(
            self.k, bcs, self.method, self.extrapolates
        )
        out = fn(
            self.axes, self.data, jnp.stack(los), jnp.stack(his)
        )
        return sign * out

    def get_buffer_shape(self, query_shape) -> tuple:
        return tuple(query_shape) + tuple(self.data.shape[self.k :])

    # -- internals ---------------------------------------------------------------
    def _check_arity(self, coords):
        if len(coords) != self.k:
            raise ValueError(
                f"expected {self.k} coordinate arrays (one per "
                f"interpolated axis), got {len(coords)}"
            )

    def _as_query(self, coords):
        coords = tuple(jnp.asarray(c) for c in coords)
        self._check_arity(coords)
        shape = coords[0].shape
        if any(c.shape != shape for c in coords[1:]):
            raise ValueError("query coordinate shapes do not match")
        return coords

    def _range_host(self):
        cached = getattr(self, "_range_cache", None)
        if cached is None:
            cached = tuple(
                (float(ax[0]), float(ax[-1])) for ax in self.axes
            )
            self._range_cache = cached
        return cached

    def _check_queries(self, flats):
        for d, q in enumerate(flats):
            qh = np.asarray(q)
            if np.issubdtype(qh.dtype, np.floating) and np.isnan(qh).any():
                raise ValueError("failed to convert NaN to an index")
        if self.extrapolates:
            return
        ranges = self._range_host()
        for d, (q, (lo, hi)) in enumerate(zip(flats, ranges)):
            if self.wraps_axis(d):  # periodic axes are never OOB
                continue
            qh = np.asarray(q)
            ok = (lo <= qh) & (qh <= hi)
            if not ok.all():
                bad = qh[~ok][0] if qh.ndim else qh
                raise OutOfBoundsError(
                    f"axis {d}: {bad} is not in range"
                )

    # -- pytree --------------------------------------------------------------
    def tree_flatten(self):
        return (self.axes, self.data, self.table), (
            self.method,
            self.extrapolates,
            self.bcs,
            self.layout,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(
            children[0], children[1], aux[0], aux[1], children[2],
            aux[2], aux[3],
        )

    def __repr__(self):
        extra = ", packed" if self.table is not None else ""
        if self.layout is not None:
            extra = f", layout={self.layout!r}"
        if self.bcs is not None:
            extra += f", bcs={self.bcs!r}"
        return (
            f"InterpND(k={self.k}, data={self.data.shape}, "
            f"method={self.method!r}, extrapolate={self.extrapolates}"
            f"{extra})"
        )


class InterpNDBuilder:
    """Create and configure an :class:`InterpND`.

    Defaults mirror the 1-D/2-D builders: axes default to indices over
    ALL data dims (``k = data.ndim``, the ``RegularGridInterpolator``
    convention), method ``"linear"``, no extrapolation.  ``.points``
    sets the axis vectors (their count fixes ``k``; trailing data dims
    are vectorized like the reference's trailing axes).
    """

    def __init__(self, data):
        self._data = jnp.asarray(data)
        self._points = None
        self._points_host = None
        self._method = "linear"
        self._extrapolate = False
        self._bcs = None
        self._layout = None

    def points(self, *axes) -> "InterpNDBuilder":
        self._points_host = tuple(_host_view(ax) for ax in axes)
        self._points = tuple(jnp.asarray(ax) for ax in axes)
        return self

    def method(self, method: str) -> "InterpNDBuilder":
        if method not in _METHODS:
            raise ValueError(
                f"unknown InterpND method {method!r}; choose from "
                f"{sorted(_METHODS)}"
            )
        self._method = method
        return self

    def boundary(self, *bcs) -> "InterpNDBuilder":
        """Per-axis boundary conditions for ``method("cubic")``: one of
        ``not_a_knot`` (default) / ``natural`` / ``clamped`` /
        ``periodic`` per axis (``Bicubic.boundary`` generalized).  A
        single name applies to every axis."""
        for bc in bcs:
            if bc not in _BCS:
                raise ValueError(
                    f"unknown boundary {bc!r}; choose from "
                    f"{sorted(_BCS)}"
                )
        self._bcs = tuple(bcs)
        return self

    def extrapolate(self, yes: bool = True) -> "InterpNDBuilder":
        self._extrapolate = bool(yes)
        return self

    def layout(self, layout: str) -> "InterpNDBuilder":
        """Force the cubic table layout: ``"cell"`` (one ``4^k·r``-
        channel row gather per query — fastest, ``~4^k``× data memory),
        ``"node"`` (``2^k`` node-row gathers — ``~2^k``× memory), or
        the paired-node tiers ``"node2"`` / ``"node4"``
        (``2^(k-1)`` / ``2^(k-2)`` gathers at 2× / 4× the node table;
        needs ``k > 1`` / ``k > 2``).  Default: the cell table when it
        fits ``config.interpnd_pack_max_elems``, else ``"node"``."""
        if layout not in ("cell", "node", "node2", "node4"):
            raise ValueError(
                "layout must be 'cell', 'node', 'node2', or 'node4', "
                f"got {layout!r}"
            )
        self._layout = layout
        return self

    def build(self) -> InterpND:
        """Validation mirrors the 2-D builder per axis
        (``mod.rs:468-518``): enough data, axis/data length match,
        strict monotonic rise."""
        data = self._data
        axes = self._points
        if axes is None:
            axes = tuple(
                jnp.arange(n, dtype=data.dtype) for n in data.shape
            )
            self._points_host = tuple(
                np.arange(n, dtype=np.dtype(data.dtype))
                for n in data.shape
            )
        k = len(axes)
        if k == 0:
            raise ShapeError("at least one axis is required")
        if data.ndim < k:
            raise ShapeError(f"data dimension needs to be at least {k}")
        bcs = self._bcs
        if bcs is not None:
            if self._method != "cubic":
                raise ValueError(
                    "boundary() applies to method('cubic') only"
                )
            if len(bcs) == 1:
                bcs = bcs * k
            if len(bcs) != k:
                raise ShapeError(
                    f"expected {k} boundary conditions (one per axis), "
                    f"got {len(bcs)}"
                )
        elif self._method == "cubic":
            bcs = ("not_a_knot",) * k
        min_pts = 3 if self._method == "cubic" else 2
        for d, ax in enumerate(axes):
            if ax.ndim != 1:
                raise ShapeError(f"axis {d} must be one-dimensional")
            if data.shape[d] < min_pts:
                raise NotEnoughDataError(
                    f"The {d}-dimension has not enough data for the "
                    f"chosen interpolation strategy. Provided: "
                    f"{data.shape[d]}, Required: {min_pts}"
                )
            if ax.shape[0] != data.shape[d]:
                raise ShapeError(
                    f"Lengths of axis {d} and data-{d}-axis need to "
                    f"match. Got axis: {ax.shape[0]}, data-{d}: "
                    f"{data.shape[d]}"
                )
            host = (
                self._points_host[d]
                if self._points_host and self._points_host[d] is not None
                else np.asarray(ax)
            )
            if not monotonic_prop(host).is_strict_rising:
                raise MonotonicError(
                    f"axis {d} needs to be strictly monotonic rising"
                )
        if bcs is not None:
            # periodic axes require first == last data along that axis
            # (cubic_spline.rs:483-489 per axis)
            host_data = np.asarray(data)
            for d, bc in enumerate(bcs):
                if bc != "periodic":
                    continue
                first = np.take(host_data, 0, axis=d)
                last = np.take(host_data, -1, axis=d)
                if not np.array_equal(first, last):
                    raise ValueError(
                        f"periodic axis {d} requires the first and "
                        "last data rows along it to be equal"
                    )
        ct = jnp.result_type(data.dtype, *(ax.dtype for ax in axes))
        if not jnp.issubdtype(ct, jnp.inexact):
            ct = jnp.result_type(ct, jnp.float32)
        axes_ct = tuple(ax.astype(ct) for ax in axes)
        data_ct = data.astype(ct)
        table, layout = InterpND.build_state(
            axes_ct, data_ct, k, self._method, bcs, layout=self._layout
        )
        return InterpND(
            axes_ct,
            data_ct,
            self._method,
            self._extrapolate,
            table,
            bcs,
            layout,
        )
