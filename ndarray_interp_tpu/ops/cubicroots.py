"""Batched closed-form real-root extraction for spline solve()/roots().

No reference analogue (the Rust crate has no root finding); the surface
this feeds — ``Interp1D.solve(y)`` / ``Interp1D.roots()`` — mirrors SciPy's
``PPoly.solve``/``PPoly.roots`` so CubicSpline users can switch.

Design: a spline with ``n`` knots has ``n-1`` interval cubics,
each with at most 3 real roots, so the root set has a *static* bound
``3(n-1)`` — the whole solve is one fixed-shape batched computation
(classify → closed form → Newton polish → accept-window → sort → dedupe)
with NaN padding, jittable and vmappable.  No per-interval Python loops,
no dynamic shapes, no host sync.

Numerics: the closed forms (trigonometric method for three real roots,
cancellation-free Cardano for one) are evaluated elementwise, then two
Newton steps on the original coefficients polish every root to ~1 ulp of
the evaluation form; roots that land within ``tol`` of an interval edge
are accepted by both neighbours and merged by the dedupe pass.
"""

from __future__ import annotations

import jax.numpy as jnp

# Acceptance slack at interval edges, in units of the local parameter t
# (intervals are [0, 1] in t).  Newton-polished roots sit ~1e-15 from the
# true root, so 1e-9 comfortably catches roots at knots computed from
# either neighbouring interval without admitting genuinely-outside roots.
_EDGE_TOL = 1e-9


def real_cubic_roots(c0, c1, c2, c3, *, newton: int = 2):
    """Real roots of ``c3 t**3 + c2 t**2 + c1 t + c0`` (elementwise batch).

    Returns ``broadcast_shape + (3,)``, NaN-padded.  Degenerate leading
    coefficients fall through to the quadratic/linear forms (exact-zero
    tests: a rounded-to-tiny ``c3`` still takes the cubic branch; its
    spurious far root lands outside any accept window and the two real
    ones are Newton-polished).  Multiple roots may appear as repeated
    entries — callers dedupe.  An identically-zero polynomial returns no
    roots (the caller decides the representative-point convention).
    """
    c0, c1, c2, c3 = jnp.broadcast_arrays(
        *(jnp.asarray(c) for c in (c0, c1, c2, c3))
    )
    dtype = jnp.result_type(c0, jnp.float32)
    c0, c1, c2, c3 = (c.astype(dtype) for c in (c0, c1, c2, c3))
    nan = jnp.full_like(c0, jnp.nan)

    is_cubic = c3 != 0
    is_quad = ~is_cubic & (c2 != 0)
    is_lin = ~is_cubic & ~is_quad & (c1 != 0)

    # -- cubic: depress to s^3 + p s + q, t = s - b/3 -------------------------
    safe3 = jnp.where(is_cubic, c3, jnp.ones_like(c3))
    b = c2 / safe3
    c = c1 / safe3
    d = c0 / safe3
    p = c - b * b / 3.0
    q = (2.0 * b * b * b / 27.0) - (b * c / 3.0) + d
    disc = 0.25 * q * q + p * p * p / 27.0

    # three real roots (disc <= 0): trigonometric method
    m2 = jnp.sqrt(jnp.maximum(-p / 3.0, 0.0))
    m2_safe = jnp.where(m2 > 0, m2, jnp.ones_like(m2))
    cos3phi = jnp.clip(-q / (2.0 * m2_safe**3), -1.0, 1.0)
    phi = jnp.arccos(cos3phi) / 3.0
    two_pi_3 = 2.0 * jnp.pi / 3.0
    s_tri = [
        2.0 * m2 * jnp.cos(phi),
        2.0 * m2 * jnp.cos(phi - two_pi_3),
        2.0 * m2 * jnp.cos(phi - 2.0 * two_pi_3),
    ]

    # one real root (disc > 0): Cardano, branch chosen to avoid cancellation
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    big = -0.5 * q - jnp.sign(q) * sq  # |big| = |q|/2 + sq: no cancellation
    A = jnp.cbrt(big)
    A_safe = jnp.where(A != 0, A, jnp.ones_like(A))
    B = jnp.where(A != 0, -p / (3.0 * A_safe), jnp.zeros_like(A))
    s_one = A + B  # q == 0 & disc > 0 ⇒ p > 0 ⇒ the only real root is 0 ✓

    three = disc <= 0
    shift = b / 3.0
    t_cubic = [
        jnp.where(three, s_tri[0], s_one) - shift,
        jnp.where(three, s_tri[1], nan) - shift,
        jnp.where(three, s_tri[2], nan) - shift,
    ]

    # -- quadratic: stable two-root form --------------------------------------
    disc2 = c1 * c1 - 4.0 * c2 * c0
    sq2 = jnp.sqrt(jnp.maximum(disc2, 0.0))
    sgn = jnp.where(c1 >= 0, 1.0, -1.0).astype(dtype)
    qq = -0.5 * (c1 + sgn * sq2)
    safe2 = jnp.where(is_quad, c2, jnp.ones_like(c2))
    qq_safe = jnp.where(qq != 0, qq, jnp.ones_like(qq))
    r1 = qq / safe2
    r2 = jnp.where(qq != 0, c0 / qq_safe, jnp.zeros_like(qq))
    ok2 = disc2 >= 0
    t_quad = [jnp.where(ok2, r1, nan), jnp.where(ok2, r2, nan), nan]

    # -- linear ----------------------------------------------------------------
    safe1 = jnp.where(is_lin, c1, jnp.ones_like(c1))
    t_lin = [-c0 / safe1, nan, nan]

    roots = [
        jnp.where(
            is_cubic,
            t_cubic[k],
            jnp.where(is_quad, t_quad[k], jnp.where(is_lin, t_lin[k], nan)),
        )
        for k in range(3)
    ]
    roots = jnp.stack(roots, axis=-1)

    # -- Newton polish on the original coefficients ---------------------------
    e0 = c0[..., None]
    e1 = c1[..., None]
    e2 = c2[..., None]
    e3 = c3[..., None]
    for _ in range(newton):
        f = ((e3 * roots + e2) * roots + e1) * roots + e0
        fp = (3.0 * e3 * roots + 2.0 * e2) * roots + e1
        upd = f / jnp.where(fp != 0, fp, jnp.ones_like(fp))
        roots = jnp.where(jnp.isfinite(upd), roots - upd, roots)
    return roots


def interval_roots_to_x(x, t_roots, *, extrapolate: bool = False):
    """Collect per-interval local roots into one sorted global root vector.

    ``x``: ``(n,)`` knots; ``t_roots``: ``(n-1, *trailing, 3)`` local roots
    from :func:`real_cubic_roots` on each interval's coefficients.  Accepts
    roots in the half-open interval window ``[0, 1)`` (closed at the top for
    the last interval, so a root at the final knot is kept once); with
    ``extrapolate`` the first/last interval windows open toward ±∞ (the
    edge polynomials extend).  Maps to global ``x``, sorts ascending with
    NaN padding last, and merges duplicates closer than ``tol`` (roots at a
    shared knot are reported by both neighbours).

    Returns ``(3*(n-1), *trailing)``.
    """
    n1 = t_roots.shape[0]
    t = t_roots
    dtype = t.dtype
    xl = x[:-1].astype(dtype)
    dx = (x[1:] - x[:-1]).astype(dtype)
    span = jnp.abs(x[-1] - x[0]).astype(dtype)

    expand = (n1,) + (1,) * (t.ndim - 2) + (1,)
    first = jnp.arange(n1).reshape(expand) == 0
    last = jnp.arange(n1).reshape(expand) == (n1 - 1)

    lo_open = extrapolate & first
    hi_open = extrapolate & last
    acc_lo = jnp.where(lo_open, t <= t, t >= -_EDGE_TOL)
    # interior intervals are half-open at the top: a knot root belongs to
    # the right interval; the final knot's root belongs to the last one
    acc_hi = jnp.where(
        hi_open,
        t <= t,
        jnp.where(last, t <= 1.0 + _EDGE_TOL, t < 1.0 - _EDGE_TOL),
    )
    acc = acc_lo & acc_hi & jnp.isfinite(t)

    # clamp interior-window roots into [0, 1] so accepted knot roots map
    # exactly onto the knot; extrapolating edge windows stay unclamped
    t = jnp.where(lo_open, t, jnp.maximum(t, 0.0))
    t = jnp.where(hi_open, t, jnp.minimum(t, 1.0))

    xr = xl.reshape(expand) + t * dx.reshape(expand)
    xr = jnp.where(acc, xr, jnp.nan)

    flat = jnp.moveaxis(xr, -1, 1).reshape((3 * n1,) + t_roots.shape[1:-1])
    flat = jnp.sort(flat, axis=0)  # NaNs sort last
    if n1 > 0:
        tol = span * jnp.asarray(10 * _EDGE_TOL, dtype)
        dup = jnp.abs(flat[1:] - flat[:-1]) <= tol
        flat = jnp.concatenate(
            [flat[:1], jnp.where(dup, jnp.nan, flat[1:])], axis=0
        )
        flat = jnp.sort(flat, axis=0)
    return flat
