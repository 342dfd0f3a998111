"""Parallel cyclic reduction (PCR) for batched tridiagonal systems.

The Thomas recurrence (``thomas.py``, reference
``cubic_spline.rs:678-721``) is inherently sequential along the knot
axis: ~2n dependent steps, each a handful of elementwise ops that cannot
overlap (an H100 spends 5.5 ms on a (2048, 4096) spline-bank solve that
way).  PCR restructures the elimination into ``ceil(log2 n)`` levels of
*independent* full-width row combinations:

    level (stride s): row i absorbs rows i-s and i+s with
        alpha_i = -a_i / b_{i-s},  gamma_i = -c_i / b_{i+s}
        a'_i = alpha_i a_{i-s}          (now couples x_{i-2s})
        c'_i = gamma_i c_{i+s}          (now couples x_{i+2s})
        b'_i = b_i + alpha_i c_{i-s} + gamma_i a_{i+s}
        d'_i = d_i + alpha_i d_{i-s} + gamma_i d_{i+s}

with out-of-range rows treated as identity rows (a = c = d = 0, b = 1).
After all levels every coupling is out of range and ``x = d / b``.

Work is O(n log n) instead of O(n), but every level is a fully parallel
elementwise pass over the (n, bank) block, and for *shared* diagonals (the common case: one knot axis, many
splines) the diagonal updates are (n,)-vector ops, so only the rhs pays
the log-factor.  The spline systems are strictly diagonally dominant
(``a_mid = 2(dx_i + dx_{i+1}) > a_up + a_low``), which PCR preserves, so
the elimination is unconditionally stable; results differ from the
sequential order by normal f32/f64 rounding only (NOT bit-identical —
the scan solver remains the reference-order path and the CPU route).
"""

from __future__ import annotations

import math

import jax.numpy as jnp


def _bview(v, ndim):
    """Append singleton dims so a (n, *partial) factor broadcasts on rhs."""
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


def _down(v, s, fill):
    """v_{i-s} with identity fill for the first s rows."""
    pad = jnp.full((s,) + v.shape[1:], fill, v.dtype)
    return jnp.concatenate([pad, v[:-s]], axis=0)


def _up(v, s, fill):
    """v_{i+s} with identity fill for the last s rows."""
    pad = jnp.full((s,) + v.shape[1:], fill, v.dtype)
    return jnp.concatenate([v[s:], pad], axis=0)


def pcr_solve(a_up, a_mid, a_low, rhs):
    """Solve the tridiagonal system ``A k = rhs`` along axis 0 by PCR.

    Same interface and convention as :func:`thomas.thomas_solve`:
    ``a_low[i]`` couples row i to i-1 (``a_low[0]`` unused), ``a_up[i]``
    couples row i to i+1 (``a_up[-1]`` unused); diagonals are (n,) or
    batched/broadcastable against ``rhs``'s trailing axes.
    """
    n = rhs.shape[0]
    if n == 1:
        return rhs / _bview(a_mid, rhs.ndim)[0]

    one = jnp.asarray(1.0, rhs.dtype)
    zero = jnp.asarray(0.0, rhs.dtype)

    # zero the out-of-matrix couplings by concatenation (not scatter)
    a = jnp.concatenate(
        [jnp.zeros_like(a_low[:1]), a_low[1:]], axis=0
    ).astype(rhs.dtype)
    c = jnp.concatenate(
        [a_up[: n - 1], jnp.zeros_like(a_up[:1])], axis=0
    ).astype(rhs.dtype)
    b = a_mid.astype(rhs.dtype)
    d = rhs
    ndim = rhs.ndim

    s = 1
    for _ in range(max(1, math.ceil(math.log2(n)))):
        alpha = -a / _down(b, s, one)
        gamma = -c / _up(b, s, one)
        b = b + alpha * _down(c, s, zero) + gamma * _up(a, s, zero)
        a, c = alpha * _down(a, s, zero), gamma * _up(c, s, zero)
        d = (
            d
            + _bview(alpha, ndim) * _down(d, s, zero)
            + _bview(gamma, ndim) * _up(d, s, zero)
        )
        s *= 2
    return d / _bview(b, ndim)
