"""Double-float (two-float) arithmetic: error-free transforms on f32.

The f64-grade serving evaluators (``serving.DoubleFloatEvaluator*``)
represent every value as an unevaluated sum ``hi + lo`` of two f32 with
``|lo| <= ulp(hi)/2``, giving ~49 effective mantissa bits (~1e-14
relative) on f32 arithmetic.  The building blocks are the classical
error-free transforms (Dekker 1971, Knuth TAOCP 4.2.2): ``two_sum`` /
``two_prod`` compute a rounded result *and* its exact f32 rounding error.

Correctness requires strict per-op f32 IEEE semantics: ``two_prod`` uses
Veltkamp splitting (no FMA assumption), and the compiler must neither
reassociate nor contract the sequences into FMAs.  Every error-term step
therefore passes through an ``optimization_barrier`` (:func:`_guard`),
and broadcasts go through :func:`_materialize_broadcast`.  Pinned on
XLA:CPU by ``tests/test_df.py`` and on an H100 by ``chip_smoke.py``
phase P5 (≤1e-12 scale-relative against a float64 SciPy oracle).

Reference mapping: the reference evaluates in native f64
(``cubic_spline.rs:818-828``); this module is an f32-pair representation
of that precision.
"""

from __future__ import annotations

import jax.numpy as jnp


def _guard(x):
    """Opacity barrier: stops XLA's algebraic simplifier from cancelling
    the error-term sequences (measured: without it, jit on CPU rewrites
    ``a - (s - (s - a))``-style chains and the error terms vanish)."""
    import jax

    return jax.lax.optimization_barrier(x)


def two_sum(a, b):
    """s, e with s = fl(a+b) and s + e == a + b exactly (Knuth)."""
    s = _guard(a + b)
    bb = _guard(s - a)
    err = (a - _guard(s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """two_sum requiring |a| >= |b| (Dekker); 3 ops instead of 6."""
    s = _guard(a + b)
    return s, b - _guard(s - a)


def _split(a):
    """Veltkamp split of f32 into two 12-bit halves (factor 2**12 + 1)."""
    c = _guard(a * jnp.asarray(4097.0, a.dtype))
    hi = c - _guard(c - a)
    return hi, a - hi


def _materialize_broadcast(x, shape):
    """Broadcast through the INTEGER domain with a barrier: XLA:CPU's
    emitter otherwise sinks the float broadcast and scalarizes the
    producer column, where LLVM contracts the Veltkamp split's
    multiply-subtract into an FMA and the split collapses (measured:
    a (Q,1) x (Q,bank) two_prod lost its error term to f32 grade on
    CPU jit while every graph-level guard survived intact in the HLO —
    the corruption is below HLO).  Bitcasting to int32 before the
    broadcast severs the float producer chain at the emitter level."""
    if tuple(jnp.shape(x)) == tuple(shape):
        return x
    import jax

    x = jnp.asarray(x)
    if x.dtype != jnp.float32:
        return jnp.broadcast_to(x, shape)
    xi = jax.lax.bitcast_convert_type(x, jnp.int32)
    xi = jax.lax.optimization_barrier(jnp.broadcast_to(xi, shape))
    return jax.lax.bitcast_convert_type(xi, x.dtype)


def two_prod(a, b):
    """p, e with p = fl(a*b) and p + e == a * b exactly (Dekker).

    Broadcasting operands (e.g. a (Q,1) pair against a (Q,bank) pair)
    are materialized through :func:`_materialize_broadcast` first — see
    its docstring for the XLA:CPU emitter trap this defeats."""
    if jnp.shape(a) != jnp.shape(b):
        shape = jnp.broadcast_shapes(jnp.shape(a), jnp.shape(b))
        a = _materialize_broadcast(a, shape)
        b = _materialize_broadcast(b, shape)
    p = _guard(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    err = (
        (_guard(ah * bh) - p) + _guard(ah * bl) + _guard(al * bh)
    ) + al * bl
    return p, err


# -- double-float ops (each value is a (hi, lo) pair) -------------------------


def df_neg(x):
    return -x[0], -x[1]


def df_add(x, y):
    """Accurate DF addition (ldadd of Dekker; ~1e-31 relative for f32)."""
    sh, sl = two_sum(x[0], y[0])
    th, tl = two_sum(x[1], y[1])
    sl = sl + th
    sh, sl = fast_two_sum(sh, sl)
    sl = sl + tl
    return fast_two_sum(sh, sl)


def df_sub(x, y):
    return df_add(x, df_neg(y))


def df_mul(x, y):
    ph, pl = two_prod(x[0], y[0])
    pl = pl + (x[0] * y[1] + x[1] * y[0])
    return fast_two_sum(ph, pl)


def df_div(x, y):
    """DF division via long division: q1 = hi quotient, one refinement."""
    q1 = x[0] / y[0]
    # r = x - q1 * y, computed exactly where it matters
    th, tl = two_prod(q1, y[0])
    rh, rl = df_add(x, (-th, -(tl + q1 * y[1])))
    q2 = (rh + rl) / y[0]
    return fast_two_sum(q1, q2)


def df_from_f64(x):
    """Split a float64 array into an (hi, lo) float32 pair (host side;
    the device never sees an f64 value)."""
    import numpy as np

    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    with np.errstate(invalid="ignore"):
        lo = (x - hi.astype(np.float64)).astype(np.float32)
    # ±inf/NaN carry entirely in hi; a NaN lo (inf - inf) would poison
    # comparisons that the hi part alone already decides
    lo = np.where(np.isfinite(hi), lo, np.float32(0.0))
    return jnp.asarray(hi), jnp.asarray(lo)


def df_to_f64(hi, lo):
    """Recombine on the host at full precision."""
    import numpy as np

    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def df_le(x, y):
    """Lexicographic x <= y for normalized DF pairs."""
    return (x[0] < y[0]) | ((x[0] == y[0]) & (x[1] <= y[1]))
