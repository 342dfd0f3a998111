"""Cubic-spline interpolation strategy.

Reference: ``/root/reference/src/interp1d/strategies/cubic_spline.rs``.
A C² cubic spline parameterized by knot derivatives ``k`` obtained from a
tridiagonal system (Wikipedia spline formulation, ``cubic_spline.rs:423-428``)
with four boundary-condition families plus per-row/per-side mixing:

* 3-level boundary hierarchy (``cubic_spline.rs:104-217``):
  ``BoundaryCondition{NotAKnot, Natural, Clamped, Periodic, Individual}``,
  ``RowBoundary{NotAKnot, Natural, Clamped, Mixed{left,right}}``,
  ``SingleBoundary{NotAKnot, Natural, Clamped, FirstDeriv, SecondDeriv}``,
  with ``Natural ≡ SecondDeriv(0)`` and ``Clamped ≡ FirstDeriv(0)``
  (``:287-296``).
* Special cases: NotAKnot with exactly 3 points → parabola system
  (``:569-596``); Periodic with 3 points → closed form (``:480-496``);
  Periodic general → condensed (n-1) system, two Thomas solves + a
  Sherman–Morrison-style correction (``:498-565``).
* Eval: Hermite in symmetric form,
  ``y = (1-t)·y_l + t·y_r + t(1-t)(a(1-t) + b t)`` (``:818-828``), with
  periodic wrap ``x = (x-x0).rem_euclid(xn-x0) + x0`` (``:804-809``).

Differences from the reference:

* One batched solve for the whole spline bank.  The reference's
  ``Individual`` mode recurses row by row (``:370-403``); here per-row
  boundaries become integer "kind" arrays selected with ``where``, the
  diagonals become batched, and a single Thomas scan solves every row
  simultaneously — identical per-element arithmetic, so f64 results match
  the reference bit-for-bit.
* Construction is pure XLA (reference-order scan Thomas on the CPU,
  parallel cyclic reduction or a probed dense operator elsewhere), so
  spline *building* can be jitted/sharded just like evaluation.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class

from ...errors import BuilderValueError, ShapeError
from ...ops.thomas import thomas_solve_fast
from .base import Interp1DStrategy, Interp1DStrategyBuilder

# specialized boundary kinds (SingleBoundary after `specialize`,
# cubic_spline.rs:287-296)
_NOT_A_KNOT = 0
_FIRST_DERIV = 1
_SECOND_DERIV = 2


# ---------------------------------------------------------------------------
# boundary-condition hierarchy (public API)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SingleBoundary:
    """Boundary condition for one side of one data row
    (``cubic_spline.rs:204-217``)."""

    kind: str  # not_a_knot | natural | clamped | first_deriv | second_deriv
    value: float = 0.0

    @staticmethod
    def FirstDeriv(value) -> "SingleBoundary":
        return SingleBoundary("first_deriv", float(value))

    @staticmethod
    def SecondDeriv(value) -> "SingleBoundary":
        return SingleBoundary("second_deriv", float(value))

    def _specialized(self) -> tuple[int, float]:
        # Natural ≡ SecondDeriv(0), Clamped ≡ FirstDeriv(0)  (:287-296)
        if self.kind == "not_a_knot":
            return (_NOT_A_KNOT, 0.0)
        if self.kind == "natural":
            return (_SECOND_DERIV, 0.0)
        if self.kind == "clamped":
            return (_FIRST_DERIV, 0.0)
        if self.kind == "first_deriv":
            return (_FIRST_DERIV, self.value)
        if self.kind == "second_deriv":
            return (_SECOND_DERIV, self.value)
        raise ValueError(f"unknown SingleBoundary kind {self.kind!r}")


SingleBoundary.NotAKnot = SingleBoundary("not_a_knot")
SingleBoundary.Natural = SingleBoundary("natural")
SingleBoundary.Clamped = SingleBoundary("clamped")


@dataclass(frozen=True)
class RowBoundary:
    """Boundary condition for a single data row (``cubic_spline.rs:171-184``)."""

    left: SingleBoundary
    right: SingleBoundary

    @staticmethod
    def Mixed(left: SingleBoundary, right: SingleBoundary) -> "RowBoundary":
        return RowBoundary(left, right)


RowBoundary.NotAKnot = RowBoundary(SingleBoundary.NotAKnot, SingleBoundary.NotAKnot)
RowBoundary.Natural = RowBoundary(SingleBoundary.Natural, SingleBoundary.Natural)
RowBoundary.Clamped = RowBoundary(SingleBoundary.Clamped, SingleBoundary.Clamped)


class BoundaryCondition:
    """Top-level boundary condition (``cubic_spline.rs:153-168``).

    Use the class constants ``NotAKnot`` / ``Natural`` / ``Clamped`` /
    ``Periodic`` or ``BoundaryCondition.Individual(rows)`` where ``rows``
    is an object array of :class:`RowBoundary` with shape = data shape with
    axis 0 of length 1 (``cubic_spline.rs:332-340``).
    """

    def __init__(self, kind: str, rows=None, arrays=None):
        self.kind = kind
        self.rows = rows
        self.arrays = arrays

    @staticmethod
    def Individual(rows) -> "BoundaryCondition":
        rows = np.asarray(rows, dtype=object)
        return BoundaryCondition("individual", rows)

    @staticmethod
    def IndividualArrays(
        left_kind, left_value, right_kind, right_value
    ) -> "BoundaryCondition":
        """Per-row boundaries as precompiled kind/value arrays.

        The jit/pjit-compatible form of :meth:`Individual`: the object-array
        lowering (``_compile_rows``) needs host-side Python objects, but the
        numeric encoding it produces is plain arrays — this constructor
        accepts them directly, so per-row-boundary banks can be built inside
        ``jit`` with traced values (e.g. learned clamp derivatives).

        Kind codes (the specialized ``SingleBoundary`` encoding,
        ``cubic_spline.rs:287-296``): ``0`` = not-a-knot, ``1`` =
        first-derivative (Clamped ≡ ``FirstDeriv(0)``), ``2`` =
        second-derivative (Natural ≡ ``SecondDeriv(0)``).  All four arrays
        must have shape ``data.shape[1:]``; kind arrays are integers, value
        arrays are the derivative payloads.
        """
        return BoundaryCondition(
            "individual_arrays",
            arrays=(left_kind, left_value, right_kind, right_value),
        )

    def __repr__(self):
        return f"BoundaryCondition({self.kind})"


BoundaryCondition.NotAKnot = BoundaryCondition("not_a_knot")
BoundaryCondition.Natural = BoundaryCondition("natural")
BoundaryCondition.Clamped = BoundaryCondition("clamped")
BoundaryCondition.Periodic = BoundaryCondition("periodic")


def _compile_rows(rows: np.ndarray):
    """Lower an object array of RowBoundary into four numeric arrays
    (left kind/value, right kind/value) — the batched encoding replacing
    the reference's per-row recursion."""
    lk = np.zeros(rows.shape, np.int32)
    lv = np.zeros(rows.shape, np.float64)
    rk = np.zeros(rows.shape, np.int32)
    rv = np.zeros(rows.shape, np.float64)
    for idx in np.ndindex(rows.shape):
        rb = rows[idx]
        if not isinstance(rb, RowBoundary):
            raise TypeError(
                "BoundaryCondition.Individual expects RowBoundary entries, "
                f"got {type(rb).__name__}"
            )
        lk[idx], lv[idx] = rb.left._specialized()
        rk[idx], rv[idx] = rb.right._specialized()
    return lk, lv, rk, rv


# ---------------------------------------------------------------------------
# system assembly + solve
# ---------------------------------------------------------------------------
@jax.jit
def _solve_for_k(x, y, left_kind, left_val, right_kind, right_val):
    """Assemble and solve ``A k = rhs`` for the knot derivatives.

    ``left_kind``/``right_kind`` are specialized kind codes — scalars for a
    uniform boundary, or arrays of shape ``y.shape[1:]`` for per-row
    (``Individual``) boundaries.  Mirrors ``solve_for_k``
    (``cubic_spline.rs:409-674``) with the boundary `match` replaced by
    vectorized selection.
    """
    return thomas_solve_fast(
        *_tridiag_system(x, y, left_kind, left_val, right_kind, right_val)
    )


def _tridiag_system(x, y, left_kind, left_val, right_kind, right_val):
    """The diagonals and right-hand side ``(a_up, a_mid, a_low, rhs)``
    of the knot-derivative system solved by :func:`_solve_for_k`."""
    n = x.shape[0]
    trailing = y.shape[1:]
    tr = len(trailing)
    dtype = y.dtype

    def ex(v):  # expand a knot-axis quantity over trailing dims
        return jnp.asarray(v, dtype=dtype).reshape((-1,) + (1,) * tr)

    dx = x[1:] - x[:-1]  # (n-1,)
    dx0, dx1 = dx[0], dx[1]
    dx_1, dx_2 = dx[n - 2], dx[n - 3]

    lk = jnp.asarray(left_kind)
    rk = jnp.asarray(right_kind)
    lv = jnp.asarray(left_val, dtype=dtype)
    rv = jnp.asarray(right_val, dtype=dtype)
    batched = lk.ndim > 0 or rk.ndim > 0

    # ---- interior rows (cubic_spline.rs:440-471) -------------------------
    # a_up[i] = dx[i-1], a_mid[i] = 2(dx[i]+dx[i-1]), a_low[i] = dx[i]
    zero = jnp.zeros((), dtype)
    a_up_1d = jnp.concatenate([zero[None], dx[:-1], zero[None]])
    a_mid_1d = jnp.concatenate(
        [zero[None], 2.0 * (dx[1:] + dx[:-1]), zero[None]]
    )
    a_low_1d = jnp.concatenate([zero[None], dx[1:], zero[None]])

    dxn = ex(dx[1:])  # dx[i]   for i = 1..n-2
    dxn_1 = ex(dx[:-1])  # dx[i-1] for i = 1..n-2
    rhs_interior = 3.0 * (
        dxn * (y[1:-1] - y[:-2]) / dxn_1 + dxn_1 * (y[2:] - y[1:-1]) / dxn
    )  # (n-2, *trailing)

    # ---- boundary-row candidates ----------------------------------------
    y0, y1, y2 = y[0], y[1], y[2]
    y_1, y_2, y_3 = y[n - 1], y[n - 2], y[n - 3]
    slope0 = (y1 - y0) / dx0
    slope1 = (y2 - y1) / dx1

    both_nak3 = (n == 3) & (lk == _NOT_A_KNOT) & (rk == _NOT_A_KNOT)

    # left row (cubic_spline.rs:598-631; parabola :584-592)
    d_l = x[2] - x[0]
    tmp1_l = (dx0 + 2.0 * d_l) * dx1
    nak_rhs0 = (tmp1_l * (y1 - y0) / dx0 + dx0 * dx0 * (y2 - y1) / dx1) / d_l
    sd_rhs0 = 3.0 * (y1 - y0) - lv * dx0 * dx0 / 2.0
    one = jnp.ones((), dtype)

    am0 = jnp.where(
        both_nak3,
        one,
        jnp.where(
            lk == _NOT_A_KNOT,
            dx1,
            jnp.where(lk == _FIRST_DERIV, one, 2.0 * dx0),
        ),
    )
    au0 = jnp.where(
        both_nak3,
        one,
        jnp.where(
            lk == _NOT_A_KNOT,
            d_l,
            jnp.where(lk == _FIRST_DERIV, zero, dx0),
        ),
    )
    rhs0 = jnp.where(
        both_nak3,
        2.0 * slope0,
        jnp.where(
            lk == _NOT_A_KNOT,
            nak_rhs0,
            jnp.where(lk == _FIRST_DERIV, lv, sd_rhs0),
        ),
    )

    # right row (cubic_spline.rs:633-668; parabola :589-595)
    d_r = x[n - 1] - x[n - 3]
    tmp1_r = (2.0 * d_r + dx_1) * dx_2
    nak_rhsn = (
        dx_1 * dx_1 * (y_2 - y_3) / dx_2 + tmp1_r * (y_1 - y_2) / dx_1
    ) / d_r
    sd_rhsn = 3.0 * (y_1 - y_2) + rv * dx_1 * dx_1 / 2.0
    slope_last = (y_1 - y_2) / dx_1  # == slope1 when n == 3

    # NOTE: the right-NAK diagonal is dx_2 (the second-to-last interval),
    # matching SciPy's formulation.  The reference writes dx_1 here
    # (cubic_spline.rs:635) — a latent bug invisible in its own tests,
    # which only exercise right-NAK on uniform axes where dx_1 == dx_2.
    amn = jnp.where(
        both_nak3,
        one,
        jnp.where(
            rk == _NOT_A_KNOT,
            dx_2,
            jnp.where(rk == _FIRST_DERIV, one, 2.0 * dx_1),
        ),
    )
    aln = jnp.where(
        both_nak3,
        one,
        jnp.where(
            rk == _NOT_A_KNOT,
            d_r,
            jnp.where(rk == _FIRST_DERIV, zero, dx_1),
        ),
    )
    rhsn = jnp.where(
        both_nak3,
        2.0 * slope_last,
        jnp.where(
            rk == _NOT_A_KNOT,
            nak_rhsn,
            jnp.where(rk == _FIRST_DERIV, rv, sd_rhsn),
        ),
    )

    rhs = jnp.concatenate([rhs0[None], rhs_interior, rhsn[None]], axis=0)

    if batched:
        # Assemble by concatenation, NOT broadcast_to + .at[].set: an
        # indexed-update on a broadcast view miscompiles under jit on the
        # CPU backend (wrong lane selected in the scan that consumes it —
        # observed with jax 0.9.0), and concatenation is what we mean
        # anyway: fixed interior rows with per-bank boundary rows.
        def brow(v):  # (trailing,) boundary row
            return jnp.broadcast_to(
                jnp.asarray(v, dtype), trailing
            )[None]

        interior_shape = (n - 2,) + trailing
        a_up = jnp.concatenate(
            [
                brow(au0),
                jnp.broadcast_to(ex(a_up_1d[1:-1]), interior_shape),
                brow(jnp.zeros((), dtype)),
            ]
        )
        a_mid = jnp.concatenate(
            [
                brow(am0),
                jnp.broadcast_to(ex(a_mid_1d[1:-1]), interior_shape),
                brow(amn),
            ]
        )
        a_low = jnp.concatenate(
            [
                brow(jnp.zeros((), dtype)),
                jnp.broadcast_to(ex(a_low_1d[1:-1]), interior_shape),
                brow(aln),
            ]
        )
    else:
        a_up = a_up_1d.at[0].set(au0)
        a_mid = a_mid_1d.at[0].set(am0).at[n - 1].set(amn)
        a_low = a_low_1d.at[n - 1].set(aln)

    return a_up, a_mid, a_low, rhs


def _validate_periodic_data(y):
    """Eager first==last check for the periodic family
    (``cubic_spline.rs:483-489``).

    The check is data-dependent, so it only runs eagerly; building under
    ``jit``/``pjit`` skips it (like ``new_unchecked``, the caller vouches
    for the data)."""
    if not isinstance(y, jax.core.Tracer):
        y0_host = np.asarray(y[0])
        ylast_host = np.asarray(y[y.shape[0] - 1])
        if not np.array_equal(y0_host, ylast_host):
            raise BuilderValueError(
                "for periodic boundary condition the first and last value "
                f"must be equal. First: {y0_host}, last: {ylast_host}"
            )


@jax.jit
def _solve_periodic_core(x, y):
    n = x.shape[0]
    trailing = y.shape[1:]
    tr = len(trailing)
    dtype = y.dtype

    def ex(v):
        return jnp.asarray(v, dtype=dtype).reshape((-1,) + (1,) * tr)

    dx = x[1:] - x[:-1]
    dx0 = dx[0]

    if n == 3:
        # closed form (cubic_spline.rs:480-496)
        dx1 = dx[1]
        slope0 = (y[1] - y[0]) / dx0
        slope1 = (y[2] - y[1]) / dx1
        k_val = (slope0 / dx0 + slope1 / dx1) / (1.0 / dx0 + 1.0 / dx1)
        return jnp.broadcast_to(k_val[None], (3,) + trailing).astype(dtype)

    dx_1 = dx[n - 2]
    dx_2 = dx[n - 3]
    dx_3 = dx[n - 4]

    # condensed diagonals, length n-2: interior rows 1..n-3 keep
    # a_up[i]=dx[i-1], a_mid[i]=2(dx[i]+dx[i-1]), a_low[i]=dx[i]; row 0 is
    # overwritten per cubic_spline.rs:512-518 and row-0 a_low is unused.
    zero = jnp.zeros((), dtype)
    a_up = jnp.concatenate([dx_1[None], dx[0 : n - 3]])
    a_mid = jnp.concatenate(
        [(2.0 * (dx_1 + dx0))[None], 2.0 * (dx[1 : n - 2] + dx[0 : n - 3])]
    )
    a_low = jnp.concatenate([zero[None], dx[1 : n - 2]])

    slope0 = (y[1] - y[0]) / dx0
    slope_1 = (y[n - 1] - y[n - 2]) / dx_1
    slope_2 = (y[n - 2] - y[n - 3]) / dx_2

    # rhs rows 0..n-2 (length n-1): row 0 and row n-2 overwritten
    dxn = ex(dx[1 : n - 2])
    dxn_1 = ex(dx[0 : n - 3])
    rhs_interior = 3.0 * (
        dxn * (y[1 : n - 2] - y[0 : n - 3]) / dxn_1
        + dxn_1 * (y[2 : n - 1] - y[1 : n - 2]) / dxn
    )  # rows 1..n-3
    rhs_0 = (slope_1 * dx0 + slope0 * dx_1) * 3.0
    rhs_m2 = (slope_2 * dx_1 + slope_1 * dx_2) * 3.0
    rhs_full = jnp.concatenate(
        [rhs_0[None], rhs_interior, rhs_m2[None]], axis=0
    )  # (n-1, *trailing)

    rhs1 = rhs_full[: n - 2]
    rhs2 = jnp.zeros((n - 2,) + trailing, dtype)
    rhs2 = rhs2.at[0].set(-dx0)
    rhs2 = rhs2.at[n - 3].set(-dx_3)

    k1 = thomas_solve_fast(a_up, a_mid, a_low, rhs1)
    k2 = thomas_solve_fast(a_up, a_mid, a_low, rhs2)

    k_m1 = (rhs_full[n - 2] - k1[0] * dx_2 - k1[n - 3] * dx_1) / (
        k2[0] * dx_2 + k2[n - 3] * dx_1 + 2.0 * (dx_1 + dx_2)
    )

    k_head = k1 + k_m1 * k2  # rows 0..n-3
    return jnp.concatenate([k_head, k_m1[None], k_head[0][None]], axis=0)


@jax.jit
def _ab_from_k(x, data, k):
    """Per-interval coefficients from knot derivatives
    (``cubic_spline.rs:350-367``)."""
    dx = (x[1:] - x[:-1]).reshape((-1,) + (1,) * (data.ndim - 1))
    dy = data[1:] - data[:-1]
    c_a = k[:-1] * dx - dy
    c_b = dy - k[1:] * dx
    return c_a, c_b


# ---------------------------------------------------------------------------
# dense-operator build (wide banks on short knot axes, off the CPU)
# ---------------------------------------------------------------------------
# For ONE shared knot axis and a uniform boundary family (zero derivative
# payloads — every kind the named families and the per-axis 2-D/N-D solves
# use), the whole build pipeline is LINEAR in the data bank: the rhs
# assembly (cubic_spline.rs:456-471 and every boundary-row candidate with
# payload 0), the tridiagonal solve, the periodic condensed solve + its
# Sherman-Morrison correction (rhs2 and the correction denominator are
# x-only), and the (a, b) coefficient pass are all linear maps y ↦ ·.
# So the operator can be PROBED: run the existing pipeline once on an
# identity bank (an (n, n) solve — tiny next to a wide bank) and apply the
# resulting (m, n) matrix to the real bank as ONE matmul at
# ``Precision.HIGHEST`` (true f32, never TF32).  Traffic drops from
# ~log2(n) full-bank passes (PCR) to read-y + write-out, at O(n²·bank)
# flops — so it wins only while the knot axis is short (on an H100 the
# (64 knots × 1e6 splines) build took 1.2 ms dense vs 2.5 ms PCR, and
# (2048 × 4096) 1.9 ms dense vs 0.71 ms PCR).  Results differ from the
# PCR/scan orders by normal f32 rounding only (~4e-7 relative); the CPU
# keeps the reference-order scan solver bit-identical to
# ``cubic_spline.rs:678-721``.

# largest knot count that takes the dense route: the H100 crossover
# against PCR at 2^26 bank values lies between 256 knots (dense 2.3 ms,
# PCR 2.9 ms) and 512 (dense 3.5 ms, PCR 3.2 ms)
_DENSE_BUILD_MAX_N = 256


def _dense_matmul(op, y):
    """Apply a probed (m, n) build operator to a (n, *trailing) bank."""
    flat = y.reshape((y.shape[0], -1))
    out = jax.lax.dot_general(
        op,
        flat,
        (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.reshape((op.shape[0],) + y.shape[1:])


def _dense_k(x, y, kind, periodic):
    """Knot-derivative solve as a probed dense operator: k = K @ y."""
    eye = jnp.eye(x.shape[0], dtype=y.dtype)
    k_op = (
        _solve_periodic_core(x, eye)
        if periodic
        else _solve_for_k(x, eye, kind, 0.0, kind, 0.0)
    )
    return _dense_matmul(k_op, y)


def _dense_ab(x, y, kind, periodic):
    """Full build map as one probed operator: (a; b) = F @ y.

    Composes the k-solve with ``_ab_from_k`` (also linear in (k, y)) so
    the wide-bank build is a single matmul with no (n, bank)
    intermediate."""
    n = x.shape[0]
    eye = jnp.eye(n, dtype=y.dtype)
    k_cols = (
        _solve_periodic_core(x, eye)
        if periodic
        else _solve_for_k(x, eye, kind, 0.0, kind, 0.0)
    )
    a_cols, b_cols = _ab_from_k(x, eye, k_cols)
    f_op = jnp.concatenate([a_cols, b_cols], axis=0)  # (2(n-1), n)
    ab = _dense_matmul(f_op, y)
    return ab[: n - 1], ab[n - 1 :]


def _periodic_ab(x, y):
    """Non-dense twin of the periodic build map (the CPU route)."""
    return _ab_from_k(x, y, _solve_periodic_core(x, y))


def _uniform_ab(x, y, kind):
    """Non-dense twin of the uniform-boundary build map."""
    return _ab_from_k(x, y, _solve_for_k(x, y, kind, 0.0, kind, 0.0))


def _dense_build_ok(n, trailing_size):
    """Static eligibility for the dense route: a short knot axis
    (``n <= _DENSE_BUILD_MAX_N``) under a bank at least as wide as the
    (n, n) identity probe itself."""
    return n <= _DENSE_BUILD_MAX_N and trailing_size >= n


def _wrap_periodic(x, xq):
    """``rem_euclid`` wrap of out-of-range queries onto the base period
    (``cubic_spline.rs:804-809``)."""
    x0 = x[0]
    xn = x[x.shape[0] - 1]
    wrapped = jnp.mod(xq - x0, xn - x0) + x0
    in_r = (x0 <= xq) & (xq <= xn)
    return jnp.where(in_r, xq, wrapped)


# ---------------------------------------------------------------------------
# strategy builder + finished strategy
# ---------------------------------------------------------------------------
class CubicSpline(Interp1DStrategyBuilder):
    """Cubic-spline strategy builder (``cubic_spline.rs:84-88, 723-741``).

    Chainable configuration::

        CubicSpline()
        CubicSpline().extrapolate(True)
        CubicSpline().boundary(BoundaryCondition.Periodic)
    """

    MINIMUM_DATA_LENGTH = 3  # cubic_spline.rs:751

    def __init__(self, extrapolate: bool = False, boundary=None):
        self.extrapolates = bool(extrapolate)
        self._boundary = (
            boundary if boundary is not None else BoundaryCondition.NotAKnot
        )

    def extrapolate(self, yes: bool = True) -> "CubicSpline":
        return CubicSpline(extrapolate=yes, boundary=self._boundary)

    def boundary(self, bc: BoundaryCondition) -> "CubicSpline":
        return CubicSpline(extrapolate=self.extrapolates, boundary=bc)

    # -- build (cubic_spline.rs:754-771) ------------------------------------
    def build(self, x, data) -> "CubicSplineStrategy":
        if not jnp.issubdtype(data.dtype, jnp.inexact):
            raise TypeError(
                "CubicSpline requires a floating-point dtype; got "
                f"{data.dtype}"
            )
        a, b = self._calc_coefficients(x, data)
        if not self.extrapolates:
            mode = "no"
        elif self._boundary.kind == "periodic":
            mode = "periodic"
        else:
            mode = "yes"
        return CubicSplineStrategy(a, b, mode)

    def _calc_coefficients(self, x, data):
        """Knot-derivative solve + per-interval ``a``/``b``
        (``cubic_spline.rs:310-368``)."""
        bc = self._boundary
        trailing = tuple(data.shape[1:])
        # Run the solve on ONE flattened bank axis (one layout for every
        # trailing shape; the dense route's matmul wants 2-D operands
        # anyway).  Results are reshaped back.
        flat = len(trailing) > 1
        y = data.reshape((data.shape[0], -1)) if flat else data
        n = x.shape[0]
        tsize = y.shape[1] if y.ndim == 2 else 0
        if bc.kind == "periodic":
            _validate_periodic_data(y)
            if _dense_build_ok(n, tsize):
                c_a, c_b = jax.lax.platform_dependent(
                    x,
                    y,
                    cpu=_periodic_ab,
                    default=functools.partial(
                        _dense_ab, kind=0, periodic=True
                    ),
                )
                return self._unflatten_ab(c_a, c_b, trailing, flat)
            k = _solve_periodic_core(x, y)
        elif bc.kind == "individual":
            expected = (1,) + trailing
            if tuple(bc.rows.shape) != expected:
                raise ShapeError(
                    "Boundary conditions array has wrong shape. "
                    f"Expected: {list(expected)}, got: {list(bc.rows.shape)}"
                )
            lk, lv, rk, rv = _compile_rows(bc.rows.reshape(trailing))
            if flat:
                lk, lv, rk, rv = (v.reshape(-1) for v in (lk, lv, rk, rv))
            k = _solve_for_k(x, y, lk, lv, rk, rv)
        elif bc.kind == "individual_arrays":
            lk, lv, rk, rv = (jnp.asarray(v) for v in bc.arrays)
            for name, v in (("left_kind", lk), ("left_value", lv),
                            ("right_kind", rk), ("right_value", rv)):
                if tuple(v.shape) != trailing:
                    raise ShapeError(
                        "Boundary conditions array has wrong shape. "
                        f"Expected: {list(trailing)}, got: {list(v.shape)} "
                        f"({name})"
                    )
            if flat:
                lk, lv, rk, rv = (v.reshape(-1) for v in (lk, lv, rk, rv))
            k = _solve_for_k(x, y, lk, lv, rk, rv)
        else:
            kind = {
                "not_a_knot": _NOT_A_KNOT,
                "natural": _SECOND_DERIV,
                "clamped": _FIRST_DERIV,
            }[bc.kind]
            if _dense_build_ok(n, tsize):
                c_a, c_b = jax.lax.platform_dependent(
                    x,
                    y,
                    cpu=functools.partial(_uniform_ab, kind=kind),
                    default=functools.partial(
                        _dense_ab, kind=kind, periodic=False
                    ),
                )
                return self._unflatten_ab(c_a, c_b, trailing, flat)
            k = _solve_for_k(x, y, kind, 0.0, kind, 0.0)

        c_a, c_b = _ab_from_k(x, y, k)
        return self._unflatten_ab(c_a, c_b, trailing, flat)

    @staticmethod
    def _unflatten_ab(c_a, c_b, trailing, flat):
        if flat:
            c_a = c_a.reshape((c_a.shape[0],) + trailing)
            c_b = c_b.reshape((c_b.shape[0],) + trailing)
        return c_a, c_b


@register_pytree_node_class
class CubicSplineStrategy(Interp1DStrategy):
    """Finished cubic-spline strategy (``cubic_spline.rs:90-102``).

    Leaves: per-interval coefficient banks ``a``/``b`` with shape
    ``(n-1, *data.shape[1:])``.  Static: the extrapolation mode.
    """

    def __init__(self, a, b, mode: str = "no"):
        self.a = a
        self.b = b
        self.mode = mode  # "no" | "yes" | "periodic"

    @property
    def extrapolates(self) -> bool:
        return self.mode != "no"

    def eval(self, interp, xq):
        if self.mode == "periodic":
            xq = _wrap_periodic(interp.x, xq)
        _, _, t, y_l, y_r, a, b = self._interval_quantities(interp, xq)
        one = jnp.ones((), y_l.dtype)
        # symmetric Hermite, exact op order of cubic_spline.rs:818-828
        return (
            (one - t) * y_l
            + t * y_r
            + t * (one - t) * (a * (one - t) + b * t)
        )

    # -- calculus (beyond reference; SciPy CubicSpline parity) ---------------
    def _interval_quantities(self, interp, p):
        """(idx, dx, t, y_l, y_r, a, b) at flat query vector ``p``: one
        interval search, one gather of both knots, and ONE stacked row
        gather of ``[y_l, y_r, a, b]`` -- the shared front end of the
        value, derivative and antiderivative forms."""
        from ...ops.searchsorted import get_lower_index

        x = interp.x
        data = interp.data
        idx = get_lower_index(x, p)
        xg = jnp.stack([x[:-1], x[1:]], axis=-1)[idx]
        dx = xg[..., 1] - xg[..., 0]
        t = (p - xg[..., 0]) / dx
        tbl = jnp.stack([data[:-1], data[1:], self.a, self.b], axis=-1)
        g = tbl[idx]  # (Q, *trailing, 4)
        expand = p.shape + (1,) * (data.ndim - 1)
        return (
            idx,
            dx.reshape(expand),
            t.reshape(expand),
            g[..., 0],
            g[..., 1],
            g[..., 2],
            g[..., 3],
        )

    def eval_derivative(self, interp, xq, order=1):
        """Analytic d^order y/dx^order of the symmetric Hermite form
        ``y = (1-t)y_l + t y_r + t(1-t)[a(1-t) + b t]``
        (``cubic_spline.rs:818-828``), order in {1, 2, 3}:
        ``y' = [y_r - y_l + (1-2t)(a(1-t)+bt) + t(1-t)(b-a)] / dx``,
        ``y'' = [a(6t-4) + b(2-6t)] / dx²``, ``y''' = 6(a-b)/dx³``
        (piecewise constant).  Pure/jittable; periodic mode wraps like
        ``eval``."""
        if order not in (1, 2, 3):
            raise ValueError(
                f"derivative order must be 1, 2, or 3; got {order}"
            )
        if self.mode == "periodic":
            xq = _wrap_periodic(interp.x, xq)
        _, dx, t, y_l, y_r, a, b = self._interval_quantities(interp, xq)
        one = jnp.ones((), y_l.dtype)
        if order == 1:
            dydt = (
                (y_r - y_l)
                + (one - 2 * t) * (a * (one - t) + b * t)
                + t * (one - t) * (b - a)
            )
            return dydt / dx
        if order == 2:
            return (a * (6 * t - 4) + b * (2 - 6 * t)) / (dx * dx)
        return 6 * (a - b) / (dx * dx * dx)

    def _antideriv(self, interp, p):
        """F(p) = ∫_{x[0]}^{p} y dx (flat ``p``): cumulative exact
        per-interval integrals + the partial-interval polynomial.  The
        full-interval integral of the symmetric Hermite form is
        ``dx·[(y_l+y_r)/2 + (a+b)/12]``; the partial (0..t) is
        ``dx·[y_l(t - t²/2) + y_r t²/2 + a(t²/2 - 2t³/3 + t⁴/4)
        + b(t³/3 - t⁴/4)]``.  Periodic mode decomposes into whole
        periods × the total + a wrapped remainder."""
        x = interp.x
        data = interp.data
        tr = data.ndim - 1
        dxk = (x[1:] - x[:-1]).reshape((-1,) + (1,) * tr)
        full = dxk * (
            0.5 * (data[:-1] + data[1:]) + (self.a + self.b) / 12.0
        )
        cum = jnp.cumsum(full, axis=0)
        csum = jnp.concatenate([jnp.zeros_like(full[:1]), cum], axis=0)

        def F_in(p):
            idx, dx, t, y_l, y_r, a, b = self._interval_quantities(
                interp, p
            )
            t2 = t * t
            t3 = t2 * t
            t4 = t2 * t2
            part = (
                y_l * (t - 0.5 * t2)
                + y_r * (0.5 * t2)
                + a * (0.5 * t2 - 2.0 * t3 / 3.0 + 0.25 * t4)
                + b * (t3 / 3.0 - 0.25 * t4)
            )
            return csum[idx] + dx * part

        if self.mode == "periodic":
            x0 = x[0]
            xn = x[x.shape[0] - 1]
            period = xn - x0
            k = jnp.floor((p - x0) / period)
            pw = p - k * period
            expand = p.shape + (1,) * tr
            return k.reshape(expand) * csum[-1] + F_in(pw)
        return F_in(p)

    def eval_integrate(self, interp, lo, hi):
        """∫_lo^hi y dx per trailing element (signed; lo > hi negates).
        Pure/jittable; exact polynomial quadrature, no sampling."""
        dtype = jnp.result_type(interp.x.dtype, interp.data.dtype)
        bounds = jnp.stack(
            [jnp.asarray(lo, dtype), jnp.asarray(hi, dtype)]
        )
        f = self._antideriv(interp, bounds)
        return f[1] - f[0]

    def eval_solve(self, interp, y=0.0):
        """Real roots of ``spline(x) - y``: each interval's symmetric
        Hermite form expands to the monomial cubic
        ``(y_l - y) + (y_r - y_l + a) t + (b - 2a) t² + (a - b) t³``,
        solved closed-form in one static-shape batch
        (``ops/cubicroots.py``), so the result is NaN-padded
        ``(3(n-1), *trailing)``, sorted ascending — jittable, no dynamic
        shapes.  ``y`` may be scalar or trailing-broadcastable.
        Extrapolating splines ("yes") also report roots of the edge
        polynomials outside the domain; periodic splines report the
        base-domain roots.  A segment identically equal to ``y``
        contributes its left knot as one representative root."""
        from ...ops.cubicroots import interval_roots_to_x, real_cubic_roots

        data = interp.data
        dtype = jnp.result_type(interp.x.dtype, data.dtype, jnp.float32)
        yq = jnp.asarray(y, dtype)
        y_l = data[:-1].astype(dtype)
        y_r = data[1:].astype(dtype)
        a = self.a.astype(dtype)
        b = self.b.astype(dtype)
        c0 = y_l - yq
        c1 = (y_r - y_l) + a
        c2 = b - 2.0 * a
        c3 = a - b
        t = real_cubic_roots(c0, c1, c2, c3)
        const0 = (c0 == 0) & (c1 == 0) & (c2 == 0) & (c3 == 0)
        t = t.at[..., 0].set(jnp.where(const0, 0.0, t[..., 0]))
        return interval_roots_to_x(
            interp.x.astype(dtype), t, extrapolate=(self.mode == "yes")
        )

    # -- pytree --------------------------------------------------------------
    def tree_flatten(self):
        return (self.a, self.b), (self.mode,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        # older pickled treedefs carry a second (routing-hint) aux entry;
        # only the mode matters
        return cls(children[0], children[1], aux[0])

    def __repr__(self):
        return f"CubicSplineStrategy(a={self.a.shape}, mode={self.mode})"
