"""Double-float evaluation routes: f64-grade answers from f32 arithmetic.

Every value -- knots, data, coefficients, queries, output -- is a
double-float ``(hi, lo)`` f32 pair (``ops/df.py``), giving ~48 mantissa
bits end to end.  The routes are plain ``jax.numpy`` / ``lax``: interval
search, row gathers and the error-free-transform (EFT) chains of the
Hermite, bilinear, bicubic and N-D tails, each EFT step guarded by
``ops/df._guard`` so XLA cannot rewrite it.

Interval selection compares DF pairs lexicographically, so knots that are
*equal in f32 but distinct in f64* still select the correct interval --
bucketize decisions match the f64 oracle's, not f32-rounded ones.

Routes (serving packs each table once and passes it as a jit argument):

====================================  ==========================================
entry point                           route
====================================  ==========================================
``eval_xla_df``                       1-D scalar axis (``cubic_spline.rs:791-830``)
``eval_xla_df_banked``                1-D bank, two row gathers per query
``gathered_bank_eval_df[_packed]``    1-D bank, one packed (hi, lo) row gather
``gathered_bank_eval_f48_packed``     the same with the bf16-lo ("f48") table
``eval_xla_df_2d``                    bilinear, four corner gathers
``gathered_bilinear_eval_*``          bilinear, one packed corner-row gather
``gathered_bicubic_eval_*``           bicubic cell table, one row gather
``gathered_bicubic_nodes_eval_df``    bicubic node table, four row gathers
``gathered_nd_eval_df_packed``        InterpND cell table (cubic / linear)
====================================  ==========================================

The "f48" tier stores the lo half of each table rounded to bf16, two per
f32 lane: 75% of the DF table's memory and gather traffic at ~2^-33
scale-relative accuracy, between the f32 routes (~2^-24) and DF (~2^-48).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.hygiene import check_route_tables
from .df import df_add, df_div, df_mul, df_neg, df_sub


# -- interval search ----------------------------------------------------------
def _df_lower_index(x_hi, x_lo, q_hi, q_lo, n, block=None):
    """DF-lexicographic ``get_lower_index`` (compare-all form).

    The count needs the full lexicographic compare (hi, then lo on hi
    ties), which has no ``searchsorted`` method -- so it is O(Q·n).  The
    (Q, n) mask is built in query blocks capped at ~64M elements, so a
    1M-query bucket over a long axis never materializes a
    multi-gigabyte mask."""
    nq = q_hi.shape[0]

    def count(qh, ql):
        le = (x_hi[None, :] < qh[:, None]) | (
            (x_hi[None, :] == qh[:, None]) & (x_lo[None, :] <= ql[:, None])
        )
        return jnp.clip(
            jnp.sum(le, axis=1).astype(jnp.int32) - 1, 0, n - 2
        )

    if block is None:
        block = max(1, (1 << 26) // max(int(n), 1))
    if nq <= block:
        return count(q_hi, q_lo)
    npad = -(-nq // block) * block - nq
    qh = jnp.pad(q_hi, (0, npad)).reshape(-1, block)
    ql = jnp.pad(q_lo, (0, npad)).reshape(-1, block)
    idx = jax.lax.map(lambda a: count(a[0], a[1]), (qh, ql))
    return idx.reshape(-1)[:nq]


def df_index_frac(x_hi, x_lo, q_hi, q_lo):
    """``(idx, t_hi, t_lo)``: DF-lexicographic index + DF fraction."""
    n = x_hi.shape[0]
    idx = _df_lower_index(x_hi, x_lo, q_hi, q_lo, n)
    x_l = (x_hi[idx], x_lo[idx])
    x_r = (x_hi[idx + 1], x_lo[idx + 1])
    t = df_div(df_sub((q_hi, q_lo), x_l), df_sub(x_r, x_l))
    return idx, t[0], t[1]


def _df_index_frac_2d(x_hi, x_lo, y_hi, y_lo, qx_hi, qx_lo, qy_hi, qy_lo):
    """Both axes' DF ``(idx, t)`` passes."""
    xi, txh, txl = df_index_frac(x_hi, x_lo, qx_hi, qx_lo)
    yi, tyh, tyl = df_index_frac(y_hi, y_lo, qy_hi, qy_lo)
    return xi, txh, txl, yi, tyh, tyl


# -- 1-D ----------------------------------------------------------------------
def eval_xla_df(x_hi, x_lo, d_hi, d_lo, a_hi, a_lo, b_hi, b_lo, q_hi, q_lo):
    """Double-float 1-D Hermite evaluation on a scalar axis: the
    reference's symmetric form (``cubic_spline.rs:818-828``) with every
    step an EFT chain.  Returns the (hi, lo) pair of shape ``(nq,)``."""
    n = x_hi.shape[0]
    idx = _df_lower_index(x_hi, x_lo, q_hi, q_lo, n)
    pick = lambda v: (v[0][idx], v[1][idx])
    pick1 = lambda v: (v[0][idx + 1], v[1][idx + 1])
    x_l = pick((x_hi, x_lo))
    x_r = pick1((x_hi, x_lo))
    y_l = pick((d_hi, d_lo))
    y_r = pick1((d_hi, d_lo))
    a = pick((a_hi, a_lo))
    b = pick((b_hi, b_lo))
    q = (q_hi, q_lo)

    t = df_div(df_sub(q, x_l), df_sub(x_r, x_l))
    one = (jnp.ones_like(q_hi), jnp.zeros_like(q_hi))
    omt = df_sub(one, t)
    base = df_add(
        df_add(df_mul(omt, y_l), df_mul(t, y_r)),
        df_mul(df_mul(t, omt), df_add(df_mul(a, omt), df_mul(b, t))),
    )
    tn = (q_hi - x_l[0]) / (x_r[0] - x_l[0])  # naive t: inf survives here
    lin_inf = (
        jnp.isinf(tn)
        & (a[0] == 0.0) & (a[1] == 0.0) & (b[0] == 0.0) & (b[1] == 0.0)
    )
    alt = y_l[0] + tn * (y_r[0] - y_l[0])
    return (
        jnp.where(lin_inf, alt, base[0]),
        jnp.where(lin_inf, jnp.zeros_like(alt), base[1]),
    )


def eval_df_from_f64(x64, d64, a64, b64, q64):
    """Convenience wrapper: split f64 host arrays, run :func:`eval_xla_df`,
    recombine to f64 on the host."""
    from .df import df_from_f64, df_to_f64

    args = []
    for v in (x64, d64, a64, b64, q64):
        args.extend(df_from_f64(v))
    hi, lo = jax.jit(eval_xla_df)(*args)
    return df_to_f64(hi, lo)


def eval_xla_df_banked(
    x_hi, x_lo, d_hi, d_lo, a_hi, a_lo, b_hi, b_lo, q_hi, q_lo
):
    """Double-float banked Hermite evaluation: data/a/b are 2-D
    ``(n, bank)`` / ``(n-1, bank)`` pairs; queries flat.  Two packed row
    gathers (hi + lo) feed the DF polynomial.  Returns the (hi, lo) pair
    ``(nq, bank)``."""
    n = x_hi.shape[0]
    idx = _df_lower_index(x_hi, x_lo, q_hi, q_lo, n)
    x_l = (x_hi[idx], x_lo[idx])
    x_r = (x_hi[idx + 1], x_lo[idx + 1])
    q = (q_hi, q_lo)
    t = df_div(df_sub(q, x_l), df_sub(x_r, x_l))

    def rows(v):
        packed = jnp.concatenate([v[:-1], v[1:]], axis=1)  # y_l | y_r
        return jnp.take(packed, idx, axis=0)

    def rows_ab(va, vb):
        return jnp.take(jnp.concatenate([va, vb], axis=1), idx, axis=0)

    bank = d_hi.shape[1]
    gh, gl = rows(d_hi), rows(d_lo)
    abh, abl = rows_ab(a_hi, b_hi), rows_ab(a_lo, b_lo)
    y_l = (gh[:, :bank], gl[:, :bank])
    y_r = (gh[:, bank:], gl[:, bank:])
    a = (abh[:, :bank], abl[:, :bank])
    b = (abh[:, bank:], abl[:, bank:])

    te = (t[0][:, None], t[1][:, None])
    one = (jnp.ones_like(te[0]), jnp.zeros_like(te[0]))
    omt = df_sub(one, te)
    base = df_add(
        df_add(df_mul(omt, y_l), df_mul(te, y_r)),
        df_mul(df_mul(te, omt), df_add(df_mul(a, omt), df_mul(b, te))),
    )
    tn = (q_hi - x_l[0]) / (x_r[0] - x_l[0])  # naive t: inf survives here
    lin_inf = (
        jnp.isinf(tn)[:, None]
        & (a[0] == 0.0) & (a[1] == 0.0) & (b[0] == 0.0) & (b[1] == 0.0)
    )
    alt = y_l[0] + tn[:, None] * (y_r[0] - y_l[0])
    return (
        jnp.where(lin_inf, alt, base[0]),
        jnp.where(lin_inf, jnp.zeros_like(alt), base[1]),
    )


def pack_bank_rows_df(d_hi, d_lo, a_hi, a_lo, b_hi, b_lo):
    """Packed DF per-interval rows ``(n-1, 8*bank_pad)``:
    ``[y_l | y_r | a | b]`` hi halves then lo halves, each block padded
    to a multiple of 8 lanes -- one row gather per query."""
    bank = d_hi.shape[1]
    bp = -(-bank // 8) * 8
    pad = ((0, 0), (0, bp - bank))

    def p(v):
        return jnp.pad(v, pad)

    return jnp.concatenate(
        [
            p(d_hi[:-1]), p(d_hi[1:]), p(a_hi), p(b_hi),
            p(d_lo[:-1]), p(d_lo[1:]), p(a_lo), p(b_lo),
        ],
        axis=1,
    )


def _df_bank_hermite(y_l, y_r, a, b, t):
    """The DF symmetric-Hermite chain on banked (hi, lo) block pairs.
    The ``lin_inf`` escape matches the f32 route's contract: ±inf queries
    on a linear segment (a=b=0) evaluate the linear form so the result is
    ±inf, not NaN from inf·0."""
    one = (jnp.ones_like(t[0]), jnp.zeros_like(t[0]))
    omt = df_sub(one, t)
    base = df_add(
        df_add(df_mul(omt, y_l), df_mul(t, y_r)),
        df_mul(df_mul(t, omt), df_add(df_mul(a, omt), df_mul(b, t))),
    )
    tn = t[0]
    lin_inf = (
        jnp.isinf(tn)
        & (a[0] == 0.0) & (a[1] == 0.0) & (b[0] == 0.0) & (b[1] == 0.0)
    )
    alt = y_l[0] + tn * (y_r[0] - y_l[0])
    return (
        jnp.where(lin_inf, alt, base[0]),
        jnp.where(lin_inf, jnp.zeros_like(alt), base[1]),
    )


def _df_xla_tail(rows, th, tl, bank):
    """DF Hermite on gathered :func:`pack_bank_rows_df` rows."""
    bp = rows.shape[1] // 8

    def sl(i):
        return rows[:, i * bp : i * bp + bank]

    return _df_bank_hermite(
        (sl(0), sl(4)), (sl(1), sl(5)), (sl(2), sl(6)), (sl(3), sl(7)),
        (th[:, None], tl[:, None]),
    )


def gathered_bank_eval_df(
    x_hi, x_lo, d_hi, d_lo, a_hi, a_lo, b_hi, b_lo, q_hi, q_lo,
):
    """DF banked gather route: DF (idx, t) → ONE packed (hi, lo) row
    gather → DF Hermite tail.  Returns (hi, lo) of shape ``(nq, bank)``."""
    # guard the RAW tables too: packing under an ambient jit turns the
    # concrete arrays into tracers before the packed route's check, so
    # a closure-captured bank would slip through
    check_route_tables(
        "gathered_bank_eval_df",
        [("d_hi", d_hi), ("d_lo", d_lo), ("a_hi", a_hi), ("a_lo", a_lo),
         ("b_hi", b_hi), ("b_lo", b_lo)],
        (q_hi, q_lo),
    )
    packed = pack_bank_rows_df(d_hi, d_lo, a_hi, a_lo, b_hi, b_lo)
    return gathered_bank_eval_df_packed(
        x_hi, x_lo, packed, d_hi.shape[1], q_hi, q_lo
    )


def gathered_bank_eval_df_packed(x_hi, x_lo, packed, bank, q_hi, q_lo):
    """The banked DF gather route from a PREPACKED row table (serving
    packs once at evaluator build and passes the table as an argument)."""
    check_route_tables(
        "gathered_bank_eval_df_packed", [("packed", packed)], (q_hi, q_lo)
    )
    idx, th, tl = df_index_frac(x_hi, x_lo, q_hi, q_lo)
    rows = jnp.take(packed, idx, axis=0)
    return _df_xla_tail(rows, th, tl, bank)


def _pack_f48_lo(lo_blocks):
    """Round a lo section to bf16 and pack two values per f32 lane: the
    first half of the lanes in the high 16 bits, the second half in the
    low 16 (bf16 → f32 is appending 16 zero bits, so unpacking is two
    integer masks -- :func:`_unpack_f48_lo`)."""
    lo16 = jax.lax.bitcast_convert_type(
        lo_blocks.astype(jnp.bfloat16), jnp.uint16
    ).astype(jnp.uint32)
    half = lo16.shape[1] // 2
    return jax.lax.bitcast_convert_type(
        (lo16[:, :half] << 16) | lo16[:, half:], jnp.float32
    )


def _unpack_f48_lo(packed_lo):
    """Unpack a bf16-pair lo section back to twice as many f32 lanes:
    high 16 bits → the first half of the output blocks, low 16 bits
    (shifted up) → the second half."""
    u = jax.lax.bitcast_convert_type(packed_lo, jnp.uint32)
    first = jax.lax.bitcast_convert_type(
        u & jnp.uint32(0xFFFF0000), jnp.float32
    )
    second = jax.lax.bitcast_convert_type(u << 16, jnp.float32)
    return jnp.concatenate([first, second], axis=1)


def pack_bank_rows_f48(d_hi, d_lo, a_hi, a_lo, b_hi, b_lo):
    """"f48" banked per-interval rows ``(n-1, 6*bp)``: the 4 hi blocks
    ``[y_l | y_r | a | b]`` exactly as in :func:`pack_bank_rows_df`, plus
    the 4 lo blocks rounded to bf16 and packed two per f32 lane
    (``[y_l_lo | y_r_lo]`` high, ``[a_lo | b_lo]`` low)."""
    bank = d_hi.shape[1]
    bp = -(-bank // 8) * 8
    pad = ((0, 0), (0, bp - bank))

    def p(v):
        return jnp.pad(v, pad)

    hi = jnp.concatenate(
        [p(d_hi[:-1]), p(d_hi[1:]), p(a_hi), p(b_hi)], axis=1
    )
    lo = jnp.concatenate(
        [p(d_lo[:-1]), p(d_lo[1:]), p(a_lo), p(b_lo)], axis=1
    )
    return jnp.concatenate([hi, _pack_f48_lo(lo)], axis=1)


def gathered_bank_eval_f48_packed(x_hi, x_lo, packed, bank, q_hi, q_lo):
    """The f48-tier banked gather route: :func:`gathered_bank_eval_df_packed`
    from a :func:`pack_bank_rows_f48` table (6bp channels per row)."""
    check_route_tables(
        "gathered_bank_eval_f48_packed", [("packed", packed)], (q_hi, q_lo)
    )
    idx, th, tl = df_index_frac(x_hi, x_lo, q_hi, q_lo)
    rows = jnp.take(packed, idx, axis=0)
    bp = packed.shape[1] // 6
    full = jnp.concatenate(
        [rows[:, : 4 * bp], _unpack_f48_lo(rows[:, 4 * bp :])], axis=1
    )
    return _df_xla_tail(full, th, tl, bank)


# -- bilinear -----------------------------------------------------------------
def _df_calc_frac(x1, y1, x2, y2, q):
    """calc_frac in double-float with the reference slope op order
    (``linear.rs:29-37``): m = (y2-y1)/(x2-x1); m*(q-x1)+y1."""
    m = df_div(df_sub(y2, y1), df_sub(x2, x1))
    return df_add(df_mul(m, df_sub(q, x1)), y1)


def eval_xla_df_2d(
    x_hi, x_lo, y_hi, y_lo, z_hi, z_lo, qx_hi, qx_lo, qy_hi, qy_lo
):
    """Double-float bilinear evaluation (reference semantics
    ``bilinear.rs:64-98``) with four corner gathers.  ``z`` may carry
    trailing (bank) dims; returns the (hi, lo) result of shape
    ``(nq, *z.shape[2:])``."""
    nx, ny = x_hi.shape[0], y_hi.shape[0]
    xi = _df_lower_index(x_hi, x_lo, qx_hi, qx_lo, nx)
    yi = _df_lower_index(y_hi, y_lo, qy_hi, qy_lo, ny)
    ex = (Ellipsis,) + (None,) * (z_hi.ndim - 2)  # broadcast over trailing

    def pick(vh, vl, i):
        return (vh[i][ex], vl[i][ex])

    x1 = pick(x_hi, x_lo, xi)
    x2 = pick(x_hi, x_lo, xi + 1)
    y1 = pick(y_hi, y_lo, yi)
    y2 = pick(y_hi, y_lo, yi + 1)
    z11 = (z_hi[xi, yi], z_lo[xi, yi])
    z12 = (z_hi[xi, yi + 1], z_lo[xi, yi + 1])
    z21 = (z_hi[xi + 1, yi], z_lo[xi + 1, yi])
    z22 = (z_hi[xi + 1, yi + 1], z_lo[xi + 1, yi + 1])
    qx = (qx_hi[ex], qx_lo[ex])
    qy = (qy_hi[ex], qy_lo[ex])
    zq1 = _df_calc_frac(x1, z11, x2, z21, qx)
    zq2 = _df_calc_frac(x1, z12, x2, z22, qx)
    return _df_calc_frac(y1, zq1, y2, zq2, qy)


def _bilinear_corner_blocks(g, bp):
    """Corner blocks ``(nx-1, ny-1, 4*bp)`` of ``g``: ``[z11|z12|z21|z22]``
    with trailing dims flattened and channel-padded to ``bp``."""
    nx, ny = g.shape[0], g.shape[1]
    r = 1
    for s in g.shape[2:]:
        r *= s
    g = g.reshape(nx, ny, r)
    quad = jnp.stack(
        [g[:-1, :-1], g[:-1, 1:], g[1:, :-1], g[1:, 1:]], axis=2
    )  # (nx-1, ny-1, 4, r)
    if bp != r:
        quad = jnp.pad(quad, ((0, 0),) * 3 + ((0, bp - r),))
    return quad.reshape(nx - 1, ny - 1, 4 * bp)


def pack_bilinear_rows_df(z_hi, z_lo):
    """DF per-cell corner rows ``((nx-1)(ny-1), 8*bp)``: the 4 corner
    blocks hi then lo, trailing dims flattened and padded to bp
    (multiple of 8).  z: (nx, ny, *trailing) pairs."""
    nx, ny = z_hi.shape[0], z_hi.shape[1]
    r = 1
    for s in z_hi.shape[2:]:
        r *= s
    bp = -(-r // 8) * 8
    return jnp.concatenate(
        [_bilinear_corner_blocks(z_hi, bp), _bilinear_corner_blocks(z_lo, bp)],
        axis=-1,
    ).reshape((nx - 1) * (ny - 1), 8 * bp)


def pack_bilinear_rows_f48(z_hi, z_lo):
    """"f48" bilinear corner rows ``((nx-1)(ny-1), 6*bp)``: the 4 hi
    corner blocks exactly as in :func:`pack_bilinear_rows_df`, plus the 4
    lo blocks rounded to bf16 and packed two per f32 lane.  Packs
    directly from the (hi, lo) corners, so no transient DF table is
    materialized."""
    nx, ny = z_hi.shape[0], z_hi.shape[1]
    r = 1
    for s in z_hi.shape[2:]:
        r *= s
    bp = -(-r // 8) * 8
    ncell = (nx - 1) * (ny - 1)
    hi = _bilinear_corner_blocks(z_hi, bp).reshape(ncell, 4 * bp)
    lo = _bilinear_corner_blocks(z_lo, bp).reshape(ncell, 4 * bp)
    return jnp.concatenate([hi, _pack_f48_lo(lo)], axis=1)


def _df_bilinear_core(z11, z12, z21, z22, tx, ty):
    """The DF bilinear chain on corner (hi, lo) pairs.  Lerp-with-t
    form: z1 + t*(z2 - z1), equivalent to the reference calc_frac to DF
    rounding."""
    zq1 = df_add(z11, df_mul(tx, df_sub(z21, z11)))
    zq2 = df_add(z12, df_mul(tx, df_sub(z22, z12)))
    return df_add(zq1, df_mul(ty, df_sub(zq2, zq1)))


def _df_bilinear_xla_tail(rows, txh, txl, tyh, tyl, r):
    """DF bilinear on gathered :func:`pack_bilinear_rows_df` rows."""
    bp = rows.shape[1] // 8

    def sl(i):
        return rows[:, i * bp : i * bp + r]

    out = _df_bilinear_core(
        (sl(0), sl(4)), (sl(1), sl(5)), (sl(2), sl(6)), (sl(3), sl(7)),
        (txh[:, None], txl[:, None]), (tyh[:, None], tyl[:, None]),
    )
    return out[0], out[1]


def gathered_bilinear_eval_df(
    x_hi, x_lo, y_hi, y_lo, z_hi, z_lo, qx_hi, qx_lo, qy_hi, qy_lo,
):
    """DF bilinear gather route: two DF (idx, t) passes + ONE packed
    (hi, lo) corner-row gather + the DF tail.  z may carry trailing dims;
    returns (hi, lo) of ``(nq, *z.shape[2:])``."""
    check_route_tables(
        "gathered_bilinear_eval_df", [("z_hi", z_hi), ("z_lo", z_lo)],
        (qx_hi, qx_lo, qy_hi, qy_lo),
    )
    packed = pack_bilinear_rows_df(z_hi, z_lo)
    r = 1
    for s_ in z_hi.shape[2:]:
        r *= s_
    hi, lo = gathered_bilinear_eval_df_packed(
        x_hi, x_lo, y_hi, y_lo, packed, z_hi.shape[1], r,
        qx_hi, qx_lo, qy_hi, qy_lo,
    )
    trailing = z_hi.shape[2:]
    nq = qx_hi.shape[0]
    return hi.reshape((nq,) + trailing), lo.reshape((nq,) + trailing)


def gathered_bilinear_eval_df_packed(
    x_hi, x_lo, y_hi, y_lo, packed, ny, r, qx_hi, qx_lo, qy_hi, qy_lo,
):
    """The bilinear DF gather route from a PREPACKED corner table.
    Returns flat (nq, r) pairs."""
    check_route_tables(
        "gathered_bilinear_eval_df_packed", [("packed", packed)],
        (qx_hi, qx_lo, qy_hi, qy_lo),
    )
    xi, txh, txl, yi, tyh, tyl = _df_index_frac_2d(
        x_hi, x_lo, y_hi, y_lo, qx_hi, qx_lo, qy_hi, qy_lo
    )
    rows = jnp.take(packed, xi * (ny - 1) + yi, axis=0)
    return _df_bilinear_xla_tail(rows, txh, txl, tyh, tyl, r)


def gathered_bilinear_eval_f48_packed(
    x_hi, x_lo, y_hi, y_lo, packed, ny, r, qx_hi, qx_lo, qy_hi, qy_lo,
):
    """The f48-tier bilinear gather route from a PREPACKED
    :func:`pack_bilinear_rows_f48` table (6bp channels per row)."""
    check_route_tables(
        "gathered_bilinear_eval_f48_packed", [("packed", packed)],
        (qx_hi, qx_lo, qy_hi, qy_lo),
    )
    xi, txh, txl, yi, tyh, tyl = _df_index_frac_2d(
        x_hi, x_lo, y_hi, y_lo, qx_hi, qx_lo, qy_hi, qy_lo
    )
    rows = jnp.take(packed, xi * (ny - 1) + yi, axis=0)
    bp = packed.shape[1] // 6
    full = jnp.concatenate(
        [rows[:, : 4 * bp], _unpack_f48_lo(rows[:, 4 * bp :])], axis=1
    )
    return _df_bilinear_xla_tail(full, txh, txl, tyh, tyl, r)


# -- bicubic ------------------------------------------------------------------
def _bicubic_blocks(v, r):
    """``(cells, 16r)`` pre-scaled cell rows as 16 blocks padded to ``bp``
    lanes each: ``(cells, 16*bp)``."""
    cells = v.shape[0]
    bp = -(-r // 8) * 8
    v3 = v.reshape(cells, 16, r)
    if bp != r:
        v3 = jnp.pad(v3, ((0, 0), (0, 0), (0, bp - r)))
    return v3.reshape(cells, 16 * bp)


def pack_bicubic_rows_df(rows_hi, rows_lo, r):
    """DF bicubic cell rows ``(cells, 32*bp)``: the 16 pre-scaled corner
    quantity blocks (bicubic cell layout, ``models/strategies/bicubic.
    pack_bicubic_rows``) hi then lo, each r-block padded to bp."""
    return jnp.concatenate(
        [_bicubic_blocks(rows_hi, r), _bicubic_blocks(rows_lo, r)], axis=1
    )


def pack_bicubic_rows_f48(rows_hi, rows_lo, r):
    """"f48" bicubic cell rows ``(cells, 24*bp)``: the 16 pre-scaled hi
    blocks exactly as in :func:`pack_bicubic_rows_df`, plus the 16 lo
    blocks rounded to bf16 and packed two per f32 lane (lo block ``j`` in
    the high half, block ``j + 8`` in the low half)."""
    return jnp.concatenate(
        [_bicubic_blocks(rows_hi, r),
         _pack_f48_lo(_bicubic_blocks(rows_lo, r))],
        axis=1,
    )


def _df_hermite_scaled(y_l, y_r, K_l, K_r, t, one):
    """DF Hermite with pre-scaled derivatives (a = K_l - dy)."""
    dy = df_sub(y_r, y_l)
    a = df_sub(K_l, dy)
    b = df_sub(dy, K_r)
    omt = df_sub(one, t)
    return df_add(
        df_add(df_mul(omt, y_l), df_mul(t, y_r)),
        df_mul(df_mul(t, omt), df_add(df_mul(a, omt), df_mul(b, t))),
    )


def _df_bicubic_tail(rows, txh, txl, tyh, tyl, bp):
    """DF bicubic tail on gathered cell rows ``(B, 32*bp)``; t pairs are
    ``(B, 1)`` columns.  The 5-Hermite nesting of the f32 cell route
    (``models/strategies/bicubic._cell_tail_nested``)."""
    def sl(i):
        return rows[:, i * bp : (i + 1) * bp]

    def q(i):  # quantity i: corners [11, 12, 21, 22] as DF pairs
        return [(sl(4 * i + c), sl(16 + 4 * i + c)) for c in range(4)]

    f = q(0)
    kx = q(1)
    ky = q(2)
    kxy = q(3)
    tx = (txh, txl)
    ty = (tyh, tyl)
    one = (jnp.ones_like(txh), jnp.zeros_like(txh))
    f_y1 = _df_hermite_scaled(f[0], f[2], kx[0], kx[2], tx, one)
    f_y2 = _df_hermite_scaled(f[1], f[3], kx[1], kx[3], tx, one)
    g_y1 = _df_hermite_scaled(ky[0], ky[2], kxy[0], kxy[2], tx, one)
    g_y2 = _df_hermite_scaled(ky[1], ky[3], kxy[1], kxy[3], tx, one)
    return _df_hermite_scaled(f_y1, f_y2, g_y1, g_y2, ty, one)


def gathered_bicubic_eval_df(
    x_hi, x_lo, y_hi, y_lo, rows_hi, rows_lo, qx_hi, qx_lo, qy_hi, qy_lo,
    r=1,
):
    """DF bicubic gather route: two DF (idx, t) passes + ONE packed
    (hi, lo) cell-row gather + the DF tail.

    ``rows``: the PRE-SCALED 16r-channel cell table (hi, lo) -- split
    the f64 ``BicubicStrategy.rows`` with ``df_from_f64`` and feed both
    halves here."""
    check_route_tables(
        "gathered_bicubic_eval_df",
        [("rows_hi", rows_hi), ("rows_lo", rows_lo)],
        (qx_hi, qx_lo, qy_hi, qy_lo),
    )
    packed = pack_bicubic_rows_df(rows_hi, rows_lo, r)
    return gathered_bicubic_eval_df_packed(
        x_hi, x_lo, y_hi, y_lo, packed, qx_hi, qx_lo, qy_hi, qy_lo, r=r,
    )


def _bicubic_cell_rows(x_hi, x_lo, y_hi, y_lo, packed, qs):
    """DF (idx, t) passes + the one cell-row gather of the bicubic routes."""
    xi, txh, txl, yi, tyh, tyl = _df_index_frac_2d(
        x_hi, x_lo, y_hi, y_lo, *qs
    )
    rows = jnp.take(packed, xi * (y_hi.shape[0] - 1) + yi, axis=0)
    return rows, (txh[:, None], txl[:, None], tyh[:, None], tyl[:, None])


def gathered_bicubic_eval_df_packed(
    x_hi, x_lo, y_hi, y_lo, packed, qx_hi, qx_lo, qy_hi, qy_lo, r=1,
):
    """The bicubic DF gather route from a PREPACKED ``(cells, 32*bp)``
    table."""
    check_route_tables(
        "gathered_bicubic_eval_df_packed", [("packed", packed)],
        (qx_hi, qx_lo, qy_hi, qy_lo),
    )
    rows, ts = _bicubic_cell_rows(
        x_hi, x_lo, y_hi, y_lo, packed, (qx_hi, qx_lo, qy_hi, qy_lo)
    )
    hi, lo = _df_bicubic_tail(rows, *ts, packed.shape[1] // 32)
    return hi[:, :r], lo[:, :r]


def gathered_bicubic_eval_f48_packed(
    x_hi, x_lo, y_hi, y_lo, packed, qx_hi, qx_lo, qy_hi, qy_lo, r=1,
):
    """The f48-tier bicubic cell route from a :func:`pack_bicubic_rows_f48`
    table (24bp channels per row); returns an (hi, lo) pair like the DF
    route, accurate to ~2^-33 scale-relative."""
    check_route_tables(
        "gathered_bicubic_eval_f48_packed", [("packed", packed)],
        (qx_hi, qx_lo, qy_hi, qy_lo),
    )
    rows, ts = _bicubic_cell_rows(
        x_hi, x_lo, y_hi, y_lo, packed, (qx_hi, qx_lo, qy_hi, qy_lo)
    )
    bp = packed.shape[1] // 24
    half = 16 * bp
    full = jnp.concatenate(
        [rows[:, :half], _unpack_f48_lo(rows[:, half:])], axis=1
    )
    hi, lo = _df_bicubic_tail(full, *ts, bp)
    return hi[:, :r], lo[:, :r]


def pack_bicubic_nodes_df(nodes_hi, nodes_lo):
    """DF node table ``(nx*ny, 8r+4)``: the (hi, lo) split of the
    memory-frugal bicubic node rows (``models/strategies/bicubic.
    pack_bicubic_nodes`` -- raw unscaled ``[f | kx | ky | kxy]`` plus the
    node's own DF ``(x, y)``), block-interleaved
    ``[f_hi|f_lo|kx_hi|kx_lo|ky_hi|ky_lo|kxy_hi|kxy_lo|x_hi,x_lo,y_hi,
    y_lo]``.  2x the f32 node table ≈ the grid's f64 memory -- the
    f64-grade route for grids whose cell table would not fit."""
    c = nodes_hi.shape[1]
    r = (c - 2) // 4
    parts = []
    for i in range(4):
        parts.append(nodes_hi[:, i * r : (i + 1) * r])
        parts.append(nodes_lo[:, i * r : (i + 1) * r])
    for j in (0, 1):
        parts.append(nodes_hi[:, 4 * r + j : 4 * r + j + 1])
        parts.append(nodes_lo[:, 4 * r + j : 4 * r + j + 1])
    return jnp.concatenate(parts, axis=1)


def _df_hermite_dx(y_l, y_r, k_l, k_r, dx, t, one):
    """DF Hermite with UNSCALED derivatives and an explicit DF interval
    width -- the node-layout arithmetic
    (``models/strategies/bicubic._hermite``)."""
    return _df_hermite_scaled(
        y_l, y_r, df_mul(k_l, dx), df_mul(k_r, dx), t, one
    )


def _df_node_tail(g11, g12, g21, g22, txh, txl, tyh, tyl, r):
    """DF node-route tail: unpack the four block-interleaved node rows
    (:func:`pack_bicubic_nodes_df` layout), DF interval widths from the
    gathered corner coordinates, derivative scaling in-tail, then the
    5-Hermite nesting.  t args are (B, 1) hi/lo columns."""

    def unpack(g):
        def blk(i):
            return (
                g[:, 2 * i * r : (2 * i + 1) * r],
                g[:, (2 * i + 1) * r : (2 * i + 2) * r],
            )

        base = 8 * r

        def coord(j):
            s = base + 2 * j
            return (g[:, s : s + 1], g[:, s + 1 : s + 2])

        return blk(0), blk(1), blk(2), blk(3), coord(0), coord(1)

    f11, kx11, ky11, kxy11, x1, y1 = unpack(g11)
    f12, kx12, ky12, kxy12, _, y2 = unpack(g12)
    f21, kx21, ky21, kxy21, x2, _ = unpack(g21)
    f22, kx22, ky22, kxy22, _, _ = unpack(g22)
    dx = df_sub(x2, x1)
    dy = df_sub(y2, y1)
    tx = (txh, txl)
    ty = (tyh, tyl)
    one = (jnp.ones_like(txh), jnp.zeros_like(txh))
    f_y1 = _df_hermite_dx(f11, f21, kx11, kx21, dx, tx, one)
    f_y2 = _df_hermite_dx(f12, f22, kx12, kx22, dx, tx, one)
    g_y1 = _df_hermite_dx(ky11, ky21, kxy11, kxy21, dx, tx, one)
    g_y2 = _df_hermite_dx(ky12, ky22, kxy12, kxy22, dx, tx, one)
    return _df_hermite_dx(f_y1, f_y2, g_y1, g_y2, dy, ty, one)


def gathered_bicubic_nodes_eval_df(
    x_hi, x_lo, y_hi, y_lo, packed, qx_hi, qx_lo, qy_hi, qy_lo,
    r=1, chunk=65536,
):
    """DF bicubic from the memory-frugal NODE table: two DF (idx, t)
    passes + FOUR (hi, lo) node-row gathers + the DF tail that scales
    derivatives by the DF interval widths read from the gathered corner
    coordinates.

    The f64-grade route for grids past ``config.bicubic_pack_max_elems``
    (the DF cell table is 2x the f32 one, so exactly the large grids
    that need DF most are the ones the cell route cannot hold).  The
    tail runs in ``chunk``-query pieces under ``lax.map``: the EFT
    guards keep every intermediate live at once, so an unchunked
    1M-query tail on a 16-channel grid needs tens of GB -- chunking caps
    the live set at ~chunk x channels x EFT depth.  Semantics anchor:
    the 2-D eval contract of ``interp2d/mod.rs:175-196``."""
    check_route_tables(
        "gathered_bicubic_nodes_eval_df", [("packed", packed)],
        (qx_hi, qx_lo, qy_hi, qy_lo),
    )
    ny = y_hi.shape[0]
    nq = qx_hi.shape[0]
    xi, txh, txl, yi, tyh, tyl = _df_index_frac_2d(
        x_hi, x_lo, y_hi, y_lo, qx_hi, qx_lo, qy_hi, qy_lo
    )

    def tail_chunk(args):
        xi, txh, txl, yi, tyh, tyl = args
        base = xi * ny + yi
        g11 = jnp.take(packed, base, axis=0)
        g12 = jnp.take(packed, base + 1, axis=0)
        g21 = jnp.take(packed, base + ny, axis=0)
        g22 = jnp.take(packed, base + ny + 1, axis=0)
        return _df_node_tail(
            g11, g12, g21, g22,
            txh[:, None], txl[:, None], tyh[:, None], tyl[:, None], r,
        )

    if nq <= chunk:
        return tail_chunk((xi, txh, txl, yi, tyh, tyl))
    cpad = -(-nq // chunk) * chunk - nq
    parts = tuple(
        jnp.pad(v, (0, cpad)).reshape(-1, chunk)
        for v in (xi, txh, txl, yi, tyh, tyl)
    )
    hi, lo = jax.lax.map(tail_chunk, parts)
    return hi.reshape(-1, r)[:nq], lo.reshape(-1, r)[:nq]


# -- InterpND -----------------------------------------------------------------
def _nd_bp(r):
    """Lanes per quantity block in the packed ND rows: ``r`` itself for
    ``r <= 8`` (a scalar grid's row stays unpadded), else rounded up to a
    multiple of 8 (waste <= 12.5%)."""
    return r if r <= 8 else -(-r // 8) * 8


def _nd_blocks(v, nb, r):
    cells = v.shape[0]
    bp = _nd_bp(r)
    v3 = v.reshape(cells, nb, r)
    if bp != r:
        v3 = jnp.pad(v3, ((0, 0), (0, 0), (0, bp - r)))
    return v3.reshape(cells, nb * bp)


def pack_rows_nd_df(rows_hi, rows_lo, nb, r):
    """Block-padded DF ND cell rows ``(cells, 2 * nb * bp)``: the ``nb``
    per-cell quantity blocks (ND cell layout,
    ``models/interpnd.pack_cubic_rows_nd`` channel order) hi then lo,
    each r-block padded to ``bp`` lanes."""
    return jnp.concatenate(
        [_nd_blocks(rows_hi, nb, r), _nd_blocks(rows_lo, nb, r)], axis=1
    )


def pack_rows_nd_f48(rows_hi, rows_lo, nb, r):
    """"f48" ND cell rows ``(cells, 3/2 * nb * bp)``: hi blocks as in
    :func:`pack_rows_nd_df` plus the lo blocks rounded to bf16 and packed
    two per f32 lane (block j pairs with block j + nb/2; ``nb`` =
    nbasis^k is always even)."""
    return jnp.concatenate(
        [_nd_blocks(rows_hi, nb, r),
         _pack_f48_lo(_nd_blocks(rows_lo, nb, r))],
        axis=1,
    )


def _df_hermite_basis(t, one):
    """The four scaled-Hermite weights as DF pairs: expanding
    :func:`_df_hermite_scaled` over its quantities (y_l, y_r, K_l, K_r)
    gives  w_yl = u + p*d,  w_yr = t - p*d,  w_Kl = p*u,  w_Kr = -p*t
    with u = 1-t, p = t*u, d = u-t (algebraically identical to the
    nested form; DF rounding differs at ~2^-48)."""
    u = df_sub(one, t)
    d = df_sub(u, t)
    p = df_mul(t, u)
    pd = df_mul(p, d)
    return (
        df_add(u, pd),
        df_sub(t, pd),
        df_mul(p, u),
        df_neg(df_mul(p, t)),
    )


def _df_linear_basis(t, one):
    """The multilinear weights ``[1-t, t]`` as DF pairs."""
    return (df_sub(one, t), t)


def _df_basis_cols(ths, tls, nbasis):
    """Per-axis DF basis values as (B, 1)-shaped column pairs:
    ``bases[d][digit] = (hi, lo)``.  The k axes' chains run batched
    through one (B, k)-wide basis call."""
    fn = _df_hermite_basis if nbasis == 4 else _df_linear_basis
    k = len(ths)
    if k == 1:
        one = (jnp.ones_like(ths[0]), jnp.zeros_like(ths[0]))
        return [fn((ths[0], tls[0]), one)]
    tstack = (
        jnp.concatenate(ths, axis=1),
        jnp.concatenate(tls, axis=1),
    )
    one = (jnp.ones_like(tstack[0]), jnp.zeros_like(tstack[0]))
    full = fn(tstack, one)  # nbasis pairs, each (B, k)
    return [
        [(p[0][:, d : d + 1], p[1][:, d : d + 1]) for p in full]
        for d in range(k)
    ]


def _df_nd_weight_tail_xla(rows, ths, tls, k, bp, nbasis):
    """DF ND tail: fold the per-axis basis columns into ONE
    (B, nbasis^k) DF weight matrix (repeat/tile, axis 0 most significant
    -- the pack's channel order), DF-multiply against the (B, nb, bp) row
    blocks, and DF-accumulate by a halving tree."""
    nb = nbasis**k
    bases = _df_basis_cols(
        [t.reshape(-1, 1) for t in ths], [t.reshape(-1, 1) for t in tls],
        nbasis,
    )

    def basis_mat(basis):
        return (
            jnp.concatenate([p[0] for p in basis], axis=1),
            jnp.concatenate([p[1] for p in basis], axis=1),
        )

    w = basis_mat(bases[0])
    for d in range(1, k):
        wa = (
            jnp.repeat(w[0], nbasis, axis=1),
            jnp.repeat(w[1], nbasis, axis=1),
        )
        m = w[0].shape[1]
        br = basis_mat(bases[d])
        bb = (jnp.tile(br[0], (1, m)), jnp.tile(br[1], (1, m)))
        w = df_mul(wa, bb)
    b = rows.shape[0]
    blocks = (
        rows[:, : nb * bp].reshape(b, nb, bp),
        rows[:, nb * bp :].reshape(b, nb, bp),
    )
    hi, lo = df_mul((w[0][:, :, None], w[1][:, :, None]), blocks)
    while hi.shape[1] > 1:
        h = hi.shape[1] // 2
        hi, lo = df_add(
            (hi[:, :h], lo[:, :h]), (hi[:, h:], lo[:, h:])
        )
    return hi[:, 0], lo[:, 0]


def gathered_nd_eval_df_packed(k, grid_shape, r, nbasis=4, tier="df"):
    """Factory for the DF ND gather route on a PREPACKED table: returns
    ``route(x0_hi, x0_lo, ..., packed, q0_hi, q0_lo, ...) -> (hi, lo)``
    of shape ``(Q, r)`` each.

    ``grid_shape``: the k leading data dims (static -- cell strides).
    ``nbasis``: 4 for the tensor-product cubic (cell layout), 2 for
    multilinear.  ``tier="f48"`` expects a :func:`pack_rows_nd_f48`
    table."""
    cells = tuple(n - 1 for n in grid_shape)
    cstrides = [1] * k
    for d in range(k - 2, -1, -1):
        cstrides[d] = cstrides[d + 1] * cells[d + 1]

    def route(*ops):
        packed = ops[2 * k]
        q_flat = ops[2 * k + 1 :]
        check_route_tables(
            "gathered_nd_eval_df_packed route", [("packed", packed)], q_flat
        )
        idx, ths, tls = [], [], []
        for d in range(k):
            i, th, tl = df_index_frac(
                ops[2 * d], ops[2 * d + 1], q_flat[2 * d], q_flat[2 * d + 1]
            )
            idx.append(i)
            ths.append(th)
            tls.append(tl)
        cell = sum(i * s for i, s in zip(idx, cstrides))
        rows = jnp.take(packed, cell, axis=0)
        nb = nbasis**k
        ch = packed.shape[1]
        bp = ch // (2 * nb) if tier == "df" else (2 * ch) // (3 * nb)
        if tier == "f48":
            rows = jnp.concatenate(
                [rows[:, : nb * bp], _unpack_f48_lo(rows[:, nb * bp :])],
                axis=1,
            )
        hi, lo = _df_nd_weight_tail_xla(rows, ths, tls, k, bp, nbasis)
        return hi[:, :r], lo[:, :r]

    return route
