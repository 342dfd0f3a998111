"""Serving helpers: fixed-shape evaluation for variable-length queries.

Under ``jit`` every new query-batch shape triggers a recompile — fatal for
a serving path fed requests of arbitrary size.  :class:`Evaluator` (1-D)
and :class:`Evaluator2D` pad each batch up to a size bucket (powers of two
by default), evaluate with a single compiled program per bucket, and slice
the padding off.  Padding uses the first knot(s), so it never produces
out-of-range work regardless of the extrapolation mode.

    ev = Evaluator(interp)
    ev.warmup()              # optional: precompile every bucket
    values = ev(queries)     # any length, no recompiles after warmup

    ev2 = Evaluator2D(interp2d)
    values = ev2(xs, ys)
"""

from __future__ import annotations

import bisect
import functools

import jax
import jax.numpy as jnp


def _default_buckets(max_size: int):
    out, b = [], 256
    while b < max_size:
        out.append(b)
        b *= 2
    out.append(max_size)
    return out


class _BucketedEvaluator:
    """Shared bucketing/padding logic; subclasses bind the jitted program
    and the padding values."""

    def __init__(self, interp, max_batch: int = 1 << 20, buckets=None,
                 donate: bool = False):
        self._interp = interp
        self._buckets = sorted(buckets or _default_buckets(max_batch))
        self._max = self._buckets[-1]
        self._donate = bool(donate)
        # extra leading device-array arguments for self._run (e.g. a
        # prepacked DF table) — always defined so call sites stay uniform
        self._run_extra = ()

    def _bucket(self, n: int) -> int:
        i = bisect.bisect_left(self._buckets, n)
        return self._buckets[min(i, len(self._buckets) - 1)]

    @property
    def buckets(self):
        return tuple(self._buckets)

    def _hygiene_args(self):
        """(fn, example_args) for one serving-program trace — what a
        single bucket evaluation runs."""
        raise NotImplementedError

    def lower(self):
        """The serving program of the smallest bucket, lowered for the
        default device: ``ev.lower().compile()`` gives its compile time
        and ``memory_analysis()``."""
        fn, args = self._hygiene_args()
        return fn.lower(*args)

    def verify_hygiene(self, cap_bytes=None):
        """Compile-payload guard: trace one serving program and assert
        it embeds no big constants (``utils/hygiene.py``).  A closure-
        captured table would be constant-folded into the program,
        copied into every compiled executable and hashed by the compile
        cache — tables must ride as jit arguments.  Runs once per evaluator (cached); called
        automatically from ``warmup()`` and the first ``__call__`` of
        the double-float evaluators.  Raises ``RuntimeError`` with the
        offending constant shapes on violation."""
        if getattr(self, "_hygiene_ok", False):
            return self
        from .utils.hygiene import assert_lean_program

        fn, args = self._hygiene_args()
        assert_lean_program(
            fn, *args, cap_bytes=cap_bytes,
            what=f"{type(self).__name__} serving program",
        )
        self._hygiene_ok = True
        return self


class Evaluator(_BucketedEvaluator):
    """Bucketed fixed-shape evaluator over an :class:`Interp1D`.

    Args:
      interp: the interpolator (pytree; captured as a constant so the
        compiled programs specialize to its shapes).
      max_batch: largest supported query count per call (larger inputs are
        evaluated in ``max_batch`` chunks).
      buckets: optional ascending list of batch buckets.
      donate: donate the padded query buffer to the compiled program
        (``jax.jit(..., donate_argnums)``), letting XLA reuse its device
        memory for the result.  Off by default because XLA warns when a
        donated buffer is unusable (e.g. dtype/shape mismatch with the
        output).
    """

    def __init__(self, interp, max_batch: int = 1 << 20, buckets=None,
                 donate: bool = False):
        super().__init__(interp, max_batch, buckets, donate)
        fn = lambda t, q: t(q)
        self._fn = jax.jit(fn, donate_argnums=1) if self._donate else jax.jit(fn)

    def _hygiene_args(self):
        q = jnp.full((self._buckets[0],), self._interp.x[0],
                     self._interp.x.dtype)
        return self._fn, (self._interp, q)

    def warmup(self):
        """Precompile every bucket (one trace + compile each)."""
        self.verify_hygiene()
        pad_val = self._interp.x[0]
        for b in self._buckets:
            q = jnp.full((b,), pad_val, self._interp.x.dtype)
            self._fn(self._interp, q)
        return self

    def __call__(self, queries):
        q = jnp.asarray(queries)
        shape = q.shape
        flat = q.reshape(-1)
        n = flat.shape[0]
        trailing = tuple(self._interp.data.shape[1:])
        if n == 0:
            return jnp.zeros(shape + trailing, self._interp.data.dtype)
        pad_val = self._interp.x[0]

        outs = []
        start = 0
        while start < n:
            chunk = flat[start : start + self._max]
            m = chunk.shape[0]
            b = self._bucket(m)
            padded = jnp.full((b,), pad_val, flat.dtype).at[:m].set(chunk)
            outs.append(self._fn(self._interp, padded)[:m])
            start += m
        out = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
        return out.reshape(shape + trailing)


class Evaluator2D(_BucketedEvaluator):
    """Bucketed fixed-shape evaluator over an :class:`Interp2D`.

    Same bucketing contract as :class:`Evaluator`; queries are the paired
    ``(xs, ys)`` arrays of the 2-D API (``xs.shape == ys.shape``,
    ``/root/reference/src/interp2d/mod.rs:175-196``).
    """

    def __init__(self, interp, max_batch: int = 1 << 20, buckets=None,
                 donate: bool = False):
        super().__init__(interp, max_batch, buckets, donate)
        fn = lambda t, qx, qy: t(qx, qy)
        self._fn = (
            jax.jit(fn, donate_argnums=(1, 2)) if self._donate else jax.jit(fn)
        )

    def _hygiene_args(self):
        b = self._buckets[0]
        qx = jnp.full((b,), self._interp.x[0], self._interp.x.dtype)
        qy = jnp.full((b,), self._interp.y[0], self._interp.y.dtype)
        return self._fn, (self._interp, qx, qy)

    def warmup(self):
        self.verify_hygiene()
        for b in self._buckets:
            qx = jnp.full((b,), self._interp.x[0], self._interp.x.dtype)
            qy = jnp.full((b,), self._interp.y[0], self._interp.y.dtype)
            self._fn(self._interp, qx, qy)
        return self

    def __call__(self, xs, ys):
        qx = jnp.asarray(xs)
        qy = jnp.asarray(ys)
        if qx.shape != qy.shape:
            raise ValueError(
                f"xs and ys need to have the same shape. "
                f"Got xs: {list(qx.shape)}, ys: {list(qy.shape)}"
            )
        shape = qx.shape
        fx = qx.reshape(-1)
        fy = qy.reshape(-1)
        n = fx.shape[0]
        trailing = tuple(self._interp.data.shape[2:])
        if n == 0:
            return jnp.zeros(shape + trailing, self._interp.data.dtype)
        px = self._interp.x[0]
        py = self._interp.y[0]

        outs = []
        start = 0
        while start < n:
            cx = fx[start : start + self._max]
            cy = fy[start : start + self._max]
            m = cx.shape[0]
            b = self._bucket(m)
            padx = jnp.full((b,), px, fx.dtype).at[:m].set(cx)
            pady = jnp.full((b,), py, fy.dtype).at[:m].set(cy)
            outs.append(self._fn(self._interp, padx, pady)[:m])
            start += m
        out = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
        return out.reshape(shape + trailing)


class EvaluatorND(_BucketedEvaluator):
    """Bucketed fixed-shape evaluator over an :class:`InterpND`.

    Same bucketing contract as :class:`Evaluator`; queries are the
    ``k`` paired coordinate arrays of the N-D API (one per interpolated
    axis, equal shapes).  Padding uses each axis's first knot."""

    def __init__(self, interp, max_batch: int = 1 << 20, buckets=None,
                 donate: bool = False):
        super().__init__(interp, max_batch, buckets, donate)
        fn = lambda t, *qs: t(*qs)
        self._fn = (
            jax.jit(fn, donate_argnums=tuple(range(1, 1 + interp.k)))
            if self._donate
            else jax.jit(fn)
        )

    def _hygiene_args(self):
        qs = [
            jnp.full((self._buckets[0],), ax[0], ax.dtype)
            for ax in self._interp.axes
        ]
        return self._fn, (self._interp, *qs)

    def warmup(self):
        self.verify_hygiene()
        for b in self._buckets:
            qs = [
                jnp.full((b,), ax[0], ax.dtype) for ax in self._interp.axes
            ]
            self._fn(self._interp, *qs)
        return self

    def __call__(self, *coords):
        k = self._interp.k
        if len(coords) != k:
            raise ValueError(
                f"expected {k} coordinate arrays (one per interpolated "
                f"axis), got {len(coords)}"
            )
        qs = [jnp.asarray(c) for c in coords]
        shape = qs[0].shape
        if any(q.shape != shape for q in qs[1:]):
            raise ValueError("query coordinate shapes do not match")
        flats = [q.reshape(-1) for q in qs]
        n = flats[0].shape[0]
        trailing = tuple(self._interp.data.shape[k:])
        if n == 0:
            return jnp.zeros(shape + trailing, self._interp.data.dtype)
        pads = [ax[0] for ax in self._interp.axes]

        outs = []
        start = 0
        while start < n:
            chunks = [f[start : start + self._max] for f in flats]
            m = chunks[0].shape[0]
            b = self._bucket(m)
            padded = [
                jnp.full((b,), p, f.dtype).at[:m].set(c)
                for p, f, c in zip(pads, flats, chunks)
            ]
            outs.append(self._fn(self._interp, *padded)[:m])
            start += m
        out = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
        return out.reshape(shape + trailing)


class DoubleFloatEvaluator(_BucketedEvaluator):
    """f64-grade serving on f32 hardware: double-float evaluation of a
    1-D cubic/Hermite (or linear) interpolator.

    Build the interpolator eagerly in f64 (the normal validated path);
    this evaluator splits its knots/data/coefficients into (hi, lo) f32
    pairs once, and evaluates queries with the double-float routes of
    ``ops/df_eval.py``, returning f64.  Accuracy gate vs the f64 oracle:
    ≤1e-12 scale-relative (``chip_smoke.py`` phase P5 on the card,
    ``tests/test_df.py`` on the CPU).

    Out-of-range semantics follow the strategy: ``extrapolate(False)``
    raises :class:`~ndarray_interp_tpu.errors.OutOfBoundsError` on the
    host (eager check, like ``interp_array``); periodic mode wraps in
    f64 before splitting.

    ``grade="f48"`` (banked route only) packs the row table's lo half
    as bf16 pairs — 75% of the DF table's memory and gather traffic at
    ~2^-33 scale-relative accuracy, the intermediate tier between the
    f32 route (~2^-24) and full DF (~2^-48); same tier family as
    :class:`DoubleFloatEvaluator2D` / :class:`DoubleFloatEvaluatorND`.
    """

    def __init__(
        self, interp, max_batch: int = 1 << 20, buckets=None, grade="df"
    ):
        import numpy as np

        from .ops.df import df_from_f64

        if grade not in ("df", "f48"):
            raise ValueError(f"grade must be 'df' or 'f48', got {grade!r}")
        super().__init__(interp, max_batch, buckets)
        strat = interp.strategy
        a = getattr(strat, "a", None)
        b = getattr(strat, "b", None)
        data = interp.data
        self._bank_shape = tuple(data.shape[1:])
        self._mode = getattr(strat, "mode", None) or (
            "yes" if getattr(strat, "extrapolates", False) else "no"
        )
        x64 = np.asarray(interp.x, np.float64)
        self._x0 = float(x64[0])
        self._xn = float(x64[-1])
        n = x64.shape[0]
        bank = 1
        for sdim in self._bank_shape:
            bank *= sdim
        zshape = (n - 1,) if not self._bank_shape else (n - 1, bank)
        d64 = np.asarray(data, np.float64).reshape(
            (n,) if not self._bank_shape else (n, bank)
        )
        a64 = (
            np.zeros(zshape)
            if a is None
            else np.asarray(a, np.float64).reshape(zshape)
        )
        b64 = (
            np.zeros(zshape)
            if b is None
            else np.asarray(b, np.float64).reshape(zshape)
        )
        self._pairs = []
        for v in (x64, d64, a64, b64):
            self._pairs.extend(df_from_f64(v))

        from .ops.df_eval import (
            eval_xla_df,
            gathered_bank_eval_df_packed,
            gathered_bank_eval_f48_packed,
            pack_bank_rows_df,
            pack_bank_rows_f48,
        )

        if grade != "df" and not self._bank_shape:
            raise ValueError(
                "grade='f48' supports the banked (trailing-dims) route "
                "only; the scalar route is always full double-float"
            )
        if self._bank_shape:
            # banked gather route: DF (idx, t) + ONE packed (hi, lo) row
            # gather + DF tail.  The table is packed ONCE here and passed
            # as a jit ARGUMENT: packing per call would re-concatenate a
            # table that can reach hundreds of MB, and a closure-captured
            # table is baked into the program (utils/hygiene.py).
            pack, route = {
                "df": (pack_bank_rows_df, gathered_bank_eval_df_packed),
                "f48": (pack_bank_rows_f48, gathered_bank_eval_f48_packed),
            }[grade]
            self._packed = jax.jit(pack)(*self._pairs[2:8])
            self._run = jax.jit(
                lambda xh, xl, packed, qh, ql: route(
                    xh, xl, packed, bank, qh, ql
                )
            )
            self._run_extra = (
                self._pairs[0], self._pairs[1], self._packed,
            )
        else:
            self._run = jax.jit(eval_xla_df)
            self._run_extra = tuple(self._pairs)

    def warmup(self):
        import numpy as np

        self.verify_hygiene()
        for b in self._buckets:
            q = np.full(b, self._x0)
            hi, lo = self._run(
                *self._run_extra, *_split_q(q)
            )
            jax.block_until_ready((hi, lo))
        return self

    def _hygiene_args(self):
        import numpy as np

        q = np.full(self._buckets[0], self._x0)
        return self._run, (*self._run_extra, *_split_q(q))

    def __call__(self, queries):
        import numpy as np

        from .errors import OutOfBoundsError
        from .ops.df import df_to_f64

        self.verify_hygiene()
        q = np.asarray(queries, np.float64)
        flat = q.reshape(-1)
        if flat.shape[0] == 0:
            return np.zeros(q.shape + self._bank_shape)
        if self._mode == "no":
            bad = (flat < self._x0) | (flat > self._xn) | np.isnan(flat)
            if bad.any():
                i = int(np.argmax(bad))
                raise OutOfBoundsError(
                    f"point {flat[i]} is out of bounds of the "
                    f"interpolation range [{self._x0}, {self._xn}]"
                )
        elif np.isnan(flat).any():
            # eager API parity: extrapolating modes raise on NaN queries
            # (docs/PARITY.md D3)
            raise ValueError("failed to convert NaN to an index")
        if self._mode == "periodic":
            span = self._xn - self._x0
            out_r = (flat < self._x0) | (flat > self._xn)
            flat = np.where(
                out_r, np.mod(flat - self._x0, span) + self._x0, flat
            )
        n = flat.shape[0]
        bsz = self._bucket(n)
        outs = []
        for start in range(0, n, bsz):
            chunk = flat[start : start + bsz]
            if chunk.shape[0] < bsz:
                chunk = np.concatenate(
                    [chunk, np.full(bsz - chunk.shape[0], self._x0)]
                )
            hi, lo = self._run(
                *self._run_extra, *_split_q(chunk)
            )
            outs.append(df_to_f64(hi, lo))
        res = np.concatenate(outs)[:n]
        return res.reshape(q.shape + self._bank_shape)


def _split_q(q64):
    from .ops.df import df_from_f64

    return df_from_f64(q64)


_donated_run_1d = jax.jit(
    # flatten first: strategy eval paths assume flat queries (the
    # public interp_array does the same via its driver)
    lambda interp, queries, out: interp.strategy.eval(
        interp, queries.reshape(-1)
    ).reshape(tuple(queries.shape) + tuple(interp.data.shape[1:])),
    donate_argnums=(2,),
)


def eval_into_donated(interp, queries, out):
    """Device-buffer ``interp_array_into`` for device-resident pipelines.

    The host ``interp_array_into`` APIs fill a numpy buffer (the
    reference's ``interp_array_into`` contract, ``interp1d/mod.rs:272``);
    this variant instead donates ``out`` — a device array with the result
    shape/dtype — to the compiled program (``jax.jit(...,
    donate_argnums)``), which permits XLA to reuse its storage for the
    result with no extra allocation.
    Returns the new array; the passed-in ``out`` must not be used
    afterwards.  (Backends without donation support fall back to a copy
    with a warning — results are still correct.)
    """
    expect = tuple(queries.shape) + tuple(interp.data.shape[1:])
    if tuple(out.shape) != expect:
        raise ValueError(
            f"output buffer has shape {tuple(out.shape)}, expected {expect}"
        )
    return _donated_run_1d(interp, queries, out)


_donated_run_2d = jax.jit(
    lambda interp, xs, ys, out: interp.strategy.eval(
        interp, xs.reshape(-1), ys.reshape(-1)
    ).reshape(tuple(xs.shape) + tuple(interp.data.shape[2:])),
    donate_argnums=(3,),
)


def eval_into_donated_2d(interp, xs, ys, out):
    """2-D analogue of :func:`eval_into_donated`: the donated
    device-buffer form of the reference's 2-D ``interp_array_into``
    (``interp2d/mod.rs:234-253``).  ``xs.shape == ys.shape`` enforced
    as in ``interp_array`` (``interp2d/mod.rs:189-192``); ``out`` must
    have shape ``xs.shape + data.shape[2:]`` and is donated — do not
    use it afterwards."""
    if tuple(xs.shape) != tuple(ys.shape):
        raise ValueError(
            f"`xs.shape` and `ys.shape` do not match: {tuple(xs.shape)} "
            f"vs {tuple(ys.shape)}"
        )
    expect = tuple(xs.shape) + tuple(interp.data.shape[2:])
    if tuple(out.shape) != expect:
        raise ValueError(
            f"output buffer has shape {tuple(out.shape)}, expected {expect}"
        )
    return _donated_run_2d(interp, xs, ys, out)


class DoubleFloatEvaluator2D(_BucketedEvaluator):
    """2-D analogue of :class:`DoubleFloatEvaluator`: f64-grade serving
    on f32 hardware for Bilinear AND Bicubic strategies.

    Both run the prepacked DF gather routes of ``ops/df_eval.py``: DF
    (idx, t) passes (DF-lexicographic search) + ONE packed (hi, lo) row
    gather + the guarded DF tail.  The packed table is built ONCE at
    construction and kept on device (~8-10x the grid's f64 memory for
    bilinear, 2x the f32 cell table for bicubic; bicubic grids past
    ``config.bicubic_pack_max_elems`` use the memory-frugal NODE table
    instead — ≈ the grid's f64 memory, 4 gathers/query).  Trailing (bank)
    dims supported; build the Interp2D eagerly in f64; periodic bicubic
    axes wrap in f64 on the host."""

    def __init__(
        self, interp, max_batch: int = 1 << 20, buckets=None, grade="df"
    ):
        import numpy as np

        from .models.strategies.bicubic import BicubicStrategy
        from .ops.df import df_from_f64

        if grade not in ("df", "f48"):
            raise ValueError(f"grade must be 'df' or 'f48', got {grade!r}")
        super().__init__(interp, max_batch, buckets)
        self._trailing = tuple(interp.data.shape[2:])
        self._extrapolates = bool(
            getattr(interp.strategy, "extrapolates", False)
        )
        self._wraps = (
            bool(getattr(interp.strategy, "wraps_x", False)),
            bool(getattr(interp.strategy, "wraps_y", False)),
        )
        x64 = np.asarray(interp.x, np.float64)
        y64 = np.asarray(interp.y, np.float64)
        self._xr = (float(x64[0]), float(x64[-1]))
        self._yr = (float(y64[0]), float(y64[-1]))
        r = 1
        for s in self._trailing:
            r *= s
        # large (hi, lo) tables are packed ONCE here and passed as jit
        # ARGUMENTS — per-call packing repeats GB-scale copies and a
        # closure-captured table is baked into the program
        if isinstance(interp.strategy, BicubicStrategy):
            # f64-grade tensor-product cubic: split the f64 strategy
            # table (build the Interp2D eagerly in f64).  Cell layout:
            # the PRE-SCALED 16r cell table, ONE gather/query.  Node
            # layout (grids past config.bicubic_pack_max_elems —
            # exactly the grids whose 2x DF cell table cannot fit): the
            # block-interleaved (8r+4)-channel DF node table, 4
            # gathers/query at ~4x less table memory.
            pairs = []
            for v in (x64, y64):
                pairs.extend(df_from_f64(v))
            self._pairs = pairs
            rows_pair = df_from_f64(
                np.asarray(interp.strategy.rows, np.float64)
            )
            if interp.strategy.layout == "cell":
                from .ops.df_eval import (
                    gathered_bicubic_eval_df_packed,
                    gathered_bicubic_eval_f48_packed,
                    pack_bicubic_rows_df,
                    pack_bicubic_rows_f48,
                )

                # grade="f48": bf16-lo packed rows — 75% of the DF
                # table's memory/gather traffic at ~2^-33 relative
                # (between the f32 route's 2^-24 and DF's 2^-48)
                pack, cell_route = {
                    "df": (pack_bicubic_rows_df,
                           gathered_bicubic_eval_df_packed),
                    "f48": (pack_bicubic_rows_f48,
                            gathered_bicubic_eval_f48_packed),
                }[grade]
                self._packed = jax.jit(
                    lambda h, l: pack(h, l, r)
                )(*rows_pair)
                route = functools.partial(cell_route, r=r)
            elif grade != "df":
                raise ValueError(
                    "grade='f48' supports the bicubic cell layout and "
                    "bilinear only"
                )
            else:
                from .ops.df_eval import (
                    gathered_bicubic_nodes_eval_df,
                    pack_bicubic_nodes_df,
                )

                self._packed = jax.jit(pack_bicubic_nodes_df)(*rows_pair)
                route = functools.partial(
                    gathered_bicubic_nodes_eval_df, r=r
                )
            self._run_extra = (*self._pairs, self._packed)
            self._run = jax.jit(
                lambda xh, xl, yh, yl, packed, a, b, c, d: route(
                    xh, xl, yh, yl, packed, a, b, c, d
                )
            )
            return
        from .ops.df_eval import (
            gathered_bilinear_eval_df_packed,
            gathered_bilinear_eval_f48_packed,
            pack_bilinear_rows_df,
            pack_bilinear_rows_f48,
        )

        pairs = []
        for v in (x64, y64):
            pairs.extend(df_from_f64(v))
        self._pairs = pairs
        z_pair = df_from_f64(np.asarray(interp.data, np.float64))
        ny = y64.shape[0]
        pack, route = {
            "df": (pack_bilinear_rows_df, gathered_bilinear_eval_df_packed),
            "f48": (pack_bilinear_rows_f48,
                    gathered_bilinear_eval_f48_packed),
        }[grade]
        self._packed = jax.jit(pack)(*z_pair)
        self._run_extra = (*self._pairs, self._packed)

        def run(xh, xl, yh, yl, packed, qxh, qxl, qyh, qyl):
            return route(xh, xl, yh, yl, packed, ny, r, qxh, qxl, qyh, qyl)

        self._run = jax.jit(run)

    def _hygiene_args(self):
        import numpy as np

        qx = np.full(self._buckets[0], self._xr[0])
        qy = np.full(self._buckets[0], self._yr[0])
        return self._run, (
            *self._run_extra, *_split_q(qx), *_split_q(qy)
        )

    def warmup(self):
        """Precompile every bucket (one trace + compile each)."""
        import numpy as np

        self.verify_hygiene()
        for b in self._buckets:
            qx = np.full(b, self._xr[0])
            qy = np.full(b, self._yr[0])
            hi, lo = self._run(
                *self._run_extra, *_split_q(qx), *_split_q(qy)
            )
            jax.block_until_ready((hi, lo))
        return self

    def __call__(self, xs, ys):
        import numpy as np

        from .errors import OutOfBoundsError
        from .ops.df import df_from_f64, df_to_f64

        self.verify_hygiene()
        qx = np.asarray(xs, np.float64)
        qy = np.asarray(ys, np.float64)
        if qx.shape != qy.shape:
            raise ValueError(
                f"`xs.shape` and `ys.shape` do not match: {qx.shape} vs "
                f"{qy.shape}"
            )
        fx = qx.reshape(-1)
        fy = qy.reshape(-1)
        if fx.shape[0] == 0:
            return np.zeros(qx.shape + self._trailing)
        wx, wy = getattr(self, "_wraps", (False, False))
        if not self._extrapolates:
            for name, f, (lo, hi), wrap in (
                ("x", fx, self._xr, wx),
                ("y", fy, self._yr, wy),
            ):
                if wrap:  # periodic axis: never OOB, NaN still refuses
                    if np.isnan(f).any():
                        raise ValueError("failed to convert NaN to an index")
                    continue
                bad = (f < lo) | (f > hi) | np.isnan(f)
                if bad.any():
                    i = int(np.argmax(bad))
                    raise OutOfBoundsError(
                        f"point {f[i]} is out of bounds of the {name} "
                        f"interpolation range [{lo}, {hi}]"
                    )
        elif np.isnan(fx).any() or np.isnan(fy).any():
            # eager API parity (docs/PARITY.md D3)
            raise ValueError("failed to convert NaN to an index")
        # periodic axes wrap in f64 on the host (cubic_spline.rs:804-809)
        if wx:
            span = self._xr[1] - self._xr[0]
            out_r = (fx < self._xr[0]) | (fx > self._xr[1])
            fx = np.where(
                out_r, np.mod(fx - self._xr[0], span) + self._xr[0], fx
            )
        if wy:
            span = self._yr[1] - self._yr[0]
            out_r = (fy < self._yr[0]) | (fy > self._yr[1])
            fy = np.where(
                out_r, np.mod(fy - self._yr[0], span) + self._yr[0], fy
            )
        n = fx.shape[0]
        bsz = self._bucket(n)
        outs = []
        for start in range(0, n, bsz):
            cx = fx[start : start + bsz]
            cy = fy[start : start + bsz]
            if cx.shape[0] < bsz:
                pad = bsz - cx.shape[0]
                cx = np.concatenate([cx, np.full(pad, self._xr[0])])
                cy = np.concatenate([cy, np.full(pad, self._yr[0])])
            hi, lo = self._run(
                *self._run_extra,
                *df_from_f64(cx), *df_from_f64(cy),
            )
            outs.append(df_to_f64(hi, lo))
        return np.concatenate(outs)[:n].reshape(qx.shape + self._trailing)


class DoubleFloatEvaluatorND(_BucketedEvaluator):
    """N-D analogue of :class:`DoubleFloatEvaluator2D`: f64-grade serving
    on f32 hardware for :class:`~ndarray_interp_tpu.models.interpnd.InterpND`
    (``method="cubic"`` cell layout, or ``method="linear"``).

    Runs the prepacked DF ND gather route
    (``ops/df_eval.gathered_nd_eval_df_packed``): per-axis DF (idx, t)
    passes + ONE packed (hi, lo) cell-row gather + the k-fold
    tensor-product Hermite (or multilinear) DF tail.  Eval contract: the
    reference's per-axis Hermite chain (``cubic_spline.rs:818-828``)
    tensor-product per axis.

    The packed table is built ONCE at construction and kept on device
    (2x the f32 cell table: ``2 * 4^k * r`` channels per cell for cubic,
    ``2 * 2^k * r`` for linear) and always passed as a jit ARGUMENT
    (``utils/hygiene.py``).  Cubic NODE-layout grids (past
    ``config.interpnd_pack_max_elems``) have no DF route yet — raise
    ``interpnd_pack_max_elems`` or evaluate in f64 on CPU.  Build the
    InterpND eagerly in f64 on CPU; periodic cubic axes wrap in f64 on
    the host (``cubic_spline.rs:804-809`` per axis)."""

    def __init__(
        self, interp, max_batch: int = 1 << 20, buckets=None, grade="df"
    ):
        import numpy as np

        from .models.interpnd import pack_corner_rows_nd
        from .ops.df import df_from_f64
        from .ops.df_eval import (
            gathered_nd_eval_df_packed,
            pack_rows_nd_df,
            pack_rows_nd_f48,
        )

        if grade not in ("df", "f48"):
            raise ValueError(f"grade must be 'df' or 'f48', got {grade!r}")
        super().__init__(interp, max_batch, buckets)
        k = interp.k
        self._k = k
        self._trailing = tuple(interp.data.shape[k:])
        self._extrapolates = bool(interp.extrapolates)
        self._wraps = tuple(interp.wraps_axis(d) for d in range(k))
        axes64 = [np.asarray(ax, np.float64) for ax in interp.axes]
        self._ranges = [(float(a[0]), float(a[-1])) for a in axes64]
        grid_shape = tuple(int(n) for n in interp.data.shape[:k])
        r = 1
        for s in self._trailing:
            r *= s

        if interp.method == "cubic":
            if interp.layout != "cell":
                raise ValueError(
                    "DoubleFloatEvaluatorND supports the cubic CELL "
                    "layout only (one packed row gather); this grid "
                    "packed as NODE layout — raise "
                    "config.interpnd_pack_max_elems to force the cell "
                    "table, or evaluate in f64 on the CPU backend"
                )
            rows64 = np.asarray(interp.table, np.float64)
            nbasis = 4
        elif interp.method == "linear":
            # the f32 interp may run the unpacked route (big grid or
            # int data); the DF table is packed here from f64 data
            data64 = jnp.asarray(np.asarray(interp.data, np.float64))
            rows64 = np.asarray(
                jax.jit(pack_corner_rows_nd, static_argnums=1)(data64, k)
            )
            nbasis = 2
        else:
            raise ValueError(
                "method='nearest' needs no DF route: its gather returns "
                "stored values exactly — evaluate the f64 InterpND"
            )
        self._nbasis = nbasis

        pairs = []
        for a in axes64:
            pairs.extend(df_from_f64(a))
        self._pairs = pairs
        rows_pair = df_from_f64(rows64)
        # table packed ONCE, passed as a jit argument (hygiene contract);
        # grade="f48": bf16-pair lo half — 75% of the DF table's memory
        # and gather traffic at ~2^-33 relative (between f32 and DF)
        pack = {"df": pack_rows_nd_df, "f48": pack_rows_nd_f48}[grade]
        self._packed = jax.jit(
            lambda h, l: pack(h, l, nbasis**k, r)
        )(*rows_pair)
        route = gathered_nd_eval_df_packed(
            k, grid_shape, r, nbasis=nbasis, tier=grade
        )
        self._run_extra = (*self._pairs, self._packed)
        self._run = jax.jit(route)

    def _hygiene_args(self):
        import numpy as np

        b = self._buckets[0]
        qs = []
        for lo, _ in self._ranges:
            qs.extend(_split_q(np.full(b, lo)))
        return self._run, (*self._run_extra, *qs)

    def warmup(self):
        """Precompile every bucket (one trace + compile each)."""
        import numpy as np

        self.verify_hygiene()
        for b in self._buckets:
            qs = []
            for lo, _ in self._ranges:
                qs.extend(_split_q(np.full(b, lo)))
            jax.block_until_ready(self._run(*self._run_extra, *qs))
        return self

    def __call__(self, *coords):
        import numpy as np

        from .errors import OutOfBoundsError
        from .ops.df import df_from_f64, df_to_f64

        self.verify_hygiene()
        k = self._k
        if len(coords) != k:
            raise ValueError(
                f"expected {k} coordinate arrays (one per interpolated "
                f"axis), got {len(coords)}"
            )
        qs = [np.asarray(c, np.float64) for c in coords]
        shape = qs[0].shape
        if any(q.shape != shape for q in qs[1:]):
            raise ValueError("query coordinate shapes do not match")
        flats = [q.reshape(-1) for q in qs]
        n = flats[0].shape[0]
        if n == 0:
            return np.zeros(shape + self._trailing)
        for d, (f, (lo, hi), wrap) in enumerate(
            zip(flats, self._ranges, self._wraps)
        ):
            if np.isnan(f).any():
                # eager API parity (docs/PARITY.md D3)
                raise ValueError("failed to convert NaN to an index")
            if wrap or self._extrapolates:
                continue
            bad = (f < lo) | (f > hi)
            if bad.any():
                i = int(np.argmax(bad))
                raise OutOfBoundsError(
                    f"point {f[i]} is out of bounds of the axis {d} "
                    f"interpolation range [{lo}, {hi}]"
                )
        # periodic axes wrap in f64 on the host (cubic_spline.rs:804-809)
        for d, wrap in enumerate(self._wraps):
            if wrap:
                lo, hi = self._ranges[d]
                span = hi - lo
                f = flats[d]
                out_r = (f < lo) | (f > hi)
                flats[d] = np.where(
                    out_r, np.mod(f - lo, span) + lo, f
                )
        bsz = self._bucket(n)
        outs = []
        for start in range(0, n, bsz):
            chunks = [f[start : start + bsz] for f in flats]
            m = chunks[0].shape[0]
            if m < bsz:
                chunks = [
                    np.concatenate([c, np.full(bsz - m, lo)])
                    for c, (lo, _) in zip(chunks, self._ranges)
                ]
            args = []
            for c in chunks:
                args.extend(df_from_f64(c))
            hi_, lo_ = self._run(*self._run_extra, *args)
            outs.append(df_to_f64(hi_, lo_))
        return np.concatenate(outs)[:n].reshape(shape + self._trailing)
