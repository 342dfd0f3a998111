"""Double-float arithmetic + DF evaluation route tests.

The error-free transforms must be *exact* (their defining property); the
DF routes must match the f64 oracle to ~1e-12 scale-relative — f64-grade
answers from f32 arithmetic (``ops/df_eval.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ndarray_interp_tpu.ops.df import (
    df_add,
    df_div,
    df_from_f64,
    df_mul,
    df_sub,
    df_to_f64,
    two_prod,
    two_sum,
)
from ndarray_interp_tpu.ops.df_eval import eval_df_from_f64


def rnd(shape, seed, lo=-10.0, hi=10.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape)


class TestErrorFreeTransforms:
    def test_two_sum_exact(self):
        a = jnp.asarray(rnd(4096, 0).astype(np.float32))
        b = jnp.asarray((rnd(4096, 1) * 1e-4).astype(np.float32))
        s, e = two_sum(a, b)
        s64 = np.asarray(s, np.float64) + np.asarray(e, np.float64)
        want = np.asarray(a, np.float64) + np.asarray(b, np.float64)
        np.testing.assert_array_equal(s64, want)

    def test_two_prod_exact(self):
        a = jnp.asarray(rnd(4096, 2).astype(np.float32))
        b = jnp.asarray(rnd(4096, 3).astype(np.float32))
        p, e = two_prod(a, b)
        p64 = np.asarray(p, np.float64) + np.asarray(e, np.float64)
        want = np.asarray(a, np.float64) * np.asarray(b, np.float64)
        np.testing.assert_array_equal(p64, want)

    @pytest.mark.parametrize(
        "op,ref",
        [
            (df_add, np.add),
            (df_sub, np.subtract),
            (df_mul, np.multiply),
            (df_div, np.divide),
        ],
    )
    def test_df_ops_f64_grade(self, op, ref):
        x64 = rnd(4096, 4)
        y64 = rnd(4096, 5, lo=0.1, hi=10.0)  # positive: safe divisor
        xs, ys = df_from_f64(x64), df_from_f64(y64)
        got = df_to_f64(*op(xs, ys))
        # oracle on the DF-*representable* inputs: additive cancellation
        # amplifies the (x - df(x)) representation error unboundedly, which
        # is a property of the 49-bit format, not of the arithmetic
        want = ref(df_to_f64(*xs), df_to_f64(*ys))
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
        assert rel.max() < 1e-13, rel.max()

    def test_split_roundtrip(self):
        x64 = rnd(4096, 6, lo=-1e6, hi=1e6)
        hi, lo = df_from_f64(x64)
        back = df_to_f64(hi, lo)
        rel = np.abs(back - x64) / np.maximum(np.abs(x64), 1e-300)
        # 24+24 mantissa bits: 2^-49 ~ 1.8e-15
        assert rel.max() < 1e-14


def _np_hermite(x, d, a, b, q):
    """NumPy f64 oracle: clamped interval search + the symmetric Hermite
    of ``cubic_spline.rs:818-828``."""
    idx = np.clip(np.searchsorted(x, q, side="right") - 1, 0, len(x) - 2)
    t = (q - x[idx]) / (x[idx + 1] - x[idx])
    return (
        (1 - t) * d[idx] + t * d[idx + 1]
        + t * (1 - t) * (a[idx] * (1 - t) + b[idx] * t)
    )


def _spline_fixture(n=512, nq=4096, seed=7):
    """Random non-uniform cubic table in f64 + the f64 oracle.

    Inputs are rounded to DF-representable values (49-bit) first: the
    oracle then isolates the *arithmetic* error.  The irreducible input
    representation error of the format is ~|x| * 2^-49, which on knots
    of magnitude ~250 would otherwise dominate the comparison."""
    rng = np.random.default_rng(seed)

    def rep(v):
        return df_to_f64(*df_from_f64(v))

    x64 = rep(np.cumsum(rng.uniform(0.05, 1.0, n)))
    d64 = rep(rng.normal(size=n))
    a64 = rep(rng.normal(size=n - 1))
    b64 = rep(rng.normal(size=n - 1))
    q64 = rep(rng.uniform(x64[0] - 2.0, x64[-1] + 2.0, nq))
    oracle = _np_hermite(x64, d64, a64, b64, q64)
    return x64, d64, a64, b64, q64, oracle


class TestDFKernel:
    """The scalar 1-D DF route (``eval_xla_df``) under CPU jit; the same
    1e-12 gate runs on the card in ``chip_smoke.py`` phase P5."""

    def test_xla_df_matches_f64_oracle(self):
        x64, d64, a64, b64, q64, oracle = _spline_fixture()
        got = eval_df_from_f64(x64, d64, a64, b64, q64)
        # scale relative error by the data magnitude: where the spline
        # crosses zero the pointwise relative error is unbounded for ANY
        # finite precision (output cancellation), which says nothing
        # about the arithmetic
        scale = np.maximum(np.abs(oracle), 0.01 * np.abs(d64).max())
        rel = np.abs(got - oracle) / scale
        assert rel.max() < 1e-12, rel.max()

    def test_f32_kernel_is_not_enough(self):
        """Sanity check the target is non-trivial: plain f32 evaluation
        misses 1e-12 by orders of magnitude on the same fixture."""
        x64, d64, a64, b64, q64, oracle = _spline_fixture()
        f32 = lambda v: np.asarray(v, np.float32)
        got = _np_hermite(f32(x64), f32(d64), f32(a64), f32(b64), f32(q64))
        got = np.asarray(got, np.float64)
        rel = np.abs(got - oracle) / np.maximum(np.abs(oracle), 1e-30)
        assert rel.max() > 1e-9

    @pytest.mark.parametrize("path", ["xla"])
    def test_clamp_and_inf_semantics(self, path):
        """OOB queries clamp to the edge intervals; ±inf on a linear
        table extrapolates to ±inf (reference get_lower_index clamp +
        calc_frac, vector_extensions.rs:61-66 / linear.rs:29-37)."""
        n = 64
        x64 = np.cumsum(np.random.default_rng(8).uniform(0.1, 1.0, n))
        d64 = 2.0 * x64 + 1.0  # linear data, a = b = 0
        z = np.zeros(n - 1)
        q64 = np.array([x64[0] - 5.0, x64[-1] + 5.0, np.inf, -np.inf])
        got = eval_df_from_f64(x64, d64, z, z, q64)
        np.testing.assert_allclose(got[:2], 2.0 * q64[:2] + 1.0, rtol=1e-12)
        assert got[2] == np.inf and got[3] == -np.inf

    @pytest.mark.parametrize("path", ["xla"])
    def test_nan_query_propagates(self, path):
        x64 = np.arange(16.0)
        d64 = np.arange(16.0) ** 2
        z = np.zeros(15)
        got = eval_df_from_f64(x64, d64, z, z, np.array([np.nan, 2.5]))
        assert np.isnan(got[0]) and np.isfinite(got[1])

    @pytest.mark.parametrize("path", ["xla"])
    def test_selection_resolves_f32_knot_collisions(self, path):
        """Two knots equal in f32 but distinct in f64: the DF compare
        still buckets a query between them correctly — an interval
        selection no f32-only path can make."""
        base = 1.0
        eps64 = 1e-12  # << f32 ulp at 1.0
        x64 = np.array([0.0, base, base + eps64, 2.0, 3.0])
        d64 = np.array([0.0, 10.0, 20.0, 30.0, 40.0])
        z = np.zeros(4)
        q64 = np.array([base + eps64 / 2])  # inside the micro-interval
        got = eval_df_from_f64(x64, d64, z, z, q64)
        # linear within [base, base+eps64]: halfway between 10 and 20
        np.testing.assert_allclose(got[0], 15.0, rtol=1e-3)

    def test_pairs_api_matches_wrapper(self):
        x64, d64, a64, b64, q64, oracle = _spline_fixture(n=128, nq=512)
        args = []
        for v in (x64, d64, a64, b64, q64):
            args.extend(df_from_f64(v))
        import jax

        from ndarray_interp_tpu.ops.df_eval import eval_xla_df

        hi, lo = jax.jit(eval_xla_df)(*args)
        got = df_to_f64(hi, lo)
        scale = np.maximum(np.abs(oracle), 0.01 * np.abs(d64).max())
        rel = np.abs(got - oracle) / scale
        assert rel.max() < 1e-12


class TestDF2D:
    def test_bilinear_df_matches_f64_oracle(self):
        from ndarray_interp_tpu.ops.df_eval import eval_xla_df_2d

        rng = np.random.default_rng(17)

        def rep(v):
            return df_to_f64(*df_from_f64(v))

        nx, ny, nq = 64, 48, 2048
        x64 = rep(np.cumsum(rng.uniform(0.05, 1.0, nx)))
        y64 = rep(np.cumsum(rng.uniform(0.05, 1.0, ny)))
        z64 = rep(rng.normal(size=(nx, ny)))
        qx64 = rep(rng.uniform(x64[0] - 1, x64[-1] + 1, nq))
        qy64 = rep(rng.uniform(y64[0] - 1, y64[-1] + 1, nq))
        args = []
        for v in (x64, y64, z64, qx64, qy64):
            args.extend(df_from_f64(v))
        import jax

        hi, lo = jax.jit(eval_xla_df_2d)(*args)
        got = df_to_f64(hi, lo)

        xi = np.clip(np.searchsorted(x64, qx64, side="right") - 1, 0, nx - 2)
        yi = np.clip(np.searchsorted(y64, qy64, side="right") - 1, 0, ny - 2)

        def L(x1, y1, x2, y2, q):
            return (y2 - y1) / (x2 - x1) * (q - x1) + y1

        z1 = L(x64[xi], z64[xi, yi], x64[xi + 1], z64[xi + 1, yi], qx64)
        z2 = L(x64[xi], z64[xi, yi + 1], x64[xi + 1], z64[xi + 1, yi + 1], qx64)
        want = L(y64[yi], z1, y64[yi + 1], z2, qy64)
        scale = np.maximum(np.abs(want), 0.01 * np.abs(z64).max())
        assert (np.abs(got - want) / scale).max() < 1e-12

    def test_serving_evaluator_2d(self):
        from ndarray_interp_tpu.errors import OutOfBoundsError
        from ndarray_interp_tpu.interp2d import Interp2D
        from ndarray_interp_tpu.serving import DoubleFloatEvaluator2D

        rng = np.random.default_rng(18)
        nx, ny = 24, 20
        x = jnp.asarray(np.linspace(0.0, 1.0, nx))
        y = jnp.asarray(np.linspace(0.0, 2.0, ny))
        data = jnp.asarray(rng.normal(size=(nx, ny)))
        itp = Interp2D.builder(data).x(x).y(y).build()
        ev = DoubleFloatEvaluator2D(itp, max_batch=512)
        qx = rng.uniform(0, 1, 300)
        qy = rng.uniform(0, 2, 300)
        got = ev(qx, qy)
        want = np.asarray(itp.interp_array(qx, qy))
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        assert (np.abs(got - want) / scale).max() < 1e-9
        with pytest.raises(OutOfBoundsError):
            ev(np.asarray([-3.0]), np.asarray([0.5]))
        with pytest.raises(ValueError):
            ev(np.zeros(3), np.zeros(4))


def test_banked_df_evaluator_matches_f64_oracle():
    from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu.serving import DoubleFloatEvaluator

    rng = np.random.default_rng(23)
    n, bank = 128, 6
    x = jnp.asarray(np.cumsum(rng.uniform(0.1, 1.0, n)))
    data = jnp.asarray(rng.normal(size=(n, bank)))
    itp = (
        Interp1D.builder(data)
        .x(x)
        .strategy(CubicSpline().extrapolate(True))
        .build()
    )
    ev = DoubleFloatEvaluator(itp, max_batch=1024).warmup()
    q = rng.uniform(float(x[0]) - 1, float(x[-1]) + 1, 500)
    got = ev(q)
    assert got.shape == (500, bank)
    want = np.asarray(itp.interp_array(q))
    scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
    assert (np.abs(got - want) / scale).max() < 1e-9


def test_df_evaluator_nan_raises_in_extrapolate_mode():
    """Eager API parity (D3): extrapolating modes raise ValueError on
    NaN queries instead of silently returning NaN."""
    from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu.serving import DoubleFloatEvaluator

    rng = np.random.default_rng(29)
    d = jnp.asarray(rng.normal(size=32))
    itp = (
        Interp1D.builder(d).strategy(CubicSpline().extrapolate(True)).build()
    )
    ev = DoubleFloatEvaluator(itp)
    with pytest.raises(ValueError, match="NaN"):
        ev(np.asarray([np.nan]))


class TestDFBankedGatherRoute:
    """DF banked gather route: DF (idx, t) pass + one packed (hi, lo)
    row gather + the DF tail."""

    def _fixture(self, n=512, bank=16, nq=2048, seed=12):
        rng = np.random.default_rng(seed)
        x64 = np.cumsum(rng.uniform(0.05, 1.0, n))
        d64 = rng.normal(size=(n, bank))
        a64 = rng.normal(size=(n - 1, bank))
        b64 = rng.normal(size=(n - 1, bank))
        q64 = np.r_[
            rng.uniform(x64[0] - 1, x64[-1] + 1, nq - 4),
            [x64[0], x64[-1], x64[7], x64[n // 2]],
        ]
        return x64, d64, a64, b64, q64

    def test_index_matches_df_oracle_interpret(self):
        import jax

        from ndarray_interp_tpu.ops.df_eval import df_index_frac

        x64, _, _, _, q64 = self._fixture()
        args = [*df_from_f64(x64), *df_from_f64(q64)]
        idx, th, tl = jax.jit(df_index_frac)(*map(jnp.asarray, args))
        # oracle: searchsorted on the f64 values (DF-lexicographic ==
        # f64 order for df_from_f64 pairs)
        want = np.clip(
            np.searchsorted(x64, q64, side="right") - 1, 0, len(x64) - 2
        )
        np.testing.assert_array_equal(np.asarray(idx), want)
        t64 = (q64 - x64[want]) / (x64[want + 1] - x64[want])
        got_t = np.asarray(th, np.float64) + np.asarray(tl, np.float64)
        # q64 is not DF-representable here: its ~2^-49 representation
        # error bounds the t agreement
        np.testing.assert_allclose(got_t, t64, rtol=1e-10, atol=1e-10)

    def test_values_match_banked_xla_form_interpret(self):
        from ndarray_interp_tpu.ops.df_eval import (
            eval_xla_df_banked,
            gathered_bank_eval_df,
        )

        x64, d64, a64, b64, q64 = self._fixture()
        args = []
        for v in (x64, d64, a64, b64, q64):
            args.extend(df_from_f64(v))
        args = [jnp.asarray(v) for v in args]
        hi, lo = gathered_bank_eval_df(*args)
        whi, wlo = eval_xla_df_banked(*args)
        got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        want = np.asarray(whi, np.float64) + np.asarray(wlo, np.float64)
        scale = np.maximum(np.abs(want), 0.01 * np.abs(d64).max())
        assert (np.abs(got - want) / scale).max() < 1e-12

    def test_packed_tail_matches_f64_formula(self):
        """The DF tail on gathered packed rows reads the right blocks:
        it reproduces the f64 Hermite of the same (idx, t) at DF grade."""
        import jax

        from ndarray_interp_tpu.ops.df_eval import (
            _df_xla_tail,
            pack_bank_rows_df,
        )

        def rep(v):
            return df_to_f64(*df_from_f64(v))

        x64, d64, a64, b64, _ = self._fixture(nq=1024)
        d64, a64, b64 = rep(d64), rep(a64), rep(b64)
        packed = pack_bank_rows_df(
            *(jnp.asarray(v) for v in (
                *df_from_f64(d64), *df_from_f64(a64), *df_from_f64(b64)
            ))
        )
        rng = np.random.default_rng(3)
        idx = rng.integers(0, len(x64) - 1, 1024)
        t64 = rep(rng.uniform(-0.5, 1.5, 1024))
        th, tl = (jnp.asarray(v) for v in df_from_f64(t64))
        rows = jnp.take(packed, jnp.asarray(idx, jnp.int32), axis=0)
        bank = d64.shape[1]
        hi, lo = jax.jit(lambda r, a, b: _df_xla_tail(r, a, b, bank))(
            rows, th, tl
        )
        t = t64[:, None]
        want = (
            (1 - t) * d64[idx] + t * d64[idx + 1]
            + t * (1 - t) * (a64[idx] * (1 - t) + b64[idx] * t)
        )
        got = df_to_f64(hi, lo)
        scale = np.maximum(np.abs(want), 0.01 * np.abs(d64).max())
        assert (np.abs(got - want) / scale).max() < 1e-12


class TestDFBilinearGatherRoute:
    """DF bilinear gather route: DF (idx, t) passes + one packed (hi, lo)
    corner-row gather + the DF tail."""

    def _fixture(self, nx=96, ny=64, trailing=(), nq=2048, seed=27):
        rng = np.random.default_rng(seed)
        x64 = np.cumsum(rng.uniform(0.05, 1.0, nx))
        y64 = np.cumsum(rng.uniform(0.05, 1.0, ny))
        z64 = rng.normal(size=(nx, ny) + trailing)
        qx64 = rng.uniform(x64[0] - 1, x64[-1] + 1, nq)
        qy64 = rng.uniform(y64[0] - 1, y64[-1] + 1, nq)
        return x64, y64, z64, qx64, qy64

    @pytest.mark.parametrize("trailing", [(), (5,)])
    def test_matches_xla_2d_form_interpret(self, trailing):
        from ndarray_interp_tpu.ops.df_eval import (
            eval_xla_df_2d,
            gathered_bilinear_eval_df,
        )

        x64, y64, z64, qx64, qy64 = self._fixture(trailing=trailing)
        args = []
        for v in (x64, y64, z64, qx64, qy64):
            args.extend(jnp.asarray(w) for w in df_from_f64(v))
        hi, lo = gathered_bilinear_eval_df(*args)
        whi, wlo = eval_xla_df_2d(*args)
        got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        want = np.asarray(whi, np.float64) + np.asarray(wlo, np.float64)
        assert got.shape == (2048,) + trailing
        scale = np.maximum(np.abs(want), 0.01 * np.abs(z64).max())
        assert (np.abs(got - want) / scale).max() < 1e-12

    def test_serving_evaluator_2d_banked(self):
        from ndarray_interp_tpu.interp2d import Interp2D
        from ndarray_interp_tpu.serving import DoubleFloatEvaluator2D

        rng = np.random.default_rng(28)
        nx, ny, r = 24, 20, 3
        x = jnp.asarray(np.linspace(0.0, 1.0, nx))
        y = jnp.asarray(np.linspace(0.0, 2.0, ny))
        data = jnp.asarray(rng.normal(size=(nx, ny, r)))
        itp = Interp2D.builder(data).x(x).y(y).build()
        ev = DoubleFloatEvaluator2D(itp, max_batch=512)
        qx = rng.uniform(0, 1, 300)
        qy = rng.uniform(0, 2, 300)
        got = ev(qx, qy)
        assert got.shape == (300, r)
        want = np.asarray(itp.interp_array(qx, qy))
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        assert (np.abs(got - want) / scale).max() < 1e-9


def test_two_prod_broadcast_exact_under_jit():
    """Round-3 regression: (Q,1) x (Q,bank) two_prod under CPU jit lost
    its error term to an emitter-level FMA contraction of the Veltkamp
    split (the HLO was correct; the corruption was below it).  The
    integer-domain broadcast materialization must keep it exact."""
    import jax

    from ndarray_interp_tpu.ops.df import two_prod

    rng = np.random.default_rng(0)
    for sa, sb in [((50, 1), (50, 3)), ((50, 3), (50, 1)), ((1,), (64,))]:
        a = jnp.asarray(rng.normal(size=sa).astype(np.float32))
        b = jnp.asarray(rng.normal(size=sb).astype(np.float32))
        ref = np.asarray(a, np.float64) * np.asarray(b, np.float64)
        p, e = jax.jit(two_prod)(a, b)
        got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
        np.testing.assert_array_equal(got, ref)


def test_banked_xla_df_f64_grade_on_cpu():
    """With the broadcast fix the banked XLA DF form reaches DF grade
    on the CPU jit surface — ~2.6e-12 max over 32k x bank samples
    (near-cancellation points) under the strict per-point scale."""
    import jax

    from ndarray_interp_tpu.ops.df_eval import eval_xla_df_banked

    rng = np.random.default_rng(33)
    n, bank, nq = 256, 8, 4096

    def rep(v):
        return df_to_f64(*df_from_f64(v))

    x64 = rep(np.linspace(0.0, 1.0, n))
    d64 = rep(rng.normal(size=(n, bank)))
    a64 = rep(rng.normal(size=(n - 1, bank)))
    b64 = rep(rng.normal(size=(n - 1, bank)))
    q64 = rep(rng.uniform(-0.1, 1.1, nq))
    args = []
    for v in (x64, d64, a64, b64, q64):
        args.extend(jnp.asarray(w) for w in df_from_f64(v))
    hi, lo = jax.jit(eval_xla_df_banked)(*args)
    got = df_to_f64(hi, lo)
    idx = np.clip(np.searchsorted(x64, q64, side="right") - 1, 0, n - 2)
    t = ((q64 - x64[idx]) / (x64[idx + 1] - x64[idx]))[:, None]
    want = (
        (1 - t) * d64[idx]
        + t * d64[idx + 1]
        + t * (1 - t) * (a64[idx] * (1 - t) + b64[idx] * t)
    )
    scale = np.maximum(np.abs(want), 0.01 * np.abs(d64).max())
    assert (np.abs(got - want) / scale).max() < 4e-12


class TestDFBicubicGatherRoute:
    """f64-grade tensor-product cubic (the beyond-reference flagship
    2-D strategy): DF (idx, t) passes + packed DF cell-row gather +
    guarded scaled-Hermite tail."""

    def _build(self, trailing=(), nx=20, ny=16, seed=37, bc=None):
        import jax

        from ndarray_interp_tpu.interp2d import Bicubic, Interp2D

        rng = np.random.default_rng(seed)
        x = np.cumsum(rng.uniform(0.2, 1.0, nx))
        y = np.cumsum(rng.uniform(0.2, 1.0, ny))
        z = rng.normal(size=(nx, ny) + trailing)
        s = Bicubic().extrapolate(True)
        if bc:
            s = s.boundary(*bc).extrapolate(True)
        itp = (
            Interp2D.builder(jnp.asarray(z))
            .x(jnp.asarray(x))
            .y(jnp.asarray(y))
            .strategy(s)
            .build()
        )
        assert itp.data.dtype == jnp.float64, "run with x64 (conftest)"
        return itp, rng

    @pytest.mark.parametrize("trailing", [(), (3,)])
    def test_route_matches_f64_strategy(self, trailing):
        import jax

        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bicubic_eval_df,
        )

        itp, rng = self._build(trailing=trailing)
        r = 1
        for s in trailing:
            r *= s
        x64 = np.asarray(itp.x, np.float64)
        y64 = np.asarray(itp.y, np.float64)
        rows64 = np.asarray(itp.strategy.rows, np.float64)
        qx = rng.uniform(x64[0], x64[-1], 400)
        qy = rng.uniform(y64[0], y64[-1], 400)
        args = []
        for v in (x64, y64, rows64, qx, qy):
            args.extend(jnp.asarray(w) for w in df_from_f64(v))
        hi, lo = jax.jit(
            lambda *a: gathered_bicubic_eval_df(*a, r=r)
        )(*args)
        got = df_to_f64(hi, lo).reshape((400,) + trailing)
        want = np.asarray(itp.interp_array(qx, qy))  # f64 strategy eval
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        assert (np.abs(got - want) / scale).max() < 1e-9

    def test_serving_evaluator_bicubic(self):
        from ndarray_interp_tpu.serving import DoubleFloatEvaluator2D

        itp, rng = self._build(trailing=(2,))
        ev = DoubleFloatEvaluator2D(itp, max_batch=512)
        x64 = np.asarray(itp.x, np.float64)
        y64 = np.asarray(itp.y, np.float64)
        qx = rng.uniform(x64[0], x64[-1], 300)
        qy = rng.uniform(y64[0], y64[-1], 300)
        got = ev(qx, qy)
        assert got.shape == (300, 2)
        want = np.asarray(itp.interp_array(qx, qy))
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        assert (np.abs(got - want) / scale).max() < 1e-9

    def test_serving_evaluator_bicubic_periodic_wraps(self):
        from ndarray_interp_tpu.serving import DoubleFloatEvaluator2D

        import jax

        from ndarray_interp_tpu.interp2d import Bicubic, Interp2D

        rng = np.random.default_rng(39)
        nx, ny = 16, 14
        x = np.cumsum(rng.uniform(0.2, 1.0, nx))
        y = np.cumsum(rng.uniform(0.2, 1.0, ny))
        z = rng.normal(size=(nx, ny))
        z[-1] = z[0]
        itp = (
            Interp2D.builder(jnp.asarray(z))
            .x(jnp.asarray(x))
            .y(jnp.asarray(y))
            .strategy(Bicubic().boundary("periodic", "not_a_knot"))
            .build()
        )
        ev = DoubleFloatEvaluator2D(itp, max_batch=512)
        qx = rng.uniform(x[0], x[-1], 100)
        qy = rng.uniform(y[0], y[-1], 100)
        base = ev(qx, qy)
        period = x[-1] - x[0]
        wrapped = ev(qx + 2 * period, qy)
        np.testing.assert_allclose(wrapped, base, rtol=1e-6, atol=1e-9)


class TestDFBicubicNodeRoute:
    """The memory-frugal f64-grade bicubic route: 4 DF node-row gathers
    + the DF tail with in-tail derivative scaling.  Must match the f64
    node-layout strategy eval (and hence the cell route)."""

    def _build(self, trailing=(), nx=18, ny=15, seed=41, monkeypatch=None):
        from ndarray_interp_tpu import config
        from ndarray_interp_tpu.interp2d import Bicubic, Interp2D

        monkeypatch.setattr(config, "bicubic_pack_max_elems", 10)
        rng = np.random.default_rng(seed)
        x = np.cumsum(rng.uniform(0.2, 1.0, nx))
        y = np.cumsum(rng.uniform(0.2, 1.0, ny))
        z = rng.normal(size=(nx, ny) + trailing)
        itp = (
            Interp2D.builder(jnp.asarray(z))
            .x(jnp.asarray(x))
            .y(jnp.asarray(y))
            .strategy(Bicubic().extrapolate(True))
            .build()
        )
        assert itp.strategy.layout == "node"
        assert itp.data.dtype == jnp.float64, "run with x64 (conftest)"
        return itp, rng

    @pytest.mark.parametrize("trailing", [(), (3,)])
    def test_route_matches_f64_strategy(self, trailing, monkeypatch):
        import jax

        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bicubic_nodes_eval_df,
            pack_bicubic_nodes_df,
        )

        itp, rng = self._build(trailing=trailing, monkeypatch=monkeypatch)
        r = 1
        for s in trailing:
            r *= s
        x64 = np.asarray(itp.x, np.float64)
        y64 = np.asarray(itp.y, np.float64)
        rows64 = np.asarray(itp.strategy.rows, np.float64)
        packed = pack_bicubic_nodes_df(*df_from_f64(rows64))
        qx = rng.uniform(x64[0], x64[-1], 400)
        qy = rng.uniform(y64[0], y64[-1], 400)
        args = []
        for v in (x64, y64):
            args.extend(jnp.asarray(w) for w in df_from_f64(v))
        args.append(packed)
        for v in (qx, qy):
            args.extend(jnp.asarray(w) for w in df_from_f64(v))
        hi, lo = jax.jit(
            lambda *a: gathered_bicubic_nodes_eval_df(*a, r=r)
        )(*args)
        got = df_to_f64(hi, lo).reshape((400,) + trailing)
        want = np.asarray(itp.interp_array(qx, qy))  # f64 strategy eval
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        assert (np.abs(got - want) / scale).max() < 1e-9

    def test_serving_evaluator_node_layout(self, monkeypatch):
        from ndarray_interp_tpu.serving import DoubleFloatEvaluator2D

        itp, rng = self._build(trailing=(2,), monkeypatch=monkeypatch)
        ev = DoubleFloatEvaluator2D(itp, max_batch=512)
        x64 = np.asarray(itp.x, np.float64)
        y64 = np.asarray(itp.y, np.float64)
        qx = rng.uniform(x64[0], x64[-1], 300)
        qy = rng.uniform(y64[0], y64[-1], 300)
        got = ev(qx, qy)
        assert got.shape == (300, 2)
        want = np.asarray(itp.interp_array(qx, qy))
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        assert (np.abs(got - want) / scale).max() < 1e-9

    def test_chunked_tail_matches_unchunked(self, monkeypatch):
        """The lax.map chunking (the live-memory cap) keeps f64 grade.

        hi halves are bit-identical; lo halves differ in last-bit
        rounding only (XLA:CPU compiles the loop body with different
        fusion/contraction than the inlined tail — the EFT chain is
        guarded either way, so the difference stays at ~2^-48 of value
        scale, checked here against the f64 strategy oracle)."""
        import jax

        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bicubic_nodes_eval_df,
            pack_bicubic_nodes_df,
        )

        itp, rng = self._build(monkeypatch=monkeypatch)
        x64 = np.asarray(itp.x, np.float64)
        y64 = np.asarray(itp.y, np.float64)
        rows64 = np.asarray(itp.strategy.rows, np.float64)
        packed = pack_bicubic_nodes_df(*df_from_f64(rows64))
        qx = rng.uniform(x64[0], x64[-1], 400)
        qy = rng.uniform(y64[0], y64[-1], 400)
        args = []
        for v in (x64, y64):
            args.extend(jnp.asarray(w) for w in df_from_f64(v))
        args.append(packed)
        for v in (qx, qy):
            args.extend(jnp.asarray(w) for w in df_from_f64(v))
        one_h, one_l = jax.jit(
            lambda *a: gathered_bicubic_nodes_eval_df(*a, r=1)
        )(*args)
        chk_h, chk_l = jax.jit(
            lambda *a: gathered_bicubic_nodes_eval_df(*a, r=1, chunk=64)
        )(*args)
        np.testing.assert_array_equal(np.asarray(one_h), np.asarray(chk_h))
        want = np.asarray(itp.interp_array(qx, qy))
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        got = df_to_f64(chk_h, chk_l).reshape(400)
        assert (np.abs(got - want) / scale).max() < 1e-9

    def test_extrapolation_matches_strategy(self, monkeypatch):
        """The node route extrapolates via the same clamped-cell
        arithmetic as the strategy (extrapolate=True built above)."""
        import jax

        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bicubic_nodes_eval_df,
            pack_bicubic_nodes_df,
        )

        itp, rng = self._build(monkeypatch=monkeypatch)
        x64 = np.asarray(itp.x, np.float64)
        y64 = np.asarray(itp.y, np.float64)
        rows64 = np.asarray(itp.strategy.rows, np.float64)
        packed = pack_bicubic_nodes_df(*df_from_f64(rows64))
        span_x = x64[-1] - x64[0]
        qx = np.concatenate(
            [x64[0] - rng.uniform(0, span_x / 4, 50),
             x64[-1] + rng.uniform(0, span_x / 4, 50)]
        )
        qy = rng.uniform(y64[0], y64[-1], 100)
        args = []
        for v in (x64, y64):
            args.extend(jnp.asarray(w) for w in df_from_f64(v))
        args.append(packed)
        for v in (qx, qy):
            args.extend(jnp.asarray(w) for w in df_from_f64(v))
        hi, lo = jax.jit(
            lambda *a: gathered_bicubic_nodes_eval_df(*a, r=1)
        )(*args)
        got = df_to_f64(hi, lo).reshape(100)
        want = np.asarray(itp.interp_array(qx, qy))
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        assert (np.abs(got - want) / scale).max() < 1e-9


class TestDFBicubicWeightTail:
    """The DF bicubic cell tail (``df_eval._df_bicubic_tail``, the
    5-Hermite nesting on gathered (hi, lo) rows) at DF grade under CPU
    jit, against an f64 NumPy oracle."""

    def _fixture(self, B=512, r=16, seed=11):
        rng = np.random.default_rng(seed)
        rows64 = rng.normal(size=(B, 16 * r))
        rh, rl = df_from_f64(rows64)
        rows = jnp.concatenate([jnp.asarray(rh), jnp.asarray(rl)], axis=1)
        tx64 = rng.uniform(-0.5, 1.5, B)
        ty64 = rng.uniform(-0.5, 1.5, B)
        txh, txl = (jnp.asarray(v) for v in df_from_f64(tx64))
        tyh, tyl = (jnp.asarray(v) for v in df_from_f64(ty64))
        return rows64, rows, tx64, ty64, (txh, txl, tyh, tyl)

    @staticmethod
    def _oracle(rows64, tx64, ty64, r):
        def herm(y_l, y_r, K_l, K_r, t):
            dy = y_r - y_l
            a = K_l - dy
            b = dy - K_r
            return (1 - t) * y_l + t * y_r + t * (1 - t) * (
                a * (1 - t) + b * t
            )

        B = rows64.shape[0]
        g = rows64.reshape(B, 4, 4, r)
        tx = tx64[:, None]
        ty = ty64[:, None]
        f_y1 = herm(g[:, 0, 0], g[:, 0, 2], g[:, 1, 0], g[:, 1, 2], tx)
        f_y2 = herm(g[:, 0, 1], g[:, 0, 3], g[:, 1, 1], g[:, 1, 3], tx)
        g_y1 = herm(g[:, 2, 0], g[:, 2, 2], g[:, 3, 0], g[:, 3, 2], tx)
        g_y2 = herm(g[:, 2, 1], g[:, 2, 3], g[:, 3, 1], g[:, 3, 3], tx)
        return herm(f_y1, f_y2, g_y1, g_y2, ty)

    def _tail(self, rows, t, r):
        import jax

        from ndarray_interp_tpu.ops.df_eval import _df_bicubic_tail

        bp = -(-r // 8) * 8
        return jax.jit(
            lambda rw, a, b, c, d: _df_bicubic_tail(
                rw, a[:, None], b[:, None], c[:, None], d[:, None], bp
            )
        )(rows, *t)

    def test_guarded_xla_jit_f64_grade(self):
        """The guarded EFT chain survives XLA:CPU jit at DF grade."""
        r = 16
        rows64, rows, tx64, ty64, t = self._fixture(r=r)
        hi, lo = self._tail(rows, t, r)
        got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        want = self._oracle(rows64, tx64, ty64, r)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < 1e-12

    @pytest.mark.parametrize("r", [3, 8])
    def test_padded_blocks_f64_grade(self, r):
        """Padded blocks (``bp`` lanes per quantity, here r=3 → 8) are
        sliced back correctly: the tail on ``pack_bicubic_rows_df`` rows
        matches the oracle at DF grade."""
        from ndarray_interp_tpu.ops.df_eval import pack_bicubic_rows_df

        rng = np.random.default_rng(19 + r)
        B = 256
        rows64 = rng.normal(size=(B, 16 * r))
        rh, rl = (jnp.asarray(v) for v in df_from_f64(rows64))
        rows = pack_bicubic_rows_df(rh, rl, r)
        tx64 = rng.uniform(-0.5, 1.5, B)
        ty64 = rng.uniform(-0.5, 1.5, B)
        t = []
        for v in (tx64, ty64):
            t.extend(jnp.asarray(w) for w in df_from_f64(v))
        hi, lo = self._tail(rows, t, r)
        got = (
            np.asarray(hi[:, :r], np.float64)
            + np.asarray(lo[:, :r], np.float64)
        )
        want = self._oracle(rows64, tx64, ty64, r)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < 1e-12


class TestF48BicubicTier:
    """Round 4: the bf16-lo "f48" accuracy tier — the one unmeasured
    variant from the round-3 DF-cost analysis (docs/ROADMAP.md): pack
    the cell table's lo half as bf16 pairs two-per-f32-lane (1.5 KB
    rows at r=16 vs DF's 2 KB), giving ~2^-33 scale-relative accuracy —
    the intermediate grade between the f32 route (~2^-24) and full DF
    (~2^-48) at 75% of DF's memory and gather traffic."""

    def _grid(self, trailing=(3,), seed=37):
        import jax

        from ndarray_interp_tpu.interp2d import Bicubic, Interp2D

        rng = np.random.default_rng(seed)
        nx, ny = 20, 16
        x = np.cumsum(rng.uniform(0.2, 1.0, nx))
        y = np.cumsum(rng.uniform(0.2, 1.0, ny))
        z = rng.normal(size=(nx, ny) + trailing)
        itp = (
            Interp2D.builder(jnp.asarray(z))
            .x(jnp.asarray(x))
            .y(jnp.asarray(y))
            .strategy(Bicubic().extrapolate(True))
            .build()
        )
        assert itp.data.dtype == jnp.float64, "run with x64 (conftest)"
        return itp, rng

    def test_pack_unpack_roundtrip_exact(self):
        """Unpacking returns EXACTLY bf16(lo) widened to f32 (bf16→f32
        appends 16 zero bits), and the hi half is untouched."""
        from ndarray_interp_tpu.ops.df_eval import (
            _unpack_f48_lo,
            pack_bicubic_rows_df,
            pack_bicubic_rows_f48,
        )

        rng = np.random.default_rng(5)
        cells, r = 37, 16
        hi = jnp.asarray(rng.normal(size=(cells, 16 * r)).astype(np.float32))
        lo = jnp.asarray(
            (rng.normal(size=(cells, 16 * r)) * 1e-8).astype(np.float32)
        )
        pk = pack_bicubic_rows_f48(hi, lo, r)
        bp = 16
        assert pk.shape == (cells, 24 * bp)
        got_lo = np.asarray(_unpack_f48_lo(pk[:, 16 * bp :]))
        want_lo = np.asarray(
            jnp.asarray(lo).astype(jnp.bfloat16).astype(jnp.float32)
        )
        np.testing.assert_array_equal(got_lo, want_lo)
        np.testing.assert_array_equal(
            np.asarray(pk[:, : 16 * bp]),
            np.asarray(pack_bicubic_rows_df(hi, lo, r)[:, : 16 * bp]),
        )

    def test_route_grade_on_cpu(self):
        """Full f48 route (guarded-XLA branch) vs the f64 strategy:
        ~1e-9 scale-relative (measured 1.3e-9) — an order past the f32
        route, two-three short of DF; gate with headroom at 1e-8."""
        import jax

        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bicubic_eval_f48_packed,
            pack_bicubic_rows_f48,
        )

        itp, rng = self._grid(trailing=(3,))
        x64 = np.asarray(itp.x, np.float64)
        y64 = np.asarray(itp.y, np.float64)
        rows64 = np.asarray(itp.strategy.rows, np.float64)
        packed = pack_bicubic_rows_f48(
            *[jnp.asarray(v) for v in df_from_f64(rows64)], 3
        )
        qx = rng.uniform(x64[0], x64[-1], 400)
        qy = rng.uniform(y64[0], y64[-1], 400)
        args = []
        for v in (x64, y64):
            args.extend(jnp.asarray(w) for w in df_from_f64(v))
        args.append(packed)
        for v in (qx, qy):
            args.extend(jnp.asarray(w) for w in df_from_f64(v))
        hi, lo = jax.jit(
            lambda *a: gathered_bicubic_eval_f48_packed(*a, r=3)
        )(*args)
        got = df_to_f64(hi, lo).reshape(400, 3)
        want = np.asarray(itp.interp_array(qx, qy))
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        assert (np.abs(got - want) / scale).max() < 1e-8

    def test_serving_grade_kwarg(self, monkeypatch):
        """DoubleFloatEvaluator2D(grade="f48") serves the tier; the
        packed table is 75% of the DF table's channels; the bicubic
        NODE layout rejects the tier with a clear error."""
        from ndarray_interp_tpu import config
        from ndarray_interp_tpu.interp2d import Bicubic, Interp2D
        from ndarray_interp_tpu.serving import DoubleFloatEvaluator2D

        itp, rng = self._grid(trailing=(2,))
        ev48 = DoubleFloatEvaluator2D(itp, max_batch=512, grade="f48")
        evdf = DoubleFloatEvaluator2D(itp, max_batch=512)
        assert ev48._packed.shape[1] * 4 == evdf._packed.shape[1] * 3
        x64 = np.asarray(itp.x, np.float64)
        y64 = np.asarray(itp.y, np.float64)
        qx = rng.uniform(x64[0], x64[-1], 300)
        qy = rng.uniform(y64[0], y64[-1], 300)
        got = ev48(qx, qy)
        want = np.asarray(itp.interp_array(qx, qy))
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        assert (np.abs(got - want) / scale).max() < 1e-8
        # node layout (forced by a tiny pack cap) has no f48 table
        monkeypatch.setattr(config, "bicubic_pack_max_elems", 1)
        node_itp = (
            Interp2D.builder(jnp.asarray(np.ones((8, 8))))
            .strategy(Bicubic())
            .build()
        )
        assert node_itp.strategy.layout == "node"
        with pytest.raises(ValueError, match="cell layout and bilinear"):
            DoubleFloatEvaluator2D(node_itp, grade="f48")
        with pytest.raises(ValueError, match="grade must be"):
            DoubleFloatEvaluator2D(itp, grade="f24")

    def test_bilinear_f48_route_and_serving(self):
        """The bilinear f48 tier (round 4 completion: every packed DF
        gather surface carries the tier): route grade vs the f64
        bilinear oracle, serving kwarg, and the 6/8-channel table."""
        from ndarray_interp_tpu.interp2d import Interp2D
        from ndarray_interp_tpu.serving import DoubleFloatEvaluator2D

        rng = np.random.default_rng(41)
        nx, ny, tr = 24, 18, 2
        x = jnp.asarray(np.cumsum(rng.uniform(0.2, 1.0, nx)))
        y = jnp.asarray(np.cumsum(rng.uniform(0.2, 1.0, ny)))
        z = jnp.asarray(rng.normal(size=(nx, ny, tr)))
        itp = Interp2D.builder(z).x(x).y(y).build()
        ev48 = DoubleFloatEvaluator2D(itp, max_batch=512, grade="f48")
        evdf = DoubleFloatEvaluator2D(itp, max_batch=512)
        assert ev48._packed.shape[1] * 4 == evdf._packed.shape[1] * 3
        qx = rng.uniform(float(x[0]), float(x[-1]), 300)
        qy = rng.uniform(float(y[0]), float(y[-1]), 300)
        got = ev48(qx, qy)
        want = np.asarray(itp.interp_array(qx, qy))
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        assert (np.abs(got - want) / scale).max() < 1e-8

class TestF48BankTier:
    """Round 4: the bf16-lo "f48" tier extended to the banked 1-D
    route (NS2-series) — the last DF eval surface without it.  Same
    bit layout as the bicubic tier: lo blocks bf16-rounded and packed
    two-per-f32-lane, 6bp-channel rows = 75% of the DF table."""

    def _fixture(self, n=512, bank=16, nq=2048, seed=12):
        rng = np.random.default_rng(seed)
        x64 = np.cumsum(rng.uniform(0.05, 1.0, n))
        d64 = rng.normal(size=(n, bank))
        a64 = rng.normal(size=(n - 1, bank))
        b64 = rng.normal(size=(n - 1, bank))
        q64 = np.r_[
            rng.uniform(x64[0] - 1, x64[-1] + 1, nq - 4),
            [x64[0], x64[-1], x64[7], x64[n // 2]],
        ]
        return x64, d64, a64, b64, q64

    def test_pack_unpack_roundtrip_exact(self):
        """Unpacking returns EXACTLY bf16(lo) widened to f32, the hi
        half matches the DF pack, and channels are 6/8 of DF's."""
        from ndarray_interp_tpu.ops.df_eval import (
            _unpack_f48_lo,
            pack_bank_rows_df,
            pack_bank_rows_f48,
        )

        rng = np.random.default_rng(5)
        n, bank = 41, 13  # bank < bp: exercises the pad path
        bp = 16
        pairs = []
        for shape in [(n, bank), (n - 1, bank), (n - 1, bank)]:
            v64 = rng.normal(size=shape)
            pairs.extend(jnp.asarray(w) for w in df_from_f64(v64))
        pk = pack_bank_rows_f48(*pairs)
        dfpk = pack_bank_rows_df(*pairs)
        assert pk.shape == (n - 1, 6 * bp)
        assert dfpk.shape == (n - 1, 8 * bp)
        np.testing.assert_array_equal(
            np.asarray(pk[:, : 4 * bp]), np.asarray(dfpk[:, : 4 * bp])
        )
        got_lo = np.asarray(_unpack_f48_lo(pk[:, 4 * bp :]))
        want_lo = np.asarray(
            dfpk[:, 4 * bp :].astype(jnp.bfloat16).astype(jnp.float32)
        )
        np.testing.assert_array_equal(got_lo, want_lo)

    def test_route_grade_on_cpu(self):
        """Full f48 route (guarded-XLA branch) vs the exact DF banked
        form: bf16-rounding the lo half costs ~2^-33 scale-relative
        (measured ~1e-10); gate with headroom at 1e-8."""
        import jax

        from ndarray_interp_tpu.ops.df_eval import (
            eval_xla_df_banked,
            gathered_bank_eval_f48_packed,
            pack_bank_rows_f48,
        )

        x64, d64, a64, b64, q64 = self._fixture()
        bank = d64.shape[1]
        dfd, dfa, dfb = (
            df_from_f64(d64), df_from_f64(a64), df_from_f64(b64)
        )
        packed = pack_bank_rows_f48(
            *(jnp.asarray(v) for v in (*dfd, *dfa, *dfb))
        )
        xp = [jnp.asarray(v) for v in df_from_f64(x64)]
        qp = [jnp.asarray(v) for v in df_from_f64(q64)]
        hi, lo = jax.jit(
            lambda xh, xl, pk, qh, ql: gathered_bank_eval_f48_packed(
                xh, xl, pk, bank, qh, ql
            )
        )(*xp, packed, *qp)
        got = df_to_f64(hi, lo)
        whi, wlo = eval_xla_df_banked(
            *xp,
            *(jnp.asarray(v) for v in dfd),
            *(jnp.asarray(v) for v in dfa),
            *(jnp.asarray(v) for v in dfb),
            *qp,
        )
        want = df_to_f64(whi, wlo)
        scale = np.maximum(np.abs(want), 0.01 * np.abs(d64).max())
        assert (np.abs(got - want) / scale).max() < 1e-8

    def test_tail_interpret_plumbing(self):
        """The f48 route's bf16 unpack indexes the right blocks: on the
        same gathered rows it agrees with the DF tail to the bf16-lo
        grade (~2^-33), which any block or bit-shift mix-up would
        miss by O(1)."""
        from ndarray_interp_tpu.ops.df_eval import (
            _df_xla_tail,
            _unpack_f48_lo,
            pack_bank_rows_df,
            pack_bank_rows_f48,
        )

        x64, d64, a64, b64, _ = self._fixture(nq=1024)
        pairs = [
            jnp.asarray(v)
            for v in (*df_from_f64(d64), *df_from_f64(a64), *df_from_f64(b64))
        ]
        packed = pack_bank_rows_f48(*pairs)
        packed_df = pack_bank_rows_df(*pairs)
        rng = np.random.default_rng(3)
        idx = jnp.asarray(rng.integers(0, len(x64) - 1, 1024), jnp.int32)
        th, tl = (
            jnp.asarray(v)
            for v in df_from_f64(rng.uniform(-0.5, 1.5, 1024))
        )
        rows = jnp.take(packed, idx, axis=0)
        bank = d64.shape[1]
        bp = packed.shape[1] // 6
        full = jnp.concatenate(
            [rows[:, : 4 * bp], _unpack_f48_lo(rows[:, 4 * bp :])], axis=1
        )
        hi, lo = _df_xla_tail(full, th, tl, bank)
        whi, wlo = _df_xla_tail(jnp.take(packed_df, idx, axis=0), th, tl, bank)
        got = df_to_f64(hi, lo)
        want = df_to_f64(whi, wlo)
        scale = np.maximum(np.abs(want), 0.01 * np.abs(d64).max())
        assert (np.abs(got - want) / scale).max() < 1e-8

    def test_serving_grade_kwarg(self):
        """DoubleFloatEvaluator(grade="f48") serves the tier on banked
        interpolators; the packed table is 75% of the DF table's
        channels; the scalar route and bad grades reject clearly."""
        from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D
        from ndarray_interp_tpu.serving import DoubleFloatEvaluator

        rng = np.random.default_rng(23)
        n, bank = 96, 5
        x = jnp.asarray(np.cumsum(rng.uniform(0.1, 1.0, n)))
        data = jnp.asarray(rng.normal(size=(n, bank)))
        itp = (
            Interp1D.builder(data)
            .x(x)
            .strategy(CubicSpline().extrapolate(True))
            .build()
        )
        ev48 = DoubleFloatEvaluator(itp, max_batch=512, grade="f48")
        evdf = DoubleFloatEvaluator(itp, max_batch=512)
        assert ev48._packed.shape[1] * 4 == evdf._packed.shape[1] * 3
        q = rng.uniform(float(x[0]) - 1, float(x[-1]) + 1, 300)
        got = ev48(q)
        want = np.asarray(itp.interp_array(q))
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        assert (np.abs(got - want) / scale).max() < 1e-8
        with pytest.raises(ValueError, match="banked"):
            DoubleFloatEvaluator(
                Interp1D.builder(jnp.asarray(np.ones(8))).build(),
                grade="f48",
            )
        with pytest.raises(ValueError, match="grade must be"):
            DoubleFloatEvaluator(itp, grade="f24")


def test_df_lower_index_blocked_matches_direct():
    """The query-blocked (Q, n) mask (memory cap) is identical to the
    direct compare-all form, including on hi-collision knots."""
    import jax

    from ndarray_interp_tpu.ops.df_eval import _df_lower_index

    rng = np.random.default_rng(67)
    n = 300
    x64 = np.cumsum(rng.uniform(1e-9, 1e-7, n)) + 1.0  # f32-colliding knots
    xh, xl = (np.asarray(v) for v in df_from_f64(x64))
    # perturbation floor >> the ~7e-15 DF resolution at |x|~1: below it
    # the exact DF-lexicographic compare may legitimately disagree with
    # the unrounded-f64 oracle (seed-fragile otherwise)
    delta = rng.uniform(1e-13, 1e-10, 5000) * rng.choice([-1.0, 1.0], 5000)
    q64 = np.sort(rng.choice(x64, 5000)) + delta
    qh, ql = (np.asarray(v) for v in df_from_f64(q64))
    args = tuple(jnp.asarray(v) for v in (xh, xl, qh, ql))
    direct = _df_lower_index(*args, n)
    blocked = _df_lower_index(*args, n, block=700)  # forces 8 blocks + pad
    np.testing.assert_array_equal(np.asarray(direct), np.asarray(blocked))
    # oracle: exact f64 searchsorted
    want = np.clip(np.searchsorted(x64, q64, side="right") - 1, 0, n - 2)
    np.testing.assert_array_equal(np.asarray(direct), want)


# ---------------------------------------------------------------------------
# Double-float InterpND (ops/df_eval.py + DoubleFloatEvaluatorND)
# ---------------------------------------------------------------------------


class TestDoubleFloatND:
    """f64-grade ND serving on f32 hardware: the k-axis analogue of the
    DF bicubic gather route.  Eval contract: the reference's per-axis
    Hermite chain (cubic_spline.rs:818-828) tensor-product per axis."""

    @staticmethod
    def _case(k, trailing=(), seed=0, sizes=None):
        rng = np.random.default_rng(seed)
        sizes = sizes or [9, 8, 7, 5][:k]
        axes = [np.sort(rng.uniform(-3.0, 3.0, n)) for n in sizes]
        data = rng.normal(size=tuple(sizes) + tuple(trailing))
        return axes, data, rng

    @pytest.mark.parametrize("k", [2, 3])
    @pytest.mark.parametrize("method", ["cubic", "linear"])
    def test_evaluator_nd_matches_f64_oracle(self, k, method):
        from ndarray_interp_tpu.interpnd import InterpND
        from ndarray_interp_tpu.serving import DoubleFloatEvaluatorND

        axes, data, rng = self._case(k, trailing=(2,), seed=11 + k)
        itp = (
            InterpND.builder(data).points(*axes).method(method).build()
        )
        ev = DoubleFloatEvaluatorND(itp, max_batch=512).warmup()
        qs = [rng.uniform(ax[0], ax[-1], 300) for ax in axes]
        got = ev(*qs)
        assert got.shape == (300, 2)
        want = np.asarray(itp.interp_array(*qs))
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        assert (np.abs(got - want) / scale).max() < 1e-9

    def test_evaluator_nd_periodic_wrap(self):
        """Periodic axes wrap OOB queries on the host
        (cubic_spline.rs:804-809 per axis)."""
        from ndarray_interp_tpu.interpnd import InterpND
        from ndarray_interp_tpu.serving import DoubleFloatEvaluatorND

        axes, data, rng = self._case(2, seed=29)
        data[-1] = data[0]  # periodic axis 0
        itp = (
            InterpND.builder(data)
            .points(*axes)
            .method("cubic")
            .boundary("periodic", "not_a_knot")
            .build()
        )
        ev = DoubleFloatEvaluatorND(itp, max_batch=512)
        span = axes[0][-1] - axes[0][0]
        q0 = rng.uniform(axes[0][0] - 2 * span, axes[0][-1] + 2 * span, 200)
        q1 = rng.uniform(axes[1][0], axes[1][-1], 200)
        got = ev(q0, q1)
        want = np.asarray(itp.interp_array(q0, q1))
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        assert (np.abs(got - want) / scale).max() < 1e-9

    def test_evaluator_nd_errors(self):
        from ndarray_interp_tpu.errors import OutOfBoundsError
        from ndarray_interp_tpu.interpnd import InterpND
        from ndarray_interp_tpu.serving import DoubleFloatEvaluatorND

        axes, data, rng = self._case(3, seed=31)
        itp = (
            InterpND.builder(data).points(*axes).method("cubic").build()
        )
        ev = DoubleFloatEvaluatorND(itp, max_batch=512)
        mid = [np.asarray([0.5 * (a[0] + a[-1])]) for a in axes]
        with pytest.raises(OutOfBoundsError, match="axis 0"):
            ev(np.asarray([axes[0][0] - 1.0]), mid[1], mid[2])
        with pytest.raises(ValueError, match="NaN"):
            ev(np.asarray([np.nan]), mid[1], mid[2])
        with pytest.raises(ValueError, match="do not match"):
            ev(np.zeros(3), np.zeros(4), np.zeros(3))
        with pytest.raises(ValueError, match="coordinate arrays"):
            ev(mid[0], mid[1])
        nearest = (
            InterpND.builder(data).points(*axes).method("nearest").build()
        )
        with pytest.raises(ValueError, match="nearest"):
            DoubleFloatEvaluatorND(nearest)

    @pytest.mark.parametrize("k,method", [(2, "cubic"), (2, "linear")])
    def test_evaluator_nd_f48_grade(self, k, method):
        """The ND f48 tier (bf16-pair lo half): 75% of the DF table's
        channels, ~2^-33-grade results (measured 4e-10 cubic / 2e-9
        linear on this fixture) — between f32 and DF, as in 2-D."""
        from ndarray_interp_tpu.interpnd import InterpND
        from ndarray_interp_tpu.serving import DoubleFloatEvaluatorND

        axes, data, rng = self._case(k, trailing=(2,), seed=13)
        itp = (
            InterpND.builder(data).points(*axes).method(method).build()
        )
        ev48 = DoubleFloatEvaluatorND(itp, max_batch=512, grade="f48")
        evdf = DoubleFloatEvaluatorND(itp, max_batch=512)
        assert ev48._packed.shape[1] * 4 == evdf._packed.shape[1] * 3
        qs = [rng.uniform(a[0], a[-1], 300) for a in axes]
        got = ev48(*qs)
        want = np.asarray(itp.interp_array(*qs))
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        assert (np.abs(got - want) / scale).max() < 1e-8
        with pytest.raises(ValueError, match="grade must be"):
            DoubleFloatEvaluatorND(itp, grade="f24")
