"""Compile-payload hygiene (utils/hygiene.py + serving wiring).

A table captured by closure is constant-folded into the compiled program
(a 535 MB table once produced 138 MB of program text).  The guardrail:
big tables ride as jit ARGUMENTS, and the serving evaluators assert
their programs embed no big constants.  These tests pin both directions — the detector fires
on a closure capture, and every shipping evaluator passes, including
one whose table is ≥100 MB.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ndarray_interp_tpu import config
from ndarray_interp_tpu.utils.hygiene import (
    assert_lean_program,
    lowered_text_bytes,
    program_const_bytes,
)


class TestDetector:
    def test_closure_capture_detected(self):
        big = jnp.zeros((512, 8192), jnp.float32)  # 16 MB
        fn = jax.jit(lambda q: (big[0] * q).sum())
        with pytest.raises(RuntimeError, match="jit ARGUMENTS"):
            assert_lean_program(fn, jnp.ones((8192,), jnp.float32))

    def test_argument_passes(self):
        big = jnp.zeros((512, 8192), jnp.float32)
        fn = jax.jit(lambda t, q: (t[0] * q).sum())
        total = assert_lean_program(
            fn, big, jnp.ones((8192,), jnp.float32)
        )
        assert total <= 1024  # scalar/iota constants only

    def test_nested_jaxpr_consts_found(self):
        # the capture hides inside lax.cond branches
        big = jnp.zeros((1024, 4096), jnp.float32)  # 16 MB

        def fn(q, flag):
            return jax.lax.cond(
                flag, lambda: (big[0] * q).sum(), lambda: q.sum()
            )

        total, consts = program_const_bytes(
            jax.jit(fn), jnp.ones((4096,), jnp.float32), True
        )
        assert total >= big.nbytes

    def test_cap_configurable(self):
        arr = jnp.zeros((1024,), jnp.float32)  # 4 KB
        fn = jax.jit(lambda q: (arr * q).sum())
        q = jnp.ones((1024,), jnp.float32)
        with pytest.raises(RuntimeError):
            assert_lean_program(fn, q, cap_bytes=1024)
        assert_lean_program(fn, q, cap_bytes=1 << 20)


def _spline_bank(n, bank, seed=0):
    from ndarray_interp_tpu.interp1d import Interp1D
    from ndarray_interp_tpu.interp1d.cubic_spline import CubicSpline

    rng = np.random.default_rng(seed)
    x = jnp.asarray(np.sort(rng.uniform(0, 10, n)))
    shape = (n,) if bank is None else (n, bank)
    d = jnp.asarray(rng.normal(size=shape))
    return (
        Interp1D.builder(d)
        .x(x)
        .strategy(CubicSpline().extrapolate(True))
        .build()
    )


class TestServingHygiene:
    def test_evaluator_1d(self):
        from ndarray_interp_tpu.serving import Evaluator

        Evaluator(_spline_bank(64, 4), buckets=[64]).verify_hygiene()

    def test_evaluator_2d_and_nd(self):
        from ndarray_interp_tpu.interp2d import Bicubic, Interp2D
        from ndarray_interp_tpu.interpnd import InterpND
        from ndarray_interp_tpu.serving import Evaluator2D, EvaluatorND

        rng = np.random.default_rng(1)
        z = jnp.asarray(rng.normal(size=(12, 10)))
        itp2 = Interp2D.builder(z).strategy(Bicubic()).build()
        Evaluator2D(itp2, buckets=[64]).verify_hygiene()
        g = jnp.asarray(rng.normal(size=(6, 7, 8)))
        nd = InterpND.builder(g).build()
        EvaluatorND(nd, buckets=[64]).verify_hygiene()

    def test_df_evaluators(self):
        from ndarray_interp_tpu.serving import DoubleFloatEvaluator

        # scalar-axis route (windowed plan) + banked gather route
        DoubleFloatEvaluator(
            _spline_bank(256, None), buckets=[256]
        ).verify_hygiene()
        DoubleFloatEvaluator(
            _spline_bank(128, 8), buckets=[256]
        ).verify_hygiene()

    def test_df_evaluator_2d(self):
        from ndarray_interp_tpu.interp2d import Bicubic, Bilinear, Interp2D
        from ndarray_interp_tpu.serving import DoubleFloatEvaluator2D

        rng = np.random.default_rng(2)
        z = jnp.asarray(rng.normal(size=(16, 12)))
        for strat in (Bilinear(), Bicubic()):
            itp = Interp2D.builder(z).strategy(strat).build()
            DoubleFloatEvaluator2D(itp, buckets=[256]).verify_hygiene()

    @pytest.mark.slow
    def test_big_table_program_is_small(self):
        """The round-3 failure shape: a table past 100 MB must NOT grow
        the program.  Builds a banked DF evaluator whose packed (hi, lo)
        table alone exceeds 100 MB and checks (a) the hygiene assert
        passes, (b) the lowered StableHLO text — the payload a
        compiler receives — stays small."""
        from ndarray_interp_tpu.serving import DoubleFloatEvaluator

        ev = DoubleFloatEvaluator(
            _spline_bank(1024, 6144), buckets=[4096]
        )
        table_bytes = sum(
            int(np.prod(p.shape)) * p.dtype.itemsize
            for p in ev._run_extra
        )
        assert table_bytes >= 100 * 2**20, table_bytes
        ev.verify_hygiene()
        fn, args = ev._hygiene_args()
        text = lowered_text_bytes(fn, *args)
        assert text < 5 * 2**20, f"lowered text is {text/2**20:.1f} MB"
        # and the program still computes: drive one batch
        q = np.linspace(ev._x0 + 0.1, ev._xn - 0.1, 100)
        out = ev(q)
        assert out.shape == (100, 6144)
        assert np.isfinite(out).all()

    def test_config_cap_respected(self, monkeypatch):
        from ndarray_interp_tpu.serving import Evaluator

        ev = Evaluator(_spline_bank(64, 4), buckets=[64])
        monkeypatch.setattr(config, "jit_const_cap_bytes", -1)
        with pytest.raises(RuntimeError, match="embeds"):
            ev.verify_hygiene()


class TestRouteGuard:
    """Trace-time closure-capture guard at the raw route entry points: a
    ``gathered_*_packed`` route traced with a concrete table is caught
    where it happens, not only inside the serving evaluators."""

    def _df_bank_args(self, n=16, bank=4, nq=8):
        rng = np.random.default_rng(0)
        x = np.linspace(0.0, 1.0, n).astype(np.float32)
        from ndarray_interp_tpu.ops.df_eval import pack_bank_rows_df

        def z(shape):
            return jnp.asarray(rng.normal(size=shape).astype(np.float32))

        packed = pack_bank_rows_df(
            z((n, bank)), z((n, bank)) * 1e-8,
            z((n - 1, bank)), z((n - 1, bank)) * 1e-8,
            z((n - 1, bank)), z((n - 1, bank)) * 1e-8,
        )
        q = jnp.asarray(
            rng.uniform(0.05, 0.95, nq).astype(np.float32)
        )
        return jnp.asarray(x), packed, bank, q

    def test_closure_captured_table_trips(self, monkeypatch):
        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bank_eval_df_packed,
        )

        x, packed, bank, q = self._df_bank_args()
        monkeypatch.setattr(config, "jit_const_cap_bytes", 64)

        fn = jax.jit(
            lambda qh: gathered_bank_eval_df_packed(
                x, jnp.zeros_like(x), packed, bank, qh, jnp.zeros_like(qh)
            )[0]
        )
        with pytest.raises(RuntimeError, match="closure-captured"):
            fn(q)

    def test_argument_table_passes(self, monkeypatch):
        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bank_eval_df_packed,
        )

        x, packed, bank, q = self._df_bank_args()
        monkeypatch.setattr(config, "jit_const_cap_bytes", 64)

        fn = jax.jit(
            lambda tbl, qh: gathered_bank_eval_df_packed(
                x, jnp.zeros_like(x), tbl, bank, qh, jnp.zeros_like(qh)
            )[0]
        )
        out = fn(packed, q)
        assert np.isfinite(np.asarray(out)).all()

    def test_eager_call_exempt(self, monkeypatch):
        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bank_eval_df_packed,
        )

        x, packed, bank, q = self._df_bank_args()
        monkeypatch.setattr(config, "jit_const_cap_bytes", 64)
        hi, lo = gathered_bank_eval_df_packed(
            x, jnp.zeros_like(x), packed, bank, q, jnp.zeros_like(q)
        )
        assert np.isfinite(np.asarray(hi)).all()

    def test_disable_flag(self, monkeypatch):
        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bank_eval_df_packed,
        )

        x, packed, bank, q = self._df_bank_args()
        monkeypatch.setattr(config, "jit_const_cap_bytes", 64)
        monkeypatch.setattr(config, "route_hygiene", False)
        fn = jax.jit(
            lambda qh: gathered_bank_eval_df_packed(
                x, jnp.zeros_like(x), packed, bank, qh, jnp.zeros_like(qh)
            )[0]
        )
        out = fn(q)
        assert np.isfinite(np.asarray(out)).all()

    def test_f48_bank_route_guarded(self, monkeypatch):
        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bank_eval_f48_packed,
            pack_bank_rows_f48,
        )

        rng = np.random.default_rng(1)
        n, bank = 16, 4

        def z(shape):
            return jnp.asarray(rng.normal(size=shape).astype(np.float32))

        x = jnp.asarray(np.linspace(0.0, 1.0, n).astype(np.float32))
        packed = pack_bank_rows_f48(
            z((n, bank)), z((n, bank)) * 1e-8,
            z((n - 1, bank)), z((n - 1, bank)) * 1e-8,
            z((n - 1, bank)), z((n - 1, bank)) * 1e-8,
        )
        q = jnp.full((8,), 0.5, jnp.float32)
        monkeypatch.setattr(config, "jit_const_cap_bytes", 16)
        with pytest.raises(RuntimeError, match="closure-captured"):
            jax.jit(
                lambda qh: gathered_bank_eval_f48_packed(
                    x, jnp.zeros_like(x), packed, bank, qh,
                    jnp.zeros_like(qh),
                )[0]
            )(q)

    def test_unpacked_wrapper_guarded(self, monkeypatch):
        # the pack-inside wrappers check their RAW tables: packing under
        # the ambient jit turns the concrete tables into tracers before
        # the packed route's check runs, so a closure-captured raw bank
        # would otherwise slip through
        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bank_eval_df,
        )

        rng = np.random.default_rng(2)
        n, bank = 16, 4

        def z(shape):
            return jnp.asarray(rng.normal(size=shape).astype(np.float32))

        x = jnp.asarray(np.linspace(0.0, 1.0, n).astype(np.float32))
        raw = (
            z((n, bank)), z((n, bank)) * 1e-8,
            z((n - 1, bank)), z((n - 1, bank)) * 1e-8,
            z((n - 1, bank)), z((n - 1, bank)) * 1e-8,
        )
        q = jnp.asarray(rng.uniform(0.05, 0.95, 8).astype(np.float32))
        monkeypatch.setattr(config, "jit_const_cap_bytes", 64)
        with pytest.raises(RuntimeError, match="closure-captured"):
            jax.jit(
                lambda qh: gathered_bank_eval_df(
                    x, jnp.zeros_like(x), *raw, qh, jnp.zeros_like(qh)
                )[0]
            )(q)
        # tables as ARGUMENTS still pass
        out = jax.jit(
            lambda *a: gathered_bank_eval_df(
                x, jnp.zeros_like(x), *a[:-1], a[-1], jnp.zeros_like(a[-1])
            )[0]
        )(*raw, q)
        assert np.isfinite(np.asarray(out)).all()
