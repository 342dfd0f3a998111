"""Auxiliary subsystems: checkpoint/restore, aliases, profiling, config."""

import numpy as np
import pytest

import jax.numpy as jnp

from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D, Linear
from ndarray_interp_tpu.interp2d import Interp2D
from ndarray_interp_tpu.utils import checkpoint


class TestCheckpoint:
    def test_roundtrip_linear(self, tmp_path):
        itp = (
            Interp1D.builder(jnp.array([[1.0, 2.0], [3.0, 4.0], [5.0, 9.0]]))
            .strategy(Linear().extrapolate(True))
            .build()
        )
        p = tmp_path / "lin.npz"
        checkpoint.save(p, itp)
        back = checkpoint.load(p)
        q = jnp.array([-0.5, 0.7, 2.0])
        np.testing.assert_array_equal(
            np.asarray(back.interp_array(q)), np.asarray(itp.interp_array(q))
        )
        assert back.strategy.extrapolates

    def test_roundtrip_cubic(self, tmp_path):
        itp = (
            Interp1D.builder(
                jnp.asarray(np.random.default_rng(0).normal(size=(12, 3)))
            )
            .strategy(CubicSpline().extrapolate(True))
            .build()
        )
        p = tmp_path / "cub"
        checkpoint.save(p, itp)
        back = checkpoint.load(p)
        q = jnp.linspace(-1.0, 12.0, 40)
        np.testing.assert_array_equal(
            np.asarray(back.interp_array(q)), np.asarray(itp.interp_array(q))
        )
        # coefficients restored verbatim — no rebuild
        np.testing.assert_array_equal(
            np.asarray(back.strategy.a), np.asarray(itp.strategy.a)
        )

    def test_legacy_bilinear_packed_checkpoint_loads(self, tmp_path):
        """Files written while Bilinear built a packed corner-row table
        name the ``bilinear_packed`` codec; they load as plain Bilinear
        and evaluate like a fresh build."""
        import json

        from ndarray_interp_tpu.interp2d import Bilinear

        rng = np.random.default_rng(7)
        x, y = np.arange(5.0), np.linspace(0.0, 2.0, 4)
        z = rng.normal(size=(5, 4, 3))
        header = {"kind": "interp2d", "strategy": "bilinear_packed",
                  "strategy_meta": {"extrapolate": True}}
        p = tmp_path / "old.npz"
        np.savez(p, x=x, y=y, data=z, __header__=np.frombuffer(
            json.dumps(header).encode(), dtype=np.uint8))
        back = checkpoint.load(p)
        assert type(back.strategy) is Bilinear
        assert back.strategy.extrapolates
        fresh = (
            Interp2D.builder(jnp.asarray(z)).x(jnp.asarray(x))
            .y(jnp.asarray(y)).strategy(Bilinear().extrapolate(True)).build()
        )
        qx = jnp.asarray(rng.uniform(-1, 5, 30))
        qy = jnp.asarray(rng.uniform(-0.5, 2.5, 30))
        np.testing.assert_array_equal(
            np.asarray(back.interp_array(qx, qy)),
            np.asarray(fresh.interp_array(qx, qy)),
        )
        # a saved Bilinear now writes the plain codec name
        checkpoint.save(tmp_path / "new.npz", back)
        with np.load(tmp_path / "new.npz") as f:
            assert json.loads(bytes(f["__header__"]))["strategy"] == "bilinear"

    def test_roundtrip_2d(self, tmp_path):
        itp = Interp2D.builder(
            jnp.asarray(np.random.default_rng(1).normal(size=(5, 6, 2)))
        ).build()
        p = tmp_path / "bi.npz"
        checkpoint.save(p, itp)
        back = checkpoint.load(p)
        qx = jnp.array([0.5, 3.3])
        qy = jnp.array([1.5, 4.4])
        np.testing.assert_array_equal(
            np.asarray(back.interp_array(qx, qy)),
            np.asarray(itp.interp_array(qx, qy)),
        )

    def test_unknown_strategy_rejected(self, tmp_path):
        from ndarray_interp_tpu.models.strategies.base import (
            PointwiseStrategy,
        )

        class Weird(PointwiseStrategy):
            def eval_point(self, interp, x):  # pragma: no cover
                return interp.data[0]

        itp = Interp1D.new_unchecked(
            jnp.arange(3.0), jnp.arange(3.0), Weird()
        )
        with pytest.raises(TypeError, match="cannot serialize strategy"):
            checkpoint.save(tmp_path / "w.npz", itp)


def test_aliases_importable():
    from ndarray_interp_tpu.interp1d.aliases import (
        Interp1DOwned,
        Interp1DScalar,
        Interp1DVec,
    )
    from ndarray_interp_tpu.interp2d.aliases import (
        Interp2DOwned,
        Interp2DScalar,
        Interp2DVec,
    )

    assert Interp1DOwned is Interp1DScalar is Interp1DVec is Interp1D
    assert Interp2DOwned is Interp2DScalar is Interp2DVec is Interp2D


def test_config_flags_exist():
    from ndarray_interp_tpu import config

    assert isinstance(config.route_hygiene, bool)
    assert isinstance(config.use_native_host, bool)


def test_profiling_helpers(tmp_path):
    from ndarray_interp_tpu.utils import profiling

    itp = Interp1D.builder(jnp.arange(8.0)).build()
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("eval"):
            itp.interp_array(jnp.linspace(0.0, 7.0, 16)).block_until_ready()
    assert any((tmp_path / "trace").rglob("*"))


class TestServing:
    def test_bucketed_eval_matches_direct(self):
        import jax

        from ndarray_interp_tpu.serving import Evaluator

        rng = np.random.default_rng(0)
        itp = (
            Interp1D.builder(jnp.asarray(rng.normal(size=(32, 3))))
            .strategy(CubicSpline().extrapolate(True))
            .build()
        )
        ev = Evaluator(itp, max_batch=4096).warmup()
        traces_before = ev._fn._cache_size()
        for n in (1, 5, 300, 257, 1000, 4096, 9000):
            q = jnp.asarray(rng.uniform(0, 31, n))
            np.testing.assert_allclose(
                np.asarray(ev(q)),
                np.asarray(itp.interp_array(q)),
                atol=1e-12,
            )
        # no new compilations after warmup
        assert ev._fn._cache_size() == traces_before

    def test_multidim_queries(self):
        from ndarray_interp_tpu.serving import Evaluator

        itp = Interp1D.builder(jnp.arange(16.0)).build()
        ev = Evaluator(itp, max_batch=1024)
        q = jnp.linspace(0.0, 15.0, 24).reshape(4, 6)
        np.testing.assert_allclose(
            np.asarray(ev(q)), np.asarray(itp.interp_array(q)), atol=1e-12
        )

    def test_empty_batch(self):
        from ndarray_interp_tpu.serving import Evaluator

        itp = Interp1D.builder(jnp.asarray(np.ones((8, 3)))).build()
        out = Evaluator(itp, max_batch=1024)(jnp.zeros((0,)))
        assert out.shape == (0, 3)
        assert out.dtype == itp.data.dtype

    def test_donate_smoke(self):
        from ndarray_interp_tpu.serving import Evaluator

        itp = Interp1D.builder(jnp.arange(16.0)).build()
        ev = Evaluator(itp, max_batch=512, donate=True)
        q = jnp.linspace(0.0, 15.0, 100)
        np.testing.assert_allclose(
            np.asarray(ev(q)), np.asarray(itp.interp_array(q)), atol=1e-12
        )

    def test_2d_bucketed_eval_matches_direct(self):
        from ndarray_interp_tpu.serving import Evaluator2D

        rng = np.random.default_rng(3)
        itp = Interp2D.builder(
            jnp.asarray(rng.normal(size=(12, 9, 2)))
        ).build()
        ev = Evaluator2D(itp, max_batch=2048).warmup()
        traces_before = ev._fn._cache_size()
        for n in rng.integers(1, 5000, size=50):
            qx = jnp.asarray(rng.uniform(0, 11, int(n)))
            qy = jnp.asarray(rng.uniform(0, 8, int(n)))
            np.testing.assert_allclose(
                np.asarray(ev(qx, qy)),
                np.asarray(itp.interp_array(qx, qy)),
                atol=1e-12,
            )
        # no new compilations across 50 random batch sizes
        assert ev._fn._cache_size() == traces_before

    def test_nd_bucketed_eval_matches_direct(self):
        from ndarray_interp_tpu.interpnd import InterpND
        from ndarray_interp_tpu.serving import EvaluatorND

        rng = np.random.default_rng(7)
        itp = (
            InterpND.builder(jnp.asarray(rng.normal(size=(8, 7, 6))))
            .method("cubic")
            .build()
        )
        ev = EvaluatorND(itp, max_batch=2048).warmup()
        traces_before = ev._fn._cache_size()
        for n in rng.integers(1, 5000, size=20):
            qs = [
                jnp.asarray(rng.uniform(0, hi - 1, int(n)))
                for hi in (8, 7, 6)
            ]
            np.testing.assert_allclose(
                np.asarray(ev(*qs)),
                np.asarray(itp.interp_array(*qs)),
                atol=1e-12,
            )
        assert ev._fn._cache_size() == traces_before
        # arity / shape / empty contracts
        out = ev(jnp.zeros((0,)), jnp.zeros((0,)), jnp.zeros((0,)))
        assert out.shape == (0,)
        with pytest.raises(ValueError, match="expected 3 coordinate"):
            ev(jnp.zeros((2,)), jnp.zeros((2,)))
        with pytest.raises(ValueError, match="do not match"):
            ev(jnp.zeros((2,)), jnp.zeros((2,)), jnp.zeros((3,)))

    def test_2d_empty_and_shape_mismatch(self):
        from ndarray_interp_tpu.serving import Evaluator2D

        itp = Interp2D.builder(jnp.asarray(np.ones((4, 4)))).build()
        ev = Evaluator2D(itp, max_batch=256)
        out = ev(jnp.zeros((0,)), jnp.zeros((0,)))
        assert out.shape == (0,)
        with pytest.raises(ValueError, match="same shape"):
            ev(jnp.zeros((3,)), jnp.zeros((4,)))


class TestDoubleFloatEvaluator:
    def _build(self, n=256, extrapolate=True, seed=11):
        rng = np.random.default_rng(seed)
        x = jnp.asarray(np.cumsum(rng.uniform(0.05, 1.0, n)))
        data = jnp.asarray(rng.normal(size=n))
        return (
            Interp1D.builder(data)
            .x(x)
            .strategy(CubicSpline().extrapolate(extrapolate))
            .build()
        )

    def test_f64_grade_accuracy(self):
        from ndarray_interp_tpu.serving import DoubleFloatEvaluator

        itp = self._build()
        ev = DoubleFloatEvaluator(itp, max_batch=4096)
        rng = np.random.default_rng(12)
        q = rng.uniform(float(itp.x[0]) - 1, float(itp.x[-1]) + 1, 2000)
        got = ev(q)
        want = np.asarray(itp.interp_array(q))  # f64 CPU oracle
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        # the GPU runs the same XLA DF formulation, gated at 1e-12 by
        # chip_smoke.py phase P5.  Includes the 49-bit input
        # representation error (slope-amplified) — still f64-grade.
        assert (np.abs(got - want) / scale).max() < 1e-9

    def test_oob_raises_without_extrapolate(self):
        from ndarray_interp_tpu.errors import OutOfBoundsError
        from ndarray_interp_tpu.serving import DoubleFloatEvaluator

        itp = self._build(extrapolate=False)
        ev = DoubleFloatEvaluator(itp)
        with pytest.raises(OutOfBoundsError):
            ev(np.asarray([float(itp.x[0]) - 5.0]))

    def test_shape_and_empty(self):
        from ndarray_interp_tpu.serving import DoubleFloatEvaluator

        itp = self._build()
        ev = DoubleFloatEvaluator(itp, max_batch=512)
        out = ev(np.zeros((3, 5)) + float(itp.x[2]))
        assert out.shape == (3, 5)
        assert ev(np.zeros((0,))).shape == (0,)

    def test_bank_data_supported(self):
        from ndarray_interp_tpu.serving import DoubleFloatEvaluator

        rng = np.random.default_rng(1)
        itp = (
            Interp1D.builder(jnp.asarray(rng.normal(size=(16, 3))))
            .strategy(CubicSpline().extrapolate(True))
            .build()
        )
        ev = DoubleFloatEvaluator(itp, max_batch=256)
        q = rng.uniform(0, 15, 20)
        got = ev(q)
        assert got.shape == (20, 3)
        want = np.asarray(itp.interp_array(q))
        scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
        assert (np.abs(got - want) / scale).max() < 1e-9


class TestCustomStrategyCodec:
    def test_class_hook_roundtrip(self, tmp_path):
        from examples.custom_strategy import StepInterpolator as Step
        from ndarray_interp_tpu.utils import checkpoint

        # attach the class-level hook (would normally live on the class)
        def enc(self):
            return {}, {}

        @classmethod
        def dec(cls, meta, arrays):
            return cls()

        Step.checkpoint_encode = enc
        Step.checkpoint_decode = dec
        try:
            rng = np.random.default_rng(3)
            data = jnp.asarray(rng.normal(size=12))
            itp = Interp1D.builder(data).strategy(Step()).build()
            p = tmp_path / "step.npz"
            checkpoint.save(p, itp)
            back = checkpoint.load(p)
            q = jnp.asarray(np.linspace(0.0, 11.0, 40))
            np.testing.assert_allclose(
                np.asarray(back.interp_array(q)),
                np.asarray(itp.interp_array(q)),
            )
        finally:
            del Step.checkpoint_encode, Step.checkpoint_decode
            checkpoint._STRATEGY_CODECS = {
                k: v
                for k, v in checkpoint._STRATEGY_CODECS.items()
                if not k.startswith("custom:")
            }

    def test_register_codec_roundtrip(self, tmp_path):
        from examples.custom_strategy import StepInterpolator as Step
        from ndarray_interp_tpu.utils import checkpoint

        checkpoint.register_strategy_codec(
            "step", Step, lambda s: ({}, {}), lambda meta, arrs: Step()
        )
        try:
            data = jnp.asarray(np.arange(8.0) ** 2)
            itp = Interp1D.builder(data).strategy(Step()).build()
            p = tmp_path / "step2.npz"
            checkpoint.save(p, itp)
            back = checkpoint.load(p)
            q = jnp.asarray([0.2, 3.7, 6.9])
            np.testing.assert_allclose(
                np.asarray(back.interp_array(q)),
                np.asarray(itp.interp_array(q)),
            )
        finally:
            checkpoint._STRATEGY_CODECS.pop("step", None)


def test_eval_into_donated_matches_interp_array():
    import warnings

    from ndarray_interp_tpu.serving import eval_into_donated

    rng = np.random.default_rng(21)
    data = jnp.asarray(rng.normal(size=(32, 4)))
    itp = (
        Interp1D.builder(data)
        .strategy(CubicSpline().extrapolate(True))
        .build()
    )
    q = jnp.asarray(rng.uniform(0, 31, 100))
    out = jnp.zeros((100, 4), data.dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # CPU backends warn on donation
        got = eval_into_donated(itp, q, out)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(itp.interp_array(q)), atol=1e-14
    )
    with pytest.raises(ValueError):
        eval_into_donated(itp, q, jnp.zeros((5, 4), data.dtype))
    # N-D query arrays: output = queries.shape + trailing (mod.rs:219-226)
    q2 = q.reshape(25, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got2 = eval_into_donated(itp, q2, jnp.zeros((25, 4, 4), data.dtype))
    np.testing.assert_allclose(
        np.asarray(got2), np.asarray(itp.interp_array(q2)), atol=1e-14
    )


def test_eval_into_donated_2d_matches_interp_array():
    import warnings

    from ndarray_interp_tpu.interp2d import Interp2D
    from ndarray_interp_tpu.serving import eval_into_donated_2d

    rng = np.random.default_rng(22)
    data = jnp.asarray(rng.normal(size=(20, 16, 3)))
    itp = Interp2D.builder(data).build()  # default Bilinear
    xs = jnp.asarray(rng.uniform(0, 19, 80))
    ys = jnp.asarray(rng.uniform(0, 15, 80))
    out = jnp.zeros((80, 3), data.dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # CPU backends warn on donation
        got = eval_into_donated_2d(itp, xs, ys, out)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(itp.interp_array(xs, ys)), atol=1e-14
    )
    with pytest.raises(ValueError):
        eval_into_donated_2d(itp, xs, ys, jnp.zeros((5, 3), data.dtype))
    with pytest.raises(ValueError):
        eval_into_donated_2d(itp, xs, ys[:7], out)
    # N-D query arrays flatten internally (interp2d/mod.rs:255-284)
    xs2 = xs.reshape(8, 10)
    ys2 = ys.reshape(8, 10)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got2 = eval_into_donated_2d(
            itp, xs2, ys2, jnp.zeros((8, 10, 3), data.dtype)
        )
    np.testing.assert_allclose(
        np.asarray(got2), np.asarray(itp.interp_array(xs2, ys2)), atol=1e-14
    )


def test_df_evaluator_warmup():
    from ndarray_interp_tpu.serving import DoubleFloatEvaluator

    rng = np.random.default_rng(41)
    d = jnp.asarray(rng.normal(size=24))
    itp = (
        Interp1D.builder(d).strategy(CubicSpline().extrapolate(True)).build()
    )
    ev = DoubleFloatEvaluator(itp, max_batch=512).warmup()
    out = ev(rng.uniform(0, 23, 77))
    assert out.shape == (77,) and np.isfinite(out).all()


def test_df_evaluator_2d_warmup():
    from ndarray_interp_tpu.interp2d import Interp2D
    from ndarray_interp_tpu.serving import DoubleFloatEvaluator2D

    rng = np.random.default_rng(43)
    z = jnp.asarray(rng.normal(size=(12, 10)))
    itp = Interp2D.builder(z).build()  # default Bilinear
    ev = DoubleFloatEvaluator2D(itp, max_batch=512).warmup()
    out = ev(rng.uniform(0, 11, 77), rng.uniform(0, 9, 77))
    assert out.shape == (77,) and np.isfinite(out).all()


class TestCheckpointCustomImportSafety:
    """load() must not import modules named by the checkpoint header
    unless the caller opts in (ADVICE r2, medium)."""

    def _save_with_fake_custom_name(self, tmp_path, name):
        # craft an npz whose header names a custom codec directly
        import json

        rng = np.random.default_rng(5)
        arrays = {
            "x": np.arange(8.0),
            "data": rng.normal(size=8),
            "__header__": np.frombuffer(
                json.dumps(
                    {"kind": "interp1d", "strategy": name, "strategy_meta": {}}
                ).encode(),
                dtype=np.uint8,
            ),
        }
        p = tmp_path / "crafted.npz"
        np.savez(p, **arrays)
        return p

    def test_load_refuses_unimported_module(self, tmp_path):
        from ndarray_interp_tpu.utils import checkpoint

        p = self._save_with_fake_custom_name(
            tmp_path, "custom:definitely_not_imported_xyz.Strategy"
        )
        with pytest.raises(TypeError, match="not imported"):
            checkpoint.load(p)

    def test_load_refuses_when_only_parent_package_imported(self, tmp_path):
        # parent package imported, defining SUBMODULE not: still the
        # curated "not imported" message, not a raw AttributeError
        import sys
        import types

        from ndarray_interp_tpu.utils import checkpoint

        pkg = types.ModuleType("ndi_fake_parent_pkg")
        sys.modules["ndi_fake_parent_pkg"] = pkg
        try:
            p = self._save_with_fake_custom_name(
                tmp_path, "custom:ndi_fake_parent_pkg.strategies.MyStrat"
            )
            with pytest.raises(TypeError, match="not imported"):
                checkpoint.load(p)
        finally:
            sys.modules.pop("ndi_fake_parent_pkg", None)

    def test_load_resolves_from_already_imported_module(self, tmp_path):
        # module already in sys.modules: no import is needed, loads fine
        from examples.custom_strategy import StepInterpolator as Step
        from ndarray_interp_tpu.utils import checkpoint

        def enc(self):
            return {}, {}

        @classmethod
        def dec(cls, meta, arrays):
            return cls()

        Step.checkpoint_encode = enc
        Step.checkpoint_decode = dec
        try:
            data = jnp.asarray(np.arange(6.0))
            itp = Interp1D.builder(data).strategy(Step()).build()
            p = tmp_path / "step3.npz"
            checkpoint.save(p, itp)
            # simulate a fresh process: forget the codec (module stays
            # imported, which is the supported no-import resolution path)
            checkpoint._STRATEGY_CODECS = {
                k: v
                for k, v in checkpoint._STRATEGY_CODECS.items()
                if not k.startswith("custom:")
            }
            back = checkpoint.load(p)
            assert type(back.strategy) is Step
        finally:
            del Step.checkpoint_encode, Step.checkpoint_decode
            checkpoint._STRATEGY_CODECS = {
                k: v
                for k, v in checkpoint._STRATEGY_CODECS.items()
                if not k.startswith("custom:")
            }

    def test_allow_custom_import_opt_in(self, tmp_path):
        # a module NOT yet imported loads only with allow_custom_import=True
        import sys
        import textwrap

        from ndarray_interp_tpu.utils import checkpoint

        modname = "ndi_tmp_codec_mod"
        (tmp_path / f"{modname}.py").write_text(
            textwrap.dedent(
                """
                class TmpStrategy:
                    @classmethod
                    def checkpoint_decode(cls, meta, arrays):
                        return cls()

                    def checkpoint_encode(self):
                        return {}, {}
                """
            )
        )
        p = self._save_with_fake_custom_name(
            tmp_path, f"custom:{modname}.TmpStrategy"
        )
        sys.path.insert(0, str(tmp_path))
        try:
            assert modname not in sys.modules
            with pytest.raises(TypeError, match="not imported"):
                checkpoint.load(p)
            back = checkpoint.load(p, allow_custom_import=True)
            assert type(back.strategy).__name__ == "TmpStrategy"
        finally:
            sys.path.remove(str(tmp_path))
            sys.modules.pop(modname, None)
            checkpoint._STRATEGY_CODECS = {
                k: v
                for k, v in checkpoint._STRATEGY_CODECS.items()
                if not k.startswith("custom:")
            }

    def test_save_rejects_unimportable_class(self, tmp_path):
        # function-scope classes can never be resolved later: fail at save
        from ndarray_interp_tpu.utils import checkpoint
        from examples.custom_strategy import StepInterpolator

        class LocalStrategy(StepInterpolator):
            def checkpoint_encode(self):
                return {}, {}

            @classmethod
            def checkpoint_decode(cls, meta, arrays):
                return cls()

        data = jnp.asarray(np.arange(6.0))
        itp = Interp1D.builder(data).strategy(LocalStrategy()).build()
        with pytest.raises(TypeError, match="importable module"):
            checkpoint.save(tmp_path / "bad.npz", itp)


def test_checkpoint_roundtrip_nearest_family(tmp_path):
    from ndarray_interp_tpu.interp1d import Nearest
    from ndarray_interp_tpu.interp2d import Interp2D, Nearest2D
    from ndarray_interp_tpu.utils import checkpoint

    rng = np.random.default_rng(63)
    d = jnp.asarray(rng.normal(size=12))
    itp = (
        Interp1D.builder(d)
        .strategy(Nearest("previous", extrapolate=True))
        .build()
    )
    p = tmp_path / "nearest.npz"
    checkpoint.save(p, itp)
    back = checkpoint.load(p)
    assert back.strategy.mode == "previous" and back.strategy.extrapolates
    q = np.array([0.3, 5.7, 11.9])
    np.testing.assert_array_equal(
        np.asarray(back.interp_array(q)), np.asarray(itp.interp_array(q))
    )
    z = jnp.asarray(rng.normal(size=(8, 6)))
    itp2 = Interp2D.builder(z).strategy(Nearest2D(extrapolate=True)).build()
    p2 = tmp_path / "nearest2d.npz"
    checkpoint.save(p2, itp2)
    back2 = checkpoint.load(p2)
    assert back2.strategy.extrapolates
    qx = np.array([0.4, 9.6])
    qy = np.array([0.2, 6.9])
    np.testing.assert_array_equal(
        np.asarray(back2.interp_array(qx, qy)),
        np.asarray(itp2.interp_array(qx, qy)),
    )
