"""Grid-axis capacity sharding (ops/gridshard.py; VERDICT r4 task 4).

The capacity story: a grid whose packed CELL table exceeds the
single-device cap (``config.interpnd_pack_max_elems``) — which the
unsharded builder degrades to the 2^k-gather node layout — keeps
one-gather cell-route evaluation when the table is split over the mesh,
and the sharded result matches the (forced) single-device cell-layout
oracle.  The gate is 1e-13 scale-relative: the sharded body IS the
unsharded cell blend (verified bit-identical to the eager formulation
in ``test_matches_eager_formulation_bitwise``), but the jitted
single-device program is a DIFFERENT XLA program whose fusion may
reassociate the 2^k/4^k-term weight reduce by ~1 ulp (measured 4e-16
abs on f64) — compiler noise, not algorithmic divergence.  NaN masks
must match exactly.  OOB/NaN and periodic-wrap contracts are the
unsharded pure path's, by construction (global (idx, t) from
replicated axes).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ndarray_interp_tpu import config
from ndarray_interp_tpu.models.interpnd import InterpND
from ndarray_interp_tpu.models.interp2d import Interp2D
from ndarray_interp_tpu.ops.gridshard import (
    shard_interp2d_grid,
    shard_interpnd_grid,
)


@pytest.fixture
def mesh():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.asarray(devs[:8]), ("grid",))


@pytest.fixture
def mesh2d():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.asarray(devs[:8]).reshape(4, 2), ("grid", "query"))


def _grid_interp(shape, k, method="cubic", seed=0, extrapolate=False,
                 bcs=None, layout="cell", dtype=np.float64):
    rng = np.random.default_rng(seed)
    axes = tuple(
        jnp.asarray(np.sort(rng.uniform(0.0, 10.0, n)).astype(dtype))
        for n in shape[:k]
    )
    data = jnp.asarray(rng.normal(size=shape).astype(dtype))
    if bcs and "periodic" in bcs:
        # periodic axes need first == last data slices
        for d, bc in enumerate(bcs):
            if bc == "periodic":
                sl = [slice(None)] * data.ndim
                sl[d] = -1
                src = [slice(None)] * data.ndim
                src[d] = 0
                data = data.at[tuple(sl)].set(data[tuple(src)])
    table, lay = InterpND.build_state(
        axes, data, k, method, bcs=bcs, layout=layout
    )
    return InterpND.new_unchecked(
        axes, data, method, extrapolate, table, bcs, lay
    )


def _assert_matches(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    scale = max(np.abs(want[m]).max(), 1e-30) if m.any() else 1.0
    assert np.abs(got[m] - want[m]).max() <= 1e-13 * scale


def _queries(interp, nq, seed=1, pad=0.0):
    rng = np.random.default_rng(seed)
    return tuple(
        jnp.asarray(
            rng.uniform(
                float(ax[0]) - pad, float(ax[-1]) + pad, nq
            ).astype(np.asarray(ax).dtype)
        )
        for ax in interp.axes
    )


class TestInterpNDGridShard:
    def test_cubic_exact_vs_cell_oracle(self, mesh):
        itp = _grid_interp((17, 9, 7, 3), 3, "cubic")
        ev = shard_interpnd_grid(itp, mesh)
        qs = _queries(itp, 257)
        got = ev(*qs)
        want = itp(*qs)
        assert got.shape == want.shape == (257, 3)
        _assert_matches(got, want)

    def test_capacity_case_beyond_single_device_cap(self, mesh, monkeypatch):
        # 33x17x17 tricubic, r=2: cell table = 16*16*16*64*2 = 524288
        # elements.  Cap it below that: the unsharded builder degrades
        # to the node layout; the sharded cell route must still run with
        # per-device tables UNDER the cap and match the (cap-lifted)
        # cell oracle exactly.
        shape, k = (33, 17, 17, 2), 3
        cell_elems = 32 * 16 * 16 * (4**3) * 2
        monkeypatch.setattr(
            config, "interpnd_pack_max_elems", cell_elems // 2
        )
        auto = _grid_interp(shape, k, "cubic", layout=None)
        # the cap forces the node layout
        assert auto.layout == "node", auto.layout
        ev = shard_interpnd_grid(auto, mesh)  # shards re-pack as cells
        per_dev_elems = ev.tbl_shards.shape[1] * ev.tbl_shards.shape[2]
        assert per_dev_elems <= config.interpnd_pack_max_elems, (
            "per-device shard must fit the cap the global table exceeds"
        )
        monkeypatch.setattr(
            config, "interpnd_pack_max_elems", 10 * cell_elems
        )
        oracle = _grid_interp(shape, k, "cubic", layout="cell")
        qs = _queries(oracle, 513)
        _assert_matches(ev(*qs), oracle(*qs))

    def test_linear_exact(self, mesh):
        itp = _grid_interp((13, 11, 5), 2, "linear")
        ev = shard_interpnd_grid(itp, mesh)
        qs = _queries(itp, 200)
        _assert_matches(ev(*qs), itp(*qs))

    def test_oob_nan_contract(self, mesh):
        itp = _grid_interp((9, 8, 4), 2, "cubic", extrapolate=False)
        ev = shard_interpnd_grid(itp, mesh)
        qs = _queries(itp, 300, pad=2.0)  # some queries land outside
        got = np.asarray(ev(*qs))
        want = np.asarray(itp(*qs))
        oob = np.isnan(want).any(axis=-1)
        assert oob.any() and (~oob).any()
        _assert_matches(got, want)  # NaN positions must match exactly

    def test_extrapolate_clamps_edge_cells(self, mesh):
        itp = _grid_interp((9, 8), 2, "cubic", extrapolate=True)
        ev = shard_interpnd_grid(itp, mesh)
        qs = _queries(itp, 300, pad=1.5)
        got = np.asarray(ev(*qs))
        want = np.asarray(itp(*qs))
        assert np.isfinite(got).all()
        _assert_matches(got, want)

    def test_periodic_axis_wraps(self, mesh):
        itp = _grid_interp(
            (11, 9, 2), 2, "cubic", bcs=("periodic", "natural")
        )
        ev = shard_interpnd_grid(itp, mesh)
        qs = _queries(itp, 200, pad=5.0)
        _assert_matches(ev(*qs), itp(*qs))

    def test_nondivisible_cells(self, mesh):
        # c0 = 9 over 8 shards: S = 2, last shard holds 1 real cell +
        # 1 pad row block, shards past ceil own nothing
        itp = _grid_interp((10, 6), 2, "cubic")
        ev = shard_interpnd_grid(itp, mesh)
        qs = _queries(itp, 123)
        _assert_matches(ev(*qs), itp(*qs))

    def test_two_axis_mesh_query_sharded(self, mesh2d):
        itp = _grid_interp((17, 9, 3), 2, "cubic")
        ev = shard_interpnd_grid(itp, mesh2d, query_axis="query")
        qs = _queries(itp, 256)
        _assert_matches(ev(*qs), itp(*qs))

    def test_query_shape_preserved(self, mesh):
        itp = _grid_interp((9, 9), 2, "cubic")
        ev = shard_interpnd_grid(itp, mesh)
        qx, qy = _queries(itp, 24)
        out = ev(qx.reshape(4, 6), qy.reshape(4, 6))
        assert out.shape == (4, 6)

    def test_matches_eager_formulation_bitwise(self, mesh):
        # the stable bit-exact gate: the sharded program reproduces the
        # eager (op-by-op, fusion-free) cell blend EXACTLY — the 1-ulp
        # slack in _assert_matches exists only because the single-device
        # JITTED oracle is a different XLA program
        from ndarray_interp_tpu.models.interpnd import _corner_weights
        from ndarray_interp_tpu.models.strategies.bicubic import _index_frac

        itp = _grid_interp((13, 11, 5), 2, "linear")
        ev = shard_interpnd_grid(itp, mesh)
        qs = _queries(itp, 500)
        idx, ts = [], []
        for ax, q in zip(itp.axes, qs):
            i, t = _index_frac(ax, q)
            idx.append(i)
            ts.append(t)
        w = _corner_weights(ts, 2)
        cell = idx[0] * (itp.data.shape[1] - 1) + idx[1]
        rows = jnp.take(itp.table, cell, axis=0).reshape(-1, 4, 5)
        want = jnp.sum(rows * w[:, :, None], axis=1)
        ok = None
        for ax, q in zip(itp.axes, qs):
            good = (q >= ax[0]) & (q <= ax[-1])
            ok = good if ok is None else ok & good
        want = jnp.where(ok[:, None], want, jnp.nan)
        np.testing.assert_array_equal(
            np.asarray(ev(*qs)), np.asarray(want)
        )

    def test_nearest_rejected(self, mesh):
        itp = _grid_interp((9, 9), 2, "linear")
        itp.method = "nearest"
        with pytest.raises(ValueError, match="linear.*cubic|'nearest'"):
            shard_interpnd_grid(itp, mesh)


class TestInterp2DGridShard:
    def test_bicubic_matches_interpnd_oracle(self, mesh):
        rng = np.random.default_rng(3)
        x = jnp.asarray(np.sort(rng.uniform(0, 5, 12)))
        y = jnp.asarray(np.sort(rng.uniform(0, 5, 10)))
        data = jnp.asarray(rng.normal(size=(12, 10, 3)))
        from ndarray_interp_tpu.models.strategies.bicubic import Bicubic

        itp = (
            Interp2D.builder(data)
            .x(x).y(y)
            .strategy(Bicubic().extrapolate(True))
            .build()
        )
        ev = shard_interp2d_grid(itp, mesh)
        qx = jnp.asarray(rng.uniform(float(x[0]), float(x[-1]), 200))
        qy = jnp.asarray(rng.uniform(float(y[0]), float(y[-1]), 200))
        # exactness oracle: the k=2 InterpND cubic (same solves/blend)
        table, lay = InterpND.build_state(
            (x, y), data, 2, "cubic",
            bcs=("not_a_knot", "not_a_knot"), layout="cell",
        )
        nd = InterpND.new_unchecked(
            (x, y), data, "cubic", True, table,
            ("not_a_knot", "not_a_knot"), lay,
        )
        _assert_matches(ev(qx, qy), nd(qx, qy))
        # and the Interp2D public eval agrees to fp tolerance
        want = np.asarray(itp.interp_array(qx, qy))
        got = np.asarray(ev(qx, qy))
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)

    def test_bilinear_matches_interp2d(self, mesh):
        rng = np.random.default_rng(4)
        x = jnp.asarray(np.sort(rng.uniform(0, 5, 9)))
        y = jnp.asarray(np.sort(rng.uniform(0, 5, 7)))
        data = jnp.asarray(rng.normal(size=(9, 7)))
        itp = Interp2D.builder(data).x(x).y(y).build()
        ev = shard_interp2d_grid(itp, mesh)
        qx = jnp.asarray(rng.uniform(float(x[0]), float(x[-1]), 150))
        qy = jnp.asarray(rng.uniform(float(y[0]), float(y[-1]), 150))
        got = np.asarray(ev(qx, qy))
        want = np.asarray(itp.interp_array(qx, qy))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


class TestRound5ReviewFixes:
    def test_f32_axes_use_xla_index_frac(self, mesh):
        # Round-5 review: _index_frac routed f32 axes to the Pallas
        # fused kernel (a custom_partitioning op) INSIDE the shard_map
        # body, failing shard_map's vma check at trace time.  Every
        # prior test ran f64 (kernel-ineligible) and never saw it.
        itp = _grid_interp((17, 9, 9), 3, "cubic", dtype=np.float32)
        ev = shard_interpnd_grid(itp, mesh)
        rng = np.random.default_rng(9)
        qs = tuple(
            jnp.asarray(
                rng.uniform(
                    float(ax[0]), float(ax[-1]), 64
                ).astype(np.float32)
            )
            for ax in itp.axes
        )
        got = np.asarray(ev(*qs))
        want = np.asarray(itp.eval_unchecked(*qs))
        ok = (got == want) | (np.isnan(got) & np.isnan(want))
        assert ok.all()

    def test_2d_rejects_non_grid_strategy(self, mesh):
        # Round-5 review: a Nearest2D strategy silently fell into the
        # bilinear branch and returned wrong values.
        from ndarray_interp_tpu.models.strategies.step import Nearest2D

        rng = np.random.default_rng(4)
        data = jnp.asarray(rng.normal(size=(8, 8)))
        itp = (
            Interp2D.builder(data)
            .strategy(Nearest2D())
            .build()
        )
        with pytest.raises(ValueError, match="Bilinear and Bicubic"):
            shard_interp2d_grid(itp, mesh)
