"""Benchmark harness mirroring the reference's criterion suite.

Workload definitions follow ``/root/reference/benches/`` (see BASELINE.md):

* 1D scalar:   100-knot linear axis, 10k uniform queries       (bench_interp1d.rs:12-47)
* 1D array:    (100, 5) data, 10k queries                      (bench_interp1d.rs:81-123)
* 1D query-dim sweep: (2500,4), (625,4,4), (125,5,4,4)         (bench_interp1d_query_dim.rs)
* 2D scalar:   100x100 bilinear grid, 10k (x, y) queries       (bench_interp2d.rs:12-84)
* 2D array:    (100, 100, 5) data                              (bench_interp2d.rs:86-131)
* 2D query-dim sweep                                            (bench_interp2d_query_dim.rs)
* get_lower_index spacing sweep: linspaced / uniform-rng /
  bunched / noisy / logspaced axes, 1k queries                  (bench_vector_extensions.rs:42-78)

plus the north-star configs from BASELINE.json (2k-knot 1M-query cubic,
batched (2k, 64, 64) cubic build, 512x512x16 bilinear with 1M queries,
Akima/PCHIP through the strategy protocol, and a bf16-query spline bank).

Where the reference uses rayon multithreading ("MT" benches), the analogue
here is the batched device path.

Each device row is the median over repeats of one jitted call ending in
``block_until_ready``.  Needs a GPU (exits non-zero otherwise); the
results file names the device, the card and its power limit.

Usage: ``python benches/run_benches.py [--quick] [--json out.json]``
(default output: ``chiprun_out/benches_<device kind>.json``)
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def timer(fn, *args, reps=10, warmup=2):
    """Median host seconds per call of a host-side function."""
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def device_timer(fn, args, reps=10):
    """Median seconds per call of ``jax.jit(fn)(*args)``; every call ends
    in ``block_until_ready`` and compilation happens before the window."""
    import jax

    run = jax.jit(fn)
    return timer(lambda: jax.block_until_ready(run(*args)), reps=reps)


def rand_ordered(rng, size, lo, hi):
    arr = np.unique(rng.uniform(lo, hi, size))
    return arr


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--json", type=str, default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from chip_smoke import card_line, setup_compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform!r} devices",
              file=sys.stderr)
        return 1
    setup_compile_cache()
    card = card_line()

    from ndarray_interp_tpu import native
    from ndarray_interp_tpu.interp1d import (
        Akima,
        CubicSpline,
        Interp1D,
        Linear,
        Pchip,
    )
    from ndarray_interp_tpu.interp2d import Interp2D

    from ndarray_interp_tpu.models.strategies.cubic import (
        CubicSplineStrategy,
    )

    def fast_build_1d(data, x=None, strategy=None):
        """Build under jit without validation: the rows time evaluation,
        not the validating builder."""
        data = jnp.asarray(data)
        if x is None:
            x = jnp.arange(data.shape[0], dtype=data.dtype)
        if strategy is None:
            strategy = Linear()
        if isinstance(strategy, Linear):
            return Interp1D.new_unchecked(x, data, strategy)
        built = jax.jit(
            lambda x_, d_: (lambda s_: (s_.a, s_.b))(strategy.build(x_, d_))
        )(x, data)
        mode = "yes" if strategy.extrapolates else "no"
        return Interp1D.new_unchecked(
            x, data, CubicSplineStrategy(built[0], built[1], mode)
        )

    def fast_build_2d(data, strategy=None):
        from ndarray_interp_tpu.models.strategies.bilinear import Bilinear

        data = jnp.asarray(data)
        x = jnp.arange(data.shape[0], dtype=data.dtype)
        y = jnp.arange(data.shape[1], dtype=data.dtype)
        strat = (strategy or Bilinear()).build(x, y, data)  # packed rows
        return Interp2D.new_unchecked(x, y, data, strat)

    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    results = []

    def record(name, seconds, work_items, source):
        results.append(
            {
                "bench": name,
                "time_ms": round(seconds * 1e3, 4),
                "items_per_sec": round(work_items / seconds, 1),
                "source": source,
            }
        )
        print(
            f"{name:<55} {seconds*1e3:10.3f} ms   "
            f"{work_items/seconds:14.0f} items/s"
        )

    rng = np.random.default_rng(42)
    reps = 3 if args.quick else 10

    # ---- 1D scalar family (100-knot linear, 10k queries) -----------------
    data100 = rng.uniform(0.0, 1.0, 100)
    q10k = rng.uniform(0.0, 99.0, 10_000)
    itp = fast_build_1d(jnp.asarray(data100, dtype))

    if native.HAVE_NATIVE:
        # numpy-input build → host copies captured → native scalar path
        itp_host = Interp1D.builder(
            data100.astype(np.dtype(dtype))
        ).build()
        state = itp_host._native_state()
        assert state is not None

        def scalar_loop():
            for x in q10k[:1000]:
                itp_host.interp_scalar(float(x))
            return None

        t = timer(scalar_loop, reps=max(1, reps // 3), warmup=1)
        record(
            "1D scalar interp_scalar (native, per-call x1000)",
            t,
            1000,
            "bench_interp1d.rs:17-23",
        )

        from ndarray_interp_tpu.native import eval_linear

        x_np = np.asarray(itp.x)
        d_np = np.asarray(itp.data)
        t = timer(lambda: eval_linear(x_np, d_np, q10k.astype(d_np.dtype), False), reps=reps)
        record(
            "1D scalar interp_array 10k (native batched)",
            t,
            10_000,
            "bench_interp1d.rs:33-37",
        )

    qd = jnp.asarray(q10k, dtype)
    f = jax.jit(lambda t_, q: t_(q))
    t = device_timer(f, (itp, qd))
    record(
        "1D scalar interp_array 10k (device)",
        t,
        10_000,
        "bench_interp1d.rs:33-37",
    )

    # ---- 1D array family ((100,5) data) ----------------------------------
    itp5 = fast_build_1d(jnp.asarray(rng.uniform(0, 1, (100, 5)), dtype))
    t = device_timer(f, (itp5, qd))
    record(
        "1D array (100,5) interp_array 10k (device)",
        t,
        10_000,
        "bench_interp1d.rs:81-123",
    )

    # ---- 1D query-dim sweep ----------------------------------------------
    for shape in ((2500, 4), (625, 4, 4), (125, 5, 4, 4)):
        qs = jnp.asarray(q10k.reshape(shape), dtype)
        t = device_timer(f, (itp, qs))
        record(
            f"1D query-dim {shape} (device)",
            t,
            10_000,
            "bench_interp1d_query_dim.rs:11-84",
        )

    # ---- 2D family --------------------------------------------------------
    grid = rng.uniform(0, 1, (100, 100))
    itp2 = fast_build_2d(jnp.asarray(grid, dtype))
    qx = rng.uniform(0, 99, 10_000)
    qy = rng.uniform(0, 99, 10_000)
    f2 = jax.jit(lambda t_, a, b: t_(a, b))
    t = device_timer(
        f2, (itp2, jnp.asarray(qx, dtype), jnp.asarray(qy, dtype)))
    record(
        "2D scalar 100x100 interp_array 10k (device)",
        t,
        10_000,
        "bench_interp2d.rs:12-84",
    )

    if native.HAVE_NATIVE:
        from ndarray_interp_tpu.native import eval_bilinear

        t = timer(
            lambda: eval_bilinear(
                np.asarray(itp2.x), np.asarray(itp2.y), np.asarray(itp2.data),
                qx.astype(np.asarray(itp2.x).dtype),
                qy.astype(np.asarray(itp2.x).dtype), False,
            ),
            reps=reps,
        )
        record(
            "2D scalar 100x100 10k (native batched)",
            t,
            10_000,
            "bench_interp2d.rs:12-84",
        )

        # beyond-reference: native bicubic (node-state nested Hermite)
        from ndarray_interp_tpu.models.strategies.bicubic import (
            bicubic_node_grids,
        )
        from ndarray_interp_tpu.native import eval_bicubic

        gj = jnp.asarray(grid)
        xh = np.asarray(itp2.x, np.float64)
        yh = np.asarray(itp2.y, np.float64)
        kxh, kyh, kxyh = (
            np.asarray(g)
            for g in bicubic_node_grids(
                jnp.asarray(xh), jnp.asarray(yh), gj
            )
        )
        t = timer(
            lambda: eval_bicubic(
                xh, yh, grid, kxh, kyh, kxyh, qx, qy, False
            ),
            reps=reps,
        )
        record(
            "2D bicubic 100x100 10k (native batched, beyond-ref)",
            t,
            10_000,
            "models/strategies/bicubic.py",
        )

    itp2v = fast_build_2d(jnp.asarray(rng.uniform(0, 1, (100, 100, 5)), dtype))
    t = device_timer(
        f2, (itp2v, jnp.asarray(qx, dtype), jnp.asarray(qy, dtype)))
    record(
        "2D array (100,100,5) interp_array 10k (device)",
        t,
        10_000,
        "bench_interp2d.rs:86-131",
    )

    # ---- get_lower_index spacing sweep ------------------------------------
    from ndarray_interp_tpu.ops.searchsorted import get_lower_index

    axes = {
        "linspaced": np.linspace(0.0, 1.0, 100),
        "uniform-rng": rand_ordered(rng, 100, 0.0, 1.0),
        "bunched": np.unique(
            np.concatenate(
                [np.linspace(0, 1, 20) + rng.uniform(-1e-3, 1e-3, 20) for _ in range(5)]
            )
        ),
        "noisy": np.unique(np.linspace(0, 1, 100) + rng.uniform(-4e-3, 4e-3, 100)),
        "logspaced": np.logspace(0.0, 1.0, 100),
    }
    q1k = rng.uniform(-0.1, 1.2, 1000)
    gli = jax.jit(get_lower_index)
    for name, axis in axes.items():
        ax = jnp.asarray(axis, dtype)
        qv = jnp.asarray(
            q1k * (float(axis[-1]) - float(axis[0])) + float(axis[0]), dtype
        )
        t = device_timer(gli, (ax, qv))
        record(
            f"get_lower_index {name} 1k (device)",
            t,
            1000,
            "bench_vector_extensions.rs:42-78",
        )

    # ---- north-star configs (BASELINE.json) -------------------------------
    nq = 100_000 if args.quick else 1_000_000
    knots2k = jnp.asarray(np.linspace(0, 100, 2048), dtype)
    vals2k = jnp.asarray(rng.normal(size=2048), dtype)
    strat = CubicSpline().extrapolate(True)
    build_jit = jax.jit(lambda x, v: (lambda s: (s.a, s.b))(strat.build(x, v)))
    a2k, b2k = build_jit(knots2k, vals2k)
    itp_c = Interp1D.new_unchecked(
        knots2k, vals2k, CubicSplineStrategy(a2k, b2k, "yes")
    )
    qbig = jnp.asarray(rng.uniform(0, 100, nq), dtype)
    t = device_timer(f, (itp_c, qbig))
    record(
        f"NS1: 1D cubic 2k knots, {nq//1000}k queries (device)",
        t,
        nq,
        "BASELINE.json config 1",
    )

    # NS2: batched cubic build on (2048, 64, 64)
    bank_shape = (2048, 8, 8) if args.quick else (2048, 64, 64)
    bank = jnp.asarray(rng.normal(size=bank_shape).astype(np.float32), dtype)
    xb = jnp.asarray(np.linspace(0, 1, 2048), dtype)
    t = device_timer(build_jit, (xb, bank))
    record(
        f"NS2: cubic build {bank_shape} bank (device)",
        t,
        int(np.prod(bank_shape[1:])),
        "BASELINE.json config 2",
    )

    # NS2b: 10k-knot x 64-bank EVAL (search + ONE stacked-row gather +
    # Hermite tail)
    n10k, bank10k = (1024, 16) if args.quick else (10240, 64)
    data10 = jnp.asarray(
        rng.normal(size=(n10k, bank10k)).astype(np.float32), dtype
    )
    x10 = jnp.asarray(np.linspace(0, 1, n10k), dtype)
    a10, b10 = build_jit(x10, data10)
    itp10 = Interp1D.new_unchecked(
        x10, data10, CubicSplineStrategy(a10, b10, "yes")
    )
    q10 = jnp.asarray(rng.uniform(0, 1, nq), dtype)
    t = device_timer(f, (itp10, q10))
    record(
        f"NS2b: {n10k}-knot x{bank10k} bank EVAL, {nq//1000}k queries (device)",
        t,
        nq * bank10k,
        "BASELINE.json config 2",
    )

    # NS2c: the same wide-bank workload at f64-grade accuracy — DF
    # (idx, t) pass + packed (hi, lo) gather + DF tail
    if not args.quick:
        from ndarray_interp_tpu.ops.df import df_from_f64
        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bank_eval_df,
        )

        dfargs = []
        for v in (
            np.linspace(0, 1, n10k),
            np.asarray(data10, np.float64),
            np.asarray(a10, np.float64),
            np.asarray(b10, np.float64),
        ):
            dfargs.extend(jnp.asarray(w) for w in df_from_f64(v))
        qdfh, qdfl = (
            jnp.asarray(w)
            for w in df_from_f64(rng.uniform(0, 1, nq))
        )

        def df_run(qh, ql, *tables):
            # tables ride as ARGUMENTS: the raw-route hygiene guard
            # rejects closure-captured banks
            return gathered_bank_eval_df(
                dfargs[0], dfargs[1], *tables, qh, ql
            )

        t = device_timer(
            df_run, (qdfh, qdfl) + tuple(dfargs[2:8]))
        record(
            f"NS2c: {n10k}-knot x{bank10k} bank DF EVAL (f64-grade), "
            f"{nq//1000}k queries (device)",
            t,
            nq * bank10k,
            "BASELINE.json:5",
        )

        # NS2d: the "f48" tier on the same workload — bf16-lo packed
        # rows (6bp channels vs DF's 8bp): ~2^-33 grade at 75% of the
        # DF table's memory and gather traffic
        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bank_eval_f48_packed,
            pack_bank_rows_f48,
        )

        packed48 = jax.jit(pack_bank_rows_f48)(*dfargs[2:8])

        def f48_run(qh, ql, packed):
            return gathered_bank_eval_f48_packed(
                dfargs[0], dfargs[1], packed, bank10k, qh, ql
            )

        t = device_timer(f48_run, (qdfh, qdfl, packed48))
        record(
            f"NS2d: {n10k}-knot x{bank10k} bank f48 EVAL (~2^-33 tier, "
            f"75% DF table), {nq//1000}k queries (device)",
            t,
            nq * bank10k,
            "beyond-reference + BASELINE.json:5 (f48 tier)",
        )

    # NS1b: large knot axis (256k)
    nbig = 66_000 if args.quick else 262_144
    xbig = jnp.asarray(np.linspace(0, 100, nbig), dtype)
    vbig = jnp.asarray(rng.normal(size=nbig), dtype)
    abig, bbig = build_jit(xbig, vbig)
    itp_big = Interp1D.new_unchecked(
        xbig, vbig, CubicSplineStrategy(abig, bbig, "yes")
    )
    t = device_timer(f, (itp_big, qbig))
    record(
        f"NS1b: 1D cubic {nbig//1000}k knots, {nq//1000}k queries (device)",
        t,
        nq,
        "beyond-64k knot axis",
    )

    # NS3: 512x512x16 bilinear, 1M scattered 2-D queries
    g_shape = (128, 128, 4) if args.quick else (512, 512, 16)
    grid3 = jnp.asarray(rng.normal(size=g_shape).astype(np.float32), dtype)
    itp3 = fast_build_2d(grid3)
    qn = nq
    qx3 = jnp.asarray(
        rng.uniform(0, g_shape[0] - 1, qn).reshape(-1, 1000), dtype
    )
    qy3 = jnp.asarray(
        rng.uniform(0, g_shape[1] - 1, qn).reshape(-1, 1000), dtype
    )
    t = device_timer(f2, (itp3, qx3, qy3))
    record(
        f"NS3: bilinear {g_shape}, {qn//1000}k 2-D queries (device)",
        t,
        qn,
        "BASELINE.json config 3",
    )

    # NS3b: bicubic on the NS3 grid (beyond-reference strategy)
    if not args.quick:
        from ndarray_interp_tpu.models.strategies.bicubic import Bicubic

        x3b = jnp.asarray(np.arange(g_shape[0], dtype=np.float32), dtype)
        y3b = jnp.asarray(np.arange(g_shape[1], dtype=np.float32), dtype)
        strat3b = jax.jit(
            lambda x_, y_, d_: Bicubic(extrapolate=True).build(x_, y_, d_)
        )(x3b, y3b, grid3)
        from ndarray_interp_tpu.models.interp2d import Interp2D as _I2

        itp3b = _I2.new_unchecked(x3b, y3b, grid3, strat3b)
        t = device_timer(f2, (itp3b, qx3, qy3))
        record(
            f"NS3b: bicubic {g_shape}, {qn//1000}k 2-D queries (device)",
            t,
            qn,
            "beyond-reference (tensor-product NAK cubic)",
        )

    # NS3c: config-3 at f64 grade — DF bilinear gather route (two DF
    # (idx, t) passes + one packed (hi, lo) corner gather + DF tail)
    if not args.quick:
        from ndarray_interp_tpu.ops.df import df_from_f64
        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bilinear_eval_df,
        )

        df3 = []
        for v in (
            np.arange(g_shape[0], dtype=np.float64),
            np.arange(g_shape[1], dtype=np.float64),
            np.asarray(grid3, np.float64),
        ):
            df3.extend(jnp.asarray(w) for w in df_from_f64(v))
        qx3h, qx3l = (
            jnp.asarray(w) for w in df_from_f64(np.asarray(qx3, np.float64).reshape(-1))
        )
        qy3h, qy3l = (
            jnp.asarray(w) for w in df_from_f64(np.asarray(qy3, np.float64).reshape(-1))
        )

        def df3_run(a, b, c, d, zh_, zl_):
            return gathered_bilinear_eval_df(
                df3[0], df3[1], df3[2], df3[3], zh_, zl_, a, b, c, d
            )

        t = device_timer(
            df3_run, (qx3h, qx3l, qy3h, qy3l, df3[4], df3[5]))
        record(
            f"NS3c: bilinear {g_shape} DF EVAL (f64-grade), {qn//1000}k "
            "2-D queries (device)",
            t,
            qn,
            "BASELINE.json config 3 + :5 (f64-grade)",
        )

        # NS3g: the bilinear "f48" tier — bf16-lo packed corner rows
        # (6bp channels vs DF's 8bp), ~2^-33 grade at 75% of the
        # DF table's memory and gather traffic
        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bilinear_eval_f48_packed,
            pack_bilinear_rows_f48,
        )

        r3 = 1
        for s_ in g_shape[2:]:
            r3 *= s_
        packed3g = jax.jit(pack_bilinear_rows_f48)(df3[4], df3[5])

        def f48_bl_run(a, b, c, d, packed):
            return gathered_bilinear_eval_f48_packed(
                df3[0], df3[1], df3[2], df3[3], packed,
                g_shape[1], r3, a, b, c, d,
            )

        t = device_timer(
            f48_bl_run, (qx3h, qx3l, qy3h, qy3l, packed3g))
        record(
            f"NS3g: bilinear {g_shape} f48 EVAL (~2^-33 tier, 75% DF "
            f"table), {qn//1000}k 2-D queries (device)",
            t,
            qn,
            "beyond-reference + BASELINE.json:5 (f48 tier)",
        )

    # NS3d: bicubic at f64 grade — DF cell-row gather route
    if not args.quick:
        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bicubic_eval_df_packed,
            pack_bicubic_rows_df,
        )

        r3d = g_shape[2]
        rows_pair = df_from_f64(
            np.asarray(itp3b.strategy.rows, np.float64)
        )
        packed3d = jax.jit(
            lambda h, l: pack_bicubic_rows_df(h, l, r3d)
        )(*(jnp.asarray(v) for v in rows_pair))
        xy_pairs = []
        for v in (
            np.arange(g_shape[0], dtype=np.float64),
            np.arange(g_shape[1], dtype=np.float64),
        ):
            xy_pairs.extend(jnp.asarray(w) for w in df_from_f64(v))

        def df3d_run(a, b, c, d, packed):
            return gathered_bicubic_eval_df_packed(
                *xy_pairs, packed, a, b, c, d, r=r3d
            )

        t = device_timer(
            df3d_run, (qx3h, qx3l, qy3h, qy3l, packed3d))
        record(
            f"NS3d: bicubic {g_shape} DF EVAL (f64-grade), {qn//1000}k "
            "2-D queries (device)",
            t,
            qn,
            "beyond-reference + BASELINE.json:5",
        )

        # NS3f: the "f48" tier — bf16-lo packed rows (1.5 KB vs DF's
        # 2 KB), ~2^-33 scale-relative; 75% of NS3d's table traffic
        from ndarray_interp_tpu.ops.df_eval import (
            gathered_bicubic_eval_f48_packed,
            pack_bicubic_rows_f48,
        )

        packed3f = jax.jit(
            lambda h, l: pack_bicubic_rows_f48(h, l, r3d)
        )(*(jnp.asarray(v) for v in rows_pair))

        def f48_run(a, b, c, d, packed):
            return gathered_bicubic_eval_f48_packed(
                *xy_pairs, packed, a, b, c, d, r=r3d
            )

        t = device_timer(
            f48_run, (qx3h, qx3l, qy3h, qy3l, packed3f))
        record(
            f"NS3f: bicubic {g_shape} f48 EVAL (~2^-33 tier, 75% DF "
            f"table), {qn//1000}k 2-D queries (device)",
            t,
            qn,
            "beyond-reference + BASELINE.json:5 (f48 tier)",
        )

    # NS4: Akima + PCHIP through the strategy protocol
    for name, s in (("akima", Akima()), ("pchip", Pchip())):
        k_fn = jax.jit(
            lambda x_, d_: (lambda st: (st.a, st.b))(
                type(s)(extrapolate=True).build(x_, d_)
            )
        )
        a4, b4 = k_fn(knots2k, vals2k)
        itp4 = Interp1D.new_unchecked(
            knots2k, vals2k, CubicSplineStrategy(a4, b4, "yes")
        )
        t = device_timer(f, (itp4, qbig))
        record(
            f"NS4: {name} 2k knots, {nq//1000}k queries (device)",
            t,
            nq,
            "BASELINE.json config 4",
        )

    # NS5: spline bank, bf16 queries vs f32 coefficients
    bank5 = 1024 if args.quick else 16384
    data5 = jnp.asarray(rng.normal(size=(256, bank5)).astype(np.float32), dtype)
    x5 = jnp.asarray(np.linspace(0, 1, 256), dtype)
    a5, b5 = build_jit(x5, data5)
    itp5b = Interp1D.new_unchecked(
        x5, data5, CubicSplineStrategy(a5, b5, "yes")
    )
    qb16 = jnp.asarray(rng.uniform(0, 1, 4096), jnp.bfloat16)
    fb = jax.jit(lambda t_, q: t_(q.astype(t_.x.dtype)))
    t = device_timer(fb, (itp5b, qb16))
    record(
        f"NS5: {bank5}-spline bank, 4k bf16 queries (device)",
        t,
        4096 * bank5,
        "BASELINE.json config 5",
    )

    # NS5b: the config-5 stretch scale — a 1e6-spline bank with a short
    # knot axis and a small query batch (out = 256 x 1e6 f32 = 1 GB)
    if not args.quick:
        bank6 = 1_000_000
        # generated on device: set-up, not the measured work
        data6 = jax.random.normal(
            jax.random.PRNGKey(0), (64, bank6), jnp.float32
        )
        x6 = jnp.asarray(np.linspace(0, 1, 64), dtype)
        t = device_timer(build_jit, (x6, data6))
        record(
            "NS5b: 1e6-spline bank BUILD (device)",
            t,
            bank6,
            "BASELINE.json config 5 (stretch scale)",
        )
        a6, b6 = build_jit(x6, data6)
        itp6 = Interp1D.new_unchecked(
            x6, data6, CubicSplineStrategy(a6, b6, "yes")
        )
        q6 = jnp.asarray(rng.uniform(0, 1, 256), dtype)
        t = device_timer(f, (itp6, q6))
        record(
            "NS5b: 1e6-spline bank EVAL, 256 queries (device)",
            t,
            256 * bank6,
            "BASELINE.json config 5 (stretch scale)",
        )

    # ND: the beyond-reference N-D family (InterpND), 64^3 grid, 1M
    # queries — the packed one-gather routes (docs/API.md memory notes)
    if not args.quick:
        from ndarray_interp_tpu.interpnd import InterpND

        axes_nd = tuple(
            jnp.asarray(np.linspace(0.0, 1.0, 64), dtype) for _ in range(3)
        )
        data_nd = jax.random.normal(
            jax.random.PRNGKey(1), (64, 64, 64), dtype
        )
        qs_nd = tuple(
            jnp.asarray(rng.uniform(0, 1, 1_000_000), dtype)
            for _ in range(3)
        )
        fnd = jax.jit(lambda i, a, b, c: i.eval_unchecked(a, b, c))
        table_lin, _ = InterpND.build_state(axes_nd, data_nd, 3, "linear")
        tri = InterpND.new_unchecked(
            axes_nd, data_nd, "linear", True, table_lin
        )
        t = device_timer(fnd, (tri,) + qs_nd)
        record(
            "ND1: trilinear 64^3 grid, 1000k queries (device)",
            t,
            1_000_000,
            "beyond reference (InterpND linear, packed rows)",
        )
        table_cub, layout_cub = InterpND.build_state(
            axes_nd, data_nd, 3, "cubic"
        )
        cub = InterpND.new_unchecked(
            axes_nd, data_nd, "cubic", True, table_cub,
            ("not_a_knot",) * 3, layout_cub,
        )
        t = device_timer(fnd, (cub,) + qs_nd)
        record(
            f"ND2: tricubic 64^3 grid, 1000k queries (device, "
            f"{layout_cub} layout)",
            t,
            1_000_000,
            "beyond reference (InterpND cubic, tensor-product spline)",
        )

    kind = devices[0].device_kind
    print(f"\ndevice={kind} card=[{card}] dtype={dtype} "
          f"native={native.HAVE_NATIVE}")
    out = Path(args.json) if args.json else (
        Path(__file__).resolve().parent.parent / "chiprun_out"
        / f"benches_{kind.replace(' ', '_')}.json"
    )
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "device": {"platform": devices[0].platform, "kind": kind,
                   "count": len(devices)},
        "card": card,
        "rows": results,
    }, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
