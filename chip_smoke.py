"""On-card smoke test of the interpolation serving path.

Drives the public path a user calls -- the validating builders, then the
``serving`` evaluators -- at deployment sizes on one GPU, and checks every
result against a plain float64 reference computed on the host with SciPy /
NumPy (independent of the code under test).

    python chip_smoke.py              # phases P1-P5 on one GPU
    python chip_smoke.py --timings    # plus steady-state timings and the
                                      # dispatch candidates' timings
    python chip_smoke.py --multi      # only the sharded paths, four GPUs

Each phase prints one line with its max error, its tolerance and its
compile time; the last line of a passing run is one JSON object naming the
device.  Any failure raises and exits non-zero without that line.  The
script refuses to run anywhere but on a GPU.

The phase functions take their sizes as arguments, so the CPU tests call
them at tiny sizes (``tests/test_chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# -- tolerances (each beside its reason) --------------------------------------
# f32 routes vs the f64 oracle: scale-relative (max |err| / max |ref| within
# the leg).  f32 keeps 24 bits (6e-8); the coefficient build and the Hermite
# tail each add a few roundings, and the knot-derivative solve spreads them
# over the axis, so 1e-5 leaves two orders of headroom while still catching a
# wrong interval or a TF32 (10-bit) matmul.  In-range and out-of-range legs are
# gated separately: extrapolation amplifies values by ~t^3, so one gate scaled
# by the largest value would hide in-range errors.
TOL_F32 = 1e-5
# P2's build may run a dense-operator matmul; it keeps Precision.HIGHEST, so
# TF32 never enters and the f32 bound above holds unchanged.
TOL_F32_BANK = 1e-5
# double-float (hi, lo) f32 pairs carry ~48 bits: 1e-12 scale-relative is the
# repo's f64-grade gate (README, serving.DoubleFloatEvaluator).  Inputs are
# rounded to DF-representable values first so the gate measures arithmetic,
# not the f64 -> pair representation error of the queries.
TOL_DF = 1e-12
# f48 stores the lo half as a bf16 pair (~2^-33): the repo's f48 gate.
TOL_F48 = 3e-9

N_CHECK = 65536  # fixed-seed subsample compared with the oracle


# -- helpers ------------------------------------------------------------------
def setup_compile_cache():
    """Persistent compile cache: ``$JAX_COMPILATION_CACHE_DIR`` if set (JAX
    reads it itself), else ``<repo>/.jax_cache``."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(ROOT / ".jax_cache"))


def card_line():
    """Card name and power limit, read by ``nvidia-smi`` (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _subsample(n, seed):
    m = min(N_CHECK, n)
    return np.sort(np.random.default_rng(seed).choice(n, m, replace=False))


class LegError:
    """Scale-relative error accumulated over chunks, one value per leg
    (in-range / out-of-range): ``max |got - want| / max |want|``."""

    def __init__(self):
        self.err = {True: 0.0, False: 0.0}
        self.scale = {True: 0.0, False: 0.0}
        self.count = {True: 0, False: 0}

    def add(self, got, want, in_range):
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        if got.shape != want.shape:
            raise AssertionError(f"shape {got.shape} != reference {want.shape}")
        if not np.all(np.isfinite(got)):
            raise AssertionError("non-finite values in the device result")
        in_range = np.asarray(in_range, bool)
        diff = np.abs(got - want).reshape(got.shape[0], -1).max(axis=1)
        mag = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
        for leg in (True, False):
            m = in_range == leg
            if m.any():
                self.err[leg] = max(self.err[leg], float(diff[m].max()))
                self.scale[leg] = max(self.scale[leg], float(mag[m].max()))
                self.count[leg] += int(m.sum())

    def rel(self, leg):
        if self.count[leg] == 0:
            return 0.0
        return self.err[leg] / max(self.scale[leg], 1e-300)

    def gate(self, name, tol, compile_s):
        ins, outs = self.rel(True), self.rel(False)
        print(
            f"{name}: max_err_in_range={ins:.3e} "
            f"max_err_out_of_range={outs:.3e} tol={tol:.0e} "
            f"(n_in={self.count[True]} n_out={self.count[False]}) "
            f"compile_s={compile_s:.2f}",
            flush=True,
        )
        if self.count[True] == 0:
            raise AssertionError(f"{name}: no in-range query was checked")
        if not (ins <= tol and outs <= tol):
            raise AssertionError(f"{name}: error above tolerance {tol:.0e}")
        return {"in": ins, "out": outs, "tol": tol, "compile_s": compile_s}


def _compile_report(name, ev):
    """Compile the evaluator's serving program once; print its memory."""
    t0 = time.perf_counter()
    compiled = ev.lower().compile()
    compile_s = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    if ma is not None:
        print(
            f"{name} memory_analysis: "
            f"argument_bytes={ma.argument_size_in_bytes} "
            f"output_bytes={ma.output_size_in_bytes} "
            f"temp_bytes={ma.temp_size_in_bytes} "
            f"generated_code_bytes={ma.generated_code_size_in_bytes}",
            flush=True,
        )
    return compile_s


def median_time(fn, reps):
    """Median per-call seconds; every call ends in ``block_until_ready``."""
    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
        if times[-1] > 2.0 and len(times) >= 3:
            break
    return statistics.median(times), len(times)


def _print_time(label, seconds, n, card):
    print(f"TIME {label}: median_s={seconds:.6f} reps={n} card=[{card}]",
          flush=True)


def _axis(rng, n, dtype):
    """Strictly rising, non-uniform axis on [0, n)."""
    steps = rng.uniform(0.5, 1.5, n - 1)
    return np.concatenate([[0.0], np.cumsum(steps)]).astype(dtype)


def _queries(rng, axis, n, margin=0.01):
    """Uniform queries over the axis widened by ``margin`` of its span on
    each side (the out-of-range leg)."""
    lo, hi = float(axis[0]), float(axis[-1])
    pad = margin * (hi - lo)
    return rng.uniform(lo - pad, hi + pad, n).astype(axis.dtype)


def _in_range(axis, q):
    return (q >= axis[0]) & (q <= axis[-1])


def _tensor_cubic_oracle(axes, data, qs, chunk=1024):
    """Sequential per-axis not-a-knot ``scipy.interpolate.CubicSpline`` in
    f64 -- the defining construction of the tensor-product spline.  The
    spline along axis 0 is evaluated at each query; for every later axis each
    query gets its own 1-D spline through the values left from the previous
    axes, evaluated at its own coordinate."""
    import scipy.interpolate as si

    axes = [np.asarray(a, np.float64) for a in axes]
    first = si.CubicSpline(axes[0], np.asarray(data, np.float64), axis=0)
    qs = [np.asarray(q, np.float64) for q in qs]
    out = []
    for s in range(0, qs[0].shape[0], chunk):
        g = first(qs[0][s : s + chunk])  # (C, n1, ..., trailing)
        for d in range(1, len(axes)):
            q = qs[d][s : s + chunk]
            c = si.CubicSpline(axes[d], g, axis=1).c  # (4, n-1, C, ...)
            i = np.clip(
                np.searchsorted(axes[d], q, side="right") - 1,
                0, axes[d].shape[0] - 2,
            )
            cols = np.arange(q.shape[0])
            coef = c[:, i, cols]  # (4, C, ...)
            dt = (q - axes[d][i]).reshape((-1,) + (1,) * (coef.ndim - 2))
            g = ((coef[0] * dt + coef[1]) * dt + coef[2]) * dt + coef[3]
        out.append(g)
    return np.concatenate(out, axis=0)


# -- phases -------------------------------------------------------------------
def phase_cubic_1d(n_knots=2048, n_queries=1 << 20, seed=0, card=None):
    """P1: 1-D not-a-knot ``CubicSpline``, scalar axis, through
    ``serving.Evaluator`` (the NS1 headline shape)."""
    import scipy.interpolate as si

    from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu.serving import Evaluator

    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 100.0, n_knots).astype(np.float32)
    y = rng.normal(size=n_knots).astype(np.float32)
    q = _queries(rng, x, n_queries)
    itp = (
        Interp1D.builder(jnp.asarray(y)).x(jnp.asarray(x))
        .strategy(CubicSpline().extrapolate(True)).build()
    )
    ev = Evaluator(itp, max_batch=n_queries, buckets=[n_queries])
    compile_s = _compile_report("P1", ev)
    got = np.asarray(ev(q))
    if got.shape != (n_queries,):
        raise AssertionError(f"P1 output shape {got.shape}")
    sub = _subsample(n_queries, seed + 1)
    want = si.CubicSpline(
        x.astype(np.float64), y.astype(np.float64), bc_type="not-a-knot"
    )(q[sub].astype(np.float64))
    err = LegError()
    err.add(got[sub], want, _in_range(x, q[sub]))
    res = err.gate(
        f"P1 cubic-1d knots={n_knots} queries={n_queries}", TOL_F32, compile_s
    )
    if card is not None:
        _print_time("P1 serve batch", *median_time(lambda: ev(q), 20), card)
    return res


def phase_cubic_bank(n_knots=2048, bank=4096, n_queries=65536, seed=1,
                     card=None):
    """P2: a bank of 1-D cubic splines sharing one knot axis, built through
    the builder (one batched solve) and served by ``serving.Evaluator``."""
    import scipy.interpolate as si

    from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu.serving import Evaluator

    rng = np.random.default_rng(seed)
    x = _axis(rng, n_knots, np.float32)
    y = rng.normal(size=(n_knots, bank)).astype(np.float32)
    q = _queries(rng, x, n_queries)
    t0 = time.perf_counter()
    itp = (
        Interp1D.builder(jnp.asarray(y)).x(jnp.asarray(x))
        .strategy(CubicSpline().extrapolate(True)).build()
    )
    jax.block_until_ready(itp.strategy.a)
    build_s = time.perf_counter() - t0
    ev = Evaluator(itp, max_batch=n_queries, buckets=[n_queries])
    compile_s = _compile_report("P2", ev)
    got = np.asarray(ev(q))
    if got.shape != (n_queries, bank):
        raise AssertionError(f"P2 output shape {got.shape}")
    sub = _subsample(n_queries, seed + 1)
    ref = si.CubicSpline(
        x.astype(np.float64), y.astype(np.float64), bc_type="not-a-knot"
    )
    err = LegError()
    for s in range(0, sub.shape[0], 4096):
        part = sub[s : s + 4096]
        err.add(got[part], ref(q[part].astype(np.float64)),
                _in_range(x, q[part]))
    res = err.gate(
        f"P2 cubic-bank knots={n_knots} bank={bank} queries={n_queries} "
        f"build_s={build_s:.2f}",
        TOL_F32_BANK, compile_s,
    )
    if card is not None:
        _print_time("P2 serve batch", *median_time(lambda: ev(q), 10), card)
        from ndarray_interp_tpu.interp1d import CubicSpline as _CS

        build = jax.jit(lambda xx, yy: _CS().build(xx, yy).a)
        xd, yd = jnp.asarray(x), jnp.asarray(y)
        _print_time("P2 build", *median_time(lambda: build(xd, yd), 10), card)
    return res


def phase_grid_2d(n=1024, channels=4, n_queries=1 << 20, seed=2, card=None):
    """P3: ``Interp2D`` with ``Bicubic`` and with ``Bilinear`` on an
    ``(n, n, channels)`` grid, served by ``serving.Evaluator2D``."""
    import scipy.interpolate as si

    from ndarray_interp_tpu.interp2d import Bicubic, Bilinear, Interp2D
    from ndarray_interp_tpu.serving import Evaluator2D

    rng = np.random.default_rng(seed)
    x = _axis(rng, n, np.float32)
    y = _axis(rng, n, np.float32)
    z = rng.normal(size=(n, n, channels)).astype(np.float32)
    qx = _queries(rng, x, n_queries)
    qy = _queries(rng, y, n_queries)
    sub = _subsample(n_queries, seed + 1)
    inr = _in_range(x, qx[sub]) & _in_range(y, qy[sub])
    x64, y64, z64 = (v.astype(np.float64) for v in (x, y, z))
    out = {}
    for name, strat in (("bicubic", Bicubic()), ("bilinear", Bilinear())):
        itp = (
            Interp2D.builder(jnp.asarray(z)).x(jnp.asarray(x))
            .y(jnp.asarray(y)).strategy(strat.extrapolate(True)).build()
        )
        ev = Evaluator2D(itp, max_batch=n_queries, buckets=[n_queries])
        compile_s = _compile_report(f"P3 {name}", ev)
        got = np.asarray(ev(qx, qy))
        if got.shape != (n_queries, channels):
            raise AssertionError(f"P3 {name} output shape {got.shape}")
        qsx, qsy = qx[sub].astype(np.float64), qy[sub].astype(np.float64)
        if name == "bicubic":
            want = _tensor_cubic_oracle((x64, y64), z64, (qsx, qsy))
        else:
            want = si.RegularGridInterpolator(
                (x64, y64), z64, method="linear", bounds_error=False,
                fill_value=None,
            )(np.stack([qsx, qsy], axis=-1))
        err = LegError()
        err.add(got[sub], want, inr)
        out[name] = err.gate(
            f"P3 {name} grid=({n},{n},{channels}) queries={n_queries}",
            TOL_F32, compile_s,
        )
        if card is not None:
            _print_time(f"P3 {name} serve batch",
                        *median_time(lambda: ev(qx, qy), 10), card)
    return out


def phase_nd_cubic(n=128, n_queries=1 << 20, seed=3, card=None):
    """P4: ``InterpND`` method ``"cubic"`` on an ``n^3`` scalar grid, served
    by ``serving.EvaluatorND``; the library picks the table layout."""
    from ndarray_interp_tpu.interpnd import InterpND
    from ndarray_interp_tpu.serving import EvaluatorND

    rng = np.random.default_rng(seed)
    axes = [_axis(rng, n, np.float32) for _ in range(3)]
    data = rng.normal(size=(n, n, n)).astype(np.float32)
    qs = [_queries(rng, a, n_queries) for a in axes]
    itp = (
        InterpND.builder(jnp.asarray(data))
        .points(*(jnp.asarray(a) for a in axes))
        .method("cubic").extrapolate(True).build()
    )
    ev = EvaluatorND(itp, max_batch=n_queries, buckets=[n_queries])
    compile_s = _compile_report("P4", ev)
    got = np.asarray(ev(*qs))
    if got.shape != (n_queries,):
        raise AssertionError(f"P4 output shape {got.shape}")
    sub = _subsample(n_queries, seed + 1)
    inr = np.ones(sub.shape[0], bool)
    for a, q in zip(axes, qs):
        inr &= _in_range(a, q[sub])
    want = _tensor_cubic_oracle(
        [a.astype(np.float64) for a in axes], data.astype(np.float64),
        [q[sub] for q in qs], chunk=512,
    )
    err = LegError()
    err.add(got[sub], want, inr)
    res = err.gate(
        f"P4 nd-cubic grid={n}^3 layout={itp.layout} queries={n_queries}",
        TOL_F32, compile_s,
    )
    if card is not None:
        _print_time("P4 serve batch", *median_time(lambda: ev(*qs), 10), card)
    return res


def _df_rep(v):
    """Round f64 values to the nearest double-float-representable value."""
    from ndarray_interp_tpu.ops.df import df_from_f64, df_to_f64

    return df_to_f64(*df_from_f64(v))


def phase_double_float(n_knots=10_000, n2=512, channels=2,
                       n_queries=1 << 20, seed=4, card=None):
    """P5: f64-grade serving -- ``DoubleFloatEvaluator`` on a spline built
    from f64 data, and ``DoubleFloatEvaluator2D`` (double-float and f48
    grades) on an ``(n2, n2, channels)`` bicubic grid."""
    import scipy.interpolate as si

    from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu.interp2d import Bicubic, Interp2D
    from ndarray_interp_tpu.serving import (
        DoubleFloatEvaluator,
        DoubleFloatEvaluator2D,
    )

    prev_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)  # f64 builds
    try:
        rng = np.random.default_rng(seed)
        out = {}
        x = _df_rep(_axis(rng, n_knots, np.float64) / n_knots)
        y = _df_rep(rng.normal(size=n_knots))
        q = _df_rep(_queries(rng, x, n_queries))
        itp = (
            Interp1D.builder(jnp.asarray(y)).x(jnp.asarray(x))
            .strategy(CubicSpline().extrapolate(True)).build()
        )
        ev = DoubleFloatEvaluator(itp, max_batch=n_queries,
                                  buckets=[n_queries])
        compile_s = _compile_report("P5 df-1d", ev)
        got = ev(q)
        sub = _subsample(n_queries, seed + 1)
        err = LegError()
        err.add(got[sub], si.CubicSpline(x, y, bc_type="not-a-knot")(q[sub]),
                _in_range(x, q[sub]))
        out["df_1d"] = err.gate(
            f"P5 df-1d knots={n_knots} queries={n_queries}", TOL_DF, compile_s
        )
        if card is not None:
            _print_time("P5 df-1d serve batch",
                        *median_time(lambda: ev(q), 5), card)

        gx = _df_rep(_axis(rng, n2, np.float64) / n2)
        gy = _df_rep(_axis(rng, n2, np.float64) / n2)
        gz = _df_rep(rng.normal(size=(n2, n2, channels)))
        qx = _df_rep(_queries(rng, gx, n_queries))
        qy = _df_rep(_queries(rng, gy, n_queries))
        itp2 = (
            Interp2D.builder(jnp.asarray(gz)).x(jnp.asarray(gx))
            .y(jnp.asarray(gy)).strategy(Bicubic().extrapolate(True)).build()
        )
        sub = _subsample(n_queries, seed + 2)
        want = _tensor_cubic_oracle((gx, gy), gz, (qx[sub], qy[sub]))
        inr = _in_range(gx, qx[sub]) & _in_range(gy, qy[sub])
        for grade, tol in (("df", TOL_DF), ("f48", TOL_F48)):
            ev2 = DoubleFloatEvaluator2D(
                itp2, max_batch=n_queries, buckets=[n_queries], grade=grade
            )
            compile_s = _compile_report(f"P5 {grade}-2d", ev2)
            got = ev2(qx, qy)
            err = LegError()
            err.add(got[sub], want, inr)
            out[f"{grade}_2d"] = err.gate(
                f"P5 {grade}-2d bicubic grid=({n2},{n2},{channels}) "
                f"queries={n_queries}",
                tol, compile_s,
            )
            if card is not None:
                _print_time(f"P5 {grade}-2d serve batch",
                            *median_time(lambda: ev2(qx, qy), 5), card)
        return out
    finally:
        jax.config.update("jax_enable_x64", prev_x64)


PHASES = (
    phase_cubic_1d,
    phase_cubic_bank,
    phase_grid_2d,
    phase_nd_cubic,
    phase_double_float,
)


# -- dispatch candidates (--timings) -----------------------------------------
def time_search_candidates(card, sizes=(2048, 16384, 262144),
                           n_queries=1 << 20, seed=5):
    """Interval search: ``jnp.searchsorted`` methods, each producing the
    ``(idx, t)`` pair the eval routes consume."""
    rng = np.random.default_rng(seed)
    results = {}
    for n in sizes:
        knots = jnp.asarray(_axis(rng, n, np.float32))
        q = jnp.asarray(_queries(rng, np.asarray(knots), n_queries))
        for method in ("compare_all", "scan", "scan_unrolled", "sort"):
            def frac(k, qq, method=method):
                i = jnp.clip(
                    jnp.searchsorted(k, qq, side="right", method=method)
                    .astype(jnp.int32) - 1, 0, k.shape[0] - 2,
                )
                xl, xr = k[i], k[i + 1]
                return i, (qq - xl) / (xr - xl)

            f = jax.jit(frac)
            med, reps = median_time(lambda: f(knots, q), 10)
            results[(n, method)] = med
            _print_time(f"search n={n} q={n_queries} {method}", med, reps,
                        card)
    return results


def time_build_candidates(card, shapes=((2048, 4096), (64, 1_000_000)),
                          crossover=(64, 128, 256, 512, 1024, 2048),
                          crossover_elems=1 << 26, seed=6):
    """Spline build (not-a-knot, shared knot axis): sequential Thomas scan,
    parallel cyclic reduction and the probed dense operator at the
    deployment shapes, then PCR vs dense over knot counts at a fixed
    bank size (``crossover_elems`` values) for the dense route's bound."""
    from ndarray_interp_tpu.models.strategies import cubic
    from ndarray_interp_tpu.ops.pcr import pcr_solve
    from ndarray_interp_tpu.ops.thomas import thomas_solve

    def solved(solver):
        def build(x, y):
            k = solver(*cubic._tridiag_system(x, y, 0, 0.0, 0, 0.0))
            return cubic._ab_from_k(x, y, k)

        return jax.jit(build)

    cands = {
        "thomas_scan": solved(thomas_solve),
        "pcr": solved(pcr_solve),
        "dense": jax.jit(
            lambda x, y: cubic._dense_ab(x, y, kind=0, periodic=False)
        ),
    }
    rng = np.random.default_rng(seed)
    results = {}
    runs = [(n, bank, tuple(cands)) for n, bank in shapes] + [
        (n, crossover_elems // n, ("pcr", "dense")) for n in crossover
    ]
    for n, bank, names in runs:
        x = jnp.asarray(_axis(rng, n, np.float32))
        y = jnp.asarray(rng.normal(size=(n, bank)).astype(np.float32))
        for name in names:
            f = cands[name]
            med, reps = median_time(lambda: f(x, y), 10)
            results[(n, bank, name)] = med
            _print_time(f"build n={n} bank={bank} {name}", med, reps, card)
        del x, y
    return results


def time_layout_candidates(card, shapes=((128, 1), (64, 4)),
                           n_queries=1 << 20, seed=7):
    """InterpND cubic table layouts (k = 3)."""
    from ndarray_interp_tpu.interpnd import InterpND

    rng = np.random.default_rng(seed)
    results = {}
    for n, r in shapes:
        axes = [jnp.asarray(_axis(rng, n, np.float32)) for _ in range(3)]
        shape = (n, n, n) + ((r,) if r > 1 else ())
        data = jnp.asarray(rng.normal(size=shape).astype(np.float32))
        qs = [jnp.asarray(_queries(rng, np.asarray(a), n_queries))
              for a in axes]
        f = jax.jit(lambda itp, *qq: itp(*qq))
        for layout in ("cell", "node", "node2", "node4"):
            itp = (
                InterpND.builder(data).points(*axes).method("cubic")
                .extrapolate(True).layout(layout).build()
            )
            med, reps = median_time(lambda: f(itp, *qs), 10)
            results[(n, r, layout)] = med
            _print_time(f"nd-layout {n}^3 x {r} q={n_queries} {layout}",
                        med, reps, card)
            del itp
    return results


# -- four cards (--multi) -----------------------------------------------------
def _devices_of(arr):
    return {s.device for s in arr.addressable_shards}


def multi_bank_step(n_devices=4, n_knots=2048, bank=4096, n_queries=65536):
    """Bank- and query-sharded build + eval + grad step, checked against the
    replicated single-logical-device evaluation."""
    import __graft_entry__

    t0 = time.perf_counter()
    res = __graft_entry__.dryrun_multichip(n_devices, n_knots, bank, n_queries)
    used = len(res["devices"])
    print(
        f"M1 bank-sharded step knots={n_knots} bank={bank} "
        f"queries={n_queries}: sharded_vs_replicated={res['diff']:.3e} "
        f"tol={TOL_F32:.0e} devices={used} wall_s={time.perf_counter() - t0:.2f}",
        flush=True,
    )
    if used != n_devices:
        raise AssertionError(f"bank step ran on {used} devices")
    if not res["diff"] <= TOL_F32:
        raise AssertionError("bank-sharded eval diverges")
    return res


def multi_knot_shard(n_devices=4, n_knots=1 << 20, n_queries=65536, seed=8):
    """``parallel.sharded_knot_eval`` on a knot axis split over the mesh,
    checked against the single-device evaluation of the same spline."""
    from jax.sharding import Mesh

    from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu.parallel import (
        pack_knot_shards,
        place_knot_shards,
        sharded_knot_eval,
    )

    rng = np.random.default_rng(seed)
    x = _axis(rng, n_knots, np.float32)
    y = rng.normal(size=n_knots).astype(np.float32)
    q = jnp.asarray(_queries(rng, x, n_queries))
    itp = (
        Interp1D.builder(jnp.asarray(y)).x(jnp.asarray(x))
        .strategy(CubicSpline().extrapolate(True)).build()
    )
    want = np.asarray(jax.jit(lambda t, qq: t(qq))(itp, q))
    mesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("knot",))
    shards = place_knot_shards(
        pack_knot_shards(itp.x, itp.data, itp.strategy.a, itp.strategy.b,
                         n_devices),
        mesh,
    )
    used = len(_devices_of(shards[0]))
    got = np.asarray(jax.jit(
        lambda k, d, a, b, qq: sharded_knot_eval(k, d, a, b, qq, mesh=mesh,
                                                 n=n_knots)
    )(*shards, q))
    err = LegError()
    err.add(got, want, _in_range(x, np.asarray(q)))
    res = err.gate(
        f"M2 knot-sharded knots={n_knots} queries={n_queries} "
        f"devices={used}", TOL_F32, 0.0,
    )
    if used != n_devices:
        raise AssertionError(f"knot shards landed on {used} devices")
    return res


def multi_grid_shard(n_devices=4, n=128, n_queries=65536, seed=9):
    """``parallel.shard_interpnd_grid``: a tricubic cell table split over
    the mesh, checked against the single-device evaluation."""
    from jax.sharding import Mesh

    from ndarray_interp_tpu.interpnd import InterpND
    from ndarray_interp_tpu.parallel import shard_interpnd_grid

    rng = np.random.default_rng(seed)
    axes = [_axis(rng, n, np.float32) for _ in range(3)]
    data = rng.normal(size=(n, n, n)).astype(np.float32)
    itp = (
        InterpND.builder(jnp.asarray(data))
        .points(*(jnp.asarray(a) for a in axes))
        .method("cubic").extrapolate(True).layout("cell").build()
    )
    qs = [jnp.asarray(_queries(rng, a, n_queries)) for a in axes]
    want = np.asarray(jax.jit(lambda t, *qq: t(*qq))(itp, *qs))
    mesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("grid",))
    ev = shard_interpnd_grid(itp, mesh)
    used = len(_devices_of(ev.tbl_shards))
    got = np.asarray(ev(*qs))
    inr = np.ones(n_queries, bool)
    for a, q in zip(axes, qs):
        inr &= _in_range(a, np.asarray(q))
    err = LegError()
    err.add(got, want, inr)
    res = err.gate(
        f"M3 grid-sharded grid={n}^3 queries={n_queries} devices={used} "
        f"table_bytes_per_device={ev.table_bytes_per_device()}",
        TOL_F32, 0.0,
    )
    if used != n_devices:
        raise AssertionError(f"grid shards landed on {used} devices")
    return res


MULTI = (multi_bank_step, multi_knot_shard, multi_grid_shard)


# -- entry point --------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timings", action="store_true",
                    help="add steady-state and dispatch-candidate timings")
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform!r} devices",
              file=sys.stderr)
        return 1
    setup_compile_cache()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__} devices={len(devices)} "
          f"kind={devices[0].device_kind}", flush=True)

    if args.multi:
        if len(devices) < 4:
            print(f"--multi needs four GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 1
        for fn in MULTI:
            fn(n_devices=4)
    else:
        for fn in PHASES:
            fn(card=card if args.timings else None)
        if args.timings:
            time_search_candidates(card)
            time_build_candidates(card)
            time_layout_candidates(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
