"""Headline benchmark: 1-D cubic-spline query throughput on one GPU.

The NS1 workload (BASELINE.md): a 2,048-knot not-a-knot spline built
through the validating builder, 1M f32 queries per batch served by
``serving.Evaluator``.  The CPU baseline is SciPy's ``CubicSpline`` on
the same host (the reference crate's own numerical oracle).  Secondary
numbers: the build of a 10k-knot × 64-spline bank, and evaluation on it.

Every device time is the median over repeats of one call that ends in
``block_until_ready``; compilation happens before the timed window.
Prints ONE JSON line naming the device, the card and its power limit.
Exits non-zero, printing nothing on stdout, when JAX finds no GPU.

    python bench.py
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from chip_smoke import card_line, median_time, setup_compile_cache


def _scipy_qps(knots, values, queries, runs=3):
    import scipy.interpolate as si

    cs = si.CubicSpline(knots, values, bc_type="not-a-knot")
    rates = []
    for _ in range(runs):
        t0 = time.perf_counter()
        cs(queries)
        rates.append(queries.shape[0] / (time.perf_counter() - t0))
    return float(np.median(rates))


def main():
    import jax
    import jax.numpy as jnp

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform!r} devices",
              file=sys.stderr)
        return 1
    setup_compile_cache()
    card = card_line()

    from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D
    from ndarray_interp_tpu.serving import Evaluator

    n_knots, n_q = 2048, 1 << 20
    rng = np.random.default_rng(42)
    knots = np.linspace(0.0, 100.0, n_knots)
    values = rng.normal(size=n_knots)
    queries = rng.uniform(0.0, 100.0, n_q)

    itp = (
        Interp1D.builder(jnp.asarray(values, jnp.float32))
        .x(jnp.asarray(knots, jnp.float32))
        .strategy(CubicSpline().extrapolate(True))
        .build()
    )
    ev = Evaluator(itp, max_batch=n_q, buckets=[n_q]).warmup()
    q_d = jnp.asarray(queries, jnp.float32)
    t_eval, reps_eval = median_time(lambda: ev(q_d), 20)

    # secondary: build and eval of a 10k-knot x 64 bank
    bank = jnp.asarray(rng.normal(size=(10_000, 64)).astype(np.float32))
    xb = jnp.asarray(np.linspace(0.0, 1.0, 10_000), jnp.float32)
    strat = CubicSpline().extrapolate(True)
    build = jax.jit(lambda x, d: strat.build(x, d).a)
    t_build, _ = median_time(lambda: build(xb, bank), 10)
    itp10 = Interp1D.builder(bank).x(xb).strategy(strat).build()
    nq10 = 1 << 18
    ev10 = Evaluator(itp10, max_batch=nq10, buckets=[nq10]).warmup()
    q10 = jnp.asarray(rng.uniform(0.0, 1.0, nq10).astype(np.float32))
    t_bank, _ = median_time(lambda: ev10(q10), 10)

    scipy_qps = _scipy_qps(knots, values, queries)
    our_qps = n_q / t_eval
    print(json.dumps({
        "metric": "queries/sec (1D cubic, 2k knots, 1M queries per batch)",
        "value": our_qps,
        "unit": "queries/s",
        "vs_baseline": our_qps / scipy_qps,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
        "card": card,
        "extra": {
            "eval_s_1M_median": t_eval,
            "eval_reps": reps_eval,
            "scipy_cpu_qps": scipy_qps,
            "build_s_10k_knot_x64_bank": t_build,
            "eval_s_10k_knot_x64_bank_per_256k_q": t_bank,
            "dtype": "float32",
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
