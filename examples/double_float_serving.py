"""f64-grade serving in f32 arithmetic with the double-float evaluator.

The double-float path represents every value as an (hi, lo) float32 pair
(~49 mantissa bits) and evaluates with error-free transforms — ≤1e-12
scale-relative vs the f64 oracle (``chip_smoke.py`` phase P5 gates this
on the GPU).

Run: python examples/double_float_serving.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import jax.numpy as jnp

from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D
from ndarray_interp_tpu.serving import DoubleFloatEvaluator


def main():
    rng = np.random.default_rng(0)

    # Build eagerly in f64 on the host: full validation + f64 coefficient
    # solve (enable jax x64 for an f64 build on the CPU backend).
    import jax

    jax.config.update("jax_enable_x64", True)
    n = 4096
    x = jnp.asarray(np.cumsum(rng.uniform(0.1, 1.0, n)))
    data = jnp.asarray(rng.normal(size=n))
    itp = (
        Interp1D.builder(data)
        .x(x)
        .strategy(CubicSpline().extrapolate(True))
        .build()
    )

    # The evaluator splits knots/data/coefficients into (hi, lo) f32
    # pairs once; queries are f64 in, f64 out.
    ev = DoubleFloatEvaluator(itp, max_batch=1 << 16)
    q = rng.uniform(float(x[0]), float(x[-1]), 50_000)
    out = ev(q)

    want = np.asarray(itp.interp_array(q))  # f64 oracle (CPU)
    scale = np.maximum(np.abs(want), 0.01 * np.abs(want).max())
    rel = (np.abs(out - want) / scale).max()
    print(f"double-float vs f64 oracle, max scale-relative error: {rel:.2e}")
    assert rel < 1e-9

    # 2-D: f64-grade bicubic serving (round 3) — same pattern, the
    # evaluator splits the strategy's pre-scaled cell table once
    from ndarray_interp_tpu.interp2d import Bicubic, Interp2D
    from ndarray_interp_tpu.serving import DoubleFloatEvaluator2D

    gx = np.cumsum(rng.uniform(0.2, 1.0, 48))
    gy = np.cumsum(rng.uniform(0.2, 1.0, 40))
    gz = rng.normal(size=(48, 40, 4))
    itp2 = (
        Interp2D.builder(jnp.asarray(gz))
        .x(jnp.asarray(gx))
        .y(jnp.asarray(gy))
        .strategy(Bicubic().extrapolate(True))
        .build()
    )
    ev2 = DoubleFloatEvaluator2D(itp2, max_batch=1 << 15)
    qx = rng.uniform(gx[0], gx[-1], 20_000)
    qy = rng.uniform(gy[0], gy[-1], 20_000)
    out2 = ev2(qx, qy)
    want2 = np.asarray(itp2.interp_array(qx, qy))
    scale2 = np.maximum(np.abs(want2), 0.01 * np.abs(want2).max())
    rel2 = (np.abs(out2 - want2) / scale2).max()
    print(f"double-float bicubic 2-D, max scale-relative error: {rel2:.2e}")
    assert rel2 < 1e-9


if __name__ == "__main__":
    main()
