"""CPU-host serving with the native C++ runtime.

The device (XLA) path owns batched workloads; hosts without an
accelerator — or latency-critical scalar lookups where device dispatch
would dominate — serve through the native runtime instead
(``ndarray_interp_tpu.native``): even-spacing guess/verify blocks for
flat linear/Hermite banks (AVX-512 gathers where the compiler targets
them), plus batched bilinear and bicubic (node-state nested Hermite).
The eager scalar entry points (``interp_scalar``) pick the native path
automatically when it is available.

Run: python examples/native_host_serving.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from ndarray_interp_tpu import native


def main():
    if not native.HAVE_NATIVE:
        print("native runtime unavailable — build it with "
              "`python -m ndarray_interp_tpu.native.build`")
        return

    rng = np.random.default_rng(0)

    # 1-D cubic bank, built on the host (no accelerator needed)
    n = 4096
    x = np.cumsum(rng.uniform(0.5, 1.5, n))
    y = rng.normal(size=n)
    a, b = native.cubic_build(x, y, 0, 0.0, 0, 0.0)  # not-a-knot both ends
    q = rng.uniform(x[0], x[-1], 100_000)
    out, rc = native.eval_hermite(x, y, a, b, q, mode=1)
    assert rc == 0
    print(f"1-D cubic: {out.shape[0]} queries, first={out[0]:.6f}")

    # scalar serving objects (the ~microsecond per-call path)
    s1 = native.ScalarEval1D(x, y, a, b, mode=1)
    v, err = s1(float(x[10]))
    assert err == 0
    print(f"scalar eval at x={x[10]:.3f}: {v:.6f} (== y[10] {y[10]:.6f})")

    # 2-D bicubic: build the spline derivative grids with the same
    # batched solves the jax strategy uses, then serve natively
    import jax.numpy as jnp

    from ndarray_interp_tpu.interp2d import bicubic_node_grids

    nx, ny = 200, 160
    gx = np.cumsum(rng.uniform(0.5, 1.5, nx))
    gy = np.cumsum(rng.uniform(0.5, 1.5, ny))
    z = rng.normal(size=(nx, ny))
    kx, ky, kxy = (
        np.asarray(g)
        for g in bicubic_node_grids(
            jnp.asarray(gx), jnp.asarray(gy), jnp.asarray(z)
        )
    )
    qx = rng.uniform(gx[0], gx[-1], 50_000)
    qy = rng.uniform(gy[0], gy[-1], 50_000)
    out2, rc = native.eval_bicubic(gx, gy, z, kx, ky, kxy, qx, qy, False)
    assert rc == 0
    print(f"2-D bicubic: {out2.shape[0]} queries, first={out2[0]:.6f}")


if __name__ == "__main__":
    main()
