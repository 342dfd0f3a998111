"""Spline bank at scale: many independent cubic splines on a device mesh.

BASELINE.json config 5: a large bank of independent 1-D cubic splines
sharded over a mesh, bf16 query streams against f32 coefficients.

Construction (the batched Thomas solve) is elementwise across the bank, so
the bank axis shards with zero communication; queries broadcast to every
device, which evaluates its own shard of splines.  On a multi-GPU host
the mesh spans the cards; here it runs on whatever devices exist
(8 virtual CPU devices with the command below).

Run: ``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/spline_bank_sharded.py``
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D
from ndarray_interp_tpu.models.strategies.cubic import CubicSplineStrategy
from ndarray_interp_tpu.parallel import make_mesh


def main(n_knots=64, bank=32_768, n_queries=2048):
    mesh = make_mesh(axis_names=("bank",))
    print(f"mesh: {mesh}")

    rng = np.random.default_rng(0)
    x = jnp.asarray(np.linspace(0.0, 1.0, n_knots), jnp.float32)
    data = jax.device_put(
        jnp.asarray(rng.normal(size=(n_knots, bank)).astype(np.float32)),
        NamedSharding(mesh, P(None, "bank")),
    )

    strat = CubicSpline().extrapolate(True)

    @jax.jit
    def build(x, data):
        s = strat.build(x, data)
        return s.a, s.b

    a, b = build(x, data)  # bank-sharded, zero-communication
    print(f"coefficients: {a.shape}, sharding {a.sharding.spec}")

    itp = Interp1D.new_unchecked(x, data, CubicSplineStrategy(a, b, "yes"))

    # bf16 query stream, replicated to all devices; f32 math inside
    queries = jnp.asarray(
        rng.uniform(0.0, 1.0, n_queries).astype(np.float32)
    ).astype(jnp.bfloat16)

    fast = jax.jit(lambda t, q: t(q))
    out = fast(itp, queries)
    print(f"output: {out.shape} {out.dtype}, sharding {out.sharding.spec}")

    # sanity: one spline vs an unsharded single build
    col = int(rng.integers(0, bank))
    single = (
        Interp1D.builder(np.asarray(data[:, col]))
        .x(np.asarray(x))
        .strategy(CubicSpline().extrapolate(True))
        .build()
    )
    ref = single.interp_array(np.asarray(queries, np.float32))
    err = float(jnp.max(jnp.abs(out[:, col] - jnp.asarray(np.asarray(ref)))))
    print(f"max err vs single-spline build (column {col}): {err:.3e}")
    assert err < 1e-4
    print("OK")


if __name__ == "__main__":
    main()
