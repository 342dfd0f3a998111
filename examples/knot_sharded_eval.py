"""Knot-axis sharding demo: an axis too long for one device, split over
a mesh with a one-knot halo per shard.

Run on the 8-virtual-device CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/knot_sharded_eval.py

On a multi-GPU host the same code runs unchanged — the mesh axis simply
maps to cards (see ``parallel.multihost`` for the multi-process
bootstrap; ``tests/multihost_worker.py`` runs this pattern across
processes).
"""

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ndarray_interp_tpu.interp1d import CubicSpline, Interp1D
from ndarray_interp_tpu.ops.knotshard import shard_interp1d_knots

mesh = Mesh(np.asarray(jax.devices()), ("knot",))
print(f"mesh: {mesh.devices.size} devices on axis 'knot'")

# a (long-axis) spline bank, built normally on one logical device
rng = np.random.default_rng(0)
n, bank = 100_000, 8
x = jnp.asarray(np.cumsum(rng.uniform(0.1, 1.0, n)).astype(np.float32))
data = jnp.asarray(rng.normal(size=(n, bank)).astype(np.float32))
itp = (
    Interp1D.builder(data)
    .x(x)
    .strategy(CubicSpline().extrapolate(True))
    .build()
)

# shard the knot/coefficient axis over the mesh: each device holds
# 1/8th of the axis plus a one-knot halo; evaluation needs no exchange
ev = shard_interp1d_knots(itp, mesh)

q = jnp.asarray(
    rng.uniform(float(x[0]), float(x[-1]), 10_000).astype(np.float32)
)
got = jax.jit(ev)(q)
want = itp.interp_array(q)
err = float(jnp.max(jnp.abs(got - want) / jnp.maximum(jnp.abs(want), 1e-2)))
print(f"sharded vs single-device: max scale-relative diff = {err:.2e}")
assert err < 1e-4
print("OK")
