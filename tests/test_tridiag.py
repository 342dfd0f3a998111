"""Tridiagonal dispatch: parallel cyclic reduction off the CPU, the
reference-order scan on it.  PCR's agreement with the scan solver is
checked on the CPU; which solver a GPU program runs is read from the
program exported for CUDA."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import export

from ndarray_interp_tpu.ops.pcr import pcr_solve
from ndarray_interp_tpu.ops.thomas import thomas_solve, thomas_solve_fast


def system(n, bank, seed=None):
    rng = np.random.default_rng(seed if seed is not None else n)
    # diagonally dominant system (like the spline systems)
    dx = rng.uniform(0.5, 2.0, n)
    a_up = jnp.asarray(np.roll(dx, 1), jnp.float32)
    a_low = jnp.asarray(dx, jnp.float32)
    a_mid = jnp.asarray(2.2 * (dx + np.roll(dx, 1)), jnp.float32)
    rhs = jnp.asarray(rng.normal(size=(n, bank)).astype(np.float32))
    return a_up, a_mid, a_low, rhs


@pytest.mark.parametrize("n,bank", [(8, 4), (33, 16), (128, 8)])
def test_kernel_matches_scan(n, bank):
    """PCR (the GPU solver) agrees with the scan to f32 rounding."""
    a_up, a_mid, a_low, rhs = system(n, bank)
    got = np.asarray(jax.jit(pcr_solve)(a_up, a_mid, a_low, rhs))
    want = np.asarray(thomas_solve(a_up, a_mid, a_low, rhs))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


def test_dispatch_falls_back_on_cpu():
    """On the CPU the dispatch IS the scan: bit-identical."""
    a_up, a_mid, a_low, rhs = system(16, 3, seed=0)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(thomas_solve_fast)(a_up, a_mid, a_low, rhs)),
        np.asarray(jax.jit(thomas_solve)(a_up, a_mid, a_low, rhs)),
    )


@pytest.mark.parametrize("n,bank", [(8, 4), (64, 16)])
def test_batched_kernel_matches_scan(n, bank):
    """Per-row (batched) diagonals, as ``Individual`` boundaries build."""
    rng = np.random.default_rng(n + 1)
    dx = rng.uniform(0.5, 2.0, (n, bank))
    a_up = jnp.asarray(np.roll(dx, 1, axis=0), jnp.float32)
    a_low = jnp.asarray(dx, jnp.float32)
    a_mid = jnp.asarray(
        2.2 * (dx + np.roll(dx, 1, axis=0)), jnp.float32
    )
    rhs = jnp.asarray(rng.normal(size=(n, bank)).astype(np.float32))
    got = np.asarray(jax.jit(pcr_solve)(a_up, a_mid, a_low, rhs))
    want = np.asarray(thomas_solve(a_up, a_mid, a_low, rhs))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("platform, has_loop", [("cuda", False), ("cpu", True)])
def test_platform_arms(platform, has_loop):
    """The program lowered for CUDA carries PCR (unrolled levels, no
    loop); the CPU program carries the scan's while loop."""
    a_up, a_mid, a_low, rhs = system(64, 8, seed=2)
    text = export.export(jax.jit(thomas_solve_fast), platforms=[platform])(
        a_up, a_mid, a_low, rhs
    ).mlir_module()
    assert ("stablehlo.while" in text) == has_loop
