"""On-card checks (``gpu`` marker): each skips through the ``gpu`` fixture
when JAX sees no GPU.  Run on the card with
``NDI_TESTS_ON_GPU=1 python -m pytest -m gpu tests/test_gpu.py``."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize(
    "phase, kwargs",
    [
        (chip_smoke.phase_cubic_1d, dict(n_knots=2048, n_queries=1 << 16)),
        (chip_smoke.phase_cubic_bank,
         dict(n_knots=256, bank=512, n_queries=1 << 14)),
        (chip_smoke.phase_grid_2d, dict(n=128, channels=2, n_queries=1 << 16)),
        (chip_smoke.phase_nd_cubic, dict(n=24, n_queries=1 << 15)),
        (chip_smoke.phase_double_float,
         dict(n_knots=2000, n2=64, channels=2, n_queries=1 << 15)),
    ],
    ids=["P1", "P2", "P3", "P4", "P5"],
)
def test_smoke_phase_on_card(gpu, phase, kwargs):
    out = phase(**kwargs)
    for res in out.values() if "in" not in out else [out]:
        assert res["in"] <= res["tol"] and res["out"] <= res["tol"], res


def test_card_matches_cpu_reference_order_build(gpu):
    """The PCR build on the card agrees with the CPU's scan build to f32
    rounding."""
    import jax
    import jax.numpy as jnp

    from ndarray_interp_tpu.interp1d import CubicSpline

    rng = np.random.default_rng(0)
    x = np.cumsum(rng.uniform(0.5, 1.5, 500)).astype(np.float32)
    y = rng.normal(size=(500, 64)).astype(np.float32)

    def build(xx, yy):
        return CubicSpline().build(xx, yy).a

    card = np.asarray(jax.jit(build)(jnp.asarray(x), jnp.asarray(y)))
    cpu = jax.devices("cpu")[0]
    ref = np.asarray(jax.jit(build)(
        jax.device_put(x, cpu), jax.device_put(y, cpu)
    ))
    np.testing.assert_allclose(card, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
