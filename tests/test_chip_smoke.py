"""``chip_smoke.py`` at tiny sizes on the CPU: every phase's plumbing and
its oracle comparison, the four-device paths on the virtual CPU mesh, and
the refusal to run without a GPU."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def _ok(res):
    assert res["in"] <= res["tol"] and res["out"] <= res["tol"], res


def test_cubic_1d_phase():
    _ok(chip_smoke.phase_cubic_1d(n_knots=64, n_queries=4096))


def test_cubic_bank_phase():
    _ok(chip_smoke.phase_cubic_bank(n_knots=32, bank=16, n_queries=2048))


def test_grid_2d_phase():
    out = chip_smoke.phase_grid_2d(n=20, channels=2, n_queries=2048)
    assert set(out) == {"bicubic", "bilinear"}
    for res in out.values():
        _ok(res)


def test_nd_cubic_phase():
    _ok(chip_smoke.phase_nd_cubic(n=10, n_queries=2048))


def test_double_float_phase():
    out = chip_smoke.phase_double_float(
        n_knots=200, n2=16, channels=2, n_queries=2048
    )
    assert set(out) == {"df_1d", "df_2d", "f48_2d"}
    for res in out.values():
        _ok(res)


@pytest.mark.parametrize(
    "fn, kwargs",
    [
        (chip_smoke.multi_bank_step,
         dict(n_knots=32, bank=16, n_queries=512)),
        (chip_smoke.multi_knot_shard, dict(n_knots=3000, n_queries=2048)),
        (chip_smoke.multi_grid_shard, dict(n=9, n_queries=2048)),
    ],
)
def test_multi_paths_on_virtual_mesh(fn, kwargs):
    """The ``--multi`` legs on four of the eight virtual CPU devices; each
    checks that its shards landed on four distinct devices."""
    fn(n_devices=4, **kwargs)


def test_tensor_oracle_matches_separable_product():
    """The sequential-spline oracle is exact on a separable cubic
    polynomial (a not-a-knot spline reproduces cubics)."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 1, 9))
    y = np.sort(rng.uniform(0, 1, 7))
    z = (x**3)[:, None] * (1 + y - y**2)[None, :]
    qx, qy = rng.uniform(0, 1, 50), rng.uniform(0, 1, 50)
    got = chip_smoke._tensor_cubic_oracle((x, y), z, (qx, qy), chunk=16)
    np.testing.assert_allclose(got, qx**3 * (1 + qy - qy**2), atol=1e-12)


def test_leg_error_gates_each_leg():
    err = chip_smoke.LegError()
    want = np.array([1.0, 2.0, 1000.0])
    err.add(np.array([1.0, 2.001, 1000.0]), want, np.array([1, 1, 0], bool))
    assert err.rel(True) == pytest.approx(0.001 / 2.0)
    assert err.rel(False) == 0.0
    with pytest.raises(AssertionError):
        err.gate("leg", 1e-5, 0.0)
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke.LegError().add(np.array([np.nan]), np.array([1.0]),
                                  np.array([True]))


def test_main_refuses_cpu(capsys):
    """On a machine without a GPU the script exits non-zero and prints no
    result line."""
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out
