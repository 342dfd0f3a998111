"""ctypes bindings for the native host runtime.

``HAVE_NATIVE`` is False when the shared library is absent and cannot be
built (no compiler); all callers must degrade to the JAX path.  The
library auto-builds on first import when a compiler is available, from
the committed sources, under a name keyed by their hash and the build
flags (``native/build.py``).
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np

_lib = None
HAVE_NATIVE = False


def _load():
    global _lib, HAVE_NATIVE
    if _lib is not None:
        return _lib
    from .build import build, library_path

    so = library_path()
    if not so.exists():
        try:
            build(verbose=False)
        except (OSError, subprocess.CalledProcessError):
            return None
    try:
        _lib = ctypes.CDLL(str(so))
    except OSError:
        return None

    c_i64 = ctypes.c_int64
    c_int = ctypes.c_int
    pd = ctypes.POINTER(ctypes.c_double)
    pf = ctypes.POINTER(ctypes.c_float)
    pi = ctypes.POINTER(ctypes.c_int64)

    pint = ctypes.POINTER(ctypes.c_int)
    _lib.ndi_scalar_linear_f64.restype = ctypes.c_double
    _lib.ndi_scalar_linear_f64.argtypes = [
        pd, pd, c_i64, ctypes.c_double, c_int, pint,
    ]
    _lib.ndi_scalar_hermite_f64.restype = ctypes.c_double
    _lib.ndi_scalar_hermite_f64.argtypes = [
        pd, pd, pd, pd, c_i64, ctypes.c_double, c_int, pint,
    ]
    _lib.ndi_scalar_bilinear_f64.restype = ctypes.c_double
    _lib.ndi_scalar_bilinear_f64.argtypes = [
        pd, pd, pd, c_i64, c_i64, ctypes.c_double, ctypes.c_double,
        c_int, pint,
    ]
    _lib.ndi_cubic_build_f64.restype = c_int
    _lib.ndi_cubic_build_f64.argtypes = [
        pd, pd, c_i64, c_i64, c_int, ctypes.c_double, c_int,
        ctypes.c_double, pd, pd,
    ]
    _lib.ndi_cubic_build_f32.restype = c_int
    _lib.ndi_cubic_build_f32.argtypes = [
        pf, pf, c_i64, c_i64, c_int, ctypes.c_float, c_int,
        ctypes.c_float, pf, pf,
    ]
    _lib.ndi_lower_index_f64.restype = c_i64
    _lib.ndi_lower_index_f64.argtypes = [pd, c_i64, ctypes.c_double]
    _lib.ndi_lower_index_f32.restype = c_i64
    _lib.ndi_lower_index_f32.argtypes = [pf, c_i64, ctypes.c_float]
    _lib.ndi_lower_index_batch_f64.restype = None
    _lib.ndi_lower_index_batch_f64.argtypes = [pd, c_i64, pd, c_i64, pi]
    _lib.ndi_monotonic_f64.restype = c_int
    _lib.ndi_monotonic_f64.argtypes = [pd, c_i64]
    _lib.ndi_eval_linear_f64.restype = c_i64
    _lib.ndi_eval_linear_f64.argtypes = [pd, pd, c_i64, c_i64, pd, c_i64, pd, c_int]
    _lib.ndi_eval_linear_f32.restype = c_i64
    _lib.ndi_eval_linear_f32.argtypes = [pf, pf, c_i64, c_i64, pf, c_i64, pf, c_int]
    _lib.ndi_eval_hermite_f64.restype = c_i64
    _lib.ndi_eval_hermite_f64.argtypes = [
        pd, pd, pd, pd, c_i64, c_i64, pd, c_i64, pd, c_int,
    ]
    _lib.ndi_eval_hermite_f32.restype = c_i64
    _lib.ndi_eval_hermite_f32.argtypes = [
        pf, pf, pf, pf, c_i64, c_i64, pf, c_i64, pf, c_int,
    ]
    _lib.ndi_eval_bilinear_f64.restype = c_i64
    _lib.ndi_eval_bilinear_f64.argtypes = [
        pd, pd, pd, c_i64, c_i64, c_i64, pd, pd, c_i64, pd, c_int,
    ]
    _lib.ndi_eval_bilinear_f32.restype = c_i64
    _lib.ndi_eval_bilinear_f32.argtypes = [
        pf, pf, pf, c_i64, c_i64, c_i64, pf, pf, c_i64, pf, c_int,
    ]
    _lib.ndi_eval_bicubic_f64.restype = c_i64
    _lib.ndi_eval_bicubic_f64.argtypes = [
        pd, pd, pd, pd, pd, pd, c_i64, c_i64, c_i64, pd, pd, c_i64, pd,
        c_int,
    ]
    _lib.ndi_eval_bicubic_f32.restype = c_i64
    _lib.ndi_eval_bicubic_f32.argtypes = [
        pf, pf, pf, pf, pf, pf, c_i64, c_i64, c_i64, pf, pf, c_i64, pf,
        c_int,
    ]
    HAVE_NATIVE = True
    return _lib


def _ptr(arr):
    return arr.ctypes.data_as(
        ctypes.POINTER(
            ctypes.c_double if arr.dtype == np.float64 else ctypes.c_float
        )
    )


def _prep(arr, dtype):
    return np.ascontiguousarray(arr, dtype=dtype)


def lower_index(x: np.ndarray, q: float) -> int:
    lib = _load()
    x = _prep(x, np.float64)
    return int(lib.ndi_lower_index_f64(_ptr(x), x.shape[0], float(q)))


def monotonic(x: np.ndarray) -> int:
    lib = _load()
    x = _prep(x, np.float64)
    return int(lib.ndi_monotonic_f64(_ptr(x), x.shape[0]))


def eval_linear(x, y, q, extrapolate: bool):
    """Returns (out, oob_index_or_0); y shape (n, *trailing)."""
    lib = _load()
    dt = np.float64 if np.result_type(x, y, q) == np.float64 else np.float32
    x = _prep(x, dt)
    yc = _prep(y, dt).reshape(y.shape[0], -1)
    qc = _prep(np.atleast_1d(q), dt).reshape(-1)
    out = np.empty((qc.shape[0], yc.shape[1]), dt)
    fn = lib.ndi_eval_linear_f64 if dt == np.float64 else lib.ndi_eval_linear_f32
    rc = fn(
        _ptr(x), _ptr(yc), x.shape[0], yc.shape[1], _ptr(qc), qc.shape[0],
        _ptr(out), int(extrapolate),
    )
    return out.reshape(np.shape(q) + y.shape[1:]), int(rc)


def eval_hermite(x, y, a, b, q, mode: int):
    """mode: 0 error-on-OOB, 1 extrapolate, 2 periodic."""
    lib = _load()
    dt = np.float64 if np.result_type(x, y) == np.float64 else np.float32
    x = _prep(x, dt)
    yc = _prep(y, dt).reshape(y.shape[0], -1)
    ac = _prep(a, dt).reshape(a.shape[0], -1)
    bc = _prep(b, dt).reshape(b.shape[0], -1)
    qc = _prep(np.atleast_1d(q), dt).reshape(-1)
    out = np.empty((qc.shape[0], yc.shape[1]), dt)
    fn = (
        lib.ndi_eval_hermite_f64 if dt == np.float64 else lib.ndi_eval_hermite_f32
    )
    rc = fn(
        _ptr(x), _ptr(yc), _ptr(ac), _ptr(bc), x.shape[0], yc.shape[1],
        _ptr(qc), qc.shape[0], _ptr(out), int(mode),
    )
    return out.reshape(np.shape(q) + y.shape[1:]), int(rc)


def _check_query_pair(qxc, qyc):
    # the C++ loops read qy[i] for i in [0, len(qx)) — a silent OOB read
    # on mismatched inputs without this guard
    if qxc.shape != qyc.shape:
        raise ValueError(
            f"`xs.shape` and `ys.shape` do not match: {qxc.shape} vs "
            f"{qyc.shape}"
        )


def eval_bilinear(x, y, z, qx, qy, extrapolate: bool):
    lib = _load()
    dt = np.float64 if np.result_type(x, y, z) == np.float64 else np.float32
    x = _prep(x, dt)
    y = _prep(y, dt)
    zc = _prep(z, dt).reshape(z.shape[0], z.shape[1], -1)
    qxc = _prep(np.atleast_1d(qx), dt).reshape(-1)
    qyc = _prep(np.atleast_1d(qy), dt).reshape(-1)
    _check_query_pair(qxc, qyc)
    out = np.empty((qxc.shape[0], zc.shape[2]), dt)
    fn = (
        lib.ndi_eval_bilinear_f64
        if dt == np.float64
        else lib.ndi_eval_bilinear_f32
    )
    rc = fn(
        _ptr(x), _ptr(y), _ptr(zc), x.shape[0], y.shape[0], zc.shape[2],
        _ptr(qxc), _ptr(qyc), qxc.shape[0], _ptr(out), int(extrapolate),
    )
    return out.reshape(np.shape(qx) + z.shape[2:]), int(rc)


def eval_bicubic(x, y, f, kx, ky, kxy, qx, qy, extrapolate: bool):
    """Tensor-product cubic (beyond-reference Bicubic) on the host.

    ``f`` is the ``(nx, ny, *trailing)`` grid; ``kx``/``ky``/``kxy`` its
    spline derivative grids (the strategy's node state — build them with
    the same batched solves as ``models/strategies/bicubic.Bicubic``).
    Returns ``(out, oob_code)``: positive = 1-based x OOB index,
    negative = y, 0 = ok (mirroring :func:`eval_bilinear`)."""
    lib = _load()
    dt = np.float64 if np.result_type(x, y, f) == np.float64 else np.float32
    x = _prep(x, dt)
    y = _prep(y, dt)
    fc = _prep(f, dt).reshape(f.shape[0], f.shape[1], -1)
    kxc = _prep(kx, dt).reshape(fc.shape)
    kyc = _prep(ky, dt).reshape(fc.shape)
    kxyc = _prep(kxy, dt).reshape(fc.shape)
    qxc = _prep(np.atleast_1d(qx), dt).reshape(-1)
    qyc = _prep(np.atleast_1d(qy), dt).reshape(-1)
    _check_query_pair(qxc, qyc)
    out = np.empty((qxc.shape[0], fc.shape[2]), dt)
    fn = (
        lib.ndi_eval_bicubic_f64
        if dt == np.float64
        else lib.ndi_eval_bicubic_f32
    )
    rc = fn(
        _ptr(x), _ptr(y), _ptr(fc), _ptr(kxc), _ptr(kyc), _ptr(kxyc),
        x.shape[0], y.shape[0], fc.shape[2], _ptr(qxc), _ptr(qyc),
        qxc.shape[0], _ptr(out), int(extrapolate),
    )
    return out.reshape(np.shape(qx) + f.shape[2:]), int(rc)


def cubic_build(x, y, left_kind, left_val, right_kind, right_val):
    """Uniform-boundary cubic coefficient build on the host.

    Returns ``(a, b)`` with shape ``(n-1, *y.shape[1:])``; kind codes:
    0 not-a-knot, 1 first-deriv, 2 second-deriv.
    """
    lib = _load()
    dt = np.float64 if np.result_type(x, y) == np.float64 else np.float32
    xc = _prep(x, dt)
    yc = _prep(y, dt).reshape(y.shape[0], -1)
    n, m = yc.shape
    a = np.empty((n - 1, m), dt)
    b = np.empty((n - 1, m), dt)
    fn = lib.ndi_cubic_build_f64 if dt == np.float64 else lib.ndi_cubic_build_f32
    rc = fn(
        _ptr(xc), _ptr(yc), n, m, int(left_kind), float(left_val),
        int(right_kind), float(right_val), _ptr(a), _ptr(b),
    )
    if rc != 0:
        raise ValueError("cubic_build failed (need at least 3 points)")
    tail = y.shape[1:]
    return a.reshape((n - 1,) + tail), b.reshape((n - 1,) + tail)


class ScalarEval1D:
    """Prebound scalar evaluator: caches contiguous f64 buffers and ctypes
    pointers once, so each ``interp_scalar`` is one C call (~µs)."""

    def __init__(self, x, y, a=None, b=None, mode=0):
        lib = _load()
        self._err = ctypes.c_int(0)
        self._x = _prep(x, np.float64)
        self._y = _prep(y, np.float64)
        self._n = self._x.shape[0]
        self._xp = _ptr(self._x)
        self._yp = _ptr(self._y)
        self._mode = int(mode)
        if a is None:
            self._fn = lib.ndi_scalar_linear_f64
            self._args = (self._xp, self._yp, self._n)
        else:
            self._a = _prep(a, np.float64)
            self._b = _prep(b, np.float64)
            self._ap = _ptr(self._a)
            self._bp = _ptr(self._b)
            self._fn = lib.ndi_scalar_hermite_f64
            self._args = (self._xp, self._yp, self._ap, self._bp, self._n)

    def __call__(self, q: float):
        """Returns (value, err): err 0 ok, 1 OOB, 2 NaN."""
        err = self._err
        v = self._fn(*self._args, q, self._mode, ctypes.byref(err))
        return v, err.value


class ScalarEval2D:
    def __init__(self, x, y, z, extrapolate: bool):
        lib = _load()
        self._err = ctypes.c_int(0)
        self._x = _prep(x, np.float64)
        self._y = _prep(y, np.float64)
        self._z = _prep(z, np.float64)
        self._args = (
            _ptr(self._x),
            _ptr(self._y),
            _ptr(self._z),
            self._x.shape[0],
            self._y.shape[0],
        )
        self._extrap = int(extrapolate)
        self._fn = lib.ndi_scalar_bilinear_f64

    def __call__(self, qx: float, qy: float):
        """Returns (value, err): 0 ok, 1 x-OOB, -1 y-OOB, 2 NaN."""
        err = self._err
        v = self._fn(*self._args, qx, qy, self._extrap, ctypes.byref(err))
        return v, err.value


# try to load eagerly so HAVE_NATIVE is accurate at import time
_load()
