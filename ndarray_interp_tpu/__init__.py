"""ndarray-interp-tpu — a JAX/XLA interpolation framework for accelerators.

A ground-up rebuild of the capabilities of the Rust crate
``ndarray-interp`` v0.6.0 (``/root/reference``), designed for batched
accelerator execution:

* interpolators are registered pytrees — they flow through ``jit`` /
  ``vmap`` / ``grad`` / ``pjit`` directly,
* evaluation is a fused bucketize → gather → polynomial program over the
  whole query batch (one device launch, not a host loop),
* cubic-spline construction is a batched tridiagonal (Thomas) solve
  vectorized over the entire spline bank,
* large banks/query sets shard over a ``jax.sharding.Mesh``
  (see :mod:`ndarray_interp_tpu.parallel`).

1-D usage (mirrors the reference crate docs, ``src/lib.rs:35-72``)::

    import jax.numpy as jnp
    from ndarray_interp_tpu import interp1d

    data = jnp.array([0.0, 1.0, 1.5, 1.0, 0.0])
    interp = interp1d.Interp1DBuilder(data).build()
    interp.interp_scalar(3.5)                      # == 0.5
    interp.interp_array(jnp.array([0.0, 0.5, 1.5]))
"""

from .errors import (
    BuilderError,
    BuilderValueError,
    InterpolateError,
    MonotonicError,
    NotEnoughDataError,
    OutOfBoundsError,
    ShapeError,
)

__version__ = "0.1.0"

__all__ = [
    "BuilderError",
    "BuilderValueError",
    "InterpolateError",
    "MonotonicError",
    "NotEnoughDataError",
    "OutOfBoundsError",
    "ShapeError",
    "interp1d",
    "interp2d",
    "interpnd",
]

from . import interp1d  # noqa: E402
from . import interp2d  # noqa: E402
from . import interpnd  # noqa: E402
