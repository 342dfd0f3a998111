"""User-defined interpolation strategy: nearest/step interpolator.

Port of the reference's extension-point demo
(``/root/reference/examples/custom_strategy.rs``): implement a strategy
using only the public driver helpers (``get_index_left_of`` /
``index_point``) and plug it into the builder.

Two equivalent styles are shown:

* ``StepInterpolator`` — pointwise, the literal analogue of the Rust
  example: write the math for ONE query point, inherit vectorization from
  ``vmap`` via :class:`PointwiseStrategy`.
* ``StepInterpolatorBatched`` — batched: write the math for the
  whole flat query batch directly.

Run: ``python examples/custom_strategy.py``
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class

from ndarray_interp_tpu.interp1d import (
    Interp1D,
    Interp1DStrategy,
    Interp1DStrategyBuilder,
    PointwiseStrategy,
)


@register_pytree_node_class
class StepInterpolator(PointwiseStrategy):
    """Nearest-neighbour (midpoint step): pointwise formulation
    (mirrors custom_strategy.rs:38-53)."""

    MINIMUM_DATA_LENGTH = 2
    # the Rust example never errors on out-of-range queries — it clamps
    extrapolates = True

    def eval_point(self, interp, x):
        idx = interp.get_index_left_of(x)
        x_left, data_left = interp.index_point(idx)
        x_right, data_right = interp.index_point(idx + 1)
        take_left = (x_right - x_left) / 2.0 > (x - x_left)
        return jnp.where(take_left, data_left, data_right)


@register_pytree_node_class
class StepInterpolatorBatched(Interp1DStrategy, Interp1DStrategyBuilder):
    """Same semantics, written batched (the accelerator-friendly shape)."""

    MINIMUM_DATA_LENGTH = 2
    extrapolates = True

    def build(self, x, data):
        return self

    def eval(self, interp, xq):
        idx = interp.get_index_left_of(xq)
        x_left = interp.x[idx]
        x_right = interp.x[idx + 1]
        take_left = (x_right - x_left) / 2.0 > (xq - x_left)
        pick = jnp.where(take_left, idx, idx + 1)
        return jnp.take(interp.data, pick, axis=0)

    def tree_flatten(self):
        return (), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux, children
        return cls()


def main():
    data = jnp.array([2.0, 4.0, 5.0])
    query = jnp.linspace(-0.5, 2.5, 6)
    expect = np.array([2.0, 2.0, 4.0, 4.0, 5.0, 5.0])

    for strat in (StepInterpolator(), StepInterpolatorBatched()):
        interp = Interp1D.builder(data).strategy(strat).build()
        result = interp.interp_array(query)
        np.testing.assert_allclose(np.asarray(result), expect, atol=1e-15)
        print(f"{type(strat).__name__}: {np.asarray(result)}")


if __name__ == "__main__":
    main()
