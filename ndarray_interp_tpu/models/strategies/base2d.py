"""Strategy protocol for 2-D interpolation.

Reference: ``/root/reference/src/interp2d/strategies/mod.rs:14-73``.
Driver guarantees before a strategy is called (``:30-37``): x and y are
strictly monotonically rising, ``len(x) == data.shape[0]``,
``len(y) == data.shape[1]``, both at least ``MINIMUM_DATA_LENGTH``;
interpolation happens along axes 0 (x) and 1 (y).

As in the 1-D protocol, the contract is batched: strategies
receive the whole flattened query vectors at once.
"""

from __future__ import annotations

import jax


class Interp2DStrategyBuilder:
    MINIMUM_DATA_LENGTH: int = 2

    def build(self, x, y, data) -> "Interp2DStrategy":
        raise NotImplementedError


class Interp2DStrategy:
    extrapolates: bool = False

    def eval(self, interp, xq, yq):
        """Evaluate at flat query vectors ``xq``/``yq`` of shape ``(Q,)``.

        Must be jit/vmap-safe and return ``(Q, *data.shape[2:])``.
        """
        raise NotImplementedError


class PointwiseStrategy2D(Interp2DStrategy, Interp2DStrategyBuilder):
    """Adapter for strategies written one ``(x, y)`` point at a time,
    vectorized with ``vmap`` (the 2-D analogue of the reference's custom
    strategy extension point)."""

    def build(self, x, y, data):
        return self

    def eval(self, interp, xq, yq):
        return jax.vmap(lambda x, y: self.eval_point(interp, x, y))(xq, yq)

    def eval_point(self, interp, x, y):
        raise NotImplementedError

    def tree_flatten(self):
        return (), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux, children
        return cls()
