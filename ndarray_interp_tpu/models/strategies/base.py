"""Strategy protocol for 1-D interpolation.

Reference: the trait pair ``Interp1DStrategyBuilder`` / ``Interp1DStrategy``
(``/root/reference/src/interp1d/strategies/mod.rs:12-65``).  The reference
contract is *pointwise*: the driver iterates queries and the strategy writes
one point's result (data shape minus the interp axis) into a mutable view.

Batched contract: the driver hands the strategy the whole flattened query
vector at once and the strategy returns the batched result — queries are
data-parallel lanes, not a host loop.  The guarantees the driver provides
before calling (mirroring ``strategies/mod.rs:26-32``) are unchanged:

* ``interp.x`` is strictly monotonically rising,
* ``len(x) == data.shape[0]`` and ``>= MINIMUM_DATA_LENGTH``,
* interpolation happens along axis 0.

Custom pointwise strategies in the style of the reference's
``examples/custom_strategy.rs`` subclass :class:`PointwiseStrategy` and get
vectorization for free via ``vmap``.
"""

from __future__ import annotations

import jax


class Interp1DStrategyBuilder:
    """Validates/configures a strategy and produces the finished strategy.

    ``build`` is invoked exactly once inside ``Interp1DBuilder.build`` after
    driver-side validation (``src/interp1d/mod.rs:443-476``).
    """

    #: Minimum number of points along the interpolation axis
    #: (``MINIMUM_DATA_LENGHT`` in the reference).
    MINIMUM_DATA_LENGTH: int = 2

    def build(self, x, data) -> "Interp1DStrategy":
        raise NotImplementedError


class Interp1DStrategy:
    """A finished (possibly precomputed) strategy.

    Implementations must be registered pytrees so the owning interpolator
    can flow through ``jit`` / ``vmap`` / ``pjit``.
    """

    #: Whether queries outside the knot range are legal.  When ``False`` the
    #: driver's eager entry points raise ``OutOfBoundsError`` and the pure
    #: path masks out-of-range results to NaN.  (Named ``extrapolates`` so
    #: concrete strategies can keep the reference's chainable
    #: ``.extrapolate(True)`` configuration method.)
    extrapolates: bool = False

    def eval(self, interp, xq):
        """Evaluate at the flat query vector ``xq`` of shape ``(Q,)``.

        Must be jit/vmap-safe and return ``(Q, *data.shape[1:])``.
        """
        raise NotImplementedError


class PointwiseStrategy(Interp1DStrategy, Interp1DStrategyBuilder):
    """Adapter for user strategies written one query point at a time.

    Mirrors the ergonomics of the reference's custom-strategy extension
    point (``examples/custom_strategy.rs:38-53``): implement
    ``eval_point(interp, x) -> (*data.shape[1:],)`` using the driver
    helpers ``interp.get_index_left_of`` / ``interp.index_point``; the
    adapter vectorizes it with ``vmap``.
    """

    def build(self, x, data):
        return self

    def eval(self, interp, xq):
        return jax.vmap(lambda x: self.eval_point(interp, x))(xq)

    def eval_point(self, interp, x):
        raise NotImplementedError

    # Pointwise strategies are stateless by default; subclasses holding
    # array state must override pytree registration themselves.
    def tree_flatten(self):
        return (), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux, children
        return cls()
