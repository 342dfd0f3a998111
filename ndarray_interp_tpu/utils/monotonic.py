"""Monotonicity classification of 1-D axes.

Reference: ``/root/reference/src/vector_extensions.rs:40-53`` classifies a
vector with a short-circuiting state machine over consecutive pairs
(``MonotonicState``, ``:114-198``).  On an accelerator a sequential state
machine is the wrong shape; the same classification falls out of three vectorized
reductions over ``diff(x)``:

* any pair rising, none falling  -> Rising  (strict iff no flat pair)
* any pair falling, none rising  -> Falling (strict iff no flat pair)
* otherwise (mixed, all-flat, or len <= 1) -> NotMonotonic

This reproduces every case pinned by the reference unit tests
(``src/vector_extensions.rs:304-403``), including "starting flat"
``[1,1,2,3] -> Rising{strict:false}`` and all-flat ``[1,1,1] -> NotMonotonic``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class MonotonicKind(enum.Enum):
    RISING = "rising"
    FALLING = "falling"
    NOT_MONOTONIC = "not_monotonic"


@dataclass(frozen=True)
class Monotonic:
    """Result of :func:`monotonic_prop` (mirrors ``Monotonic`` enum,
    ``src/vector_extensions.rs:24-29``)."""

    kind: MonotonicKind
    strict: bool = False

    @property
    def is_strict_rising(self) -> bool:
        return self.kind is MonotonicKind.RISING and self.strict


def monotonic_prop(x) -> Monotonic:
    """Classify the monotonic property of a 1-D array.

    This runs host-side at build time (the value-dependent check cannot live
    under jit); ``x`` may be a numpy or JAX array.
    """
    x = np.asarray(x)
    if x.ndim != 1:
        raise ValueError(f"monotonic_prop expects a 1-D array, got ndim={x.ndim}")
    if x.shape[0] <= 1:
        return Monotonic(MonotonicKind.NOT_MONOTONIC)

    a, b = x[:-1], x[1:]
    has_up = bool(np.any(a < b))
    has_down = bool(np.any(a > b))
    has_flat = bool(np.any(a == b))

    if has_up and not has_down:
        return Monotonic(MonotonicKind.RISING, strict=not has_flat)
    if has_down and not has_up:
        return Monotonic(MonotonicKind.FALLING, strict=not has_flat)
    return Monotonic(MonotonicKind.NOT_MONOTONIC)
