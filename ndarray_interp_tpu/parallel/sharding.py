"""Mesh sharding for spline banks and query batches.

The reference is single-process CPU; its only parallelism is driving the
library from rayon threads in benches (``benches/bench_interp1d.rs:49-79``).
The scale-out story here (SURVEY.md §5/§7) replaces that with
``jax.sharding``:

* **Bank parallelism** (the analogue of tensor parallelism): the trailing
  axes of ``data`` — the bank of independent splines — shard across the
  mesh.  Coefficient construction (the batched Thomas solve) is elementwise
  across the bank, so it runs with **zero communication**; each device
  solves its shard of the bank.
* **Query parallelism** (the analogue of data parallelism): the flat query
  axis shards across the mesh; each device evaluates its queries against
  its (replicated or bank-sharded) knot/coefficient tables.  Knot vectors
  are small (kB), so they replicate; there is no halo problem because each
  query touches only two adjacent knots.

Collectives only appear when a computation reduces across one of these
axes (e.g. a loss over all queries/banks under ``grad``) — XLA inserts the
``psum`` over the device interconnect automatically from the sharding annotations.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices=None, axis_names=("query", "bank"), devices=None):
    """Create a 2-D device mesh ``(query, bank)``.

    The device count is factorized as evenly as possible; pass
    ``axis_names`` with one name for a 1-D mesh.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if len(axis_names) == 1:
        shape = (n,)
    else:
        # largest factor pair q*b = n with q <= b
        q = 1
        for f in range(1, int(math.isqrt(n)) + 1):
            if n % f == 0:
                q = f
        shape = (q, n // q)
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def shard_interp1d(interp, mesh, bank_axis: str = "bank"):
    """Place an :class:`~ndarray_interp_tpu.models.interp1d.Interp1D` on a
    mesh with its bank (trailing) axes sharded and knots replicated.

    Data/coefficient arrays of rank >= 2 shard their *last* axis over
    ``bank_axis``; 1-D leaves (the knot vector, scalar-data banks)
    replicate.
    """

    def place(leaf):
        if not hasattr(leaf, "ndim"):
            return leaf
        if leaf.ndim >= 2:
            spec = P(*([None] * (leaf.ndim - 1) + [bank_axis]))
        else:
            spec = P()
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(place, interp)


def shard_queries(xq, mesh, query_axis: str = "query"):
    """Shard a flat query vector over the ``query`` mesh axis."""
    return jax.device_put(xq, NamedSharding(mesh, P(query_axis)))


def sharded_eval_1d(interp, xq, mesh, query_axis="query", bank_axis="bank"):
    """Evaluate with queries sharded over ``query_axis`` and the output
    bank dimension sharded over ``bank_axis``.

    Returns ``(len(xq), *data.shape[1:])`` with sharding
    ``P(query_axis, ..., bank_axis)``.
    """
    out_ndim = 1 + (interp.data.ndim - 1)
    if out_ndim >= 2:
        out_spec = P(query_axis, *([None] * (out_ndim - 2) + [bank_axis]))
    else:
        out_spec = P(query_axis)

    @jax.jit
    def run(interp, xq):
        out = interp.strategy.eval(interp, xq)
        return jax.lax.with_sharding_constraint(
            out, NamedSharding(mesh, out_spec)
        )

    return run(interp, shard_queries(xq, mesh, query_axis))


def shard_interp2d(interp, mesh, bank_axis: str = "bank"):
    """Place an :class:`~ndarray_interp_tpu.models.interp2d.Interp2D` on a
    mesh: trailing (bank) axes of rank >= 3 leaves shard their last axis
    over ``bank_axis``; the two grid axes and the 1-D knot vectors
    replicate (each query touches a 2x2 grid neighborhood, so splitting
    the grid itself would need halo exchange for no bandwidth win at
    these sizes)."""

    def place(leaf):
        if not hasattr(leaf, "ndim"):
            return leaf
        if leaf.ndim >= 3:
            spec = P(*([None] * (leaf.ndim - 1) + [bank_axis]))
        else:
            spec = P()
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(place, interp)


def sharded_eval_2d(
    interp, xq, yq, mesh, query_axis="query", bank_axis="bank"
):
    """2-D analogue of :func:`sharded_eval_1d`: flat (x, y) query vectors
    shard over ``query_axis``; trailing data axes shard over
    ``bank_axis`` in the output."""
    out_ndim = 1 + (interp.data.ndim - 2)
    if out_ndim >= 2:
        out_spec = P(query_axis, *([None] * (out_ndim - 2) + [bank_axis]))
    else:
        out_spec = P(query_axis)

    @jax.jit
    def run(interp, xq, yq):
        out = interp.strategy.eval(interp, xq, yq)
        return jax.lax.with_sharding_constraint(
            out, NamedSharding(mesh, out_spec)
        )

    return run(
        interp,
        shard_queries(xq, mesh, query_axis),
        shard_queries(yq, mesh, query_axis),
    )
