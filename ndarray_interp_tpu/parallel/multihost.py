"""Multi-host (multi-process) scale-out scaffolding.

The single-process mesh story (``sharding.py``) covers one host's
devices.  For banks past one host, the same shardings extend across
hosts — JAX's global-view model means *no interpolator code changes*:
the mesh simply spans all processes' devices, bank shards land on each
host's local devices, and the only cross-host traffic is whatever
reduction the caller runs across the bank/query axes (e.g. a loss
``psum``).

This module wraps the process bootstrap and global-mesh construction.
It is exercised by a two-process CPU cluster
(``tests/test_multihost.py``); it has not run across GPU hosts.

Knot vectors stay replicated (kB-scale); bank axes shard. A query's
2-knot (1-D) / 2x2 (2-D) neighborhood never crosses a bank shard, so
evaluation itself needs no halo exchange at any scale.
"""

from __future__ import annotations

import jax

from .sharding import make_mesh


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Bootstrap this process into a multi-host JAX cluster.

    Thin wrapper over :func:`jax.distributed.initialize`; pass the
    coordinator address, process count and this process's id (a
    cluster without a scheduler that advertises them cannot infer
    them).
    Call once per process before any other JAX API.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis_names=("query", "bank")):
    """A mesh over every device in the cluster (all processes).

    With ``jax.distributed`` initialized, ``jax.devices()`` is global;
    the resulting mesh makes ``shard_interp1d`` / ``sharded_eval_1d``
    place bank shards on their owning hosts automatically.  Use
    ``jax.make_array_from_process_local_data`` to assemble bank arrays
    whose shards are loaded per-host.
    """
    return make_mesh(devices=jax.devices(), axis_names=axis_names)


def process_local_devices():
    """This process's addressable devices (its own chips)."""
    return jax.local_devices()
