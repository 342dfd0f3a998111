"""Grid-axis capacity sharding: Interp2D/InterpND cell tables split
over a device mesh (SURVEY §5 scale-axis row).

The component that hits memory caps on multi-axis grids is the packed
CELL table — ``4^k``× the grid data's memory for the tensor-product
cubic (an ND 256³ tricubic cell table is 4.2 GB; its node fallback is
still 738 MB) — while the axis knot *vectors* are tiny (a 256-entry f32
axis is 1 KB).  The split therefore inverts
``ops/knotshard.py``'s layout: **replicate the axis vectors, shard the
table** along the leading grid axis's cells.

* **Contiguous cell-row shards, halo materialized by the pack.**  The
  cell table is axis-0-major (``cstrides[0] = prod(cells[1:])``), so
  device ``d`` of ``D`` owning axis-0 cells ``[d*S, (d+1)*S)``
  (``S = ceil(c0/D)``) holds exactly the contiguous row range
  ``[d*S*rs, (d+1)*S*rs)``.  No halo exchange ever happens because the
  per-cell rows already duplicate shared corner state — two cells
  meeting at a node plane each carry that plane's values/derivatives in
  their own rows.  That duplication IS knotshard's ``S+1``-knot halo,
  materialized once at pack time.
* **Ownership by computed cell index.**  Every device computes the
  GLOBAL per-axis ``(idx, t)`` from the replicated axis vectors — the
  clamp contract (``vector_extensions.rs:61-66``), periodic wrap
  (``cubic_spline.rs:804-809``), and NaN propagation are those of the
  unsharded eval *by construction*.  Device ``d`` owns a query iff its
  axis-0 cell lands in ``[d*S, (d+1)*S)``; the global clamp to
  ``[0, c0-1]`` makes the ownership sets a partition, so the combine is
  ONE ``psum`` of zero-masked local blends over the grid mesh axis.
* **Local blend = the unsharded blend.**  The owner gathers the same
  row values and applies the same weight reduce as
  ``models/interpnd._eval_core`` (cell route) — sharded output is
  bit-identical to the single-device cell-layout eval (gated in
  ``tests/test_gridshard.py``), with the per-device table ``1/D`` of
  the global one: grids past ``config.interpnd_pack_max_elems`` scale
  OUT at cell-route speed instead of degrading to the 2^k-gather node
  layout.

The pack never materializes the global cell table: the mixed-derivative
node grids (``2^k``× data memory) are computed once, and each shard's
rows are packed from its ``S+1``-node-plane slab.

Composable with query-axis data parallelism on a 2-D mesh
(``query_axis=``), like ``sharded_knot_eval``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models.interpnd import (
    _corner_weights,
    _cubic_weights,
    interpnd_node_grids,
    pack_corner_rows_nd,
    pack_cubic_rows_nd,
)
from ..models.strategies.bicubic import _index_frac


def grid_shard_geometry(c0, n_shards):
    """Axis-0 cells per shard ``S = ceil(c0 / D)``."""
    if c0 < 1:
        raise ValueError("need at least 2 knots on the sharded axis")
    return -(-c0 // n_shards)


def pack_interpnd_grid_shards(axes, data, k, method, bcs, n_shards,
                              mesh=None, axis="grid"):
    """Per-shard cell tables ``(D, S*rs, nb*r)`` for the leading grid
    axis (``rs = prod(cells[1:])``, ``nb = 2^k`` linear / ``4^k``
    cubic).  Shard ``d`` holds the rows of axis-0 cells
    ``[d*S, (d+1)*S)``; short tail shards are zero-row padded (pad rows
    own no queries — global cell indices never reach them).

    The global cell table is never materialized: each shard's rows are
    packed from its ``S+1``-node-plane slab of the data (linear) or of
    the mixed-derivative node grids (cubic; the grids are the one
    global intermediate, ``2^k``× data memory — the same scale the node
    layout stores permanently)."""
    grid = data.shape[:k]
    if not jnp.issubdtype(data.dtype, jnp.floating):
        raise ValueError("grid sharding needs floating data")
    c0 = grid[0] - 1
    s = grid_shard_geometry(c0, n_shards)
    rs = 1
    for n in grid[1:]:
        rs *= n - 1

    if method == "cubic":
        bcs_eff = tuple(bcs) if bcs is not None else ("not_a_knot",) * k
        grids = jax.jit(
            lambda ax, d: interpnd_node_grids(ax, d, k, bcs_eff)
        )(tuple(axes), data)
        masks = sorted(grids)

        @jax.jit
        def pack_slab(ax0_slab, data_slab, grid_slabs):
            return pack_cubic_rows_nd(
                (ax0_slab,) + tuple(axes[1:]),
                data_slab,
                k,
                dict(zip(masks, grid_slabs)),
            )

        def slab_args(a, b):
            return (
                axes[0][a : b + 1],
                data[a : b + 1],
                tuple(grids[m][a : b + 1] for m in masks),
            )

    elif method == "linear":

        @jax.jit
        def pack_slab(data_slab):
            return pack_corner_rows_nd(data_slab, k)

        def slab_args(a, b):
            return (data[a : b + 1],)

    else:
        raise ValueError(
            f"grid sharding supports 'linear'/'cubic', got {method!r}"
        )

    want = s * rs
    r = 1
    for n in data.shape[k:]:
        r *= n
    ch = ((4 if method == "cubic" else 2) ** k) * r

    def shard_d(d):
        a = d * s
        b = min((d + 1) * s, c0)
        if a >= c0:
            return jnp.zeros((want, ch), data.dtype)
        tbl = pack_slab(*slab_args(a, b))
        if tbl.shape[0] < want:
            tbl = jnp.pad(tbl, ((0, want - tbl.shape[0]), (0, 0)))
        return tbl

    if mesh is None:
        return jnp.stack([shard_d(d) for d in range(n_shards)]), s

    # Sharded assembly (round-5 review fix): the jnp.stack path above
    # materializes the FULL (D, S*rs, ch) stack on the default device
    # before any resharding — exactly the single-device capacity wall
    # this module exists to break.  Here each slab is device_put to its
    # owner(s) as soon as it is packed and dropped from the packing
    # device, so no device ever holds more than one slab transiently.
    sh = NamedSharding(mesh, P(axis, None, None))
    shape = (n_shards, want, ch)
    owners = {}
    for device, index in sh.addressable_devices_indices_map(shape).items():
        owners.setdefault(index[0].start or 0, []).append(device)
    arrays = []
    for d in range(n_shards):
        tbl = shard_d(d)[None]
        for device in owners.get(d, []):
            arrays.append(jax.device_put(tbl, device))
    return jax.make_array_from_single_device_arrays(shape, sh, arrays), s


def place_grid_shards(tbl_shards, mesh, axis="grid"):
    """Device-put the ``(D, S*rs, ch)`` stack sharded over ``axis`` so
    every device holds only its own rows."""
    return jax.device_put(
        tbl_shards, NamedSharding(mesh, P(axis, None, None))
    )


def sharded_grid_eval(
    axes,
    grid,
    k,
    method,
    bcs,
    tbl_shards,
    s,
    flats,
    mesh,
    axis="grid",
    query_axis=None,
    extrapolate=False,
):
    """Evaluate flat per-axis query vectors against the sharded cell
    table.  Returns ``(Q, r)`` (trailing dims flattened; reshape at the
    caller).  One ``psum`` over ``axis``; with ``query_axis`` the
    queries stay sharded end-to-end (2-D capacity × throughput mesh).

    OOB contract: ``extrapolate=True`` extends the edge cells (the
    clamped ``(idx, t)`` does this globally); ``False`` masks
    out-of-range queries to NaN — the pure-path driver contract
    (docs/PARITY.md D1).  Periodic axes wrap and are never OOB."""
    nb = (4 if method == "cubic" else 2) ** k
    cells = tuple(n - 1 for n in grid)
    rs = 1
    for c in cells[1:]:
        rs *= c
    ch = tbl_shards.shape[-1]
    r = ch // nb
    bcs_eff = tuple(bcs) if bcs is not None else (None,) * k
    n_shards = tbl_shards.shape[0]
    assert n_shards == mesh.shape[axis], (
        f"table packed for {n_shards} devices but mesh axis {axis!r} "
        f"has {mesh.shape[axis]}"
    )

    cstr = [1] * k
    for d in range(k - 2, -1, -1):
        cstr[d] = cstr[d + 1] * cells[d + 1]

    def body(tbl_loc, *qs):
        tbl = tbl_loc[0]
        idx, ts, ok = [], [], None
        for d, (ax, q) in enumerate(zip(axes, qs)):
            if bcs_eff[d] == "periodic":
                q = jnp.mod(q - ax[0], ax[-1] - ax[0]) + ax[0]
            elif not extrapolate:
                # same in-range test as _eval_flat_masked
                good = (q >= ax[0]) & (q <= ax[-1])
                ok = good if ok is None else (ok & good)
            i, t = _index_frac(ax, q)
            idx.append(i)
            ts.append(t)
        w = (
            _cubic_weights(ts, k)
            if method == "cubic"
            else _corner_weights(ts, k)
        )  # (Q, nb)
        me = jax.lax.axis_index(axis)
        own = (idx[0] >= me * s) & (idx[0] < (me + 1) * s)
        local_cell = (idx[0] - me * s) * cstr[0] + sum(
            i * st for i, st in zip(idx[1:], cstr[1:])
        )
        rows = jnp.take(tbl, jnp.where(own, local_cell, 0), axis=0)
        out = jnp.sum(
            rows.reshape(-1, nb, r) * w[:, :, None], axis=1
        )  # same reduce as _eval_core's cell route
        if ok is not None:
            out = jnp.where(ok[:, None], out, jnp.asarray(jnp.nan, out.dtype))
        out = jnp.where(own[:, None], out, jnp.zeros((), out.dtype))
        return jax.lax.psum(out, axis)

    qspec = P(query_axis)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis, None, None),) + (qspec,) * k,
        out_specs=P(query_axis, None),
    )(tbl_shards, *flats)


class GridShardedEvaluator:
    """Callable mirroring ``InterpND.__call__`` on a grid-sharded cell
    table: ``ev(*coords) -> (query_shape, *trailing)``."""

    def __init__(self, axes, data_shape, data_dtype, k, method, bcs,
                 tbl_shards, s, mesh, axis, query_axis, extrapolate):
        self.axes = tuple(axes)
        self.grid = tuple(data_shape[:k])
        self.trailing = tuple(data_shape[k:])
        self.k = k
        self.method = method
        self.bcs = tuple(bcs) if bcs is not None else None
        self.tbl_shards = tbl_shards
        self.s = s
        self.mesh = mesh
        self.axis = axis
        self.query_axis = query_axis
        self.extrapolates = bool(extrapolate)
        self.dtype = data_dtype

    def table_bytes_per_device(self):
        return int(
            self.tbl_shards.shape[1]
            * self.tbl_shards.shape[2]
            * self.tbl_shards.dtype.itemsize
        )

    def __call__(self, *coords):
        if len(coords) != self.k:
            raise TypeError(
                f"expected {self.k} coordinate arrays, got {len(coords)}"
            )
        coords = [jnp.asarray(c, self.axes[d].dtype)
                  for d, c in enumerate(coords)]
        shape = coords[0].shape
        for c in coords[1:]:
            if c.shape != shape:
                raise ValueError("coordinate arrays must share one shape")
        flats = tuple(c.reshape(-1) for c in coords)
        out = sharded_grid_eval(
            self.axes, self.grid, self.k, self.method, self.bcs,
            self.tbl_shards, self.s, flats, self.mesh, axis=self.axis,
            query_axis=self.query_axis, extrapolate=self.extrapolates,
        )
        return out.reshape(shape + self.trailing)


def shard_interpnd_grid(interp, mesh, axis="grid", query_axis=None):
    """Grid-shard an :class:`~ndarray_interp_tpu.models.interpnd.InterpND`
    over ``mesh`` axis ``axis`` (leading grid axis's cells); returns a
    :class:`GridShardedEvaluator` — the ``shard_interp1d_knots``
    (``knotshard.py``) convenience for the multi-axis capacity case.

    Always produces the CELL layout per shard (the whole point: each
    device holds ``1/D`` of the cell table, so grids past
    ``config.interpnd_pack_max_elems`` keep one-gather eval instead of
    degrading to the node route).  ``method="nearest"`` has no table to
    shard and is rejected."""
    n_shards = mesh.shape[axis]
    tbl_shards, s = pack_interpnd_grid_shards(
        interp.axes, interp.data, interp.k, interp.method, interp.bcs,
        n_shards, mesh=mesh, axis=axis,
    )
    return GridShardedEvaluator(
        interp.axes, interp.data.shape, interp.data.dtype, interp.k,
        interp.method, interp.bcs, tbl_shards, s, mesh, axis, query_axis,
        interp.extrapolates,
    )


def shard_interp2d_grid(interp, mesh, axis="grid", query_axis=None):
    """Grid-shard an :class:`~ndarray_interp_tpu.models.interp2d.Interp2D`
    (Bilinear or finished Bicubic) over its x-axis cells.

    Routes through the k=2 grid-shard machinery: Bilinear is the k=2
    multilinear blend (same interpolant as ``bilinear.rs:88-97``'s
    calc_frac composition), Bicubic's per-axis boundary kinds map
    directly (the 2-D tensor-product cubic IS InterpND's k=2 cubic —
    both derive node state via the same ``_solve_axis0`` solves)."""
    strat = interp.strategy
    name = type(strat).__name__
    if "Bicubic" in name:
        method = "cubic"
        bcs = (strat.bc_x, strat.bc_y)
    elif "Bilinear" in name:
        method = "linear"
        bcs = None
    else:
        # anything else (Nearest2D, custom strategies) has no grid-shard
        # blend here — silently treating it as bilinear returns wrong
        # values (caught by round-5 review)
        raise ValueError(
            "shard_interp2d_grid supports Bilinear and Bicubic "
            f"strategies, got {name}"
        )
    extrapolate = bool(getattr(strat, "extrapolates", False))
    n_shards = mesh.shape[axis]
    tbl_shards, s = pack_interpnd_grid_shards(
        (interp.x, interp.y), interp.data, 2, method, bcs, n_shards,
        mesh=mesh, axis=axis,
    )
    return GridShardedEvaluator(
        (interp.x, interp.y), interp.data.shape, interp.data.dtype, 2,
        method, bcs, tbl_shards, s, mesh, axis, query_axis, extrapolate,
    )
