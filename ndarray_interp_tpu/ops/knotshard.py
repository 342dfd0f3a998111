"""Knot-axis sharding: evaluation with the knot/coefficient axis itself
split over a device mesh (SURVEY §5 scale-axis row).

Everywhere else in this framework the knot vector replicates — the right
default at kB scale — and bank/query axes shard.  When a knot axis and
its coefficients outgrow one device the knot axis splits too.  The
design:

* **Contiguous shards + a one-knot halo.**  Device ``d`` of ``D`` owns
  intervals ``[d*S, (d+1)*S)`` (``S = ceil((n-1)/D)``) and stores the
  ``S+1`` knots bounding them — the ``+1`` is the halo: the first knot
  of shard ``d+1``, materialized once at shard time.  Evaluation then
  needs **no halo exchange at all**: a query's 2-knot neighborhood never
  crosses a shard boundary that its owning shard can't see.
* **Ownership by value range.**  Shard ``d`` owns query ``q`` iff
  ``local_knots[0] <= q < local_knots[S]``; shard 0 additionally owns
  everything left of the axis (and NaN), the shard holding the last real
  interval owns everything right of it — reproducing the reference's
  clamp contract (``vector_extensions.rs:61-66``) globally.  The
  ownership sets partition the query space, so the final combine is ONE
  ``psum`` over the knot mesh axis of zero-masked local results.
* **Local evaluation is the existing single-device machinery** on the
  shard: the vectorized searchsorted (``ops/searchsorted.py``) over the
  shard's own ``S+1`` knots, then the Hermite form.

Padding intervals (to make ``D*S`` divisible) carry largest-finite
sentinel knots and zero data; they own no queries (their value range is
empty), and the shard holding the last real interval overrides its
right-extrapolation queries — everything in ``[x[n-1], +inf]`` — with
the closed-form Hermite of interval ``n-2`` read at *static* local
positions (no gather), so pad garbage never reaches the psum.

Reference semantics preserved: clamp to ``[0, n-2]`` incl. ±inf
(``vector_extensions.rs:61-66``), NaN→NaN, Hermite symmetric form with
the exact op order of ``cubic_spline.rs:818-828`` (linear: a = b = 0
collapses to the lerp, with a ``lin_inf`` guard so ±inf queries give
±inf, not NaN from inf·0).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .searchsorted import get_lower_index


def shard_geometry(n, n_shards):
    """Intervals per shard ``S = ceil((n-1)/D)`` and the (static) shard
    index holding the last real interval."""
    if n < 2:
        raise ValueError("need at least 2 knots")
    s = -(-(n - 1) // n_shards)
    d_last = (n - 2) // s
    return s, d_last


def pack_knot_shards(knots, data, a, b, n_shards):
    """Stack per-shard arrays: ``(D, S+1)`` knots/data, ``(D, S)`` a/b.

    Pad knots are ``+inf`` (own nothing), pad data/coefficients are 0.
    Place the returned arrays with ``P(knot_axis, None)`` — each device
    then holds exactly its shard + the one-knot halo.
    """
    n = knots.shape[0]
    s, _ = shard_geometry(n, n_shards)
    total = n_shards * s + 1
    # largest-FINITE sentinel: pad intervals then have finite widths, so
    # no inf - inf reaches the (masked-out) local arithmetic
    big = jnp.asarray(jnp.finfo(knots.dtype).max, knots.dtype)
    kp = jnp.concatenate([knots, jnp.full((total - n,), big, knots.dtype)])
    dp = jnp.concatenate(
        [data, jnp.zeros((total - n,) + data.shape[1:], data.dtype)]
    )
    ap = jnp.concatenate(
        [a, jnp.zeros((total - 1 - (n - 1),) + a.shape[1:], a.dtype)]
    )
    bp = jnp.concatenate(
        [b, jnp.zeros((total - 1 - (n - 1),) + b.shape[1:], b.dtype)]
    )
    # windows of S+1 knots starting every S — the overlap IS the halo
    win = jnp.arange(s + 1)[None, :] + s * jnp.arange(n_shards)[:, None]
    tail = a.shape[1:]  # trailing (bank) dims shard-replicate per knot shard
    return (
        kp[win],
        dp[win],
        ap.reshape((n_shards, s) + tail),
        bp.reshape((n_shards, s) + tail),
    )


def _local_index_frac(kloc, q, idx_max):
    """Local ``(idx, t)`` on the shard's S+1 knots, idx clamped to
    ``[0, idx_max]`` (the shard's last *real* interval)."""
    # shared clamp-to-[0, n-2] search; idx_max <= n_loc - 2 always
    idx = jnp.minimum(get_lower_index(kloc, q), idx_max)
    x_l = kloc[idx]
    x_r = kloc[idx + 1]
    return idx, (q - x_l) / (x_r - x_l)


def _hermite(y_l, y_r, a, b, t):
    one = jnp.ones((), t.dtype)
    base = (one - t) * y_l + t * y_r + t * (one - t) * (a * (one - t) + b * t)
    lin_inf = jnp.isinf(t) & (a == 0) & (b == 0)
    return jnp.where(lin_inf, y_l + t * (y_r - y_l), base)


def _local_eval(kloc, dloc, aloc, bloc, q, *, n, s, d_last, axis,
                oob="clamp"):
    """One shard's contribution: zero-masked local Hermite values.

    Trailing (bank) dims of ``dloc``/``aloc``/``bloc`` are supported:
    the bank replicates within each knot shard (shard it over a second
    mesh axis with the usual bank sharding if needed).

    ``oob="nan"`` masks out-of-range queries (strictly left of ``x[0]``
    or right of ``x[n-1]``) to NaN instead of clamping — the pure-path
    driver contract at ``extrapolate=False`` (the eager driver raises;
    NaN is its jit-safe twin, docs/PARITY.md D2).  The mask costs no
    extra communication: each OOB query is owned by exactly one edge
    shard, which emits NaN instead of the clamped value."""
    d = jax.lax.axis_index(axis)
    start = d * s
    # last real interval this shard holds, as a LOCAL index
    idx_max = jnp.clip(n - 2 - start, 0, s - 1)
    idx, t = _local_index_frac(kloc, q, idx_max)
    tr = dloc.ndim - 1  # trailing (bank) dims
    te = t.reshape(t.shape + (1,) * tr)
    rows_y_l = dloc[idx]
    rows_y_r = dloc[idx + 1]
    val = _hermite(rows_y_l, rows_y_r, aloc[idx], bloc[idx], te)

    sd = kloc[0]
    ed = kloc[s]
    # the (d <= d_last) guard keeps pad shards out even when the axis
    # length aligns with the shard size: at (n-1) % S == 0 the first pad
    # shard's window STARTS at x[n-1] (a real knot), so its value range
    # [x[n-1], sentinel) would otherwise overlap the d_last shard's
    # right-clamp ownership and the psum would double-count every
    # query >= x[n-1]
    own = (sd <= q) & (q < ed) & (d <= d_last)
    # shard 0: left clamp — everything not >= the axis start (incl. NaN,
    # which must propagate as NaN output, so it needs an owner)
    own = own | ((d == 0) & ~(q >= sd))
    # shard holding interval n-2: right clamp [x[n-1], +inf]; its local
    # positions are static, so the override needs no gather
    p_last = (n - 1) - d_last * s  # in [1, S]
    x_last = kloc[p_last]
    right = (d == d_last) & (q >= x_last)
    own = own | right
    t_last = (q - kloc[p_last - 1]) / (x_last - kloc[p_last - 1])
    val_last = _hermite(
        dloc[p_last - 1], dloc[p_last], aloc[p_last - 1], bloc[p_last - 1],
        t_last.reshape(t_last.shape + (1,) * tr),
    )
    righte = right.reshape(right.shape + (1,) * tr)
    val = jnp.where(righte, val_last, val)
    if oob == "nan":
        # strictly-OOB queries: owned by exactly one edge shard, which
        # emits NaN (q == x[0] / x[n-1] stay in range)
        bad = ((d == 0) & (q < sd)) | ((d == d_last) & (q > x_last))
        bade = bad.reshape(bad.shape + (1,) * tr)
        val = jnp.where(bade, jnp.asarray(jnp.nan, val.dtype), val)
    owne = own.reshape(own.shape + (1,) * tr)
    return jnp.where(owne, val, jnp.zeros((), val.dtype))


def sharded_knot_eval(kshards, dshards, ashards, bshards, q, mesh, n,
                      axis="knot", query_axis=None, oob="clamp"):
    """Evaluate flat queries against knot-sharded Hermite state.

    ``kshards``/``dshards``: (D, S+1); ``ashards``/``bshards``: (D, S)
    from :func:`pack_knot_shards`; ``n`` the true (unpadded) knot count.
    The result is one ``psum`` over ``axis``.

    ``query_axis``: optional SECOND mesh axis the queries shard over —
    the capacity axis (knots) and the throughput axis (queries) compose
    on one 2-D mesh: the knot ``psum`` rides only its own axis, each
    query sub-batch evaluates against every knot shard, and the result
    stays query-sharded (no gather).  ``None`` replicates the queries.

    ``oob="nan"``: mask out-of-range queries to NaN instead of clamping
    (the driver's pure-path ``extrapolate=False`` contract).
    """
    n_shards = kshards.shape[0]
    s, d_last = shard_geometry(n, n_shards)
    assert kshards.shape[1] == s + 1, (kshards.shape, s)
    assert n_shards == mesh.shape[axis], (
        f"shard stack packed for {n_shards} devices but mesh axis "
        f"{axis!r} has {mesh.shape[axis]} — each device must hold "
        "exactly one shard (repack with pack_knot_shards(..., "
        f"{mesh.shape[axis]}))"
    )
    if oob not in ("clamp", "nan"):
        raise ValueError(f"oob must be 'clamp' or 'nan', got {oob!r}")

    def body(kloc, dloc, aloc, bloc, ql):
        out = _local_eval(
            kloc[0], dloc[0], aloc[0], bloc[0], ql,
            n=n, s=s, d_last=d_last, axis=axis, oob=oob,
        )
        return jax.lax.psum(out, axis)

    kspec = P(axis, None)

    def spec_for(v):
        return P(axis, *([None] * (v.ndim - 1)))

    qspec = P(query_axis)
    out_tr = dshards.ndim - 2  # trailing (bank) dims of the result
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(kspec, spec_for(dshards), spec_for(ashards),
                  spec_for(bshards), qspec),
        out_specs=P(query_axis, *([None] * out_tr)),
    )(kshards, dshards, ashards, bshards, q)


def place_knot_shards(shards, mesh, axis="knot"):
    """Device-put the packed shard stack sharded over ``axis`` (leading
    dim) so every device holds only its own shard (+halo)."""
    return tuple(
        jax.device_put(
            v,
            NamedSharding(mesh, P(axis, *([None] * (v.ndim - 1)))),
        )
        for v in shards
    )


def shard_interp1d_knots(interp, mesh, axis="knot", query_axis=None,
                         oob="clamp"):
    """Knot-shard an :class:`~ndarray_interp_tpu.models.interp1d.Interp1D`
    over a mesh axis; returns an evaluator ``ev(q) -> (len(q), *bank)``.

    Works for Linear (a = b = 0) and finished cubic/Hermite strategies
    (which carry ``a``/``b``).  The strategy's extrapolation flag is not
    consulted — by default OOB queries clamp to the edge intervals;
    ``oob="nan"`` applies the pure-path ``extrapolate=False`` mask.
    ``query_axis`` forwards to :func:`sharded_knot_eval`."""
    x = interp.x
    data = interp.data
    strat = interp.strategy
    a = getattr(strat, "a", None)
    b = getattr(strat, "b", None)
    if a is None:
        a = jnp.zeros_like(data[:-1])
        b = jnp.zeros_like(data[:-1])
    n_shards = mesh.shape[axis]
    shards = place_knot_shards(
        pack_knot_shards(x, data, a, b, n_shards), mesh, axis
    )
    n = x.shape[0]

    def ev(q):
        return sharded_knot_eval(
            *shards, q, mesh=mesh, n=n, axis=axis, query_axis=query_axis,
            oob=oob,
        )

    return ev
