"""One process of the multi-host CPU test cluster (tests/test_multihost.py).

Usage: ``python tests/multihost_worker.py <process_id> <num_processes> <port>``

Each process contributes 2 virtual CPU devices; the cluster forms a
global ``bank``-axis mesh via ``parallel.multihost``, builds a
bank-sharded cubic-spline bank under jit (zero-communication elementwise
Thomas solve), evaluates replicated queries against it, reduces a loss
across the bank axis (a real cross-process gloo collective), and checks
the allgathered result bit-exactly against the same jit build/eval run
single-process on the full local copy.
"""

import os
import sys

_pid = int(sys.argv[1])
_nproc = int(sys.argv[2])
_port = sys.argv[3]

# must precede `import jax`: the CPU backend with 2 virtual devices per
# process
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from ndarray_interp_tpu.parallel import multihost

multihost.initialize(
    f"localhost:{_port}", num_processes=_nproc, process_id=_pid
)
assert jax.process_count() == _nproc, jax.process_count()
assert len(jax.devices()) == 2 * _nproc
assert len(multihost.process_local_devices()) == 2

mesh = multihost.global_mesh(axis_names=("bank",))
assert mesh.devices.size == 2 * _nproc

from jax.experimental import multihost_utils
from jax.sharding import NamedSharding, PartitionSpec as P

from ndarray_interp_tpu.models.interp1d import Interp1D
from ndarray_interp_tpu.models.strategies.cubic import (
    CubicSpline,
    CubicSplineStrategy,
)

n, bank, nq = 48, 32, 400
rng = np.random.default_rng(11)
full = rng.normal(size=(n, bank)).astype(np.float32)
x_np = np.cumsum(rng.uniform(0.5, 1.5, n)).astype(np.float32)
qs = rng.uniform(x_np[0], x_np[-1], nq).astype(np.float32)

x = jnp.asarray(x_np)
sh_bank = NamedSharding(mesh, P(None, "bank"))

# every process holds the full (deterministic) bank; the global array picks
# each process's shards from it — the multi-host assembly recipe
gdata = jax.make_array_from_callback(
    (n, bank), sh_bank, lambda idx: full[idx]
)

strategy = CubicSpline().extrapolate(True)


def _build(x_, d_):
    s = strategy.build(x_, d_)
    return s.a, s.b


# bank-sharded coefficient build: elementwise across the bank, so the
# tridiagonal solve runs with zero communication on each device's shard
a, b = jax.jit(_build, out_shardings=(sh_bank, sh_bank))(x, gdata)
itp = Interp1D.new_unchecked(x, gdata, CubicSplineStrategy(a, b, "yes"))

qg = jnp.asarray(qs)  # queries replicate (every device evaluates all)
out_sh = NamedSharding(mesh, P(None, "bank"))


@jax.jit
def run(itp_, q_):
    out = itp_.strategy.eval(itp_, q_)
    return jax.lax.with_sharding_constraint(out, out_sh)


out = run(itp, qg)
assert out.shape == (nq, bank)

# a real cross-process collective: the global reduction over the sharded
# bank axis rides the distributed (gloo) backend
loss = float(jax.jit(jnp.sum)(out))

got = multihost_utils.process_allgather(out, tiled=True)

# oracle: identical jit build + eval, single-process on the full copy
a0, b0 = jax.jit(_build)(x, jnp.asarray(full))
itp0 = Interp1D.new_unchecked(
    x, jnp.asarray(full), CubicSplineStrategy(a0, b0, "yes")
)
want = np.asarray(jax.jit(lambda i, q: i.strategy.eval(i, q))(itp0, qg))
loss0 = float(np.sum(want, dtype=np.float32))

err = float(np.max(np.abs(np.asarray(got) - want)))
assert err == 0.0, f"sharded-vs-single mismatch: {err}"
assert abs(loss - loss0) <= 1e-3 * max(1.0, abs(loss0)), (loss, loss0)

# knot-axis sharding ACROSS HOSTS: each process's devices own a slice of
# the knot axis (capacity sharding over DCN); ownership masks + one psum
# reassemble the full answer on every host
from ndarray_interp_tpu.ops.knotshard import (
    pack_knot_shards,
    sharded_knot_eval,
)

kmesh = multihost.global_mesh(axis_names=("knot",))
nk = 512
xk_np = np.cumsum(rng.uniform(0.2, 1.0, nk)).astype(np.float32)
dk_np = rng.normal(size=nk).astype(np.float32)
ak_np = rng.normal(size=nk - 1).astype(np.float32)
bk_np = rng.normal(size=nk - 1).astype(np.float32)
qk_np = rng.uniform(xk_np[0] - 2, xk_np[-1] + 2, 300).astype(np.float32)
nshards = kmesh.devices.size
shards_local = pack_knot_shards(
    jnp.asarray(xk_np), jnp.asarray(dk_np), jnp.asarray(ak_np),
    jnp.asarray(bk_np), nshards,
)
from jax.sharding import NamedSharding as _NS

gshards = tuple(
    jax.make_array_from_callback(
        v.shape,
        _NS(kmesh, P("knot", *([None] * (v.ndim - 1)))),
        lambda idx, vv=v: np.asarray(vv)[idx],
    )
    for v in shards_local
)
kq = jnp.asarray(qk_np)
kout = jax.jit(
    lambda *s: sharded_knot_eval(*s, mesh=kmesh, n=nk, axis="knot")
)(*gshards, kq)
kgot = np.asarray(multihost_utils.process_allgather(kout, tiled=True))
kidx = np.clip(np.searchsorted(xk_np, qk_np, "right") - 1, 0, nk - 2)
tk = (qk_np - xk_np[kidx]) / (xk_np[kidx + 1] - xk_np[kidx])
kwant = (
    (1 - tk) * dk_np[kidx]
    + tk * dk_np[kidx + 1]
    + tk * (1 - tk) * (ak_np[kidx] * (1 - tk) + bk_np[kidx] * tk)
)
kerr = float(np.max(np.abs(kgot - kwant) / np.maximum(np.abs(kwant), 1e-2)))
assert kerr < 1e-4, f"knot-sharded multihost mismatch: {kerr}"

print(
    f"RESULT {_pid} OK maxdiff={err} loss={loss:.6f} knotshard={kerr:.2e}",
    flush=True,
)
