"""Runtime settings, consulted at trace time (flipping one does not
invalidate already-compiled jit caches)."""

from __future__ import annotations

import os

#: Route eager scalar queries (``interp_scalar``) through the native C++
#: host runtime (``ndarray_interp_tpu/native``) when available.  Disable
#: with ``NDI_DISABLE_NATIVE=1``.
use_native_host: bool = os.environ.get("NDI_DISABLE_NATIVE", "0") != "1"

#: Largest per-cell packed Bicubic row table, in ELEMENTS (f32 elements =
#: 4 bytes each; default 128M elements = 512 MB).  A memory bound: the
#: cell table stores the 16-quantity corner state per cell — ~17x the grid
#: data's memory for scalar-ish trailing dims (e.g. 267 MB for a
#: (512, 512, 16) f32 grid) — in exchange for ONE row gather per query.
#: Grids whose table would exceed this cap build the memory-frugal node
#: table instead (~4x data memory, 4 corner gathers per query; see
#: docs/API.md).
bicubic_pack_max_elems: int = 128 * 1024 * 1024

#: Compile-payload hygiene cap, in BYTES (default 8 MB): the serving
#: evaluators assert at warmup that their jitted programs embed less
#: than this much constant data (``utils/hygiene.py``).  A big device
#: table captured by CLOSURE (instead of passed as a jit argument) is
#: constant-folded into the program and copied into its executable.
#: Override with ``NDI_JIT_CONST_CAP_BYTES``.
jit_const_cap_bytes: int = int(
    os.environ.get("NDI_JIT_CONST_CAP_BYTES", 8 * 1024 * 1024)
)

#: Trace-time closure-capture guard at the raw route entry points
#: (``gathered_*`` / packed DF/f48/ND routes): calling a route under
#: jit/vmap/grad with a CONCRETE table bigger than
#: :data:`jit_const_cap_bytes` raises immediately instead of embedding
#: the table in the program (``utils/hygiene.py:check_route_tables``).
#: On by default — the check is trace-time-only and free at runtime;
#: set ``NDI_ROUTE_HYGIENE=0`` to disable.
route_hygiene: bool = os.environ.get("NDI_ROUTE_HYGIENE", "1") != "0"

#: Largest packed InterpND table, in ELEMENTS (default 128M elements =
#: 512 MB of f32).  A memory bound: the linear cell table stores all
#: ``2^k`` cell corners contiguously per cell (``2^k``× the grid data's
#: memory) so evaluation is ONE row gather per query; grids past the cap
#: use the unpacked ``2^k``-corner gather.  The cubic cell table
#: (``4^k``× the data) falls back to a node layout past the cap.
interpnd_pack_max_elems: int = 128 * 1024 * 1024
