"""Compile-payload hygiene: keep big tables OUT of jitted programs.

A device array captured by closure is constant-folded into the compiled
program: the constant is copied into every executable that captures it,
inflates the program text the compiler and the persistent compile cache
hash (a 535 MB captured table once produced 138 MB of program text), and
lengthens compilation.  Big tables must therefore always be jit
*arguments*.

This module provides the guardrail: :func:`program_const_bytes` walks a
function's jaxpr (recursively, through ``pjit``/``scan``/``cond``
sub-jaxprs) and totals the bytes of every embedded constant;
:func:`assert_lean_program` raises a clear ``RuntimeError`` when that
total exceeds the configured cap.  The serving evaluators
(``serving.py``) run the assert once per program at warmup, so a
regression that reintroduces a closure capture fails loudly before it
can reach a compiler.

No reference analogue (the reference is a single-process CPU crate,
``/root/reference/src/lib.rs``).
"""

from __future__ import annotations

import numpy as np

from .. import config


def _walk_consts(closed, seen, out):
    """Collect (shape, dtype, nbytes) for every const in ``closed`` and
    in any sub-ClosedJaxpr reachable through equation params."""
    for c in closed.consts:
        key = id(c)
        if key in seen:
            continue
        seen.add(key)
        nbytes = getattr(c, "nbytes", None)
        if nbytes is None:
            try:
                nbytes = np.asarray(c).nbytes
            except Exception:
                continue
        out.append(
            (
                tuple(getattr(c, "shape", ()) or ()),
                str(getattr(c, "dtype", type(c).__name__)),
                int(nbytes),
            )
        )
    jaxpr = getattr(closed, "jaxpr", closed)
    for eqn in getattr(jaxpr, "eqns", ()):
        for v in eqn.params.values():
            vals = v if isinstance(v, (tuple, list)) else (v,)
            for item in vals:
                if hasattr(item, "jaxpr") and hasattr(item, "consts"):
                    _walk_consts(item, seen, out)
                elif hasattr(item, "eqns"):  # a raw Jaxpr (constvar-less)
                    _walk_consts(
                        type("_C", (), {"consts": (), "jaxpr": item})(),
                        seen,
                        out,
                    )


def program_const_bytes(fn, *args, **kwargs):
    """Trace ``fn`` for these arguments and return
    ``(total_bytes, [(shape, dtype, nbytes), ...])`` for every constant
    that would be embedded in the compiled program (closure-captured
    arrays, hoisted literals), including inside nested sub-jaxprs.

    Tracing only — nothing is compiled or transferred."""
    import jax

    closed = jax.make_jaxpr(fn)(*args, **kwargs)
    out: list = []
    _walk_consts(closed, set(), out)
    return sum(b for _, _, b in out), out


def assert_lean_program(fn, *args, cap_bytes=None, what="jitted program",
                        **kwargs):
    """Raise ``RuntimeError`` if tracing ``fn(*args)`` embeds more than
    ``cap_bytes`` (default :data:`config.jit_const_cap_bytes`) of
    constants into the program.

    The failure mode this guards: a big device table captured by CLOSURE
    instead of passed as a jit ARGUMENT — the table would be
    constant-folded into the program and copied into its executable.  Fix by threading the table through the function's
    arguments (see ``serving.py``'s ``_run_extra`` pattern)."""
    cap = config.jit_const_cap_bytes if cap_bytes is None else int(cap_bytes)
    total, consts = program_const_bytes(fn, *args, **kwargs)
    if total > cap:
        biggest = sorted(consts, key=lambda t: -t[2])[:5]
        detail = ", ".join(
            f"{shape} {dtype} = {nb / 2**20:.1f} MB"
            for shape, dtype, nb in biggest
        )
        raise RuntimeError(
            f"{what} embeds {total / 2**20:.1f} MB of constants "
            f"(cap {cap / 2**20:.1f} MB): [{detail}]. A closure-captured "
            f"device array is constant-folded into the compiled program "
            f"and copied into its executable — pass big tables "
            f"as jit ARGUMENTS instead (docs/DESIGN.md, compile-payload "
            f"hygiene)."
        )
    return total


def check_route_tables(what, tables, queries):
    """Trace-time closure-capture guard for raw route entry points.

    The serving evaluators assert program leanness at warmup, but a
    capture can also happen one level lower: a raw route function
    (``gathered_*_packed``) traced with a big CONCRETE table while the
    queries are tracers — i.e. the table was a closure capture about to
    be constant-folded into the program.  That exact combination is
    detectable right at the route entry, with no extra tracing: if any
    query argument is a tracer (we are inside jit/vmap/grad) while a
    table argument is a concrete device/numpy array bigger than
    :data:`config.jit_const_cap_bytes`, raise.

    Eager calls (no tracer anywhere) are exempt — a concrete table there
    transfers once and is never embedded in a program.  Tables passed as
    proper jit arguments are tracers during the trace and are exempt.
    Disable with ``NDI_ROUTE_HYGIENE=0`` (:data:`config.route_hygiene`).

    ``tables``: iterable of ``(name, array_or_None)``;
    ``queries``: iterable of the query-side arguments.
    """
    if not config.route_hygiene:
        return
    import jax

    if not any(isinstance(q, jax.core.Tracer) for q in queries):
        return
    cap = config.jit_const_cap_bytes
    offenders = [
        (name, tuple(getattr(a, "shape", ())),
         str(getattr(a, "dtype", "?")), int(getattr(a, "nbytes", 0)))
        for name, a in tables
        if a is not None
        and not isinstance(a, jax.core.Tracer)
        and getattr(a, "nbytes", 0) > cap
    ]
    if offenders:
        detail = ", ".join(
            f"{n}{s} {d} = {nb / 2**20:.1f} MB"
            for n, s, d, nb in offenders
        )
        raise RuntimeError(
            f"{what} was traced (jit/vmap/grad) with concrete "
            f"closure-captured table argument(s) over the "
            f"{cap / 2**20:.1f} MB hygiene cap: [{detail}]. The table "
            f"would be constant-folded into the compiled program and "
            f"copied into its executable — pass it through the "
            f"jitted function's ARGUMENTS instead (docs/DESIGN.md, "
            f"compile-payload hygiene; set NDI_ROUTE_HYGIENE=0 to "
            f"override)."
        )


def lowered_text_bytes(fn, *args, **kwargs):
    """Size in bytes of the lowered StableHLO text for ``fn(*args)`` —
    a direct proxy for the program a compiler receives.
    (Costs a lowering; for the hot guard prefer
    :func:`program_const_bytes`, which only traces.)"""
    import jax

    lowered = jax.jit(fn).lower(*args, **kwargs)
    return len(lowered.as_text())
