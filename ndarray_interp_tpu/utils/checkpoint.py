"""Interpolator serialization (save / restore).

The reference has no checkpointing; its nearest concept is
``new_unchecked`` — reconstructing an interpolator from parts without
revalidation (``/root/reference/src/interp1d/mod.rs:356-365``,
``interp2d/mod.rs:323-342``).  Interpolators here are pytrees, so
serialization is flatten → save leaves + static aux → unflatten-without-
validation on load (the exact ``new_unchecked`` role).

Format: a single ``.npz`` holding the leaves plus a JSON header with the
structural info.  No framework dependency beyond numpy.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

import jax.numpy as jnp

from ..models.interp1d import Interp1D
from ..models.interp2d import Interp2D
from ..models.interpnd import InterpND
from ..models.strategies.bicubic import BicubicStrategy
from ..models.strategies.bilinear import Bilinear
from ..models.strategies.cubic import CubicSplineStrategy
from ..models.strategies.linear import Linear
from ..models.strategies.step import Nearest, Nearest2D

_STRATEGY_CODECS = {
    "linear": (
        Linear,
        lambda s: ({"extrapolate": s.extrapolates}, {}),
        lambda meta, arrs: Linear(extrapolate=meta["extrapolate"]),
    ),
    "cubic": (
        CubicSplineStrategy,
        lambda s: ({"mode": s.mode}, {"a": s.a, "b": s.b}),
        lambda meta, arrs: CubicSplineStrategy(
            jnp.asarray(arrs["a"]), jnp.asarray(arrs["b"]), meta["mode"]
        ),
    ),
    "bilinear": (
        Bilinear,
        lambda s: ({"extrapolate": s.extrapolates}, {}),
        lambda meta, arrs: Bilinear(extrapolate=meta["extrapolate"]),
    ),
    "bicubic": (
        BicubicStrategy,
        lambda s: (
            {
                "extrapolate": s.extrapolates,
                "bc_x": s.bc_x,
                "bc_y": s.bc_y,
                "layout": s.layout,
            },
            {"rows": s.rows},
        ),
        lambda meta, arrs: BicubicStrategy(
            _bicubic_rows_from_checkpoint(jnp.asarray(arrs["rows"])),
            extrapolate=meta["extrapolate"],
            bc_x=meta.get("bc_x", "not_a_knot"),
            bc_y=meta.get("bc_y", "not_a_knot"),
            layout=meta.get("layout", "cell"),
        ),
    ),
    "nearest": (
        Nearest,
        lambda s: ({"mode": s.mode, "extrapolate": s.extrapolates}, {}),
        lambda meta, arrs: Nearest(
            mode=meta["mode"], extrapolate=meta["extrapolate"]
        ),
    ),
    "nearest2d": (
        Nearest2D,
        lambda s: ({"extrapolate": s.extrapolates}, {}),
        lambda meta, arrs: Nearest2D(extrapolate=meta["extrapolate"]),
    ),
    # load-only: files written while Bilinear still built a packed
    # corner-row table (no class encodes to this name any more)
    "bilinear_packed": (
        None,
        None,
        lambda meta, arrs: Bilinear(extrapolate=meta["extrapolate"]),
    ),
}


def _bicubic_rows_from_checkpoint(rows):
    """Accept both bicubic cell-row formats.

    Round-2 checkpoints stored ``(cells, 16r+4)`` rows: RAW corner
    derivatives plus the 4 interval-endpoint channels.  The current
    layout is ``(cells, 16r)`` with derivatives PRE-SCALED by the
    cell's interval widths and no endpoints (the widths are recoverable
    from the legacy endpoint channels, so old checkpoints convert
    exactly instead of silently evaluating unscaled derivatives as
    scaled ones)."""
    w = rows.shape[1]
    if w % 16 != 4:
        return rows  # current 16r layout
    r = (w - 4) // 16
    dx = (rows[:, 16 * r + 1] - rows[:, 16 * r + 0])[:, None]
    dy = (rows[:, 16 * r + 3] - rows[:, 16 * r + 2])[:, None]
    return jnp.concatenate(
        [
            rows[:, 0 * r * 4 : 4 * r],
            rows[:, 4 * r : 8 * r] * dx,
            rows[:, 8 * r : 12 * r] * dy,
            rows[:, 12 * r : 16 * r] * (dx * dy),
        ],
        axis=1,
    )


def register_strategy_codec(name, cls, encode, decode):
    """Class-level serialization hook for custom strategies.

    ``encode(strategy) -> (meta_dict, array_dict)`` (meta must be JSON-
    serializable); ``decode(meta, arrays) -> strategy``.  After
    registration, :func:`save`/:func:`load` handle interpolators carrying
    ``cls`` like the built-in strategies.  Alternatively a strategy class
    may define ``checkpoint_encode(self)`` / ``checkpoint_decode(meta,
    arrays)`` classmethods, which are picked up automatically.
    """
    _STRATEGY_CODECS[name] = (cls, encode, decode)


def _encode_strategy(strategy):
    for name, (cls, enc, _) in _STRATEGY_CODECS.items():
        if type(strategy) is cls:
            meta, arrs = enc(strategy)
            return name, meta, arrs
    # class-level hook: strategies can carry their own codec
    if hasattr(type(strategy), "checkpoint_encode"):
        cls = type(strategy)
        if cls.__module__ == "__main__" or "<locals>" in cls.__qualname__:
            raise TypeError(
                f"cannot auto-name a codec for {cls.__qualname__!r}: the "
                "class lives in __main__ or a function scope, so the saved "
                "name could never be resolved in a fresh process. Define "
                "the strategy in an importable module, or register an "
                "explicit codec via utils.checkpoint.register_strategy_codec"
            )
        name = f"custom:{cls.__module__}.{cls.__qualname__}"
        register_strategy_codec(
            name, cls,
            lambda s: s.checkpoint_encode(),
            cls.checkpoint_decode,
        )
        meta, arrs = strategy.checkpoint_encode()
        return name, meta, arrs
    raise TypeError(
        f"cannot serialize strategy {type(strategy).__name__}; register a "
        "codec via utils.checkpoint.register_strategy_codec or define "
        "checkpoint_encode/checkpoint_decode on the class"
    )


def _resolve_codec(sname, allow_custom_import=False):
    """Look up a codec.

    ``custom:`` names resolve the class from modules the *user* has
    already imported (``sys.modules``) and bind its
    ``checkpoint_encode``/``checkpoint_decode`` hooks.  By default no
    import is performed on load — importing a dotted path taken from a
    checkpoint header would execute arbitrary module top-level code, so
    an untrusted ``.npz`` could trigger code execution.  Callers who
    trust the file may opt in with ``allow_custom_import=True``.
    """
    if sname in _STRATEGY_CODECS:
        return _STRATEGY_CODECS[sname]
    if sname.startswith("custom:"):
        import sys

        path = sname[len("custom:"):]
        # longest already-imported module prefix, remainder = qualname
        modname, _, qual = path.rpartition(".")
        obj = None
        while modname:
            if modname in sys.modules:
                obj = sys.modules[modname]
                break
            if allow_custom_import:
                import importlib

                try:
                    obj = importlib.import_module(modname)
                    break
                except ImportError:
                    pass
            modname, _, rest = modname.rpartition(".")
            qual = f"{rest}.{qual}"
        unresolved = TypeError(
            f"cannot resolve strategy class for {sname!r}: its module "
            "is not imported. Import the module defining the strategy "
            "(or call register_strategy_codec) before load(); or pass "
            "load(path, allow_custom_import=True) if you trust the "
            "checkpoint"
        )
        if obj is None:
            raise unresolved
        for part in qual.split("."):
            # a parent package may be imported while the defining
            # submodule is not — keep the actionable message
            try:
                obj = getattr(obj, part)
            except AttributeError:
                raise unresolved from None
        register_strategy_codec(
            sname, obj,
            lambda s: s.checkpoint_encode(),
            obj.checkpoint_decode,
        )
        return _STRATEGY_CODECS[sname]
    raise TypeError(f"unknown strategy codec {sname!r}")


def save(path, interp) -> None:
    """Save an :class:`Interp1D` / :class:`Interp2D` / :class:`InterpND`
    to ``path`` (.npz)."""
    arrays = {}
    if isinstance(interp, Interp1D):
        header = {"kind": "interp1d"}
        arrays["x"] = np.asarray(interp.x)
        arrays["data"] = np.asarray(interp.data)
    elif isinstance(interp, Interp2D):
        header = {"kind": "interp2d"}
        arrays["x"] = np.asarray(interp.x)
        arrays["y"] = np.asarray(interp.y)
        arrays["data"] = np.asarray(interp.data)
    elif isinstance(interp, InterpND):
        # InterpND carries no strategy object — method/extrapolate are
        # plain static aux, the axes are k separate leaf arrays
        header = {
            "kind": "interpnd",
            "k": interp.k,
            "method": interp.method,
            "extrapolate": interp.extrapolates,
            "bcs": list(interp.bcs) if interp.bcs is not None else None,
        }
        for d, ax in enumerate(interp.axes):
            arrays[f"axis_{d}"] = np.asarray(ax)
        arrays["data"] = np.asarray(interp.data)
        arrays["__header__"] = np.frombuffer(
            json.dumps(header).encode(), dtype=np.uint8
        )
        np.savez(Path(path), **arrays)
        return
    else:
        raise TypeError(f"cannot serialize {type(interp).__name__}")

    sname, smeta, sarrs = _encode_strategy(interp.strategy)
    header["strategy"] = sname
    header["strategy_meta"] = smeta
    for k, v in sarrs.items():
        arrays[f"strategy_{k}"] = np.asarray(v)

    arrays["__header__"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8
    )
    np.savez(Path(path), **arrays)


def load(path, allow_custom_import=False):
    """Restore an interpolator; no revalidation (``new_unchecked``).

    Custom-strategy checkpoints resolve their class from modules already
    imported in this process; set ``allow_custom_import=True`` to let a
    *trusted* checkpoint's ``custom:`` codec name trigger the import
    itself (imports execute module code — never enable for untrusted
    files).
    """
    p = Path(path)
    if not p.exists():  # np.savez appends .npz when missing
        p = Path(f"{path}.npz")
    with np.load(p) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if header["kind"] == "interpnd":
            axes = tuple(
                jnp.asarray(z[f"axis_{d}"]) for d in range(header["k"])
            )
            d_nd = jnp.asarray(z["data"])
            bcs = header.get("bcs")
            bcs = tuple(bcs) if bcs is not None else None
            # packed corner/node tables are derived state — re-derive
            table, layout = InterpND.build_state(
                axes, d_nd, header["k"], header["method"], bcs
            )
            return InterpND.new_unchecked(
                axes,
                d_nd,
                header["method"],
                header["extrapolate"],
                table,
                bcs,
                layout,
            )
        sname = header["strategy"]
        _, _, dec = _resolve_codec(sname, allow_custom_import)
        sarrs = {
            k[len("strategy_"):]: z[k]
            for k in z.files
            if k.startswith("strategy_")
        }
        strategy = dec(header["strategy_meta"], sarrs)
        if header["kind"] == "interp1d":
            return Interp1D.new_unchecked(
                jnp.asarray(z["x"]), jnp.asarray(z["data"]), strategy
            )
        x2 = jnp.asarray(z["x"])
        y2 = jnp.asarray(z["y"])
        d2 = jnp.asarray(z["data"])
        return Interp2D.new_unchecked(x2, y2, d2, strategy)
