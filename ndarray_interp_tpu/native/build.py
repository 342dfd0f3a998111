"""Build the native host runtime shared library.

Usage: ``python -m ndarray_interp_tpu.native.build``

The library is a plain C++ shared object with an ``extern "C"`` ABI
(loaded via ctypes), so no Python headers or packaging steps are needed.
It is built from the committed sources into ``native/_build/`` (not
committed), under a file name keyed by a hash of the sources, the
compiler flags and the machine architecture: a library built from other
sources or flags is never loaded.  The flags target the architecture's
baseline instruction set (no ``-march=native``), so a library built on
one host runs on any other host of the same architecture.
"""

from __future__ import annotations

import hashlib
import platform
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC_DIR = HERE / "src"
BUILD_DIR = HERE / "_build"

FLAGS = (
    "-O3",
    "-funroll-loops",
    # forbid FMA contraction so results match the XLA CPU path (and the
    # reference's scalar arithmetic) bit-for-bit
    "-ffp-contract=off",
    "-shared",
    "-fPIC",
    "-std=c++17",
    "-fopenmp",
)


def sources():
    return sorted(SRC_DIR.glob("*.cpp"))


def build_key(srcs=None, flags=FLAGS, machine=None) -> str:
    """Hash of the source files, the flags and the architecture."""
    h = hashlib.sha256()
    for path in srcs if srcs is not None else sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(flags).encode())
    h.update((machine or platform.machine()).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    return BUILD_DIR / f"libndi_native-{build_key()}.so"


def build(verbose: bool = True) -> Path:
    out = library_path()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(".so.tmp")
    cmd = ["g++", *FLAGS, *map(str, sources()), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    tmp.replace(out)  # never leave a half-written library under the key
    return out


if __name__ == "__main__":
    print(f"built {build()}")
    sys.exit(0)
