"""The native library's build key: a library is found only under the name
that hashes the current sources, flags and machine architecture, so a
stale or foreign build (other sources, other flags, another CPU family)
is never loaded."""

import subprocess

import pytest

from ndarray_interp_tpu.native import build


def _src(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return path


def test_key_follows_source_content(tmp_path):
    a = _src(tmp_path, "a.cpp", "int f() { return 1; }")
    k1 = build.build_key([a])
    a.write_text("int f() { return 2; }")
    assert build.build_key([a]) != k1
    a.write_text("int f() { return 1; }")
    assert build.build_key([a]) == k1


@pytest.mark.parametrize(
    "change",
    [
        dict(flags=build.FLAGS + ("-march=native",)),
        dict(flags=tuple(f for f in build.FLAGS if f != "-O3")),
        dict(machine="aarch64-other"),
    ],
    ids=["extra-flag", "dropped-flag", "other-arch"],
)
def test_key_follows_flags_and_architecture(tmp_path, change):
    a = _src(tmp_path, "a.cpp", "int f() { return 1; }")
    assert build.build_key([a], **change) != build.build_key([a])


def test_flags_target_no_host_specific_isa():
    assert not any(f.startswith("-march") or f.startswith("-mtune")
                   for f in build.FLAGS)
    assert "-ffp-contract=off" in build.FLAGS


def test_library_path_is_keyed_and_outside_the_package_root():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert build.build_key() in path.name
    assert path.parent != build.HERE


def test_build_writes_the_keyed_name_atomically(tmp_path, monkeypatch):
    """``build`` compiles to a temporary name and renames it, so a failed
    or interrupted compile never leaves a library under the key."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    seen = {}

    def fake_run(cmd, check):
        out = cmd[cmd.index("-o") + 1]
        seen["out"] = out
        with open(out, "wb") as fh:
            fh.write(b"\x7fELF")
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(build.subprocess, "run", fake_run)
    path = build.build(verbose=False)
    assert path == build.library_path()
    assert path.exists() and path.name.endswith(".so")
    assert seen["out"].endswith(".so.tmp")
    assert not (tmp_path / "_build" / (path.name + ".tmp")).exists()

    def failing_run(cmd, check):
        raise subprocess.CalledProcessError(1, cmd)

    path.unlink()
    monkeypatch.setattr(build.subprocess, "run", failing_run)
    with pytest.raises(subprocess.CalledProcessError):
        build.build(verbose=False)
    assert not path.exists()
