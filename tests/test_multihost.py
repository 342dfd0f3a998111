"""Multi-host execution tests (VERDICT r2 task 2).

Spawns a real 2-process ``jax.distributed`` CPU cluster (localhost
coordinator, gloo collectives, 2 virtual devices per process = 4 global)
and drives ``parallel/multihost.py`` end-to-end: initialize → global
mesh → bank-sharded cubic build/eval → cross-process loss reduction →
allgather, checked bit-exactly against the single-process oracle.  See
``tests/multihost_worker.py`` for the per-process program.

SURVEY §7 step 7 ("distributed tests on CPU via jax.distributed").
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

_REPO = Path(__file__).resolve().parent.parent


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("nproc", [2])
def test_multihost_cpu_cluster(nproc):
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                str(_REPO / "tests" / "multihost_worker.py"),
                str(i),
                str(nproc),
                str(port),
            ],
            env=env,
            cwd=_REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"RESULT {i} OK" in out, f"worker {i} output:\n{out}"
    # both workers agreed on the cross-process loss
    losses = {
        line.split("loss=")[1].strip()
        for out in outs
        for line in out.splitlines()
        if "RESULT" in line
    }
    assert len(losses) == 1, losses
