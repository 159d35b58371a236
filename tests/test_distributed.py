"""Multi-host (multi-process) dataset build: 2 processes x 4 CPU devices.

Launches two OS processes that join a jax.distributed cluster (gloo CPU
collectives), build the dataset tree on a global mesh whose "slots" axis
spans the processes, and each check the dataset root
bit-exactly against the oracle (SURVEY.md section 2c multi-host obligation;
replaces the serial loop of reference gen_input/bn254.nim:26-28).
"""

import os
import pathlib
import socket
import subprocess
import sys

import pytest

WORKER = pathlib.Path(__file__).resolve().parent / "_distributed_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dataset_root():
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # XLA:CPU compile of the 2-process SPMD program takes ~5 min at the
    # default opt level (~2.5 min at 0)
    env["XLA_FLAGS"] = "--xla_backend_optimization_level=0"
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:\n{out}\nstderr:\n{err[-4000:]}"
        assert "DSET_ROOT_OK" in out, out
        assert "GL_DSET_ROOT_OK" in out, out
    # both processes computed the same replicated roots
    for marker in ("DSET_ROOT_OK", "GL_DSET_ROOT_OK"):
        roots = {
            line.split()[1]
            for rc, out, _ in outs
            for line in out.splitlines()
            if line.startswith(marker)
        }
        assert len(roots) == 1, (marker, roots)
