"""EXECUTED multi-process distributed bootstrap (SURVEY.md §5 distributed
comms row): 2 real OS processes + a localhost coordinator through
`jax.distributed.initialize` (via parallel.mesh.initialize_distributed), a
process-spanning ('host','chip') CPU mesh, cross-process collectives in the
sharded prover — and the proof bytes are identical to a solo prove.

This is the multi-host code path that single-process mesh simulation cannot
reach: real process bootstrap, real coordination service, inputs fed as
global replicated arrays, outputs replicated back to every host.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_bootstrap_proof_byte_identical(tmp_path):
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    coord = f"localhost:{_free_port()}"
    # Children get a clean-slate CPU JAX, set at PROCESS START (the worker
    # body would be too late: XLA_FLAGS is read at backend discovery).
    env = {
        k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", coord, str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=780)
            outs.append((p.returncode, out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err[-3000:]}"

    blobs = []
    for i in range(2):
        with open(tmp_path / f"proof_{i}.bin", "rb") as f:
            blobs.append(f.read())
    # every process derived the identical transcript
    assert blobs[0] == blobs[1] and len(blobs[0]) > 32

    # and it matches the solo (no-mesh, this-process) proof byte-for-byte
    from zkstark_tpu.protocol.air import fibonacci_sq_trace
    from zkstark_tpu.protocol.config import StarkConfig
    from zkstark_tpu.protocol.prover import prove
    from zkstark_tpu.protocol.verifier import verify
    from zkstark_tpu.protocol.proof import Proof

    trace = fibonacci_sq_trace(63, 3141592)
    cfg = StarkConfig(trace_len=63, blowup=8, boundary_last=int(trace[-1]))
    solo = prove(cfg, 3141592)
    assert blobs[0] == solo.state + solo.data

    verify(Proof(state=blobs[0][:32], data=blobs[0][32:]), cfg)
