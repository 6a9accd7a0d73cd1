"""ctypes bindings for the native C++ runtime (native/zkstark_native.cpp).

Builds the shared library on demand (g++, no external deps) and exposes:
  * the Fiat-Shamir channel primitives (commit / draw),
  * batched scalar hash helpers,
  * `verify_native` — a fully independent C++ verifier used to cross-check
    the Python verifier and the device prover's transcript bytes (the stand-in
    for "accepted by the reference verifier": no Rust toolchain exists here).

Falls back gracefully (native() returns None) if the toolchain is missing.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_SO = os.path.join(_NATIVE_DIR, "libzkstark_native.so")
_SRC = os.path.join(_NATIVE_DIR, "zkstark_native.cpp")


@functools.lru_cache(maxsize=1)
def native():
    """Load (building if needed) the native library, or None if unavailable."""
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(
            _SRC
        ):
            subprocess.run(
                ["make", "-C", os.path.abspath(_NATIVE_DIR)],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(os.path.abspath(_SO))
    except Exception:
        return None

    lib.zk_channel_commit.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_size_t,
    ]
    lib.zk_channel_draw.argtypes = [ctypes.c_char_p]
    lib.zk_channel_draw.restype = ctypes.c_uint32
    lib.zk_verify.argtypes = [
        ctypes.c_char_p,  # final state (32) or None
        ctypes.c_char_p,  # transcript
        ctypes.c_size_t,
        ctypes.c_uint32,  # trace_len
        ctypes.c_uint32,  # blowup
        ctypes.c_uint32,  # coset_offset
        ctypes.c_uint32,  # n_queries
        ctypes.c_uint32,  # prime (the protocol field, cfg.field.p)
        ctypes.POINTER(ctypes.c_uint32),  # AIR description blob
        ctypes.c_size_t,  # blob length (u32 words)
        ctypes.c_char_p,  # err buf
        ctypes.c_size_t,
    ]
    lib.zk_verify.restype = ctypes.c_int
    return lib


def channel_commit(state: bytes, payload: bytes) -> bytes:
    lib = native()
    buf = ctypes.create_string_buffer(state, 32)
    lib.zk_channel_commit(buf, payload, len(payload))
    return buf.raw[:32]


def channel_draw(state: bytes) -> tuple:
    lib = native()
    buf = ctypes.create_string_buffer(state, 32)
    draw = lib.zk_channel_draw(buf)
    return buf.raw[:32], int(draw)


def verify_native(proof, cfg) -> None:
    """Raise VerificationError if the C++ verifier rejects the proof.

    The constraint system travels as the serialized AIR blob
    (protocol/air.py serialize_air) — the same definition the prover and
    Python verifier consume, interpreted by the C++ RPN evaluator."""
    from zkstark_tpu.protocol.air import serialize_air
    from zkstark_tpu.protocol.verifier import VerificationError

    lib = native()
    if lib is None:
        raise RuntimeError("native library unavailable (no C++ toolchain?)")
    blob = serialize_air(cfg)
    err = ctypes.create_string_buffer(256)
    rc = lib.zk_verify(
        proof.state,
        proof.data,
        len(proof.data),
        cfg.trace_len,
        cfg.blowup,
        cfg.coset_offset,
        cfg.n_queries,
        cfg.field.p,
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(blob),
        err,
        len(err),
    )
    if rc != 0:
        raise VerificationError(f"native(code={rc})", err.value.decode())
