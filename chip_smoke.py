"""Smoke run of the prover on an NVIDIA GPU: the main path at full size, every
hand-written kernel against its plain reference, in ONE process.

    python chip_smoke.py          # one card: phases device, stark101, real, kernels
    python chip_smoke.py --four   # four cards: the sharded and data-parallel
                                  # paths against the single-card bytes

Phases (each raises on any mismatch, so a failure exits non-zero):
  device    the platform must be "gpu"; prints device kind, JAX version,
            compile-cache directory and the card's name and power limit;
  stark101  the 7,836-byte golden transcript from prove, prove(fused=False),
            prove_pipelined, prove_batch (B=8) and the CLI, accepted by the
            Python and C++ verifiers; STARK101_Q3's golden; the second prime;
  real      square-chain statements on 2^24- and 2^26-point domains through
            plain prove(): cold/warm seconds, the process's peak device
            memory after each proof (it runs before `kernels`, so the first
            statement's peak is its own, stark-101's being far smaller),
            proof bytes, both verifiers;
  kernels   SHA-256 leaf (2^24) and node (2^23 pairs) hashing: the GPU kernel,
            the fori_loop form and (leaves) the unrolled plain form, bit-equal
            and checked against hashlib, each timed; the four-step NTT against the
            flat radix-2 chain and host-numpy sampled outputs at 2^24 (both
            directions, both timed) and 2^27 (forward); tests/test_gpu.py.
Every line that carries a number names the card and its power limit. The
last line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

GOLDEN_STATE = "d7eec91544f72a592145e7d505a2f274de740e0319ede8c983fd84c7736f6712"
Q3_STATE = "8a33e974201e1cd6e3b996d11adecfffaccd2cce2efb7253fb2eb5f7f3077eb1"
CARD = None  # "name, power limit" from nvidia-smi, set by phase_device
SHA_LOG_N = 24  # leaf hashes 2^24 values, node hashes 2^23 pairs
NTT_LOG_N = (24, 27)  # four-step vs radix-2 + samples at the first, samples at the second
REAL_TRACE_BITS = (21, 23)  # square-chain statements: 2^24- and 2^26-point domains


class SmokeFailure(AssertionError):
    pass


def check(cond, what: str):
    if not cond:
        raise SmokeFailure(what)


def report(phase: str, **fields):
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


def quietly(fn, *args):
    """fn(*args) with its stdout captured: (result, captured lines), so that
    what it prints can be reported on a line that names the card."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue().splitlines()


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def median_seconds(fn, *args, reps: int = 5) -> float:
    import jax

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_device():
    global CARD
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's first device is {dev.platform}", file=sys.stderr)
        sys.exit(2)
    import zkstark_tpu

    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
    ).stdout.strip().splitlines()[0]
    print(CARD, flush=True)
    report(
        "device",
        device_kind=dev.device_kind,
        count=len(jax.devices()),
        jax=jax.__version__,
        cache_dir=zkstark_tpu.compilation_cache_dir(),
    )


def _verify_both(proof, cfg):
    from zkstark_tpu import native
    from zkstark_tpu.protocol import verify

    check(native.native() is not None, "native verifier failed to build")
    t0 = time.perf_counter()
    verify(proof, cfg)
    py = time.perf_counter() - t0
    native.verify_native(proof, cfg)
    return py


def phase_stark101():
    from zkstark_tpu.__main__ import main as cli
    from zkstark_tpu.protocol import (
        STARK101,
        STARK101_Q3,
        STARK101_SECRET,
        prove,
        prove_pipelined,
    )
    from zkstark_tpu.protocol.batch import prove_batch
    from zkstark_tpu.protocol.config import alt_field_config

    t0 = time.perf_counter()
    proof = prove(STARK101, STARK101_SECRET)
    cold = time.perf_counter() - t0
    check(len(proof.data) == 7836, f"stark-101 length {len(proof.data)}")
    check(proof.state.hex() == GOLDEN_STATE, "stark-101 final state")
    _verify_both(proof, STARK101)
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        again = prove(STARK101, STARK101_SECRET)
        warm.append(time.perf_counter() - t0)
        check(again.data == proof.data, "stark-101 repeat bytes")
    report("stark101", path="prove", cold_s=cold, warm_median_s=statistics.median(warm),
           bytes=len(proof.data), state=proof.state.hex())

    variants = {
        "fused=False": lambda: [prove(STARK101, STARK101_SECRET, fused=False)],
        "prove_pipelined": lambda: prove_pipelined(STARK101, [STARK101_SECRET] * 3),
        "prove_batch_b8": lambda: prove_batch(STARK101, [STARK101_SECRET] * 8),
    }
    for name, fn in variants.items():
        t0 = time.perf_counter()
        proofs = fn()
        dt = time.perf_counter() - t0
        check(all(p.data == proof.data and p.state == proof.state for p in proofs),
              f"{name} bytes differ from prove()")
        report("stark101", path=name, proofs=len(proofs), cold_s=dt)

    printed = []
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "proof.bin")
        for argv in (["--json", "prove", "--out", out], ["--json", "verify", out]):
            rc, lines = quietly(cli, argv)
            check(rc == 0, f"CLI {argv[1]} rc {rc}")
            printed += lines
        with open(out, "rb") as f:
            check(f.read() == proof.to_bytes(), "CLI proof bytes differ from prove()")
    rc, lines = quietly(cli, ["--json", "run"])
    check(rc == 0, f"CLI run rc {rc}")
    report("stark101", path="cli", bytes_equal=True,
           printed=[json.loads(line) for line in printed + lines])

    q3 = prove(STARK101_Q3, STARK101_SECRET)
    check(len(q3.data) == 22628 and q3.state.hex() == Q3_STATE, "STARK101_Q3 golden")
    _verify_both(q3, STARK101_Q3)
    alt = alt_field_config()
    alt_proof = prove(alt, STARK101_SECRET)
    _verify_both(alt_proof, alt)
    report("stark101", path="q3+alt_field", q3_bytes=len(q3.data),
           alt_prime=alt.field.p, alt_bytes=len(alt_proof.data))


def _sha_checks():
    import jax
    import jax.numpy as jnp

    from zkstark_tpu.hash import sha256
    from zkstark_tpu.ops import sha256_kernel

    rng = np.random.default_rng(1)
    n = 1 << SHA_LOG_N
    vals = jnp.asarray(rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32))
    pairs = jnp.asarray(
        rng.integers(0, 1 << 32, (n // 2, 16), dtype=np.uint64).astype(np.uint32)
    )
    versions = {
        "leaf": {
            "kernel": sha256_kernel.leaf_hash,
            "fori_loop": jax.jit(sha256.leaf_hash_loop),
            "unrolled_jnp": sha256.leaf_hash_unrolled,
        },
        # no unrolled node form: XLA did not finish compiling its ~5,000-op
        # fusion within 20 minutes on the card
        "node": {
            "kernel": sha256_kernel.node_hash,
            "fori_loop": jax.jit(sha256.node_hash_loop),
        },
    }
    sample = [0, 1, 12345 % (n // 2), n // 2 - 1]
    for kind, arg in (("leaf", vals), ("node", pairs)):
        outs = {}
        for name, fn in versions[kind].items():
            outs[name], first = timed(fn, arg)
            med = median_seconds(fn, arg)
            report("kernels", op=f"sha256_{kind}", version=name, n=int(arg.shape[0]),
                   first_call_s=first, median_s=med,
                   hashes_per_s=arg.shape[0] / med)
        ref = np.asarray(outs["fori_loop"])
        for name, out in outs.items():
            check(np.array_equal(np.asarray(out), ref), f"sha256 {kind} {name} != fori_loop")
        host = np.asarray(arg)
        for i in sample:
            msg = (int(host[i]).to_bytes(4, "big") if kind == "leaf"
                   else host[i].astype(">u4").tobytes())
            check(sha256.digest_to_bytes(ref[i]) == hashlib.sha256(msg).digest(),
                  f"sha256 {kind} row {i} != hashlib")


def _host_dft_samples(x_std: np.ndarray, w: int, ks, field) -> list:
    """Σ_j x[j]·w^{jk} mod p for a few k, in host numpy (exact u64)."""
    p = np.uint64(field.p)
    out = []
    for k in ks:
        wk = pow(w, int(k), field.p)
        pw = field.host_powers_pow2(wk, x_std.shape[0]).astype(np.uint64)
        terms = (x_std.astype(np.uint64) * pw) % p
        out.append(int(terms.sum(dtype=np.uint64) % p))
    return out


def _ntt_checks():
    import jax
    import jax.numpy as jnp

    from zkstark_tpu import ntt
    from zkstark_tpu.field.fp import FIELD101 as F
    from zkstark_tpu.ntt import core

    rng = np.random.default_rng(2)
    for log_n, with_radix2 in zip(NTT_LOG_N, (True, False)):
        n = 1 << log_n
        x_std = rng.integers(0, F.p, n, dtype=np.uint64).astype(np.uint32)
        x = jnp.asarray(F.host_to_mont(x_std))
        fwd, inv = ntt.forward_plan(n), ntt.inverse_plan(n)
        four = jax.jit(lambda v: ntt.ntt(v, fwd))
        y, first = timed(four, x)
        ks = [0, 1, 777, n - 1]
        want = _host_dft_samples(x_std, fwd.w, ks, F)
        y_std = np.asarray(F.from_mont(y))
        check([int(y_std[k]) for k in ks] == want, f"NTT 2^{log_n} sampled outputs")
        fields = dict(op="ntt_forward", n=n, first_call_s=first,
                      fourstep_median_s=median_seconds(four, x))
        if with_radix2:
            tables = {}
            for d, plan in (("forward", fwd), ("inverse", inv)):
                tables[d] = (
                    jnp.asarray(core.bit_reverse_indices(n)),
                    tuple(jnp.asarray(t) for t in core.radix2_twiddles(n, plan.w, F)),
                )
            flat = jax.jit(lambda v, br, tw: core.radix2(v, br, tw, F))
            y2 = flat(x, *tables["forward"])
            check(np.array_equal(np.asarray(y2), np.asarray(y)), f"NTT 2^{log_n} four-step != radix-2")
            fields["radix2_median_s"] = median_seconds(flat, x, *tables["forward"])
            inv4 = jax.jit(lambda v: ntt.intt(v, inv))
            back = inv4(y)
            check(np.array_equal(np.asarray(back), np.asarray(x)), f"INTT 2^{log_n} round trip")
            back2 = F.mont_mul(flat(y, *tables["inverse"]), np.uint32(inv.scale_mont))
            check(np.array_equal(np.asarray(back2), np.asarray(back)), f"INTT 2^{log_n} four-step != radix-2")
            want_inv = _host_dft_samples(np.asarray(F.from_mont(y)), inv.w, ks, F)
            got_inv = np.asarray(F.from_mont(back))
            n_inv = pow(n, F.p - 2, F.p)
            check([int(got_inv[k]) for k in ks] == [v * n_inv % F.p for v in want_inv],
                  f"INTT 2^{log_n} sampled outputs")
            fields["inverse_fourstep_median_s"] = median_seconds(inv4, y)
        report("kernels", **fields)
        del x, y


def phase_kernels():
    _sha_checks()
    _ntt_checks()
    # the `gpu`-marked tests, in this process (one process per card)
    import pytest

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "test_gpu.py")
    rc, lines = quietly(pytest.main, ["-q", "-m", "gpu", "-p", "no:cacheprovider", tests])
    check(rc == 0 and "skipped" not in lines[-1],
          f"gpu-marked tests failed or skipped (pytest rc {rc}):\n" + "\n".join(lines))
    report("kernels", op="tests/test_gpu.py", pytest_rc=int(rc), summary=lines[-1:])


def _square_chain_cfg(trace_bits: int):
    from zkstark_tpu.protocol.air import SQUARE_CHAIN
    from zkstark_tpu.protocol.config import StarkConfig

    trace_len = (1 << trace_bits) - 1
    trace = SQUARE_CHAIN.trace(trace_len, 271828)
    return StarkConfig(trace_len=trace_len, boundary_last=int(trace[-1]), air=SQUARE_CHAIN)


def phase_real():
    import jax

    from zkstark_tpu.protocol import prove

    dev = jax.devices()[0]
    for trace_bits in REAL_TRACE_BITS:
        cfg = _square_chain_cfg(trace_bits)
        t0 = time.perf_counter()
        proof = prove(cfg, 271828)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = prove(cfg, 271828)
        warm = time.perf_counter() - t0
        check(again.data == proof.data, f"2^{cfg.eval_domain.bit_length() - 1} repeat bytes")
        verify_s = _verify_both(proof, cfg)
        report("real", eval_domain=cfg.eval_domain, trace_len=cfg.trace_len,
               cold_prove_s=cold, warm_prove_s=warm,
               process_peak_bytes_in_use=dev.memory_stats()["peak_bytes_in_use"],
               proof_bytes=len(proof.data), verify_s=verify_s)


def phase_four():
    """prove(mesh=make_mesh(4)) and DP prove_batch over four cards, each
    byte-identical to the single-card proof made on device 0."""
    import jax
    from jax.sharding import Mesh

    from zkstark_tpu.parallel.mesh import make_mesh
    from zkstark_tpu.protocol import STARK101, STARK101_SECRET, prove
    from zkstark_tpu.protocol.batch import prove_batch

    devices = jax.devices()
    check(len(devices) == 4 and all(d.platform == "gpu" for d in devices),
          f"--four needs four GPUs, have {devices}")
    mesh = make_mesh(4)
    stark101 = prove(STARK101, STARK101_SECRET)
    _check_sharded("stark101", STARK101, STARK101_SECRET, stark101, mesh)
    dp_mesh = Mesh(np.array(devices), ("data",))
    t0 = time.perf_counter()
    proofs = prove_batch(STARK101, [STARK101_SECRET] * 8, mesh=dp_mesh)
    dt = time.perf_counter() - t0
    check(all(p.data == stark101.data and p.state == stark101.state for p in proofs),
          "DP prove_batch bytes differ from the single-card proof")
    report("four", path="prove_batch(mesh=data x4) b8", cold_s=dt)
    cfg = _square_chain_cfg(21)
    _check_sharded("square_chain_2e24", cfg, 271828, prove(cfg, 271828), mesh)


def _check_sharded(name, cfg, secret, single, mesh):
    from zkstark_tpu.protocol import prove

    t0 = time.perf_counter()
    sharded = prove(cfg, secret, mesh=mesh)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = prove(cfg, secret, mesh=mesh)
    warm = time.perf_counter() - t0
    check(sharded.data == single.data and sharded.state == single.state,
          f"{name}: sharded bytes differ from the single-card proof")
    _verify_both(sharded, cfg)
    report("four", path=f"prove(mesh=make_mesh(4)) {name}",
           eval_domain=cfg.eval_domain, cold_prove_s=cold, warm_prove_s=warm)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded and data-parallel paths")
    args = ap.parse_args(argv)
    phase_device()
    if args.four:
        phase_four()
    else:
        phase_stark101()
        phase_real()
        phase_kernels()
    import jax

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
