"""CLI driver — the analog of the reference's main() (main.rs:15-36).

The reference binary proves, verifies, and prints timings + proof size with no
flags. This entry point does the same by default and adds the config surface
the reference lacks (SURVEY.md §5 config):

    python -m zkstark_tpu prove   [--out proof.bin] [--secret N] [--trace-len N]
                                  [--blowup N] [--boundary-last N] [--queries Q]
                                  [--air fibonacci-sq|fibonacci] [--json]
    python -m zkstark_tpu verify  proof.bin [--boundary-last N] [--queries Q]
                                  [--air ...] [--json]
    python -m zkstark_tpu run     # prove + verify in one process (main.rs behavior)
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _build_cfg(args, secret: int | None = None) -> "StarkConfig":
    from zkstark_tpu.field.fp import field_for
    from zkstark_tpu.protocol.air import AIRS
    from zkstark_tpu.protocol.config import StarkConfig

    kw = {}
    if args.trace_len is not None:
        kw["trace_len"] = args.trace_len
    if args.blowup is not None:
        kw["blowup"] = args.blowup
    if args.queries is not None:
        kw["n_queries"] = args.queries
    if getattr(args, "prime", None) is not None:
        kw["field"] = field_for(args.prime)
    air_obj = AIRS[args.air] if args.air is not None else None
    if air_obj is not None:
        kw["air"] = air_obj
    if getattr(args, "boundary_last", None) is not None:
        kw["boundary_last"] = args.boundary_last
    elif secret is not None and (kw or secret != 3141592):
        # Proving side: the public output is derived from the witness the
        # prover already knows (trace endpoint). Verifiers of a non-default
        # statement must pass --boundary-last explicitly (it is the public
        # input; prove prints it).
        trace_len = kw.get("trace_len", StarkConfig.trace_len)
        air = air_obj if air_obj is not None else StarkConfig.air
        p = kw["field"].p if "field" in kw else None
        trace = air.trace(trace_len, secret, p) if p else air.trace(trace_len, secret)
        kw["boundary_last"] = int(trace[-1])
    return StarkConfig(**kw)


def _emit(args, payload: dict):
    if args.json:
        print(json.dumps(payload))
    else:
        for k, v in payload.items():
            print(f"{k}: {v}")


def cmd_prove(args) -> int:
    from zkstark_tpu.protocol.prover import prove

    cfg = _build_cfg(args, secret=args.secret)
    t0 = time.perf_counter()
    try:
        if args.checkpoint:
            # resumable: a checkpoint is written at the Fiat-Shamir barrier;
            # re-running the same command after a crash resumes from it
            from zkstark_tpu.protocol.checkpoint import ResumableProver

            proof = ResumableProver(
                cfg, args.secret, args.checkpoint, fused=True
            ).run()
        else:
            proof = prove(cfg, secret=args.secret)
    except ValueError as e:
        _emit(args, {"error": str(e)})
        return 1
    dt = time.perf_counter() - t0
    with open(args.out, "wb") as f:
        f.write(proof.to_bytes())
    _emit(
        args,
        {
            "prover_runtime_seconds": round(dt, 4),
            "proof_size_bytes": proof.size(),
            "boundary_last": cfg.boundary_last,
            "out": args.out,
        },
    )
    return 0


def cmd_verify(args) -> int:
    from zkstark_tpu.protocol.proof import Proof
    from zkstark_tpu.protocol.verifier import VerificationError, verify

    cfg = _build_cfg(args)
    try:
        with open(args.proof, "rb") as f:
            proof = Proof.from_bytes(f.read())
    except (OSError, ValueError) as e:
        _emit(args, {"verified": False, "error": f"unreadable proof: {e}"})
        return 1
    t0 = time.perf_counter()
    try:
        report = verify(proof, cfg)
    except VerificationError as e:
        _emit(args, {"verified": False, "error": str(e)})
        return 1
    dt = time.perf_counter() - t0
    _emit(
        args,
        {
            "verified": True,
            "verifier_runtime_seconds": round(dt, 6),
            "checks_passed": len(report.checks_passed),
        },
    )
    return 0


def cmd_run(args) -> int:
    """prove + verify + size print — the reference main()'s exact behavior."""
    import contextlib

    from zkstark_tpu.protocol.prover import prove
    from zkstark_tpu.protocol.verifier import verify

    cfg = _build_cfg(args, secret=args.secret)
    if args.profile:
        # capture the STEADY-STATE program, not the compile: one warm-up
        # prove outside the trace window
        prove(cfg, secret=args.secret)
    t0 = time.perf_counter()
    try:
        if args.profile:
            import jax

            ctx = jax.profiler.trace(args.profile)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            proof = prove(cfg, secret=args.secret)
    except ValueError as e:
        _emit(args, {"error": str(e)})
        return 1
    t1 = time.perf_counter()
    report = verify(proof, cfg)
    t2 = time.perf_counter()
    _emit(
        args,
        {
            "prover_runtime_seconds": round(t1 - t0, 4),
            "verifier_runtime_seconds": round(t2 - t1, 6),
            "proof_size_bytes": proof.size(),
            "checks_passed": len(report.checks_passed),
        },
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zkstark_tpu")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--trace-len", type=int, default=None)
    ap.add_argument("--blowup", type=int, default=None)
    ap.add_argument(
        "--queries",
        type=int,
        default=None,
        help="FRI query count (default 1, matching the reference's single "
        "query, prover.rs:263)",
    )
    ap.add_argument(
        "--air",
        choices=["fibonacci-sq", "fibonacci", "square-chain"],
        default=None,
        help="constraint system / witness generator (default fibonacci-sq, "
        "the reference's statement; square-chain = MiMC-style iterated "
        "squaring with the secret as the chain seed)",
    )
    ap.add_argument(
        "--prime",
        type=int,
        default=None,
        help="protocol field prime (default 3221225473 = 3*2^30+1, the "
        "reference's Gf<3221225473>; any odd prime < 2^32 with enough "
        "2-adicity for the domain works, e.g. 2013265921 = 15*2^27+1)",
    )
    ap.add_argument(
        "--boundary-last",
        type=int,
        default=None,
        help="public output a[trace_len-1]; derived from the witness when "
        "proving, required when verifying a non-default statement",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("prove", help="generate a proof and write it to a file")
    p.add_argument("--out", default="proof.bin")
    p.add_argument("--secret", type=int, default=3141592)
    p.add_argument(
        "--checkpoint",
        default=None,
        metavar="FILE",
        help="write a resumable checkpoint at the Fiat-Shamir barrier; "
        "re-running after a crash resumes from it (protocol/checkpoint.py)",
    )
    p.set_defaults(fn=cmd_prove)

    v = sub.add_parser("verify", help="verify a proof file")
    v.add_argument("proof")
    v.set_defaults(fn=cmd_verify)

    r = sub.add_parser("run", help="prove + verify in one process (main.rs:15-36)")
    r.add_argument("--secret", type=int, default=3141592)
    r.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="capture a jax.profiler trace (Perfetto/XProf) of one warm "
        "prove into DIR (SURVEY.md §5 tracing)",
    )
    r.set_defaults(fn=cmd_run)

    args = ap.parse_args(argv)
    from zkstark_tpu.parallel.mesh import initialize_distributed

    # Multi-host bootstrap (SURVEY.md §5 distributed-comms row): a no-op
    # single-process, joins the coordinator when a cluster env is present.
    initialize_distributed()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
