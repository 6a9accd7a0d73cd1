"""End-to-end proof at production scale: full Fiat-Shamir transcript +
decommitment at --trace-bits (eval domain = 8× bigger), on the default
backend.

    python tools/prove_big.py --trace-bits 21   # 2^24-point eval domain

Unlike tools/scaling_bench.py (device pipeline with challenges as inputs),
this produces and VERIFIES a real proof — the complete prover path at scale.
Prints one JSON line per step; artifacts go to stdout.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-bits", type=int, default=21)
    ap.add_argument("--blowup", type=int, default=8)
    ap.add_argument("--queries", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()

    from zkstark_tpu.protocol import prove, verify
    from zkstark_tpu.protocol.air import SQUARE_CHAIN
    from zkstark_tpu.protocol.config import StarkConfig

    trace_len = (1 << args.trace_bits) - 1
    t0 = time.perf_counter()
    # square-chain: witness generation is one sequential modular square per
    # step (the Fibonacci AIRs work too; this is the cheapest host loop)
    trace = SQUARE_CHAIN.trace(trace_len, 271828)
    cfg = StarkConfig(
        trace_len=trace_len,
        blowup=args.blowup,
        boundary_last=int(trace[-1]),
        n_queries=args.queries,
        air=SQUARE_CHAIN,
    )
    print(json.dumps({"step": "witness", "seconds": round(time.perf_counter() - t0, 1),
                      "trace_len": trace_len, "eval_domain": cfg.eval_domain,
                      "fri_rounds": cfg.fri_rounds}), flush=True)

    t0 = time.perf_counter()
    proof = prove(cfg, 271828)
    warm = time.perf_counter() - t0
    print(json.dumps({"step": "cold_prove", "seconds": round(warm, 1),
                      "proof_bytes": len(proof.data)}), flush=True)

    best = float("inf")
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        proof = prove(cfg, 271828)
        best = min(best, time.perf_counter() - t0)
    t0 = time.perf_counter()
    verify(proof, cfg)
    vs = time.perf_counter() - t0
    print(json.dumps({
        "metric": f"prove_latency_2e{args.trace_bits + 3}",
        "value": round(best, 3),
        "unit": "seconds",
        "points_per_sec": round(cfg.eval_domain / best),
        "verify_seconds": round(vs, 4),
        "proof_bytes": len(proof.data),
        "trace_bits": args.trace_bits,
        "queries": args.queries,
    }), flush=True)


if __name__ == "__main__":
    main()
