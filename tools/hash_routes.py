"""Time one verified square-chain proof end to end with each SHA-256 route.

    python tools/hash_routes.py --trace-bits 21                # 2^24-point domain
    python tools/hash_routes.py --routes fori_loop kernel --cap 600

Routes: `kernel` (ops/sha256_kernel.py — what prove() uses on a GPU) and
`fori_loop` (hash/sha256.py). The unrolled plain form has no route: its node
hash did not finish compiling in 20 minutes on an H100 even alone. A route is swapped in by
rebinding hash/sha256.py's `leaf_hash` / `node_hash_pairs` for this process
only; each route compiles its own fused program (reported as cold seconds).
Every route must produce the same proof bytes. A route whose cold prove is
still running after --cap seconds is reported as such and the process ends
(a compile cannot be interrupted any other way). One JSON line per route.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import statistics
import subprocess
import threading
import time

import jax


def _routes():
    from zkstark_tpu.hash import sha256
    from zkstark_tpu.ops import sha256_kernel

    return {
        "kernel": (sha256_kernel.leaf_hash, sha256_kernel.node_hash),
        "fori_loop": (sha256.leaf_hash_loop, sha256.node_hash_loop),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-bits", type=int, default=21)
    ap.add_argument("--routes", nargs="+", default=["kernel", "fori_loop"],
                    choices=["kernel", "fori_loop"])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--cap", type=float, default=900.0, help="seconds per cold prove")
    args = ap.parse_args()

    from zkstark_tpu.hash import sha256
    from zkstark_tpu.protocol import fused, prove, verify
    from zkstark_tpu.protocol.air import SQUARE_CHAIN
    from zkstark_tpu.protocol.config import StarkConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip() or "no nvidia-smi"
    dev = jax.devices()[0]
    trace_len = (1 << args.trace_bits) - 1
    secret = 271828
    cfg = StarkConfig(
        trace_len=trace_len,
        boundary_last=int(SQUARE_CHAIN.trace(trace_len, secret)[-1]),
        air=SQUARE_CHAIN,
    )
    routes = _routes()
    ref = None
    for name in args.routes:
        sha256.leaf_hash, sha256.node_hash_pairs = routes[name]
        fused.fused_core_packed.clear_cache()
        fused.fused_core.clear_cache()
        box = {}
        t0 = time.perf_counter()
        worker = threading.Thread(target=lambda: box.update(proof=prove(cfg, secret)), daemon=True)
        worker.start()
        worker.join(args.cap)
        cold = time.perf_counter() - t0
        line = {"route": name, "eval_domain": cfg.eval_domain, "card": card,
                "device_kind": dev.device_kind}
        if "proof" not in box:
            print(json.dumps({**line, "cold_prove_s": f"> {args.cap} (still compiling; stopped)"}),
                  flush=True)
            os._exit(0)
        proof = box["proof"]
        warm = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            again = prove(cfg, secret)
            warm.append(time.perf_counter() - t0)
            assert again.data == proof.data
        verify(proof, cfg)
        if ref is None:
            ref = proof.data
        assert proof.data == ref, f"{name}: proof bytes differ between routes"
        print(json.dumps({**line, "cold_prove_s": cold, "warm_prove_s": warm,
                          "warm_median_s": statistics.median(warm)}), flush=True)


if __name__ == "__main__":
    main()
