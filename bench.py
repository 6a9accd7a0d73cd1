"""Benchmark harness for one NVIDIA GPU — streams cumulative JSON lines; the
LAST line is the record.

Headline: end-to-end stark-101 prove latency (trace 1023 → 7836-byte proof,
including the host Fiat-Shamir replay and decommitments), verified after
timing. vs_baseline is the speedup over the single-core Python replay of the
reference pipeline at 9.1 s (BASELINE.md; the reference publishes no numbers).

After EVERY measurement the full cumulative record is re-printed as one
stdout JSON line, so a timeout truncates the tail of metrics instead of
losing the run. An elapsed-time budget (--budget, default 1200 s) gates each
expensive metric; skipped metrics are listed in the record's "skipped" field.
Every line names the device (platform, device_kind, count); the run fails
without a GPU.

Metrics, cheapest first:
  * stark101_prove_latency (+ warmup_prove_seconds, verify_seconds, phases)
    and stark101_prove_pipelined_latency (prover.prove_pipelined);
  * merkle_hashes_per_sec_2e20 — 2^20-leaf commitment throughput;
  * ntt_points_per_sec_2e24 — one 2^24 transform, timed in a jitted scan;
  * proofs_per_sec_b32 (one-shot batch) and proofs_per_sec_b64 (pipelined
    across batches — protocol/batch.prove_batch_pipelined).
--all adds the smaller-domain NTT sweep (2^16/2^20/2^22).
"""

import argparse
import json
import sys
import time

import numpy as np

BASELINE_REPLAY_SECONDS = 9.1  # BASELINE.md: survey Python replay, 1 CPU core
DEVICE = {}  # platform / device_kind / count, set in main()

_START = time.perf_counter()


def eprint(obj):
    print(json.dumps({**obj, "device": DEVICE}), file=sys.stderr, flush=True)


class Record:
    """Cumulative benchmark record, re-printed to stdout after every update
    so the last stdout line always carries everything measured so far."""

    def __init__(self):
        self.extra = {}
        self.best = None
        self.provisional = True
        self.skipped = []

    def emit(self):
        line = {
            "metric": "stark101_prove_latency",
            "value": round(self.best, 4) if self.best is not None else None,
            "unit": "seconds",
            "vs_baseline": (
                round(BASELINE_REPLAY_SECONDS / self.best, 2) if self.best else None
            ),
            "device": DEVICE,
            **self.extra,
        }
        if self.provisional:
            line["provisional"] = True
        if self.skipped:
            line["skipped"] = self.skipped
        print(json.dumps(line), flush=True)

    def update(self, **kw):
        self.extra.update(kw)
        self.emit()


def elapsed() -> float:
    return time.perf_counter() - _START


def over_budget(budget: float, section: str, rec: Record, reserve: float = 0.0):
    """True (and records the skip) if running `section` would bust the budget."""
    if elapsed() + reserve > budget:
        rec.skipped.append(section)
        eprint({"phase": "skipped", "section": section, "elapsed": elapsed()})
        rec.emit()
        return True
    return False


def bench_stark101(repeats: int, rec: Record):
    from zkstark_tpu.protocol import STARK101, STARK101_SECRET, prove, verify

    # warm-up: compile everything once
    t0 = time.perf_counter()
    proof = prove(STARK101, STARK101_SECRET)
    warmup = time.perf_counter() - t0
    eprint({"phase": "warmup_prove_seconds", "value": warmup})
    assert len(proof.data) == 7836
    rec.extra.pop("status", None)  # warming is over
    rec.update(warmup_prove_seconds=round(warmup, 3))

    # first timed repeat → provisional headline, so a timeout after this
    # point still records a real steady-state latency
    t0 = time.perf_counter()
    proof = prove(STARK101, STARK101_SECRET)
    times = [time.perf_counter() - t0]
    rec.best = times[0]
    rec.emit()

    for _ in range(repeats - 1):
        t0 = time.perf_counter()
        proof = prove(STARK101, STARK101_SECRET)
        times.append(time.perf_counter() - t0)
    rec.best = min(times)
    rec.provisional = False
    rec.emit()
    eprint({"phase": "prove_seconds_all", "value": times})

    t0 = time.perf_counter()
    verify(proof, STARK101)
    rec.update(verify_seconds=round(time.perf_counter() - t0, 5))

    # one instrumented run: named phase spans (SURVEY.md §5 metrics)
    timings = {}
    prove(STARK101, STARK101_SECRET, timings=timings)
    rec.update(phases={k: round(v, 5) for k, v in timings.items()})

    # steady-state PIPELINED latency: device programs overlapped with host
    # fetch/replay (prover.prove_pipelined)
    from zkstark_tpu.protocol import prove_pipelined

    n_pipe = 12
    proofs = prove_pipelined(STARK101, [STARK101_SECRET] * 2)  # warm-up
    assert all(len(p.data) == 7836 for p in proofs)
    t0 = time.perf_counter()
    proofs = prove_pipelined(STARK101, [STARK101_SECRET] * n_pipe)
    per = (time.perf_counter() - t0) / n_pipe
    assert all(len(p.data) == 7836 for p in proofs)
    rec.update(stark101_prove_pipelined_latency=round(per, 4))
    eprint({"metric": "stark101_prove_pipelined_latency", "value": per})


def bench_ntt(log_n: int, reps: int = 8) -> float:
    """Points/sec for a size-2^log_n forward NTT — ONE jitted program running
    the transform `reps` times back-to-back (output feeds input so nothing is
    DCE'd); per-call dispatch latency is amortized away."""
    import jax
    import jax.numpy as jnp
    from zkstark_tpu import ntt
    from zkstark_tpu.field import fp

    n = 1 << log_n
    plan = ntt.forward_plan(n)

    @jax.jit
    def fn(v):
        def step(c, _):
            return ntt.ntt(c, plan), None

        c, _ = jax.lax.scan(step, v, None, length=reps)
        return c

    rng = np.random.default_rng(0)
    x = jnp.asarray(
        fp.host_to_mont(rng.integers(0, fp.P, n, dtype=np.uint64).astype(np.uint32))
    )
    jax.block_until_ready(fn(x))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        best = min(best, (time.perf_counter() - t0) / reps)
    return n / best


def bench_merkle(log_n: int, repeats: int = 5, reps: int = 8) -> float:
    """SHA-256 hashes/sec for a full 2^log_n-leaf commitment (≈2n hashes) —
    `reps` full trees back-to-back inside ONE jitted scan (root feeds the
    next tree's leaves so nothing is DCE'd); per-call dispatch latency is
    amortized away, like bench_ntt."""
    import jax
    import jax.numpy as jnp
    from zkstark_tpu.hash import merkle

    n = 1 << log_n

    @jax.jit
    def fn(v):
        def step(c, _):
            root = merkle.build_levels(c)[-1][0]
            return c + root[0], root

        _, roots = jax.lax.scan(step, v, None, length=reps)
        return roots

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32))
    jax.block_until_ready(fn(x))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        best = min(best, (time.perf_counter() - t0) / reps)
    return (2 * n - 1) / best


def bench_proofs_per_sec(batch: int = 8, repeats: int = 2) -> float:
    """Data-parallel batched proving throughput (BASELINE.json proofs/sec):
    B lockstep witnesses through fused_core_batch + per-proof transcripts."""
    from zkstark_tpu.protocol import STARK101, STARK101_SECRET
    from zkstark_tpu.protocol.batch import prove_batch

    secrets = [STARK101_SECRET] * batch
    proofs = prove_batch(STARK101, secrets)  # warm-up/compile
    assert all(len(p.data) == 7836 for p in proofs)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        prove_batch(STARK101, secrets)
        best = min(best, time.perf_counter() - t0)
    return batch / best


def bench_proofs_per_sec_pipelined(batch: int, n_batches: int = 4) -> float:
    """Batched throughput with host work OVERLAPPED across batches
    (prove_batch_pipelined) — the production shape: the per-proof replay/
    serialization hides behind the next batch's device program."""
    from zkstark_tpu.protocol import STARK101, STARK101_SECRET
    from zkstark_tpu.protocol.batch import prove_batch_pipelined

    batches = [[STARK101_SECRET] * batch] * n_batches
    proofs = prove_batch_pipelined(STARK101, batches[:2])  # warm
    assert all(len(p.data) == 7836 for p in proofs)
    t0 = time.perf_counter()
    proofs = prove_batch_pipelined(STARK101, batches)
    dt = time.perf_counter() - t0
    assert all(len(p.data) == 7836 for p in proofs)
    return batch * n_batches / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--all", action="store_true", help="also run kernel sweep")
    ap.add_argument("--quick", action="store_true", help="skip kernel + batch metrics")
    ap.add_argument(
        "--batch",
        type=int,
        default=32,
        help="batch size for the proofs/sec metric (each size compiles its "
        "own fused-batch program)",
    )
    ap.add_argument(
        "--budget",
        type=float,
        default=1200.0,
        help="soft wall-clock budget (s); kernel metrics are skipped past it",
    )
    args = ap.parse_args()

    import jax

    import zkstark_tpu

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX's first device is {dev.platform}")
    DEVICE.update(platform=dev.platform, kind=dev.device_kind, count=len(jax.devices()))
    eprint({"phase": "compilation_cache", "value": zkstark_tpu.compilation_cache_dir()})

    rec = Record()
    # one line before any device work: a driver timeout during warm-up then
    # records "bench alive, still warming" instead of nothing at all
    rec.update(status="warming")
    bench_stark101(args.repeats, rec)

    if not args.quick:
        # ---- kernel and batch metrics, cheapest first, budget-gated ----
        if not over_budget(args.budget, "merkle_2e20", rec):
            hps = bench_merkle(20)
            rec.update(merkle_hashes_per_sec_2e20=round(hps))
            eprint({"metric": "merkle_hashes_per_sec_2e20", "value": hps})
        if not over_budget(args.budget, "ntt_2e24", rec):
            pps = bench_ntt(24)
            rec.update(ntt_points_per_sec_2e24=round(pps))
            eprint({"metric": "ntt_points_per_sec_2e24", "value": pps})
        if not over_budget(args.budget, f"proofs_per_sec_b{args.batch}", rec):
            pfs = bench_proofs_per_sec(args.batch)
            rec.update(**{f"proofs_per_sec_b{args.batch}": round(pfs, 3)})
            eprint({"metric": f"proofs_per_sec_b{args.batch}", "value": pfs})
        # does batched throughput scale past b32?
        if args.batch == 32 and not over_budget(
            args.budget, "proofs_per_sec_b64", rec, reserve=120
        ):
            pfs64 = bench_proofs_per_sec_pipelined(64)
            rec.update(proofs_per_sec_b64=round(pfs64, 3))
            eprint({"metric": "proofs_per_sec_b64", "value": pfs64,
                    "note": "pipelined (host work overlapped across batches)"})

    if args.all:
        for log_n in (16, 20, 22):
            if over_budget(args.budget, f"ntt_2e{log_n}", rec):
                continue
            pps = bench_ntt(log_n)
            rec.update(**{f"ntt_points_per_sec_2e{log_n}": round(pps)})
            eprint(
                {
                    "metric": f"ntt_points_per_sec_2e{log_n}",
                    "value": pps,
                    "unit": "points/s",
                }
            )

    rec.update(total_bench_seconds=round(elapsed(), 1))


if __name__ == "__main__":
    main()
