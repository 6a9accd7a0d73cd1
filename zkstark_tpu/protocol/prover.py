"""The 4-phase STARK prover, device-resident except the Fiat-Shamir spine.

Phase map (mirrors SURVEY.md §3.2 / prover.rs:9-293, re-shaped for a vector device):
  1. trace (host, sequential recurrence) → INTT interpolation + coset-NTT LDE
     + Merkle commit (device) → commit root (host channel sync);
  2. constraint composition evaluated *pointwise on the coset* — the
     polynomial long divisions of prover.rs:101-145 become batched field
     inversions against precomputed vanishing denominators, and the f(g·x),
     f(g²·x) shifts become rolls by ±blowup lanes (g = h^blowup, which is
     also why the reference opens x+8 and x+16, prover.rs:268-271);
  3. FRI: evaluation-form folds (the identity asserted by the reference's own
     fri_test, polynomial.rs:419-425, and verifier, proof.rs:107-113), each
     followed by a Merkle commit and a channel sync for β;
  4. decommit: one query, 4 trace openings + fri_rounds layer-pair openings.

Every device phase is a jitted XLA program; the host only runs the ~40-hash
serial channel chain and O(log n) auth-path gathers. Each channel sync blocks
only on the 32-byte Merkle root, letting XLA pipeline the rest.
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from zkstark_tpu import ntt
from zkstark_tpu.field import fp
from zkstark_tpu.hash import merkle, sha256
from zkstark_tpu.protocol import air
from zkstark_tpu.protocol.config import StarkConfig
from zkstark_tpu.protocol.proof import Proof
from zkstark_tpu.transcript import Channel, bincode


def _mont_scalar(v: int, field: fp.Field = fp.FIELD101) -> np.uint32:
    # numpy scalar: embeds as a literal when closed over inside a trace (a
    # cached jnp scalar would be a device constant lowering must fetch back)
    return field.mont_scalar(v)


# Domains up to this size get their protocol constants from exact host
# numpy (microseconds, zero XLA compiles); bigger domains keep the device
# path, whose arrays stay shardable under GSPMD instead of becoming huge
# replicated MLIR constants.
_HOST_CONST_MAX = 1 << 20


def composition_constants(cfg: StarkConfig):
    """Denominators for the pointwise constraint evaluation.

    The coset offset·⟨h⟩ is disjoint from ⟨h⟩ ⊇ ⟨g⟩ (offset=5 generates all of
    F_p^*), so every denominator is invertible on the evaluation domain and the
    reference's exact polynomial divisions (no remainder, prover.rs:148-151)
    equal these pointwise quotients.

    Ordinary domains (≤ 2^20): cached exact HOST NUMPY arrays. Numpy is the
    load-bearing choice twice over: (a) a numpy constant closed over by a
    traced function embeds into the lowered module straight from host memory,
    whereas a cached DEVICE array forces a device→host fetch during
    lowering, and (b) numpy can
    never be a leaked tracer, the round-3 regression that broke batched and
    sharded proving in mixed-trace processes.

    Large domains (> 2^20): computed IN-TRACE per program via elementwise
    powers_iota — no multi-MB constants in the module, and the arrays come
    up natively sharded under GSPMD (each device builds exactly its block).
    """
    if cfg.eval_domain <= _HOST_CONST_MAX:
        return _composition_constants_host(cfg)
    return _composition_constants_impl(cfg)


@functools.lru_cache(maxsize=None)
def _composition_constants_host(cfg: StarkConfig):
    """Exact numpy twin of _composition_constants_impl (same Montgomery-form
    uint32 outputs bit-for-bit; u64 modular arithmetic is exact). Returns
    HOST numpy arrays — safe to cache (never tracers) and free to embed."""
    n, d, o = cfg.trace_domain, cfg.eval_domain, cfg.coset_offset
    fld = cfg.field
    g = cfg.trace_generator
    h = cfg.domain_generator
    p64 = np.uint64(fld.p)

    xs_std = fld.host_powers_pow2(h, d, scale=o)  # the coset domain, residues
    xs64 = xs_std.astype(np.uint64)

    inv_dens = []
    for con in cfg.constraints:
        if isinstance(con, air.Boundary):
            point = np.uint64(pow(g, con.step, fld.p))
            den = (xs64 + p64 - point) % p64
            inv_dens.append(fld.host_to_mont(fld.host_inv_vec(den)))
        else:
            # x^n − 1 over the coset, then ×(x − g^e) per exempt point
            xn = np.ones_like(xs64)
            base, e = xs64, n
            while e:
                if e & 1:
                    xn = (xn * base) % p64
                base = (base * base) % p64
                e >>= 1
            num = (xn + p64 - np.uint64(1)) % p64
            den = np.ones_like(xs64)
            for ex in con.exempt:
                ge = np.uint64(pow(g, ex, fld.p))
                den = (den * ((xs64 + p64 - ge) % p64)) % p64
            inv = (den * fld.host_inv_vec(num).astype(np.uint64)) % p64
            inv_dens.append(fld.host_to_mont(inv.astype(np.uint32)))

    return {
        "xs": fld.host_to_mont(xs_std),
        "inv_dens": tuple(inv_dens),
    }


def _composition_constants_impl(cfg: StarkConfig):
    n, d, o = cfg.trace_domain, cfg.eval_domain, cfg.coset_offset
    fld = cfg.field
    g = cfg.trace_generator
    h = cfg.domain_generator

    # powers_iota (not device_powers): each element depends only on its own
    # index, so the coset domain shards cleanly under GSPMD — this path is
    # exactly the >2^20 domains the sharded 2^24 runs hit.
    xs = fp.powers_iota_f(fld, h, d, scale=o)  # the coset domain
    one = jnp.full((d,), jnp.uint32(fld.r_mod_p))

    # One inverse-denominator vector per AIR constraint, in alpha order:
    #   Boundary(step, v):     1/(x − g^step)
    #   Transition(num, ex):   1/Z, Z = (x^n − 1) / Π_{e ∈ ex} (x − g^e)
    # (the reference's c0/c1/c2 denominators, prover.rs:101-145, generalized)
    inv_dens = []
    for con in cfg.constraints:
        if isinstance(con, air.Boundary):
            point = jnp.broadcast_to(
                _mont_scalar(pow(g, con.step, fld.p), fld), (d,)
            )
            inv_dens.append(fp.inv_f(fld, fp.sub_f(fld, xs, point)))
        else:
            num = fp.sub_f(fld, fp.pow_static_f(fld, xs, n), one)
            den = one
            for e in con.exempt:
                den = fp.mont_mul_f(
                    fld,
                    den,
                    fp.sub_f(
                        fld,
                        xs,
                        jnp.broadcast_to(_mont_scalar(pow(g, e, fld.p), fld), (d,)),
                    ),
                )
            inv_dens.append(fp.mont_mul_f(fld, den, fp.inv_f(fld, num)))

    return {"xs": xs, "inv_dens": tuple(inv_dens)}


def fri_layer_constants(cfg: StarkConfig, layer: int):
    """Inverse first-half domain for the evaluation-form fold at `layer`.

    Layer-k domain is {offset^{2^k}·(h^{2^k})^j}; we need 1/x_j for j < m/2
    plus the constant 1/2. Constant policy mirrors composition_constants,
    keyed on THIS LAYER's own size (not cfg.eval_domain — a big proof's late
    FRI layers are tiny and take the host path): cached HOST NUMPY when the
    layer's half-domain ≤ 2^20 (free to embed at lowering, never a tracer),
    in-trace powers_iota above (shardable, no giant module constants). The
    host builder's n ≥ 1 assert (host_powers_pow2) guards the d // 2 == 0
    degenerate layer."""
    if (cfg.eval_domain >> layer) // 2 <= _HOST_CONST_MAX:
        return _fri_layer_constants_host(cfg, layer)
    return _fri_layer_constants_impl(cfg, layer)


@functools.lru_cache(maxsize=None)
def _fri_layer_constants_host(cfg: StarkConfig, layer: int) -> np.ndarray:
    fld = cfg.field
    d = cfg.eval_domain >> layer
    base = pow(cfg.domain_generator, 1 << layer, fld.p)
    off = pow(cfg.coset_offset, 1 << layer, fld.p)
    inv_base = pow(base, fld.p - 2, fld.p)
    inv_off = pow(off, fld.p - 2, fld.p)
    return fld.host_to_mont(fld.host_powers_pow2(inv_base, d // 2, scale=inv_off))


def _fri_layer_constants_impl(cfg: StarkConfig, layer: int):
    fld = cfg.field
    d = cfg.eval_domain >> layer
    base = pow(cfg.domain_generator, 1 << layer, fld.p)
    off = pow(cfg.coset_offset, 1 << layer, fld.p)
    inv_base = pow(base, fld.p - 2, fld.p)
    inv_off = pow(off, fld.p - 2, fld.p)
    # powers_iota for GSPMD shardability (see _composition_constants_impl).
    return fp.powers_iota_f(fld, inv_base, d // 2, scale=inv_off)


_INV2 = (fp.P + 1) // 2  # 1/2 in the DEFAULT field (generic: (p+1)//2)


@functools.partial(jax.jit, static_argnums=(0,))
def _phase1(cfg: StarkConfig, trace_mont):
    """Interpolate + LDE + leaf residues + Merkle levels, one XLA program."""
    coeffs = air.interpolate_trace(trace_mont, cfg.trace_domain, cfg.field)
    f_eval = ntt.coset_ntt(coeffs, cfg.eval_domain, cfg.coset_offset, cfg.field)
    f_res = fp.from_mont_f(cfg.field, f_eval)
    levels = merkle.build_levels(f_res)
    return f_eval, f_res, levels


def composition_eval(cfg: StarkConfig, f_eval, alphas_mont):
    """Pointwise constraint composition on the coset (prover.rs:87-180),
    derived from the config's pluggable AIR (protocol/air.py).

    The single source of truth for the phase-2 math — used by the host-synced
    prover, the fused device-channel prover, the batched prover, and the
    sharded pipeline. Works on any leading batch shape (last axis = the
    evaluation domain). The f(g^k·x) shifts the constraints read are rolls by
    k·blowup lanes (g = h^blowup — why the reference opens x+8 and x+16,
    prover.rs:268-271)."""
    c = composition_constants(cfg)
    fld = cfg.field
    b = cfg.blowup
    shifted = {
        k: f_eval if k == 0 else jnp.roll(f_eval, -k * b, axis=-1)
        for k in cfg.air.shifts
    }
    acc = None
    for i, (con, inv_den) in enumerate(zip(cfg.constraints, c["inv_dens"])):
        if isinstance(con, air.Boundary):
            num = fp.sub_f(
                fld,
                shifted[0],
                jnp.broadcast_to(_mont_scalar(con.value, fld), f_eval.shape),
            )
        else:
            num = con.numerator(air.device_ops(fld), lambda k: shifted[k], c["xs"])
        term = fp.mont_mul_f(
            fld, fp.mont_mul_f(fld, num, inv_den), alphas_mont[..., i : i + 1]
        )
        acc = term if acc is None else fp.add_f(fld, acc, term)
    return acc


@functools.partial(jax.jit, static_argnums=(0,))
def _phase2(cfg: StarkConfig, f_eval, alphas_mont):
    cp = composition_eval(cfg, f_eval, alphas_mont)
    cp_res = fp.from_mont_f(cfg.field, cp)
    levels = merkle.build_levels(cp_res)
    return cp, cp_res, levels


def fri_fold_eval(cfg: StarkConfig, layer: int, evals, beta_mont):
    """Evaluation-form FRI fold: P'(x²) = (P(x)+P(−x))/2 + β·(P(x)−P(−x))/(2x).

    Identical to the reference's coefficient fold (polynomial.rs:385-400) on
    the halved-and-squared domain — the identity its verifier checks at
    proof.rs:107-113. Returns (folded_evals, residues, merkle levels).

    Last axis = the layer domain; leading axes are batch proofs (beta_mont
    must then carry matching leading axes)."""
    fld = cfg.field
    inv_x = fri_layer_constants(cfg, layer)
    half = evals.shape[-1] // 2
    a, b = evals[..., :half], evals[..., half:]
    inv2 = _mont_scalar((fld.p + 1) // 2, fld)
    even = fp.mont_mul_f(fld, fp.add_f(fld, a, b), inv2)
    odd = fp.mont_mul_f(fld, fp.mont_mul_f(fld, fp.sub_f(fld, a, b), inv2), inv_x)
    folded = fp.add_f(fld, even, fp.mont_mul_f(fld, odd, beta_mont))
    res = fp.from_mont_f(fld, folded)
    levels = merkle.build_levels(res)
    return folded, res, levels


_fri_fold = jax.jit(fri_fold_eval, static_argnums=(0, 1))


def _root_bytes(levels) -> bytes:
    return sha256.digest_to_bytes(np.asarray(levels[-1][0]))


class ProverArtifacts:
    """Per-phase outputs kept for decommitment, inspection and checkpointing."""

    def __init__(self):
        self.f_res = None
        self.f_tree = None
        self.layer_res = []  # residues per FRI layer, layer 0 = cp_eval
        self.layer_trees = []
        self.query_indices = []

    @property
    def query_index(self):
        return self.query_indices[0] if self.query_indices else None


class DeviceChannelMismatch(RuntimeError):
    """The device-derived Fiat-Shamir chain disagreed with the host replay."""


def fused_replay(cfg: StarkConfig, channel, out) -> list:
    """Replay the byte transcript through the host channel from the fused
    core's fetched roots, asserting every host-derived challenge equals the
    device-derived one (the per-proof device-chain cross-check). Returns the
    query indices. `out` is a host-fetched fused_core output dict."""
    roots = out["roots"]
    channel.commit_hash(sha256.digest_to_bytes(roots[0]))
    for k in range(cfg.n_constraints):
        a = channel.get_u32()
        if a != int(out["alphas"][k]):
            raise DeviceChannelMismatch(f"alpha[{k}]")
    channel.commit_hash(sha256.digest_to_bytes(roots[1]))
    for layer in range(cfg.fri_rounds):
        beta = channel.get_u32()
        if beta != int(out["betas"][layer]):
            raise DeviceChannelMismatch(f"beta[{layer}]")
        channel.commit_hash(sha256.digest_to_bytes(roots[2 + layer]))
    channel.commit_u32(int(out["free_term"]))
    queries = []
    for qi in range(cfg.n_queries):
        x = channel.get_u32() % cfg.query_range
        if x != int(out["queries"][qi]):
            raise DeviceChannelMismatch(f"query index {qi}")
        queries.append(x)
    return queries


def _path_bytes(path_arr) -> list:
    """(depth, 8) uint32 digest rows → list of 32-byte sibling digests."""
    arr = np.asarray(path_arr)
    return [sha256.digest_to_bytes(arr[d]) for d in range(arr.shape[0])]


def fused_decommit(cfg: StarkConfig, channel, art, out, queries) -> None:
    """Phase 4 for the fused path: serialize the device-gathered sparse
    openings (values + auth-path siblings picked on device by fused_core —
    SURVEY.md:110's sparse gathers; only KBs cross the host link, never the
    full Merkle levels). Commit order matches _decommit / prover.rs:256-289."""
    for qi in range(len(queries)):
        for si in range(len(cfg.air.shifts)):
            channel.commit_bytes(
                bincode.ser_opening(
                    int(out["open_f_vals"][qi][si]),
                    _path_bytes(out["open_f_paths"][qi][si]),
                )
            )
        channel.commit_bytes(
            bincode.ser_opening(
                int(out["open_cp_vals"][qi]), _path_bytes(out["open_cp_paths"][qi])
            )
        )
        for layer in range(cfg.fri_rounds):
            v = out["open_fri_vals"][layer][qi]
            p = out["open_fri_paths"][layer][qi]
            channel.commit_bytes(
                bincode.ser_fri_opening(
                    int(v[0]), int(v[1]), _path_bytes(p[0]), _path_bytes(p[1])
                )
            )
    art.query_indices = list(queries)


def _decommit(cfg, channel, art, f_res_h, f_tree_h, layer_res_h, trees_h, queries):
    """Phase 4: per query, len(air.shifts)+1 trace openings + per-layer pair
    openings (prover.rs:256-289, generalized to n_queries — the reference's
    single query is a soundness quirk, SURVEY.md §3.3(b)). All inputs are host
    arrays — zero device syncs."""
    b = cfg.blowup
    for x in queries:
        for k in cfg.air.shifts:
            idx = x + k * b
            channel.commit_bytes(
                bincode.ser_opening(int(f_res_h[idx]), f_tree_h.auth_path(idx))
            )
        channel.commit_bytes(
            bincode.ser_opening(int(layer_res_h[0][x]), trees_h[0].auth_path(x))
        )
        for layer in range(cfg.fri_rounds):
            size = cfg.eval_domain >> layer
            xi = x % size
            nxi = (xi + size // 2) % size
            channel.commit_bytes(
                bincode.ser_fri_opening(
                    int(layer_res_h[layer][xi]),
                    int(layer_res_h[layer][nxi]),
                    trees_h[layer].auth_path(xi),
                    trees_h[layer].auth_path(nxi),
                )
            )
    art.f_res, art.f_tree = f_res_h, f_tree_h
    art.layer_res, art.layer_trees = layer_res_h, trees_h
    art.query_indices = list(queries)


def _trace_to_device(cfg: StarkConfig, secret: int):
    trace = cfg.air.trace(cfg.trace_len, secret, cfg.field.p)
    if int(trace[-1]) != cfg.boundary_last:
        raise ValueError(
            "witness does not satisfy the public boundary: trace endpoint "
            f"{int(trace[-1])} != {cfg.boundary_last}"
        )
    return jnp.asarray(cfg.field.host_to_mont(trace))


class _PhaseClock:
    """Named wall-clock spans filled into a caller-supplied dict (SURVEY.md
    §5 metrics: the per-phase observability the reference's two Instant::now
    spans lack). No-ops (and adds no device syncs) when timings is None."""

    def __init__(self, timings: dict | None):
        self.timings = timings
        self.t0 = time.perf_counter() if timings is not None else 0.0

    def lap(self, name: str, block_on=None):
        if self.timings is None:
            return
        if block_on is not None:
            jax.block_until_ready(block_on)
        now = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + now - self.t0
        self.t0 = now


def prove(
    cfg: StarkConfig = StarkConfig(),
    secret: int = 3141592,
    channel: Channel | None = None,
    artifacts: ProverArtifacts | None = None,
    fused: bool = True,
    timings: dict | None = None,
    mesh=None,
) -> Proof:
    """Generate a proof byte-identical to the reference's generate_proof
    (prover.rs:9-293) for the same config and witness.

    fused=True (default): phases 1-3 and all challenge derivation run as ONE
    XLA program with the channel chain on device (protocol/fused.py); the host
    replays the ~40-hash transcript from the fetched roots and asserts every
    challenge matches — a per-proof cross-check of the device chain.
    fused=False: the legacy host-synced path (one round trip per challenge).
    timings: optional dict filled with named phase spans (seconds); adds
    device fences, so leave None on the latency-critical path.
    mesh: optional jax.sharding.Mesh — runs the device program sharded over
    the evaluation domain (six-step NTT all_to_alls, Merkle subtree gathers,
    cross-shard FRI exchanges); the transcript bytes are identical at any
    mesh size (fused path only)."""
    channel = channel or Channel()
    art = artifacts if artifacts is not None else ProverArtifacts()
    clock = _PhaseClock(timings)

    if mesh is not None and not fused:
        raise ValueError("sharded proving requires the fused path")

    # A mesh pins the default device to its own first device for the whole
    # call: kernel routing (ops.gpu_kernels) and constant placement follow
    # the default device, so a CPU mesh in a process whose default backend is
    # a GPU (or the reverse) traces for the platform its arrays live on.
    import contextlib

    if mesh is not None:
        # pin to this PROCESS's first device of the mesh (a multi-host mesh
        # contains devices this process cannot address)
        local = [
            d for d in mesh.devices.flat if d.process_index == jax.process_index()
        ]
        ctx = jax.default_device(local[0] if local else mesh.devices.flat[0])
    else:
        ctx = contextlib.nullcontext()
    with ctx:
        return _prove_inner(cfg, secret, channel, art, fused, clock, mesh)


def _finish_fused(cfg: StarkConfig, out_dev, channel=None, art=None) -> Proof:
    """Fetch + host-replay + decommit one fused device result → Proof."""
    from zkstark_tpu.protocol import fused as fused_mod

    channel = channel or Channel()
    art = art if art is not None else ProverArtifacts()
    out = fused_mod.unpack_out(cfg, jax.device_get(out_dev))
    queries = fused_replay(cfg, channel, out)
    fused_decommit(cfg, channel, art, out, queries)
    state, data = channel.finalize()
    return Proof(state=state, data=data)


def prove_pipelined(cfg: StarkConfig, secrets, depth: int = 2) -> list:
    """Prove a SEQUENCE of witnesses with the device kept busy: up to
    `depth` fused device programs stay in flight while the host fetches,
    replays, and serializes earlier proofs.

    A solo prove serializes trace upload, device program, fetch and host
    replay. JAX dispatch is asynchronous, so enqueueing proof i+1's program
    BEFORE blocking on proof i's bytes hides the transfers and the host work
    behind device compute; steady-state per-proof latency approaches the
    larger of the device time and the host time.
    Each proof's bytes are identical to a solo prove() (tested) — the
    Fiat-Shamir chain runs on device, so no cross-proof dependency exists.

    This is the latency twin of batch.prove_batch (which instead widens one
    program; combine them for throughput × latency)."""
    from collections import deque

    from zkstark_tpu.protocol import fused as fused_mod

    pending = deque()
    proofs = []
    for s in secrets:
        trace_mont = _trace_to_device(cfg, s)
        pending.append(fused_mod.fused_core_packed(cfg, trace_mont, None))
        if len(pending) > depth:
            proofs.append(_finish_fused(cfg, pending.popleft()))
    while pending:
        proofs.append(_finish_fused(cfg, pending.popleft()))
    return proofs


def _prove_inner(cfg, secret, channel, art, fused, clock, mesh):
    trace_mont = _trace_to_device(cfg, secret)
    if mesh is not None:
        # a GLOBAL replicated array: on a multi-process mesh every process
        # contributes its identical local copy (the standard multihost input
        # path); on single-process meshes this is a no-op placement
        from jax.sharding import NamedSharding, PartitionSpec

        trace_mont = jax.device_put(
            trace_mont, NamedSharding(mesh, PartitionSpec())
        )
    clock.lap("trace", block_on=trace_mont)

    if fused:
        from zkstark_tpu.protocol import fused as fused_mod

        out_dev = fused_mod.fused_core_packed(cfg, trace_mont, mesh)
        clock.lap("device_program", block_on=out_dev)
        out = fused_mod.unpack_out(cfg, jax.device_get(out_dev), mesh)
        clock.lap("fetch")
        queries = fused_replay(cfg, channel, out)
        fused_decommit(cfg, channel, art, out, queries)
        state, data = channel.finalize()
        clock.lap("replay_decommit")
        return Proof(state=state, data=data)

    # ---- Legacy host-synced path ----
    # Phase 1: trace → LDE → commit (prover.rs:24-85)
    f_eval, f_res, f_levels = _phase1(cfg, trace_mont)
    f_tree = merkle.MerkleTree(levels=f_levels)
    channel.commit_hash(_root_bytes(f_levels))
    clock.lap("phase1_lde_commit")

    # Phase 2: composition (prover.rs:87-180)
    alphas = [channel.get_u32() for _ in range(cfg.n_constraints)]
    alphas_mont = jnp.stack([_mont_scalar(a, cfg.field) for a in alphas])
    cp_eval, cp_res, cp_levels = _phase2(cfg, f_eval, alphas_mont)
    channel.commit_hash(_root_bytes(cp_levels))
    clock.lap("phase2_composition")

    # Phase 3: FRI (prover.rs:182-254)
    layer_res = [cp_res]
    layer_trees = [merkle.MerkleTree(levels=cp_levels)]
    evals = cp_eval
    for layer in range(cfg.fri_rounds):
        beta = channel.get_u32()
        evals, res, levels = _fri_fold(
            cfg, layer, evals, _mont_scalar(beta, cfg.field)
        )
        layer_res.append(res)
        layer_trees.append(merkle.MerkleTree(levels=levels))
        channel.commit_hash(_root_bytes(levels))
    free_term = int(np.asarray(layer_res[-1][0]))
    channel.commit_u32(free_term)
    clock.lap("phase3_fri")

    # Phase 4: one bulk device→host transfer for everything decommitment
    # needs (~1 MB); per-element fetches would cost hundreds of round trips.
    f_res_h, f_levels_h, layer_res_h, layer_levels_h = jax.device_get(
        (f_res, f_tree.levels, layer_res, [t.levels for t in layer_trees])
    )
    f_tree_h = merkle.MerkleTree(levels=f_levels_h)
    trees_h = [merkle.MerkleTree(levels=lv) for lv in layer_levels_h]
    clock.lap("fetch")

    queries = [channel.get_u32() % cfg.query_range for _ in range(cfg.n_queries)]
    _decommit(cfg, channel, art, f_res_h, f_tree_h, layer_res_h, trees_h, queries)

    state, data = channel.finalize()
    clock.lap("phase4_decommit")
    return Proof(state=state, data=data)
