"""Data-parallel batched proving: B independent proofs in ONE XLA program.

The reference proves one statement per process (main.rs:15-36). Production
proving is throughput-bound — the DP axis of SURVEY.md §2: batch B witnesses
as a leading array axis, run B Fiat-Shamir chains in lockstep on device
(transcript/device_channel.py is axis-generic), and hash B Merkle trees per
level through the same hash path (it just sees a B× bigger flat batch).
Per-proof transcripts remain byte-identical to single proving — asserted by
tests/test_batch.py against the stark-101 golden.

Sharding: lay the batch axis over the mesh ('data' axis) via
jax.sharding.NamedSharding on the traces — every op here is batch-elementwise,
so GSPMD partitions the whole program with zero collectives.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from zkstark_tpu import ntt
from zkstark_tpu.field import fp
from zkstark_tpu.hash import merkle, sha256
from zkstark_tpu.protocol import air
from zkstark_tpu.protocol import fused
from zkstark_tpu.protocol import prover as pr
from zkstark_tpu.protocol.config import StarkConfig
from zkstark_tpu.protocol.proof import Proof
from zkstark_tpu.transcript import Channel
from zkstark_tpu.transcript import device_channel as dc


@functools.partial(jax.jit, static_argnums=(0,))
def fused_core_batch(cfg: StarkConfig, traces_mont):
    """(B, trace_len) Montgomery traces → batched proof artifacts.

    The batched twin of fused.fused_core: same math, every array carries a
    leading B axis, B channel chains evolve in lockstep."""
    bsz = traces_mont.shape[0]

    coeffs = air.interpolate_trace(traces_mont, cfg.trace_domain, cfg.field)
    f_eval = ntt.coset_ntt(coeffs, cfg.eval_domain, cfg.coset_offset, cfg.field)
    f_res = fp.from_mont_f(cfg.field, f_eval)
    f_levels = merkle.build_levels(f_res)

    state = dc.zero_state((bsz,))
    state = dc.absorb_hash(state, f_levels[-1][:, 0])
    roots = [f_levels[-1][:, 0]]

    alphas = []
    for _ in range(cfg.n_constraints):
        a, state = dc.draw_u32(state)
        alphas.append(a)
    alphas_mont = jnp.stack(
        [dc.draw_to_mont(a, cfg.field) for a in alphas], axis=-1
    )  # (B, n_constraints)
    cp = pr.composition_eval(cfg, f_eval, alphas_mont)
    cp_res = fp.from_mont_f(cfg.field, cp)
    cp_levels = merkle.build_levels(cp_res)
    state = dc.absorb_hash(state, cp_levels[-1][:, 0])
    roots.append(cp_levels[-1][:, 0])

    layer_res = [cp_res]
    layer_levels = [cp_levels]
    evals = cp
    betas = []
    for layer in range(cfg.fri_rounds):
        b, state = dc.draw_u32(state)
        betas.append(b)
        evals, res, levels = pr.fri_fold_eval(
            cfg,
            layer,
            evals,
            dc.draw_to_mont(b, cfg.field)[:, None],
        )
        layer_res.append(res)
        layer_levels.append(levels)
        state = dc.absorb_hash(state, levels[-1][:, 0])
        roots.append(levels[-1][:, 0])
    free_term = layer_res[-1][:, 0]
    state = dc.absorb_u32_le(state, free_term)

    queries = []
    for _ in range(cfg.n_queries):
        q, state = dc.draw_u32(state)
        queries.append(q % jnp.uint32(cfg.query_range))

    return {
        "roots": jnp.stack(roots, axis=1),  # (B, 2+rounds, 8)
        "alphas": jnp.stack(alphas, axis=1),  # (B, n_constraints)
        "betas": (
            jnp.stack(betas, axis=1) if betas else jnp.zeros((bsz, 0), jnp.uint32)
        ),
        "free_term": free_term,
        "queries": jnp.stack(queries, axis=1),  # (B, n_queries)
        # sparse per-proof openings, (B, q, ...) — same device-side gathers
        # as the solo fused prover, so the fetch stays KBs at any batch size
        **fused.sparse_openings(cfg, f_res, f_levels, layer_res, layer_levels, queries),
    }


@functools.partial(jax.jit, static_argnums=(0,))
def _fused_core_batch_packed(cfg: StarkConfig, traces_mont):
    return fused.pack_tree(fused_core_batch(cfg, traces_mont))


@functools.lru_cache(maxsize=None)
def _batch_out_spec(cfg: StarkConfig, bsz: int):
    return jax.eval_shape(
        functools.partial(fused_core_batch.__wrapped__, cfg),
        jax.ShapeDtypeStruct((bsz, cfg.trace_len), jnp.uint32),
    )


def _dispatch_batch(cfg: StarkConfig, secrets, mesh=None, data_axis: str = "data"):
    """Witness-check + upload + enqueue ONE fused batch program (async)."""
    traces = np.stack(
        [cfg.air.trace(cfg.trace_len, s, cfg.field.p) for s in secrets]
    )
    for i, s in enumerate(secrets):
        if int(traces[i, -1]) != cfg.boundary_last:
            raise ValueError(f"witness {i} (secret {s}) fails the public boundary")
    traces_mont = jnp.asarray(cfg.field.host_to_mont(traces))
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        traces_mont = jax.device_put(
            traces_mont, NamedSharding(mesh, PartitionSpec(data_axis, None))
        )
    return _fused_core_batch_packed(cfg, traces_mont)


def prove_batch(
    cfg: StarkConfig, secrets, mesh=None, data_axis: str = "data"
) -> list[Proof]:
    """Prove B witnesses; returns B proofs, each byte-identical to a solo
    prove() of the same secret. With a mesh, the batch axis is sharded over
    `data_axis` — pure DP, no cross-device communication."""
    out_dev = _dispatch_batch(cfg, secrets, mesh, data_axis)
    return _finish_batch(cfg, secrets, out_dev)


def prove_batch_pipelined(
    cfg: StarkConfig, secret_batches, depth: int = 2
) -> list[Proof]:
    """Stream of batches with up to `depth` device programs in flight: the
    B-proof host work (per-proof channel replay + decommit serialization —
    the r4 host ceiling that flattened proofs/sec past B=32) overlaps the
    NEXT batch's device compute instead of serializing after it. Bytes are
    identical to prove_batch / solo prove (tested)."""
    from collections import deque

    pending = deque()
    proofs = []
    for secrets in secret_batches:
        pending.append((list(secrets), _dispatch_batch(cfg, secrets)))
        if len(pending) > depth:
            s_, o_ = pending.popleft()
            proofs.extend(_finish_batch(cfg, s_, o_))
    while pending:
        s_, o_ = pending.popleft()
        proofs.extend(_finish_batch(cfg, s_, o_))
    return proofs


def _finish_batch(cfg: StarkConfig, secrets, out_dev) -> list[Proof]:
    """Fetch one batch result (one packed transfer instead of ~30 per-buffer
    round trips) and run the per-proof host replay + decommit serialization."""
    out = fused.unpack_tree(
        jax.device_get(out_dev), _batch_out_spec(cfg, len(secrets))
    )

    proofs = []
    for i in range(len(secrets)):
        channel = Channel()
        art = pr.ProverArtifacts()
        roots = out["roots"][i]
        channel.commit_hash(sha256.digest_to_bytes(roots[0]))
        for k in range(cfg.n_constraints):
            a = channel.get_u32()
            if a != int(out["alphas"][i, k]):
                raise pr.DeviceChannelMismatch(f"proof {i} alpha[{k}]")
        channel.commit_hash(sha256.digest_to_bytes(roots[1]))
        for layer in range(cfg.fri_rounds):
            beta = channel.get_u32()
            if beta != int(out["betas"][i, layer]):
                raise pr.DeviceChannelMismatch(f"proof {i} beta[{layer}]")
            channel.commit_hash(sha256.digest_to_bytes(roots[2 + layer]))
        channel.commit_u32(int(out["free_term"][i]))
        queries = []
        for qi in range(cfg.n_queries):
            x = channel.get_u32() % cfg.query_range
            if x != int(out["queries"][i, qi]):
                raise pr.DeviceChannelMismatch(f"proof {i} query index {qi}")
            queries.append(x)

        sliced = {
            k: [a[i] for a in out[k]] if isinstance(out[k], list) else out[k][i]
            for k in (
                "open_f_vals", "open_f_paths", "open_cp_vals",
                "open_cp_paths", "open_fri_vals", "open_fri_paths",
            )
        }
        pr.fused_decommit(cfg, channel, art, sliced, queries)
        state, data = channel.finalize()
        proofs.append(Proof(state=state, data=data))
    return proofs
