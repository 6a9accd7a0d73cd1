"""Single-program prover: phases 1-3 + the Fiat-Shamir chain, one XLA call.

The host-synced prover (prover.py) blocks on a device→host round trip at
every challenge boundary — 13 per proof (SURVEY.md §3.5). Here the channel
hash chain itself runs on device (transcript/device_channel.py), so
interpolation, LDE, Merkle commits, composition, every FRI fold, every
challenge derivation, AND the phase-4 sparse opening gathers compile into
ONE XLA program; only the roots, challenges, and a few KB of gathered
openings ever cross the host link.

The host then *replays* the byte transcript with the host Channel from the
fetched roots/values (≈40 hashlib calls, microseconds) and asserts each
host-derived challenge equals the device-derived one — every proof
cross-checks the device chain against the host chain for free, and the
transcript bytes remain byte-identical to the reference (channel.rs:19-32,
prover.rs:9-293 commit order).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from zkstark_tpu import ntt
from zkstark_tpu.field import fp
from zkstark_tpu.hash import merkle
from zkstark_tpu.protocol import air
from zkstark_tpu.protocol import prover as pr
from zkstark_tpu.protocol.config import StarkConfig
from zkstark_tpu.transcript import device_channel as dc


@functools.partial(jax.jit, static_argnums=(0, 2))
def fused_core(cfg: StarkConfig, trace_mont, mesh=None):
    """trace (Montgomery, (trace_len,)) → everything the transcript and the
    decommitment need, challenges derived on device.

    With `mesh` (static), the whole program is sharded over the evaluation
    domain: six-step NTT LDE (all_to_all transposes), local Merkle subtrees
    + root gathers, cross-shard FRI exchanges — while the transcript stays
    byte-identical to the single-device proof at any mesh size (mesh config
    is separate from protocol config, SURVEY.md §5).

    Returns a dict: roots (2+fri_rounds, 8) u32 digests in commit order,
    alphas (n_constraints,), betas (fri_rounds,), free_term (),
    queries (n_queries,), plus the phase-4 openings gathered ON DEVICE —
    open_f_vals/open_f_paths (per query, per AIR shift), open_cp_vals/
    open_cp_paths, and per-FRI-layer open_fri_vals/open_fri_paths pairs —
    so only a few KB ever cross the host link."""
    if mesh is not None:
        from zkstark_tpu.parallel.fri_sharded import fold_sharded
        from zkstark_tpu.parallel.merkle_sharded import sharded_build_levels
        from zkstark_tpu.parallel.mesh import mesh_size, vec_sharding
        from zkstark_tpu.parallel.ntt_sharded import coset_ntt_sixstep

        n_shards = mesh_size(mesh)

        def build_levels(res):
            if res.shape[0] >= n_shards:
                return sharded_build_levels(res, mesh)
            return merkle.build_levels(res)

        def constrain(arr):
            return jax.lax.with_sharding_constraint(arr, vec_sharding(mesh))

        def lde(coeffs):
            return coset_ntt_sixstep(
                coeffs, cfg.eval_domain, cfg.coset_offset, mesh=mesh,
                field=cfg.field,
            )

        def fold(layer, evals, beta_mont):
            folded = fold_sharded(
                evals,
                beta_mont,
                pr.fri_layer_constants(cfg, layer),
                pr._mont_scalar((cfg.field.p + 1) // 2, cfg.field),
                mesh=mesh if evals.shape[0] // 2 >= n_shards else None,
                field=cfg.field,
            )
            res = fp.from_mont_f(cfg.field, folded)
            return folded, res, build_levels(res)

    else:
        build_levels = merkle.build_levels
        constrain = lambda arr: arr  # noqa: E731

        def lde(coeffs):
            return ntt.coset_ntt(
                coeffs, cfg.eval_domain, cfg.coset_offset, cfg.field
            )

        def fold(layer, evals, beta_mont):
            return pr.fri_fold_eval(cfg, layer, evals, beta_mont)

    # ---- Phase 1: interpolate + LDE + commit (prover.rs:24-85) ----
    coeffs = air.interpolate_trace(trace_mont, cfg.trace_domain, cfg.field)
    f_eval = lde(coeffs)
    f_res = fp.from_mont_f(cfg.field, f_eval)
    f_levels = build_levels(f_res)

    state = dc.zero_state()
    state = dc.absorb_hash(state, f_levels[-1][0])
    roots = [f_levels[-1][0]]

    # ---- Phase 2: composition (prover.rs:87-180) ----
    alphas = []
    for _ in range(cfg.n_constraints):
        a, state = dc.draw_u32(state)
        alphas.append(a)
    alphas_mont = jnp.stack([dc.draw_to_mont(a, cfg.field) for a in alphas])
    cp = constrain(pr.composition_eval(cfg, f_eval, alphas_mont))
    cp_res = fp.from_mont_f(cfg.field, cp)
    cp_levels = build_levels(cp_res)
    state = dc.absorb_hash(state, cp_levels[-1][0])
    roots.append(cp_levels[-1][0])

    # ---- Phase 3: FRI (prover.rs:182-254) ----
    layer_res = [cp_res]
    layer_levels = [cp_levels]
    evals = cp
    betas = []
    for layer in range(cfg.fri_rounds):
        b, state = dc.draw_u32(state)
        betas.append(b)
        evals, res, levels = fold(layer, evals, dc.draw_to_mont(b, cfg.field))
        layer_res.append(res)
        layer_levels.append(levels)
        state = dc.absorb_hash(state, levels[-1][0])
        roots.append(levels[-1][0])
    free_term = layer_res[-1][0]
    state = dc.absorb_u32_le(state, free_term)

    # ---- Phase 4 prologue: the query indices (prover.rs:263, generalized
    # to n_queries; all draws precede the openings so the whole chain stays
    # on device — each draw self-commits, so the draws are distinct) ----
    queries = []
    for _ in range(cfg.n_queries):
        q, state = dc.draw_u32(state)
        queries.append(q % jnp.uint32(cfg.query_range))

    return {
        "roots": jnp.stack(roots),
        "alphas": jnp.stack(alphas),
        "betas": jnp.stack(betas) if betas else jnp.zeros(0, jnp.uint32),
        "free_term": free_term,
        "queries": jnp.stack(queries),
        **sparse_openings(cfg, f_res, f_levels, layer_res, layer_levels, queries),
    }


def pack_tree(out):
    """Ravel every (uint32) leaf of a pytree into ONE flat device vector.

    The fused output dict is ~30 tiny arrays, and each buffer fetch pays a
    device→host round trip. One concatenated vector = one transfer; the host
    re-slices with unpack_tree (shapes are static per config via
    jax.eval_shape — no extra compile or device work)."""
    return jnp.concatenate([jnp.ravel(leaf) for leaf in jax.tree.leaves(out)])


def unpack_tree(flat, shapes):
    """Host-side inverse of pack_tree. `shapes` = jax.eval_shape of the
    unpacked pytree; returns numpy arrays in that structure."""
    import numpy as np

    leaves, treedef = jax.tree.flatten(shapes)
    flat = np.asarray(flat)
    out, pos = [], 0
    for leaf in leaves:
        size = int(np.prod(leaf.shape)) if leaf.shape else 1
        out.append(flat[pos : pos + size].reshape(leaf.shape))
        pos += size
    assert pos == flat.shape[0], (pos, flat.shape)
    return jax.tree.unflatten(treedef, out)


@functools.partial(jax.jit, static_argnums=(0, 2))
def fused_core_packed(cfg: StarkConfig, trace_mont, mesh=None):
    """fused_core with the whole output packed into one flat uint32 vector.

    With a mesh the packed vector is constrained REPLICATED so that every
    process of a multi-host mesh holds the full few-KB result and the host
    replay (fused_replay) can run identically everywhere — the multi-process
    contract: same transcript bytes on every host."""
    flat = pack_tree(fused_core(cfg, trace_mont, mesh))
    if mesh is not None:
        from zkstark_tpu.parallel.mesh import replicated

        flat = jax.lax.with_sharding_constraint(flat, replicated(mesh))
    return flat


@functools.lru_cache(maxsize=None)
def _out_spec(cfg: StarkConfig):
    return jax.eval_shape(
        functools.partial(fused_core.__wrapped__, cfg, mesh=None),
        jax.ShapeDtypeStruct((cfg.trace_len,), jnp.uint32),
    )


def unpack_out(cfg: StarkConfig, flat, mesh=None) -> dict:
    """Host-side inverse of fused_core_packed (mesh doesn't change shapes)."""
    return unpack_tree(flat, _out_spec(cfg))


# ---- Phase 4 openings: SPARSE device-side gathers (SURVEY.md:110) --------
# Fetching every Merkle level to the host costs ~1 MB over the device link
# (90 ms of the round-2 prove latency); the openings themselves are a few
# KB. The query indices live on device (the channel ran here), so gather
# exactly the opened values + auth-path siblings and ship only those.
# Sharded levels: the gathers become tiny GSPMD collectives. All helpers are
# batch-generic over leading axes (the batched prover passes (B,) queries).


def _take_val(arr, idx):
    """arr (..., n), idx (...,) uint32 → (...,)."""
    return jnp.take_along_axis(arr, idx[..., None].astype(jnp.int32), axis=-1)[..., 0]


def _take_digest(level, idx):
    """Digest at index `idx` of a (..., k, 8) level. idx (...,) → (..., 8)."""
    return jnp.take_along_axis(level, idx[..., None, None].astype(jnp.int32), axis=-2)[
        ..., 0, :
    ]


def _auth_path(levels, idx):
    """Sibling digests leaf→root: (..., depth, 8). idx is a traced index."""
    sibs = []
    i = idx
    for level in levels[:-1]:
        sibs.append(_take_digest(level, i ^ jnp.uint32(1)))
        i = i >> 1
    if not sibs:
        return jnp.zeros(jnp.shape(idx) + (0, 8), jnp.uint32)
    return jnp.stack(sibs, axis=-2)


def sparse_openings(cfg, f_res, f_levels, layer_res, layer_levels, queries) -> dict:
    """Every phase-4 opening (values + auth-path siblings), gathered on
    device. `queries` is a list of traced uint32 indices (any leading batch
    shape); layer 0 of layer_res/layer_levels is the composition tree."""
    b = jnp.uint32(cfg.blowup)
    f_vals, f_paths, cp_vals, cp_paths = [], [], [], []
    fri_vals = [[] for _ in range(cfg.fri_rounds)]
    fri_paths = [[] for _ in range(cfg.fri_rounds)]
    for x in queries:
        f_vals.append(
            jnp.stack(
                [_take_val(f_res, x + jnp.uint32(k) * b) for k in cfg.air.shifts],
                axis=-1,
            )
        )
        f_paths.append(
            jnp.stack(
                [_auth_path(f_levels, x + jnp.uint32(k) * b) for k in cfg.air.shifts],
                axis=-3,
            )
        )
        cp_vals.append(_take_val(layer_res[0], x))
        cp_paths.append(_auth_path(layer_levels[0], x))
        for layer in range(cfg.fri_rounds):
            mask = jnp.uint32((cfg.eval_domain >> layer) - 1)
            xi = x & mask
            nxi = (xi + jnp.uint32(cfg.eval_domain >> (layer + 1))) & mask
            fri_vals[layer].append(
                jnp.stack(
                    [_take_val(layer_res[layer], xi), _take_val(layer_res[layer], nxi)],
                    axis=-1,
                )
            )
            fri_paths[layer].append(
                jnp.stack(
                    [
                        _auth_path(layer_levels[layer], xi),
                        _auth_path(layer_levels[layer], nxi),
                    ],
                    axis=-3,
                )
            )
    return {
        "open_f_vals": jnp.stack(f_vals, axis=-2),  # (..., q, n_shifts)
        "open_f_paths": jnp.stack(f_paths, axis=-4),  # (..., q, n_shifts, d, 8)
        "open_cp_vals": jnp.stack(cp_vals, axis=-1),  # (..., q)
        "open_cp_paths": jnp.stack(cp_paths, axis=-3),  # (..., q, d, 8)
        "open_fri_vals": [jnp.stack(v, axis=-2) for v in fri_vals],  # (..., q, 2)
        "open_fri_paths": [jnp.stack(p, axis=-4) for p in fri_paths],
    }
