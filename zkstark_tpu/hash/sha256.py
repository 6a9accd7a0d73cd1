"""Batched SHA-256: N independent hashes per call, pure uint32 vector ops.

The reference calls a scalar SHA-256 ~33k times per proof for Merkle leaves
and nodes (merkle.rs:27-47). Every add/rotate/xor of the compression function
is a native uint32 vector op, so a whole Merkle level is hashed in one call.

Only the two fixed message shapes the protocol needs are provided:
  * `leaf_hash`        — a single 4-byte big-endian u32 (merkle.rs:30-34), one block;
  * `node_hash_pairs`  — 64 bytes = left‖right digests (merkle.rs:42-45), two blocks.
On a GPU both route to the Pallas kernel (ops/sha256_kernel.py); elsewhere
they run the plain `fori_loop` form below. The round and schedule arithmetic
(`_round`/`_next_word` over lists of word arrays) is shared by the kernel,
which loops over it, and by the unrolled plain form (`leaf_hash_unrolled`),
so the versions differ only in how the same arithmetic is compiled.

The sequential Fiat-Shamir channel chain stays on the host (hashlib) or in
`compress` (transcript/device_channel.py): a ~40-hash serial dependency chain.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

_H0 = np.array(
    [
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    ],
    dtype=np.uint32,
)

# Second block of a 64-byte message: the constant SHA-256 padding.
_PAD_BLOCK_512 = np.zeros(16, dtype=np.uint32)
_PAD_BLOCK_512[0] = 0x80000000
_PAD_BLOCK_512[15] = 512  # message length in bits: 64 bytes


def _rotr(x, r: int):
    return (x >> r) | (x << (32 - r))


# ---- the compression body (shared by the kernel and the unrolled form) -----
# Every word is an array of one shape (one hash per element); constants are
# numpy scalars so they lower as literals inside a kernel.


def _next_word(win):
    """Schedule step over the 16-word window w[t-16..t-1] → w[t]."""
    s0 = _rotr(win[1], 7) ^ _rotr(win[1], 18) ^ (win[1] >> 3)
    s1 = _rotr(win[14], 17) ^ _rotr(win[14], 19) ^ (win[14] >> 10)
    return win[0] + s0 + win[9] + s1


def _round(state, wk):
    """One round; wk = w[t] + K[t]."""
    a, b, c, d, e, f, g, h = state
    big_s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
    ch = (e & f) ^ (~e & g)
    t1 = h + big_s1 + ch + wk
    big_s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
    maj = (a & b) ^ (a & c) ^ (b & c)
    return (t1 + big_s0 + maj, a, b, c, d + t1, e, f, g)


def _schedule(w16):
    """Expand 16 message words to all 64, unrolled."""
    w = list(w16)
    for t in range(16, 64):
        w.append(_next_word(w[t - 16 : t]))
    return w


def _rounds(state, wk):
    """64 unrolled rounds; wk[t] = w[t] + K[t] already summed."""
    for t in range(64):
        state = _round(state, wk[t])
    return state


def _compress(state, w16):
    w = _schedule(w16)
    out = _rounds(state, [w[t] + _K[t] for t in range(64)])
    return tuple(s + o for s, o in zip(state, out))


def _pad_schedule_plus_k() -> np.ndarray:
    """w[t] + K[t] of the constant second node block, on the host."""
    w = [int(x) for x in _PAD_BLOCK_512]
    m = (1 << 32) - 1

    def rotr(x, r):
        return ((x >> r) | (x << (32 - r))) & m

    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & m)
    return np.array([(w[t] + int(_K[t])) & m for t in range(64)], dtype=np.uint32)


# The second node block is message-independent: its schedule is a constant.
_PAD_WK = _pad_schedule_plus_k()


def leaf_words(v):
    """Leaf digest words of the padded block [v, 0x80…, 0×13, bitlen=32]."""
    z = v & np.uint32(0)
    w16 = [v, z + np.uint32(0x80000000)] + [z] * 13 + [z + np.uint32(32)]
    return _compress(tuple(z + h for h in _H0), w16)


@jax.jit
def leaf_hash_unrolled(values):
    """(N,) → (N, 8): the straight-line body as plain jnp under XLA — the
    unrolled comparison for the GPU kernel. Its node counterpart is not kept:
    XLA did not finish compiling that ~5,000-op fusion in 20 minutes on an
    H100."""
    return jnp.stack(leaf_words(values), axis=-1)


# ---- fori_loop form (compact graph; the CPU path) --------------------------


def compress(state, block):
    """One SHA-256 compression: state (..., 8), block (..., 16) uint32 arrays.

    The 48 schedule steps and 64 rounds run as `lax.fori_loop`s (compact XLA
    graph, static trip counts); each iteration is a handful of vector ops over
    the whole batch, so the loop overhead amortizes across lanes."""
    # Derive the zero-fill and state init from `block` (value-preserving &0)
    # so every fori_loop carry has the same device-varying type under
    # shard_map — mixing replicated constants into the carry is a type error.
    zeros48 = jnp.repeat(block & jnp.uint32(0), 3, axis=-1)
    w0 = jnp.concatenate([block, zeros48], axis=-1)
    state = state + (block[..., :8] & jnp.uint32(0))

    def sched(t, w):
        w15 = jax.lax.dynamic_index_in_dim(w, t - 15, axis=-1, keepdims=False)
        w2 = jax.lax.dynamic_index_in_dim(w, t - 2, axis=-1, keepdims=False)
        w16 = jax.lax.dynamic_index_in_dim(w, t - 16, axis=-1, keepdims=False)
        w7 = jax.lax.dynamic_index_in_dim(w, t - 7, axis=-1, keepdims=False)
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        nxt = w16 + s0 + w7 + s1
        return jax.lax.dynamic_update_index_in_dim(w, nxt, t, axis=-1)

    w = jax.lax.fori_loop(16, 64, sched, w0)
    k_arr = jnp.asarray(_K)

    def round_fn(t, carry):
        a, b, c, d, e, f, g, h = carry
        wt = jax.lax.dynamic_index_in_dim(w, t, axis=-1, keepdims=False)
        kt = jax.lax.dynamic_index_in_dim(k_arr, t, axis=0, keepdims=False)
        big_s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + big_s1 + ch + kt + wt
        big_s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = big_s0 + maj
        return (t1 + t2, a, b, c, d + t1, e, f, g)

    init = tuple(state[..., i] for i in range(8))
    out = jax.lax.fori_loop(0, 64, round_fn, init)
    return jnp.stack(out, axis=-1) + state


def leaf_hash_loop(values):
    """(N,) → (N, 8) through the `fori_loop` compression."""
    n = values.shape[0]
    z = jnp.zeros((n,), dtype=jnp.uint32)
    block = jnp.stack(
        [values, jnp.full((n,), 0x80000000, dtype=jnp.uint32)]
        + [z] * 13
        + [jnp.full((n,), 32, dtype=jnp.uint32)],
        axis=-1,
    )
    state = jnp.broadcast_to(jnp.asarray(_H0), (n, 8))
    return compress(state, block)


def node_hash_loop(pairs):
    """(K, 16) → (K, 8) through the `fori_loop` compression."""
    k = pairs.shape[0]
    state = compress(jnp.broadcast_to(jnp.asarray(_H0), (k, 8)), pairs)
    return compress(state, jnp.broadcast_to(jnp.asarray(_PAD_BLOCK_512), (k, 16)))


# ---- routed entry points ---------------------------------------------------


def leaf_hash(values):
    """SHA-256 of the 4-byte big-endian encoding of each uint32 value.

    Matches merkle.rs:30-34 (`hasher.update(v.to_be_bytes())`): one padded
    block [v, 0x80000000, 0×13, bitlen=32]. values: (N,) uint32 → (N, 8)."""
    from zkstark_tpu import ops

    if ops.gpu_kernels():
        from zkstark_tpu.ops import sha256_kernel

        return sha256_kernel.leaf_hash(values)
    return leaf_hash_loop(values)


def node_hash_pairs(pairs):
    """SHA-256 of each 64-byte row left‖right (merkle.rs:42-45).
    (K, 16) → (K, 8); adjacent digest rows of a level ARE these rows."""
    from zkstark_tpu import ops

    if ops.gpu_kernels():
        from zkstark_tpu.ops import sha256_kernel

        return sha256_kernel.node_hash(pairs)
    return node_hash_loop(pairs)


def node_hash(left, right):
    """SHA-256 of left‖right digests. (N,8),(N,8) → (N,8)."""
    return node_hash_pairs(jnp.concatenate([left, right], axis=-1))


def digest_to_bytes(digest: np.ndarray) -> bytes:
    """(8,) uint32 words → canonical 32-byte big-endian digest."""
    return np.asarray(digest, dtype=">u4").tobytes()


def bytes_to_digest(b: bytes) -> np.ndarray:
    return np.frombuffer(b, dtype=">u4").astype(np.uint32)
