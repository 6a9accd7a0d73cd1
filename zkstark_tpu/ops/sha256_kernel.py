"""Batched SHA-256 as a Pallas kernel for NVIDIA GPUs (Triton route).

Every Merkle leaf and node of a commitment is one independent SHA-256, so a
level is a flat batch. The kernel hashes BLOCK of them at a time, one hash
per lane: the 8 state words and the 16-word schedule window live in
registers as loop carries and never touch device memory (the `fori_loop`
twin in hash/sha256.py round-trips a materialized (N, 64) schedule every
round). The round and schedule arithmetic is hash/sha256.py's `_round` /
`_next_word`, shared with the unrolled plain form; here the 64 rounds stay a
loop, which keeps the compiled kernel small (the fully unrolled node body
took ~86 s to compile for the card per shape). Arithmetic intensity is
~2,500 u32 ops per 64 bytes read, so the kernel is compute-bound.

Layouts are the Merkle level's own, row-major: leaves read (N,) values, nodes
read the (K, 16) rows left‖right straight from the child level, both write
(·, 8) digests. The grid is a fixed number of programs that stride over the
blocks, and the row count arrives as a one-element operand masking the last
block — so the kernel is identical for every batch size, and one compiled
kernel serves every level of every tree in a program.

Reference semantics preserved: leaf = SHA256(big-endian u32) (merkle.rs:30-34),
node = SHA256(left ‖ right) (merkle.rs:42-45).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from zkstark_tpu.hash import sha256

BLOCK = 256  # hashes per program step (one per lane)
GRID = 1056  # programs: 8 per SM of a 132-SM H100
NUM_WARPS = 4


def _compress(state, w16, k_ref):
    """One compression with a rolling 16-word window as loop carry."""

    def body(t, carry):
        st, win = carry[:8], carry[8:]
        st = sha256._round(st, win[0] + k_ref[t])
        return st + win[1:] + (sha256._next_word(win),)

    out = lax.fori_loop(0, 64, body, tuple(state) + tuple(w16))
    return tuple(s + o for s, o in zip(state, out[:8]))


def _pad_rounds(state, wk_ref):
    """The second node block: 64 rounds over the constant schedule w+K."""
    out = lax.fori_loop(0, 64, lambda t, st: sha256._round(st, wk_ref[t]), state)
    return tuple(s + o for s, o in zip(state, out))


def _for_each_block(n_ref, body):
    """Call body(rows, mask) for every BLOCK-row block this program owns:
    blocks pid, pid + programs, … below ceil(n / BLOCK)."""
    n = n_ref[0]
    pid = pl.program_id(0)
    programs = pl.num_programs(0)
    nblocks = lax.div(n + (BLOCK - 1), BLOCK)
    trips = lax.div(jnp.maximum(nblocks - pid, 0) + programs - 1, programs)

    def step(j, carry):
        start = (pid + j * programs) * BLOCK
        rows = start + lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)
        body(pl.ds(start, BLOCK), rows < n)
        return carry

    lax.fori_loop(0, trips, step, 0)


def _leaf_kernel(n_ref, k_ref, vals_ref, out_ref):
    def body(rows, mask):
        v = plgpu.load(vals_ref.at[rows], mask=mask, other=np.uint32(0))
        z = v & np.uint32(0)
        w16 = [v, z + np.uint32(0x80000000)] + [z] * 13 + [z + np.uint32(32)]
        digest = _compress(tuple(z + h for h in sha256._H0), w16, k_ref)
        for i, word in enumerate(digest):
            plgpu.store(out_ref.at[rows, i], word, mask=mask)

    _for_each_block(n_ref, body)


def _node_kernel(n_ref, k_ref, pad_wk_ref, pairs_ref, out_ref):
    def body(rows, mask):
        w16 = [
            plgpu.load(pairs_ref.at[rows, i], mask=mask, other=np.uint32(0))
            for i in range(16)
        ]
        z = w16[0] & np.uint32(0)
        mid = _compress(tuple(z + h for h in sha256._H0), w16, k_ref)
        for i, word in enumerate(_pad_rounds(mid, pad_wk_ref)):
            plgpu.store(out_ref.at[rows, i], word, mask=mask)

    _for_each_block(n_ref, body)


def _grid_spec(n: int, programs: int = GRID, vma=frozenset()) -> dict:
    """The production grid — shared by the real pallas_call and the grid-
    emulation tests (tests/test_pallas_grid.py). Every operand is one
    whole-array ref; the kernel picks its blocks itself. `vma`: the mesh
    axes the output varies over inside shard_map (those of the input)."""
    return dict(
        grid=(programs,),
        out_shape=jax.ShapeDtypeStruct((n, 8), jnp.uint32, vma=vma),
    )


def _pallas_call(kernel, spec: dict, interpret: bool, *args):
    return pl.pallas_call(
        kernel,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        **spec,
    )(*args)


def _consts(n: int, *tables):
    return (jnp.full((1,), n, jnp.int32),) + tuple(jnp.asarray(t) for t in tables)


@functools.partial(jax.jit, static_argnames=("interpret",))
def leaf_hash(values, interpret: bool = False):
    """(N,) uint32 → (N, 8) digests, any N ≥ 1."""
    n = values.shape[0]
    spec = _grid_spec(n, vma=jax.typeof(values).vma)
    return _pallas_call(_leaf_kernel, spec, interpret, *_consts(n, sha256._K), values)


@functools.partial(jax.jit, static_argnames=("interpret",))
def node_hash(pairs, interpret: bool = False):
    """(K, 16) uint32 rows left‖right → (K, 8) digests, any K ≥ 1."""
    k = pairs.shape[0]
    return _pallas_call(
        _node_kernel,
        _grid_spec(k, vma=jax.typeof(pairs).vma),
        interpret,
        *_consts(k, sha256._K, sha256._PAD_WK),
        pairs,
    )
