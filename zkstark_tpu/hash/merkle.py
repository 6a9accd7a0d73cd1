"""Merkle commitment over uint32 residues, built level-by-level on device.

The reference builds a flat heap with scalar SHA-256 calls (merkle.rs:14-51).
Here each level is one batched `node_hash` over the whole level — log2(n)
device calls, each perfectly data-parallel (SURVEY.md §3.4). Leaf encoding
(big-endian u32, merkle.rs:30-34), node order (left‖right, merkle.rs:42-45),
auth-path order (leaf→root siblings, merkle.rs:54-71) and the index-parity walk
of compute_root_from_path (merkle.rs:82-110) are preserved bit-for-bit.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from zkstark_tpu.hash import sha256


def build_levels(values):
    """All tree levels bottom-up from (..., n) uint32 residues; n a power of
    two, leading axes are independent trees (the batched prover's B axis).

    Returns [leaf_level (..., n, 8), …, root (..., 1, 8)] — still on device.
    Every level is row-major natural order, so the adjacent digest rows of a
    level ARE the 64-byte left‖right messages of the next: one reshape, no
    gathers. Pairs never cross trees (n is even)."""
    lead = values.shape[:-1]
    n = values.shape[-1]
    assert n & (n - 1) == 0 and n >= 1
    level = sha256.leaf_hash(values.reshape(-1)).reshape(lead + (n, 8))
    levels = [level]
    while level.shape[-2] > 1:
        k = level.shape[-2] // 2  # number of parent nodes
        pairs = level.reshape(-1, 16)
        level = sha256.node_hash_pairs(pairs).reshape(lead + (k, 8))
        levels.append(level)
    return levels


@dataclass
class MerkleTree:
    """Host handle over device-resident levels, mirroring reference Merkle."""

    levels: list  # device arrays, leaf level first

    @classmethod
    def commit(cls, values) -> "MerkleTree":
        return cls(levels=build_levels(values))

    @property
    def num_leaves(self) -> int:
        return self.levels[0].shape[0]

    def root(self) -> bytes:
        return sha256.digest_to_bytes(np.asarray(self.levels[-1][0]))

    def auth_path(self, index: int) -> list:
        """Sibling digests leaf→root (reference trace(), merkle.rs:54-71)."""
        path = []
        i = index
        for level in self.levels[:-1]:
            path.append(sha256.digest_to_bytes(np.asarray(level[i ^ 1])))
            i >>= 1
        return path

    def auth_paths(self, indices) -> list:
        """Batch variant: one host sync per level instead of per (index, level)."""
        idx = np.asarray(indices, dtype=np.int64)
        per_level = []
        for level in self.levels[:-1]:
            sibs = np.asarray(jnp.take(level, jnp.asarray(idx ^ 1), axis=0))
            per_level.append(sibs)
            idx >>= 1
        return [
            [sha256.digest_to_bytes(per_level[d][k]) for d in range(len(per_level))]
            for k in range(len(np.atleast_1d(indices)))
        ]


def compute_root_from_path(element: int, index: int, path: list) -> bytes:
    """Recompute the root from one opening — verifier side (merkle.rs:82-110).

    Host-side hashlib: a single log-depth serial hash chain."""
    current = hashlib.sha256(int(element).to_bytes(4, "big")).digest()
    i = index
    for sibling in path:
        if i & 1:
            current = hashlib.sha256(sibling + current).digest()
        else:
            current = hashlib.sha256(current + sibling).digest()
        i >>= 1
    return current
