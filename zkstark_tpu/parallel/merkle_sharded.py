"""Sharded Merkle commitment: local subtrees + gathered top tree.

Leaf hashing is embarrassingly parallel; only the top log2(S) levels couple
shards. Each device builds the subtree over its contiguous leaf block with
the same batched kernel as the single-chip path (hash/merkle.py), the S
subtree roots are all-gathered (one tiny collective), and the top tree is
computed replicated. Because the leaves are blocked contiguously and every
level size is a power of two, the concatenation of local levels IS the global
level — the root and every auth path are bit-identical to the single-device
tree (shard-invariance is tested), hence the proof transcript is unchanged
at any mesh size.
"""

from __future__ import annotations

from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from zkstark_tpu.hash import merkle, sha256
from zkstark_tpu.parallel.mesh import mesh_size


def sharded_build_levels(values, mesh: Mesh):
    """All global tree levels for block-sharded (n,) uint32 leaf residues.

    Returns the same level list as merkle.build_levels (leaf level first);
    levels at or below the shard size come out block-sharded, the top
    log2(S) levels replicated. Works on any mesh shape — the domain blocks
    over the flattened axis product."""
    n = values.shape[0]
    s = mesh_size(mesh)
    local_n = n // s
    assert local_n * s == n and local_n >= 1

    num_local_levels = local_n.bit_length()  # local leaf level … local root
    axes = tuple(mesh.axis_names)

    # The GPU hash kernel declares its output varying over the same mesh
    # axes as its input (ops/sha256_kernel.py), so shard_map's check holds.
    local_levels = shard_map(
        lambda v: tuple(merkle.build_levels(v)),
        mesh=mesh,
        in_specs=P(axes),
        out_specs=tuple([P(axes, None)] * num_local_levels),
    )(values)

    levels = list(local_levels)
    # top tree over the S gathered subtree roots (replicated, tiny)
    top = levels[-1]
    while top.shape[0] > 1:
        top = sha256.node_hash_pairs(top.reshape(-1, 16))
        levels.append(top)
    return levels


def sharded_commit(values, mesh: Mesh) -> merkle.MerkleTree:
    return merkle.MerkleTree(levels=sharded_build_levels(values, mesh))
