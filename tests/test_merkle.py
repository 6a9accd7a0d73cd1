"""Hash/Merkle tests: batched SHA-256 vs hashlib, plus the reference's
hard-coded 4-leaf tree digests (merkle.rs:112-182)."""

import hashlib

import numpy as np

import jax.numpy as jnp

from zkstark_tpu.hash import (
    MerkleTree,
    build_levels,
    compute_root_from_path,
    digest_to_bytes,
    leaf_hash,
    node_hash,
)

rng = np.random.default_rng(0x5AA5)


def test_leaf_hash_vs_hashlib():
    vals = rng.integers(0, 1 << 32, size=512, dtype=np.uint64).astype(np.uint32)
    got = np.asarray(leaf_hash(jnp.asarray(vals)))
    for i in (0, 1, 7, 100, 511):
        want = hashlib.sha256(int(vals[i]).to_bytes(4, "big")).digest()
        assert digest_to_bytes(got[i]) == want


def test_node_hash_vs_hashlib():
    l = rng.integers(0, 1 << 32, size=(64, 8), dtype=np.uint64).astype(np.uint32)
    r = rng.integers(0, 1 << 32, size=(64, 8), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(node_hash(jnp.asarray(l), jnp.asarray(r)))
    for i in (0, 31, 63):
        want = hashlib.sha256(
            digest_to_bytes(l[i]) + digest_to_bytes(r[i])
        ).digest()
        assert digest_to_bytes(got[i]) == want


# The seven node digests pinned by the reference merkle_test (merkle.rs:117-153),
# heap order: i0 = root, i1/i2 = level 1, i3..i6 = leaves of [1, 2, 3, 4].
_I3 = bytes.fromhex("b40711a88c7039756fb8a73827eabe2c0fe5a0346ca7e0a104adc0fc764f528d")
_I4 = bytes.fromhex("433ebf5bc03dffa38536673207a21281612cef5faa9bc7a4d5b9be2fdb12cf1a")
_I5 = bytes.fromhex("88185d128d9922e0e6bcd32b07b6c7f20f27968eab447a1d8d1cdf250f79f7d3")
_I6 = bytes.fromhex("1bc5d0e3df0ea12c4d0078668d14924f95106bbe173e196de50fe13a900b0937")
_I1 = bytes.fromhex("be8dc357decb6e09c8e5ad874d3c4fa7fc09730bbb5e90f42c97dad20e0012d4")
_I2 = bytes.fromhex("6bed5b6d7ae093d1812ab9be5cbfa1ce787812a003d95c11448720a407b61727")
_I0 = bytes.fromhex("327cf213e1738de4206bfd14297c26c682961750cb56897ed5e8f519b0548ff2")


def test_reference_four_leaf_tree():
    tree = MerkleTree.commit(jnp.asarray(np.array([1, 2, 3, 4], dtype=np.uint32)))
    leaves = np.asarray(tree.levels[0])
    assert [digest_to_bytes(leaves[i]) for i in range(4)] == [_I3, _I4, _I5, _I6]
    mid = np.asarray(tree.levels[1])
    assert [digest_to_bytes(mid[i]) for i in range(2)] == [_I1, _I2]
    assert tree.root() == _I0

    # auth paths (merkle.rs:164-178)
    assert tree.auth_path(0) == [_I4, _I2]
    assert tree.auth_path(1) == [_I3, _I2]
    assert tree.auth_path(2) == [_I6, _I1]
    assert tree.auth_path(3) == [_I5, _I1]
    assert tree.auth_paths([0, 1, 2, 3]) == [
        [_I4, _I2], [_I3, _I2], [_I6, _I1], [_I5, _I1]
    ]

    # compute_root_from_path round-trip (merkle.rs:181)
    assert compute_root_from_path(1, 0, tree.auth_path(0)) == _I0
    assert compute_root_from_path(4, 3, tree.auth_path(3)) == _I0


def test_large_tree_roundtrip():
    n = 1024
    vals = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    tree = MerkleTree.commit(jnp.asarray(vals))
    root = tree.root()
    for i in (0, 1, 513, n - 1):
        assert compute_root_from_path(int(vals[i]), i, tree.auth_path(i)) == root
    # tampered element must not verify
    assert compute_root_from_path(int(vals[0]) ^ 1, 0, tree.auth_path(0)) != root


def test_batched_levels_equal_solo_trees():
    """build_levels over a leading batch axis == one tree per row."""
    vals = jnp.asarray(
        np.random.default_rng(3).integers(0, 1 << 32, (3, 16), dtype=np.uint64).astype(np.uint32)
    )
    batched = build_levels(vals)
    for b in range(3):
        solo = build_levels(vals[b])
        for lb, ls in zip(batched, solo):
            np.testing.assert_array_equal(np.asarray(lb[b]), np.asarray(ls))
