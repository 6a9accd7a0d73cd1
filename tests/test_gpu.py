"""Checks that need an NVIDIA GPU: the compiled SHA-256 kernel against the
plain `fori_loop` form and hashlib, and the golden transcript with the kernel
on the path. They skip elsewhere; chip_smoke.py runs them on the card."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zkstark_tpu.hash import sha256

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("n", [1, 1000, 1 << 16])
def test_gpu_sha256_kernel_matches_plain(gpu_device, n):
    from zkstark_tpu.ops import sha256_kernel

    rng = np.random.default_rng(n)
    vals = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    pairs = rng.integers(0, 1 << 32, (n, 16), dtype=np.uint64).astype(np.uint32)
    with jax.default_device(gpu_device):
        leaves = np.asarray(sha256_kernel.leaf_hash(jnp.asarray(vals)))
        nodes = np.asarray(sha256_kernel.node_hash(jnp.asarray(pairs)))
        np.testing.assert_array_equal(
            leaves, np.asarray(jax.jit(sha256.leaf_hash_loop)(vals))
        )
        np.testing.assert_array_equal(
            nodes, np.asarray(jax.jit(sha256.node_hash_loop)(pairs))
        )
    i = n - 1
    assert sha256.digest_to_bytes(leaves[i]) == hashlib.sha256(
        int(vals[i]).to_bytes(4, "big")
    ).digest()
    assert sha256.digest_to_bytes(nodes[i]) == hashlib.sha256(
        pairs[i].astype(">u4").tobytes()
    ).digest()


def test_gpu_stark101_golden(gpu_device):
    from zkstark_tpu import ops
    from zkstark_tpu.protocol import STARK101, STARK101_SECRET, prove, verify

    with jax.default_device(gpu_device):
        assert ops.gpu_kernels()
        proof = prove(STARK101, STARK101_SECRET)
    assert len(proof.data) == 7836
    assert proof.state.hex() == (
        "d7eec91544f72a592145e7d505a2f274de740e0319ede8c983fd84c7736f6712"
    )
    verify(proof, STARK101)
