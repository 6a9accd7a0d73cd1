"""SHA-256 GPU kernel: bodies, the wrapper's ragged tails, and routing.

Kernel bodies run via ops.testing.emulate_kernel / emulate_pallas_grid (the
same arithmetic the GPU compiler sees, run eagerly). Equality with the
`fori_loop` twin — itself pinned to the reference's hard-coded digests
(merkle.rs:112-182) in tests/test_merkle.py — and with hashlib carries the
golden contract over. The compiled kernel is checked on the card by
tests/test_gpu.py and chip_smoke.py.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zkstark_tpu import ops
from zkstark_tpu.hash import merkle, sha256
from zkstark_tpu.ops import sha256_kernel, testing

N = sha256_kernel.BLOCK


@pytest.fixture(scope="module")
def values():
    rng = np.random.default_rng(42)
    return rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)


def _count(n):
    return np.array([n], np.int32)


def test_leaf_kernel_matches_jnp_and_hashlib(values):
    got = np.asarray(
        testing.emulate_kernel(
            sha256_kernel._leaf_kernel, (N, 8), jnp.uint32, _count(N), sha256._K, values
        )
    )
    want = np.asarray(sha256.leaf_hash_loop(jnp.asarray(values)))
    np.testing.assert_array_equal(got, want)
    for i in (0, 17, N - 1):
        ref = hashlib.sha256(int(values[i]).to_bytes(4, "big")).digest()
        assert sha256.digest_to_bytes(got[i]) == ref


def test_node_kernel_matches_jnp_and_hashlib(values):
    left = sha256.leaf_hash_loop(jnp.asarray(values))
    right = sha256.leaf_hash_loop(jnp.asarray(values[::-1].copy()))
    pairs = np.asarray(jnp.concatenate([left, right], axis=-1))  # (N, 16)
    got = np.asarray(
        testing.emulate_kernel(
            sha256_kernel._node_kernel,
            (N, 8),
            jnp.uint32,
            _count(N),
            sha256._K,
            sha256._PAD_WK,
            pairs,
        )
    )
    want = np.asarray(sha256.node_hash_loop(jnp.asarray(pairs)))
    np.testing.assert_array_equal(got, want)
    assert sha256.digest_to_bytes(got[3]) == hashlib.sha256(
        pairs[3].astype(">u4").tobytes()
    ).digest()


def test_pad_schedule_constant():
    """The precomputed second-block schedule must equal a live expansion."""
    w16 = [jnp.full((1, 1), int(v), jnp.uint32) for v in sha256._PAD_BLOCK_512]
    live = sha256._schedule(w16)
    for t in range(64):
        want = (int(live[t][0, 0]) + int(sha256._K[t])) & 0xFFFFFFFF
        assert int(sha256._PAD_WK[t]) == want


@pytest.fixture
def emulated(monkeypatch):
    """Route the wrappers' pallas_call through the grid emulator, recording
    the interpret flag each call asked for."""
    calls = []

    def fake(kernel, spec, interpret, *args):
        calls.append(interpret)
        return jnp.asarray(testing.emulate_pallas_grid(kernel, spec, *args))

    monkeypatch.setattr(sha256_kernel, "_pallas_call", fake)
    return calls


@pytest.mark.parametrize("n", [1, 1000, 1025, 3000])
def test_wrapper_ragged_batches_match_hashlib(emulated, n):
    """Any batch size: the last block is masked, never read or written past
    the array."""
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    pairs = rng.integers(0, 1 << 32, (n, 16), dtype=np.uint64).astype(np.uint32)
    with jax.disable_jit():
        leaves = np.asarray(sha256_kernel.leaf_hash(jnp.asarray(vals)))
        nodes = np.asarray(sha256_kernel.node_hash(jnp.asarray(pairs)))
    assert leaves.shape == (n, 8) and nodes.shape == (n, 8)
    for i in sorted({0, n // 2, n - 1}):
        assert sha256.digest_to_bytes(leaves[i]) == hashlib.sha256(
            int(vals[i]).to_bytes(4, "big")
        ).digest()
        assert sha256.digest_to_bytes(nodes[i]) == hashlib.sha256(
            pairs[i].astype(">u4").tobytes()
        ).digest()


def test_routing_cpu_takes_plain_path(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel called on the CPU")

    monkeypatch.setattr(sha256_kernel, "leaf_hash", boom)
    monkeypatch.setattr(sha256_kernel, "node_hash", boom)
    assert ops.target_platform() == "cpu" and not ops.gpu_kernels()
    vals = jnp.arange(8, dtype=jnp.uint32)
    levels = merkle.build_levels(vals)
    assert len(levels) == 4 and levels[-1].shape == (1, 8)


def test_routing_gpu_takes_kernel(monkeypatch):
    seen = []

    def leaf(values):
        seen.append(("leaf", values.shape))
        return sha256.leaf_hash_loop(values)

    def node(pairs):
        seen.append(("node", pairs.shape))
        return sha256.node_hash_loop(pairs)

    monkeypatch.setattr(ops, "target_platform", lambda: "gpu")
    monkeypatch.setattr(sha256_kernel, "leaf_hash", leaf)
    monkeypatch.setattr(sha256_kernel, "node_hash", node)
    vals = jnp.arange(8, dtype=jnp.uint32)
    got = merkle.build_levels(vals)
    assert seen == [("leaf", (8,)), ("node", (4, 16)), ("node", (2, 16)), ("node", (1, 16))]
    monkeypatch.undo()
    want = merkle.build_levels(vals)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_routing_never_interprets_on_gpu(monkeypatch, emulated):
    monkeypatch.setattr(ops, "target_platform", lambda: "gpu")
    with jax.disable_jit():
        levels = merkle.build_levels(jnp.arange(4, dtype=jnp.uint32))
    assert emulated == [False, False, False]  # one leaf call, two node levels
    leaf = hashlib.sha256((3).to_bytes(4, "big")).digest()
    assert sha256.digest_to_bytes(np.asarray(levels[0][3])) == leaf
