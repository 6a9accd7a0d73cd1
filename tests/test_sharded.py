"""Shard-invariance tests on a virtual 8-device CPU mesh (SURVEY.md §4):
sharded four-step NTT, sharded Merkle and sharded FRI fold must be
bit-identical to their single-device counterparts."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from zkstark_tpu import ntt
from zkstark_tpu.field import fp
from zkstark_tpu.hash import merkle
from zkstark_tpu.parallel import (
    coset_ntt_sixstep,
    fold_sharded,
    make_mesh,
    ntt_sixstep,
    sharded_commit,
    vec_sharding,
)

rng = np.random.default_rng(0xD15C)


def cpu_mesh(n=8):
    return make_mesh(n, backend="cpu")


def rand_mont(n):
    vals = rng.integers(0, fp.P, size=n, dtype=np.uint64).astype(np.uint32)
    return jnp.asarray(fp.host_to_mont(vals))


@pytest.mark.parametrize("n", [256, 4096, 65536])
def test_sixstep_matches_flat(n):
    x = rand_mont(n)
    root = fp.subgroup_generator(n)
    flat = np.asarray(ntt.ntt(x, ntt.forward_plan(n)))
    six = np.asarray(ntt_sixstep(x, n, root))
    np.testing.assert_array_equal(six, flat)


@pytest.mark.parametrize("n", [4096, 65536])
def test_sixstep_sharded_matches_flat(n):
    mesh = cpu_mesh()
    x = jax.device_put(rand_mont(n), vec_sharding(mesh))
    root = fp.subgroup_generator(n)
    fn = jax.jit(lambda v: ntt_sixstep(v, n, root, mesh=mesh))
    six = np.asarray(fn(x))
    flat = np.asarray(ntt.ntt(x, ntt.forward_plan(n)))
    np.testing.assert_array_equal(six, flat)


def test_sixstep_inverse_roundtrip():
    n = 4096
    mesh = cpu_mesh()
    x = jax.device_put(rand_mont(n), vec_sharding(mesh))
    root = fp.subgroup_generator(n)
    fwd = jax.jit(lambda v: ntt_sixstep(v, n, root, mesh=mesh))
    inv = jax.jit(lambda v: ntt_sixstep(v, n, root, mesh=mesh, inverse=True))
    back = np.asarray(inv(fwd(x)))
    np.testing.assert_array_equal(back, np.asarray(x))


def test_coset_sixstep_matches_coset_ntt():
    n = 8192
    k = 1024
    coeffs = rand_mont(k)
    single = np.asarray(ntt.coset_ntt(coeffs, n, 5))
    mesh = cpu_mesh()
    six = np.asarray(jax.jit(lambda c: coset_ntt_sixstep(c, n, 5, mesh=mesh))(coeffs))
    np.testing.assert_array_equal(six, single)


def test_sharded_merkle_matches_single():
    n = 8192
    vals = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    mesh = cpu_mesh()
    single = merkle.MerkleTree.commit(jnp.asarray(vals))
    sharded = sharded_commit(jax.device_put(jnp.asarray(vals), vec_sharding(mesh)), mesh)
    assert sharded.root() == single.root()
    assert len(sharded.levels) == len(single.levels)
    for i in (0, 1, 4095, 8191):
        assert sharded.auth_path(i) == single.auth_path(i)


def test_sharded_fold_matches_single():
    from zkstark_tpu.protocol.config import STARK101
    from zkstark_tpu.protocol import prover as pr

    m = 8192
    evals = rand_mont(m)
    beta = 123456789
    inv_x = pr.fri_layer_constants(STARK101, 0)
    inv2 = pr._mont_scalar(pr._INV2)
    beta_m = pr._mont_scalar(beta)

    single, _, _ = pr._fri_fold(STARK101, 0, evals, beta_m)
    mesh = cpu_mesh()
    sharded = jax.jit(
        lambda e: fold_sharded(e, beta_m, inv_x, inv2, mesh=mesh)
    )(jax.device_put(evals, vec_sharding(mesh)))
    np.testing.assert_array_equal(np.asarray(sharded), np.asarray(single))


def test_sharded_merkle_gpu_route_passes_vma_check(monkeypatch):
    """With the GPU kernel routed in, the per-shard Merkle build still passes
    shard_map's varying-axes check: the kernel declares its output varying
    over the input's mesh axes (traced only — the kernel compiles for GPUs)."""
    from zkstark_tpu import ops
    from zkstark_tpu.parallel import sharded_build_levels

    monkeypatch.setattr(ops, "target_platform", lambda: "gpu")
    mesh = cpu_mesh(4)
    jaxpr = jax.make_jaxpr(lambda v: sharded_build_levels(v, mesh))(
        jnp.zeros(64, jnp.uint32)
    )
    assert "pallas_call" in str(jaxpr)
