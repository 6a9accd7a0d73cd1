"""Sharded END-TO-END proving: a real transcript out of sharded trees.

Round-2 gap (VERDICT #4): the sharded code paths never produced an actual
proof. Here prove(mesh=...) runs the fused device program sharded over the
domain (six-step NTT all_to_alls, Merkle subtree gathers, cross-shard FRI
exchanges) and serves decommitment auth paths out of the sharded levels —
and the transcript must be BYTE-IDENTICAL to the single-device proof at
every mesh size/shape (SURVEY.md §5: mesh config separate from protocol
config).
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from zkstark_tpu import field as fp
from zkstark_tpu.parallel.mesh import (
    DOMAIN_AXIS,
    make_host_chip_mesh,
    mesh_size,
)
from zkstark_tpu.protocol import prove, verify
from zkstark_tpu.protocol.air import FIBONACCI_SQ
from zkstark_tpu.protocol.config import StarkConfig


def small_cfg(n_queries=1):
    trace = FIBONACCI_SQ.trace(63, 31415)
    return StarkConfig(
        trace_len=63,
        boundary_first=int(trace[0]),
        boundary_last=int(trace[-1]),
        n_queries=n_queries,
    )


def cpu_mesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), (DOMAIN_AXIS,))


@pytest.fixture(scope="module")
def solo_proof():
    cfg = small_cfg()
    return cfg, prove(cfg, 31415)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_prove_bytes_identical(solo_proof, n_dev):
    cfg, solo = solo_proof
    sharded = prove(cfg, 31415, mesh=cpu_mesh(n_dev))
    assert sharded.data == solo.data
    assert sharded.state == solo.state
    verify(sharded, cfg)


def test_sharded_prove_host_chip_mesh(solo_proof):
    """('host','chip') 2-D mesh — the multi-process mesh shape,
    CPU-simulated — still yields identical bytes."""
    cfg, solo = solo_proof
    mesh = make_host_chip_mesh(n_hosts=2, chips_per_host=4, backend="cpu")
    assert mesh_size(mesh) == 8
    sharded = prove(cfg, 31415, mesh=mesh)
    assert sharded.data == solo.data


def test_sharded_prove_multi_query(solo_proof):
    cfg = small_cfg(n_queries=3)
    solo = prove(cfg, 31415)
    sharded = prove(cfg, 31415, mesh=cpu_mesh(8))
    assert sharded.data == solo.data
    verify(sharded, cfg)


def test_powers_iota_matches_host_powers():
    """powers_iota (elementwise, shardable) == device_powers == exact host."""
    for base, n, scale in ((5, 256, 1), (7, 64, 5)):
        got = np.asarray(fp.from_mont(fp.powers_iota(base, n, scale)))
        want = fp.host_powers(base, n, start=scale)
        np.testing.assert_array_equal(got, want)
