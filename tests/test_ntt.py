"""NTT-layer tests: roundtrip, agreement with naive DFT, coset evaluation, and
the reference's own evaluation goldens (prover.rs:73-78)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from zkstark_tpu import field as fp
from zkstark_tpu import ntt

rng = np.random.default_rng(0x17717)


def naive_eval(coeffs: np.ndarray, points: np.ndarray) -> np.ndarray:
    """O(n²) exact evaluation with Python ints (test oracle)."""
    out = np.empty(len(points), dtype=np.uint32)
    cs = [int(c) for c in coeffs]
    for i, x in enumerate(points):
        acc, xp = 0, 1
        x = int(x)
        for c in cs:
            acc = (acc + c * xp) % fp.P
            xp = (xp * x) % fp.P
        out[i] = acc
    return out


@pytest.mark.parametrize("n", [2, 8, 64, 1024])
def test_ntt_matches_naive(n):
    coeffs = rng.integers(0, fp.P, size=n, dtype=np.uint64).astype(np.uint32)
    h = fp.subgroup_generator(n)
    points = fp.host_powers(h, n)
    want = naive_eval(coeffs, points)
    got = np.asarray(
        fp.from_mont(ntt.ntt(jnp.asarray(fp.host_to_mont(coeffs)), ntt.forward_plan(n)))
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [8, 256, 8192])
def test_roundtrip(n):
    vals = rng.integers(0, fp.P, size=n, dtype=np.uint64).astype(np.uint32)
    x = jnp.asarray(fp.host_to_mont(vals))
    back = ntt.intt(ntt.ntt(x, ntt.forward_plan(n)), ntt.inverse_plan(n))
    np.testing.assert_array_equal(np.asarray(fp.from_mont(back)), vals)


@pytest.mark.parametrize("n,k,offset", [(64, 17, 5), (1024, 1023, 5), (8192, 1024, 5)])
def test_coset_ntt(n, k, offset):
    coeffs = rng.integers(0, fp.P, size=k, dtype=np.uint64).astype(np.uint32)
    h = fp.subgroup_generator(n)
    points = (fp.host_powers(h, n).astype(np.uint64) * offset % fp.P).astype(np.uint32)
    # oracle on a few random points to keep the O(n*k) cost down
    sel = rng.integers(0, n, size=8)
    want = naive_eval(coeffs, points[sel])
    ev = ntt.coset_ntt(jnp.asarray(fp.host_to_mont(coeffs)), n, offset)
    got = np.asarray(fp.from_mont(ev))[sel]
    np.testing.assert_array_equal(got, want)
    # and inverse-coset roundtrip
    back = np.asarray(fp.from_mont(ntt.coset_intt(ev, offset)))
    np.testing.assert_array_equal(back[:k], coeffs)
    np.testing.assert_array_equal(back[k:], np.zeros(n - k, np.uint32))


def test_ntt_jit_and_grad_free():
    # the transform must be jittable as one XLA program
    n = 1024
    plan_f = ntt.forward_plan(n)
    fn = jax.jit(lambda x: ntt.ntt(x, plan_f))
    vals = rng.integers(0, fp.P, size=n, dtype=np.uint64).astype(np.uint32)
    a = np.asarray(fn(jnp.asarray(fp.host_to_mont(vals))))
    b = np.asarray(ntt.ntt(jnp.asarray(fp.host_to_mont(vals)), plan_f))
    np.testing.assert_array_equal(a, b)


def _rand_mont(field, n, seed):
    vals = np.random.default_rng(seed).integers(0, field.p, n, dtype=np.uint64)
    return jnp.asarray(field.host_to_mont(vals.astype(np.uint32)))


@pytest.mark.parametrize("field", [fp.FIELD101, fp.FIELD_ALT], ids=["p101", "p_alt"])
@pytest.mark.parametrize("log_n", [14, 15, 16])
def test_fourstep_matches_radix2(field, log_n):
    """The plain-jnp four-step route (n ≥ FOURSTEP_MIN) is bit-identical to
    the flat radix-2 chain it replaces at these sizes."""
    n = 1 << log_n
    assert n >= ntt.core.FOURSTEP_MIN
    x = _rand_mont(field, n, log_n)
    plan = ntt.forward_plan(n, field)
    br, tw = ntt.bit_reverse_indices(n), ntt.core.radix2_twiddles(n, plan.w, field)
    # jitted: eager dispatch would compile every primitive shape separately
    flat = jax.jit(lambda v: ntt.core.radix2(v, br, tw, field))(x)
    four = jax.jit(lambda v: ntt.ntt(v, plan))(x)
    np.testing.assert_array_equal(np.asarray(four), np.asarray(flat))


@pytest.mark.parametrize("field", [fp.FIELD101, fp.FIELD_ALT], ids=["p101", "p_alt"])
def test_fourstep_inverse_roundtrip(field):
    """intt folds n^{-1} into the four-step twiddles: a batched round trip
    (leading axis) returns the input exactly."""
    n = 1 << 15
    x = jnp.stack([_rand_mont(field, n, 1), _rand_mont(field, n, 2)])
    fwd, inv = ntt.forward_plan(n, field), ntt.inverse_plan(n, field)
    back = jax.jit(lambda v: ntt.intt(ntt.ntt(v, fwd), inv))(x)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


@pytest.mark.parametrize("log_n", [26, 27])
def test_big_plans_hold_no_size_n_tables(log_n):
    """Plans past the old 2^25 cliff build, carry no radix-2 tables, and their
    four-step constants are O(√n) words; the transform traces without
    raising."""
    n = 1 << log_n
    plan = ntt.forward_plan(n)
    assert plan.bitrev is None and plan.twiddles == ()
    c = ntt.core.fourstep_constants(n, plan.w)
    words = c.rows.size + c.rows_blk.size
    for sub in (c.inner, c.outer):
        words += sum(t.size for t in sub.twiddles) + (
            0 if sub.bitrev is None else sub.bitrev.size
        )
    assert words <= 8 * (1 << ((log_n + 1) // 2)), words
    out = jax.eval_shape(lambda v: ntt.ntt(v, plan), jax.ShapeDtypeStruct((n,), jnp.uint32))
    assert out.shape == (n,)
