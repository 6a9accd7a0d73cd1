"""Radix-2 and four-step NTT/INTT over F_p — the workhorse replacing the
reference's polynomial algebra.

The reference interpolates with an O(n³) Lagrange (polynomial.rs:337-383) and
evaluates with a fresh pow per term (polynomial.rs:49-57). Here both collapse
into O(n log n) number-theoretic transforms over the power-of-two-smooth
multiplicative subgroups of F_p (protocol field: p − 1 = 3·2^30, so domains up
to 2^30 exist — SURVEY.md §7). Every function is generic over the `Field`
descriptor, mirroring the reference's Gf<const P> genericity; omitted, it
defaults to the stark-101 protocol field.

Shape of the algorithm (plain jnp; XLA fuses each pass into one kernel):
  * n < FOURSTEP_MIN — radix-2: one bit-reversal gather, then log2(n)
    vectorized butterfly passes, each an `(n/m, m)`-shaped elementwise add/sub
    plus one Montgomery multiply against a per-stage twiddle row (host
    constants, O(n) words);
  * n ≥ FOURSTEP_MIN — four-step, n = n1·n2: n2 row transforms of size n1,
    a twiddle multiply, n1 row transforms of size n2, three transposes. The
    row transforms are the same `ntt()` over a leading batch axis (so sizes
    past 2^27 recurse), and the twiddles are expanded in-trace from two
    O(√n) host vectors — no constant of size n exists at any size the field
    allows;
  * evaluation on the coset `offset·⟨h⟩` (prover.rs:69: offset = 5) is a
    pointwise pre-scale by `offset^j` followed by a plain NTT.

Everything operates on Montgomery-form uint32 arrays (see field.fp); outputs
are bit-identical across the two routes (exact field identities).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from zkstark_tpu.field import fp
from zkstark_tpu.field.fp import FIELD101, Field

# Transforms of at least this size take the four-step route (both factors are
# then ≥ 128, the twiddle block width below).
FOURSTEP_MIN = 1 << 14
_TW_BLK = 128  # inner factor of the four-step twiddle factorization


def bit_reverse_indices(n: int) -> np.ndarray:
    """Permutation such that perm[i] = bit-reverse of i in log2(n) bits."""
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@dataclass(frozen=True)
class NttPlan:
    """Constants for a size-n transform with root ω (order n). The radix-2
    tables exist only below FOURSTEP_MIN; bigger plans carry none."""

    n: int
    root: int  # standard-form n-th root of unity (Python int)
    field: Field
    w: int  # the root the transform uses (ω, or ω^{-1} for inverse plans)
    bitrev: np.ndarray | None  # uint32[n] bit-reversal permutation (host)
    twiddles: tuple  # per-stage Montgomery twiddle rows (host), sizes 1,2,…,n/2
    scale_mont: int | None  # Montgomery-form n^{-1} for inverse transforms


def radix2_twiddles(n: int, w: int, field: Field = FIELD101) -> tuple:
    """Per-stage Montgomery twiddle rows of the radix-2 chain (host numpy)."""
    stages = []
    for s in range(1, n.bit_length()):
        half = 1 << (s - 1)
        wm = pow(w, n >> s, field.p)
        stages.append(field.host_to_mont(field.host_powers_pow2(wm, half)))
    return tuple(stages)


@functools.lru_cache(maxsize=None)
def make_plan(
    n: int, root: int, inverse: bool = False, field: Field = FIELD101
) -> NttPlan:
    # All plan constants are host numpy: closed over by a jitted function they
    # embed into the module as literals, and can never be leaked tracers.
    p = field.p
    assert n & (n - 1) == 0 and n >= 2, "NTT size must be a power of two"
    assert pow(root, n, p) == 1 and pow(root, n // 2, p) != 1, (
        "root must have exact order n"
    )
    w = pow(root, p - 2, p) if inverse else root
    small = n < FOURSTEP_MIN
    scale = None
    if inverse:
        n_inv = pow(n, p - 2, p)
        scale = int(field.host_to_mont(np.array([n_inv], dtype=np.uint32))[0])
    return NttPlan(
        n=n,
        root=root,
        field=field,
        w=w,
        bitrev=bit_reverse_indices(n) if small else None,
        twiddles=radix2_twiddles(n, w, field) if small else (),
        scale_mont=scale,
    )


def forward_plan(n: int, field: Field = FIELD101) -> NttPlan:
    """Plan evaluating at ⟨h⟩ in natural order, h = g^((p-1)/n) (prover.rs:48-57)."""
    return make_plan(n, field.subgroup_generator(n), inverse=False, field=field)


def inverse_plan(n: int, field: Field = FIELD101) -> NttPlan:
    return make_plan(n, field.subgroup_generator(n), inverse=True, field=field)


def radix2(x, bitrev, twiddles, field: Field = FIELD101):
    """The flat radix-2 chain along the last axis: bit-reversal gather, then
    one butterfly pass per stage. Tables may be host numpy or device arrays
    (a caller with a giant transform passes them as jit arguments)."""
    x = jnp.take(x, bitrev, axis=-1)
    n = x.shape[-1]
    lead = x.shape[:-1]
    for stage_tw in twiddles:
        half = stage_tw.shape[0]
        m = half * 2
        v = x.reshape(lead + (n // m, m))
        e = v[..., :half]
        o = fp.mont_mul_f(field, v[..., half:], stage_tw)
        x = jnp.concatenate(
            [fp.add_f(field, e, o), fp.sub_f(field, e, o)], axis=-1
        ).reshape(lead + (n,))
    return x


# ---- four-step ------------------------------------------------------------


@dataclass(frozen=True)
class FourStep:
    """n = n1·n2 (n1 ≥ n2): row plans and the O(√n) twiddle generators."""

    n1: int
    n2: int
    inner: NttPlan  # size n1, root w^{n2}
    outer: NttPlan  # size n2, root w^{n1}
    rows: np.ndarray  # w^{j2}, j2 < n2 (Montgomery, host)
    rows_blk: np.ndarray  # w^{blk·j2} (Montgomery, host)
    blk: int
    scale_mont: int | None  # folded into the twiddles (inverse transforms)


@functools.lru_cache(maxsize=None)
def fourstep_constants(
    n: int, w: int, inverse_scale: int | None = None, field: Field = FIELD101
) -> FourStep:
    """Factor n and build the row plans plus the two generator vectors of the
    twiddle matrix T[j2, k1] = w^{j2·k1}. With k1 = blk·kh + kl,
        T[j2, k1] = U[j2, kh] · V[j2, kl],
    U = (w^{blk})^{j2·kh} (n2 × n1/blk), V = w^{j2·kl} (n2 × blk); both are
    expanded in-trace from `rows` and `rows_blk` (see `_twiddle_uv`)."""
    bits = n.bit_length() - 1
    b1 = (bits + 1) // 2
    n1, n2 = 1 << b1, 1 << (bits - b1)
    p = field.p
    blk = min(_TW_BLK, n1)
    rows = field.host_powers_pow2(w, n2)  # w^{j2} residues
    return FourStep(
        n1=n1,
        n2=n2,
        inner=make_plan(n1, pow(w, n2, p), field=field),
        outer=make_plan(n2, pow(w, n1, p), field=field),
        rows=field.host_to_mont(rows),
        rows_blk=field.host_to_mont(field.host_pow_vec(rows, blk)),
        blk=blk,
        scale_mont=inverse_scale,
    )


def _vandermonde(bases, width: int, first, field: Field):
    """(len(bases), width) Montgomery matrix first·bases[r]^c, built by
    doubling (log2(width) fused passes)."""
    v = jnp.full(bases.shape + (1,), jnp.uint32(first))
    bm = jnp.asarray(bases)
    while v.shape[-1] < width:
        v = jnp.concatenate([v, fp.mont_mul_f(field, v, bm[..., None])], axis=-1)
        bm = fp.mont_mul_f(field, bm, bm)
    return v


def _twiddle_uv(c: FourStep, field: Field):
    """U (n2, n1/blk) and V (n2, blk); an inverse transform's n^{-1} rides
    in U's first column, so every element picks it up exactly once."""
    first_u = c.scale_mont if c.scale_mont is not None else field.r_mod_p
    u = _vandermonde(c.rows_blk, c.n1 // c.blk, first_u, field)
    v = _vandermonde(c.rows, c.blk, field.r_mod_p, field)
    return u, v


def _identity(arr):
    return arr


def fourstep(x, c: FourStep, field: Field = FIELD101, constrain=_identity):
    """Size-(n1·n2) transform along the last axis, natural order in and out.

    X[k1 + n1·k2] = Σ_{j2} (w^{n1})^{j2·k2} · w^{j2·k1} · Σ_{j1}
    x[j1·n2 + j2] (w^{n2})^{j1·k1}. `constrain` is applied to every
    intermediate (the sharded caller pins each to the row sharding, so the
    transposes become all_to_alls)."""
    n1, n2 = c.n1, c.n2
    lead = x.shape[:-1]
    xt = constrain(jnp.swapaxes(x.reshape(lead + (n1, n2)), -1, -2))  # [j2, j1]
    a = ntt(xt, c.inner)  # [j2, k1]
    u, v = _twiddle_uv(c, field)
    a3 = a.reshape(lead + (n2, n1 // c.blk, c.blk))
    a3 = fp.mont_mul_f(field, fp.mont_mul_f(field, a3, u[:, :, None]), v[:, None, :])
    b = constrain(jnp.swapaxes(a3.reshape(lead + (n2, n1)), -1, -2))  # [k1, j2]
    d = ntt(b, c.outer)  # [k1, k2]
    return constrain(jnp.swapaxes(d, -1, -2)).reshape(lead + (n1 * n2,))


def ntt(x, plan: NttPlan):
    """X[k] = Σ_j x[j]·ω^{jk} along the last axis (Montgomery-form in/out,
    natural order in/out); leading axes are independent batch transforms."""
    assert x.shape[-1] == plan.n
    if plan.n >= FOURSTEP_MIN:
        c = fourstep_constants(plan.n, plan.w, None, plan.field)
        return fourstep(x, c, plan.field)
    return radix2(x, plan.bitrev, plan.twiddles, plan.field)


def intt(x, plan: NttPlan):
    """Inverse transform: x[j] = n^{-1}·Σ_k X[k]·ω^{-jk}; plan must be inverse."""
    assert plan.scale_mont is not None, "intt needs a plan built with inverse=True"
    if plan.n >= FOURSTEP_MIN:
        # n^{-1} folds into the twiddle matrix — no extra pass
        c = fourstep_constants(plan.n, plan.w, plan.scale_mont, plan.field)
        return fourstep(x, c, plan.field)
    y = radix2(x, plan.bitrev, plan.twiddles, plan.field)
    return fp.mont_mul_f(plan.field, y, np.uint32(plan.scale_mont))


@functools.lru_cache(maxsize=None)
def _offset_powers_mont(
    n: int, offset: int, invert: bool, field: Field = FIELD101
) -> np.ndarray:
    o = pow(offset, field.p - 2, field.p) if invert else offset % field.p
    return field.host_to_mont(field.host_powers_pow2(o, n))


def coset_ntt(coeffs, n: int, offset: int, field: Field = FIELD101):
    """Evaluate the polynomial with `coeffs` (len ≤ n, Montgomery form) on the
    coset {offset·h^i} in natural order — the reference's f_domain evaluation
    (prover.rs:69-70) done as one pre-scale + NTT."""
    k = coeffs.shape[-1]
    if k < n:
        coeffs = jnp.concatenate(
            [coeffs, jnp.zeros(coeffs.shape[:-1] + (n - k,), dtype=jnp.uint32)],
            axis=-1,
        )
    if n > (1 << 20):
        # big domains: compute offset^j in-trace (elementwise, GSPMD-shardable)
        # instead of embedding a multi-MB host table into the module
        scaled = fp.mont_mul_f(field, coeffs, fp.powers_iota_f(field, offset, n))
    else:
        scaled = fp.mont_mul_f(
            field, coeffs, _offset_powers_mont(n, offset, invert=False, field=field)
        )
    return ntt(scaled, forward_plan(n, field))


def coset_intt(evals, offset: int, field: Field = FIELD101):
    """Inverse of coset_ntt: recover coefficients from coset evaluations."""
    n = evals.shape[-1]
    coeffs = intt(evals, inverse_plan(n, field))
    if n > (1 << 20):
        return fp.mont_mul_f(
            field, coeffs, fp.powers_iota_f(field, pow(offset, field.p - 2, field.p), n)
        )
    return fp.mont_mul_f(
        field, coeffs, _offset_powers_mont(n, offset, invert=True, field=field)
    )
