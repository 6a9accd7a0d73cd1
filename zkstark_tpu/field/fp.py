"""Vectorized prime-field arithmetic, generic over the prime.

Design notes
------------
The reference implementation (`/root/reference/src/field.rs:8-211`) wraps a scalar
Montgomery integer (`num_modular::MontgomeryInt<u32>`), generic over `const P: u32`
— one element at a time on a CPU. Here the unit of work is a whole `uint32`
array: every operation below is an elementwise vector program over field
elements, designed so XLA can fuse chains of them (butterflies, constraint
evaluation, FRI folds) into single kernels.

Genericity mirrors the reference's `Gf<const P: u32>` (its own tests
instantiate Gf⟨4391⟩, field.rs:213-226, and Gf⟨101⟩/Gf⟨7⟩,
polynomial.rs:402-454): a `Field` descriptor carries the prime and every
derived Montgomery constant; all math below is written against a descriptor.
The protocol default `FIELD101` (p = 3·2^30+1, main.rs:13) additionally gets a
shift/add specialization of REDC's m·p high word (`_mp_hi`) auto-selected by
its prime shape; every other prime takes the generic 16-bit-limb multiply.
Module-level functions are the default field's ops — existing call sites (and
the byte-exact stark-101 transcript) are untouched.

The 64-bit products needed by Montgomery reduction are synthesized from 16-bit
limb products, which stay inside uint32 vector ops (`_mul32_wide`) — a form
every backend lowers (a native 32×32→64 multiply is an open item for GPUs).
Representation:

* **Montgomery form, R = 2^32.** An element ``a`` is stored as ``a·R mod p`` in a
  ``uint32``. `mont_mul(x, y) = x·y·R^{-1} mod p` keeps the form closed under
  multiplication. This mirrors the reference's representation (field.rs:8) so all
  algebraic behavior — including `residue()` conversion at commit boundaries
  (field.rs:41-43) — matches bit-for-bit.
* Inversion is Fermat (`a^{p-2}`), fully vectorized: ~32 squarings over the whole
  array instead of the reference's sequential per-element `Inv` (field.rs:206-211).
  Montgomery's sequential batch-inversion trick is *not* used: it is a serial
  dependency chain, which is the wrong shape for a vector unit.
* `pow` takes a static Python exponent and unrolls square-and-multiply at trace
  time — no data-dependent control flow under `jit`.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

# REDC's m·p high word: "spec" (default) = shift/add form exploiting
# p = 3·2^30+1 where that prime is in use; ZKSTARK_MULP=mul = generic
# 16-bit-limb multiply everywhere (A/B lever).
_MULP_SPEC = os.environ.get("ZKSTARK_MULP", "spec") != "mul"

_U32 = jnp.uint32
# numpy scalars lower as literals inside Pallas kernels (jnp scalars would be
# captured array constants, which pallas_call rejects).
_MASK16 = np.uint32(0xFFFF)

R = 1 << 32
_SPEC_P = 3221225473  # the prime whose m·p high word has a shift/add form


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=_U32)


# ---------------------------------------------------------------------------
# Field descriptor — the vector twin of the reference's Gf<const P: u32>
# ---------------------------------------------------------------------------


def _prime_factors(n: int) -> list[int]:
    """Unique prime factors of n by trial division (n ≤ ~2^64 protocol sizes)."""
    out = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        out.append(n)
    return out


class Field:
    """All constants of F_p for an odd prime p < 2^32, R = 2^32.

    Hash/eq by p, so descriptors are valid `jit` static arguments and
    lru_cache keys. `generator` (the reference's trial algorithm,
    field.rs:52-86) and the prime factorization are computed lazily — most
    descriptors are built once per process and cached by `field_for`.
    """

    __slots__ = (
        "p",
        "two_adicity",
        "r_mod_p",
        "r2_mod_p",
        "p_inv_neg",
        "spec_mp_hi",
        "p_u32",
        "p_inv_neg_u32",
        "r_minus_p_u32",
        "_p_minus_2_bits",
        "_generator",
    )

    def __init__(self, p: int):
        if p < 3 or p % 2 == 0 or p >= R:
            raise ValueError(f"need an odd prime 3 <= p < 2^32, got {p}")
        self.p = p
        t = p - 1
        two_adicity = 0
        while t % 2 == 0:
            t //= 2
            two_adicity += 1
        self.two_adicity = two_adicity
        self.r_mod_p = R % p
        self.r2_mod_p = (R * R) % p
        self.p_inv_neg = (-pow(p, -1, R)) % R  # Montgomery magic constant
        self.spec_mp_hi = p == _SPEC_P
        self.p_u32 = np.uint32(p)
        self.p_inv_neg_u32 = np.uint32(self.p_inv_neg)
        self.r_minus_p_u32 = np.uint32(R - p)
        # LSB-first bits of p−2, consumed by the inv() scan.
        self._p_minus_2_bits = np.array(
            [((p - 2) >> i) & 1 for i in range(32)], dtype=bool
        )
        self._generator = None

    # -- identity ----------------------------------------------------------
    def __hash__(self):
        return hash(self.p)

    def __eq__(self, other):
        return isinstance(other, Field) and other.p == self.p

    def __repr__(self):
        return f"Field({self.p})"

    # -- structure ---------------------------------------------------------
    @property
    def generator(self) -> int:
        """Smallest multiplicative generator of F_p^*, by the reference's
        trial algorithm (field.rs:52-86): collect the unique prime factors q
        of p−1, return the first x ≥ 2 with x^((p−1)/q) ≠ 1 for all q.
        For the protocol field this finds 5 (noted at prover.rs:44)."""
        if self._generator is None:
            factors = _prime_factors(self.p - 1)
            x = 2
            while True:
                if all(pow(x, (self.p - 1) // q, self.p) != 1 for q in factors):
                    break
                x += 1
            self._generator = x
        return self._generator

    def subgroup_generator(self, order: int) -> int:
        """Generator of the order-`order` subgroup, derived from the field
        generator exactly as the reference does (prover.rs:48-49:
        g^((p-1)/order))."""
        return _subgroup_generator(self, order)

    def multiplicative_order(self, x: int) -> int:
        """Exact multiplicative order of x in F_p^* (reference field.rs:45-49
        computes this by linear scan; here divisor-refinement over the group
        order — same result, O(log²) instead of O(p))."""
        p = self.p
        x %= p
        if x == 0:
            raise ValueError("0 has no multiplicative order")
        order = p - 1
        for q in _prime_factors(p - 1):
            while order % q == 0 and pow(x, order // q, p) == 1:
                order //= q
        return order

    # -- device ops (defined below, bound as methods) ----------------------
    def mont_mul(self, a, b):
        return mont_mul_f(self, a, b)

    def to_mont(self, a):
        return to_mont_f(self, a)

    def from_mont(self, a):
        return from_mont_f(self, a)

    def add(self, a, b):
        return add_f(self, a, b)

    def sub(self, a, b):
        return sub_f(self, a, b)

    def neg(self, a):
        return neg_f(self, a)

    def pow_static(self, a, e: int):
        return pow_static_f(self, a, e)

    def inv(self, a):
        return inv_f(self, a)

    def device_powers(self, base: int, n: int):
        return device_powers_f(self, base, n)

    def powers_iota(self, base: int, n: int, scale: int = 1):
        return powers_iota_f(self, base, n, scale)

    def mont_scalar(self, v: int) -> np.uint32:
        """to_mont of one host residue as a numpy scalar — embeds as a
        literal when closed over inside a trace (a jnp scalar would be a
        device constant lowering must fetch back)."""
        return np.uint32(self.host_to_mont(np.array([v % self.p], np.uint32))[0])

    # -- host exact helpers ------------------------------------------------
    def host_to_mont(self, arr: np.ndarray) -> np.ndarray:
        """Exact host-side conversion to Montgomery form."""
        return (
            (arr.astype(np.uint64) * np.uint64(self.r_mod_p)) % np.uint64(self.p)
        ).astype(np.uint32)

    def host_powers(self, base: int, count: int, start: int = 1) -> np.ndarray:
        """[start, start·base, start·base², …] as uint32 (exact Python ints)."""
        out = np.empty(count, dtype=np.uint32)
        acc = start % self.p
        for i in range(count):
            out[i] = acc
            acc = (acc * base) % self.p
        return out

    def host_powers_pow2(self, base: int, n: int, scale: int = 1) -> np.ndarray:
        """[scale·base^j for j < n] as uint32 residues, n a power of two —
        numpy log-doubling (log2(n) vectorized u64 modmul passes; host_powers'
        per-element Python loop is too slow past ~2^14). All products are
        < 2^32·2^32 so u64 arithmetic is exact."""
        assert n >= 1 and n & (n - 1) == 0
        arr = np.array([scale % self.p], dtype=np.uint64)
        while arr.shape[0] < n:
            step = np.uint64(pow(base, arr.shape[0], self.p))
            arr = np.concatenate([arr, (arr * step) % np.uint64(self.p)])
        return arr.astype(np.uint32)

    def host_vandermonde(self, bases: np.ndarray, n: int) -> np.ndarray:
        """V[i, k] = bases[i]^k mod p for k < n, as uint32 residues — numpy
        column log-doubling (exact u64 modmuls). The host twin of the device
        Vandermonde builders; used so twiddle tables are HOST constants that
        embed at lowering instead of device buffers lowering must fetch."""
        v = np.ones((bases.shape[0], 1), dtype=np.uint64)
        bm = bases.astype(np.uint64)
        p64 = np.uint64(self.p)
        while v.shape[1] < n:
            step = min(v.shape[1], n - v.shape[1])
            v = np.concatenate([v, (v[:, :step] * bm[:, None]) % p64], axis=1)
            bm = (bm * bm) % p64
        return v.astype(np.uint32)

    def host_pow_vec(self, bases: np.ndarray, e: int) -> np.ndarray:
        """bases^e mod p elementwise, exact numpy u64 square-and-multiply."""
        r = np.ones_like(bases, dtype=np.uint64)
        b = bases.astype(np.uint64)
        p64 = np.uint64(self.p)
        while e:
            if e & 1:
                r = (r * b) % p64
            b = (b * b) % p64
            e >>= 1
        return r.astype(np.uint32)

    def host_inv_vec(self, a: np.ndarray) -> np.ndarray:
        """Vectorized exact Fermat inverse of uint32 residues (numpy u64
        square-and-multiply — ~32 passes; zero maps to zero like pow())."""
        return self.host_pow_vec(a.astype(np.uint64), self.p - 2)


@functools.lru_cache(maxsize=None)
def field_for(p: int) -> Field:
    """Canonical (cached) descriptor for F_p."""
    return Field(p)


@functools.lru_cache(maxsize=None)
def _subgroup_generator(field: Field, order: int) -> int:
    assert (field.p - 1) % order == 0, f"no subgroup of order {order}"
    return pow(field.generator, (field.p - 1) // order, field.p)


# ---------------------------------------------------------------------------
# Protocol field constants (reference: main.rs:13  `type F = Gf<3221225473>`)
# ---------------------------------------------------------------------------

P = _SPEC_P  # 3 * 2**30 + 1
FIELD101 = field_for(P)  # the stark-101 protocol field
FIELD101._generator = 5  # known (reference finds 5, prover.rs:44); skips trial

TWO_ADICITY = FIELD101.two_adicity  # 30: p - 1 = 3 * 2**30
GENERATOR = 5  # smallest multiplicative generator (reference field.rs:52-86)

R_MOD_P = FIELD101.r_mod_p  # 1073741823 == Montgomery form of 1
R2_MOD_P = FIELD101.r2_mod_p  # to_mont multiplier
P_INV_NEG = FIELD101.p_inv_neg  # p' = -p^{-1} mod 2^32

_P_U32 = FIELD101.p_u32
_P_INV_NEG_U32 = FIELD101.p_inv_neg_u32
_R_MINUS_P_U32 = FIELD101.r_minus_p_u32

# A second 2-adic prime with deep power-of-two subgroups (15·2^27 + 1, the
# "BabyBear-adjacent" NTT prime): the standard end-to-end witness that the
# framework is generic over P like the reference's Gf<const P>.
P_ALT = 2013265921
FIELD_ALT = field_for(P_ALT)


# ---------------------------------------------------------------------------
# 32x32 -> 64 wide multiply out of 16-bit limb products (pure uint32 ops)
# ---------------------------------------------------------------------------

def _mul32_wide(a, b):
    """Return (hi, lo) of the full 64-bit product of two uint32 arrays.

    All partial products fit in uint32:
      a = ah·2^16 + al, b = bh·2^16 + bl
      a·b = hh·2^32 + (lh + hl)·2^16 + ll
    The carry column `t` is at most 3·(2^16 − 1) < 2^18 and the final `hi` sum is
    provably < 2^32 (the true product is < 2^64), so nothing overflows.
    """
    ah = a >> 16
    al = a & _MASK16
    bh = b >> 16
    bl = b & _MASK16
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    t = (ll >> 16) + (lh & _MASK16) + (hl & _MASK16)
    lo = (t << 16) | (ll & _MASK16)
    hi = hh + (lh >> 16) + (hl >> 16) + (t >> 16)
    return hi, lo


def _mul32_hi(a, b):
    """High 32 bits of the 64-bit product (lo discarded; XLA DCEs the rest)."""
    hi, _ = _mul32_wide(a, b)
    return hi


# ---------------------------------------------------------------------------
# Montgomery reduction / multiplication
# ---------------------------------------------------------------------------

def _mp_hi(m):
    """High 32 bits of m·p exploiting p = 3·2^30 + 1: m·p = (3m << 30) + m,
    so hi32 = (3m >> 2) + carries — shifts and adds only, replacing the four
    16-bit limb multiplies of the generic _mul32_hi(m, P) inside every REDC.
    Auto-selected only when the active field IS p = 3·2^30+1 (Field.spec_mp_hi).

    3m needs 34 bits: s = low 32 of 3m, c ∈ {0,1,2} its overflow;
    hi32(m·p) = (s >> 2) + (c << 30) + [((s & 3) << 30) + m wraps].
    Exhaustively property-checked against (m·P) >> 32."""
    m2 = m << 1
    c = (m >> 31) + (m2 + m < m2).astype(_U32)
    s = m2 + m
    t = (s & np.uint32(3)) << 30
    carry = (t + m < t).astype(_U32)
    return (s >> 2) + (c << 30) + carry


def mont_reduce_f(f: Field, hi, lo):
    """REDC: given t = hi·2^32 + lo < p·2^32, return t·R^{-1} mod p.

    m = lo·p' mod 2^32 makes t + m·p divisible by 2^32; the low word of m·p is
    exactly (2^32 − lo) mod 2^32, so its only effect is a carry of (lo != 0).
    u = hi + hi(m·p) + carry can itself carry out of 32 bits (u < 2p and
    2p > 2^32 is possible), handled via wraparound detection — correct for
    any odd p < 2^32.
    """
    m = lo * f.p_inv_neg_u32
    mp_hi = _mp_hi(m) if (f.spec_mp_hi and _MULP_SPEC) else _mul32_hi(m, f.p_u32)
    carry = (lo != 0).astype(_U32)
    s1 = hi + mp_hi
    c1 = s1 < hi
    s2 = s1 + carry
    c2 = s2 < s1
    overflow = jnp.logical_or(c1, c2)
    # If overflow: true u = s2 + 2^32 ≥ 2^32 > p, so subtract p once:
    #   u − p  ≡  s2 + (2^32 − p)  (mod 2^32), and u − p < p so it fits.
    reduced_ov = s2 + f.r_minus_p_u32
    reduced_no = jnp.where(s2 >= f.p_u32, s2 - f.p_u32, s2)
    return jnp.where(overflow, reduced_ov, reduced_no)


def mont_mul_f(f: Field, a, b):
    """Montgomery product a·b·R^{-1} mod p (both operands in Montgomery form)."""
    hi, lo = _mul32_wide(a, b)
    return mont_reduce_f(f, hi, lo)


def to_mont_f(f: Field, a):
    """Standard residue -> Montgomery form (a·R mod p)."""
    return mont_mul_f(f, _u32(a), jnp.uint32(f.r2_mod_p))


def from_mont_f(f: Field, a):
    """Montgomery form -> standard residue (matches reference residue(), field.rs:41)."""
    return mont_reduce_f(f, jnp.zeros_like(a), a)


# ---------------------------------------------------------------------------
# Add / sub / neg (representation-agnostic: work in either form)
# ---------------------------------------------------------------------------

def add_f(f: Field, a, b):
    s = a + b
    wrapped = s < a  # uint32 wraparound ⇒ true sum ≥ 2^32 > p
    need_sub = jnp.logical_or(wrapped, s >= f.p_u32)
    return jnp.where(need_sub, s - f.p_u32, s)


def sub_f(f: Field, a, b):
    d = a - b
    borrow = a < b
    return jnp.where(borrow, d + f.p_u32, d)


def neg_f(f: Field, a):
    return jnp.where(a == 0, a, f.p_u32 - a)


# ---------------------------------------------------------------------------
# Static-exponent pow / inverse (trace-time unrolled square-and-multiply)
# ---------------------------------------------------------------------------

def pow_static_f(f: Field, a, e: int):
    """a^e for a static Python int e ≥ 0, on Montgomery-form input/output."""
    if e < 0:
        raise ValueError("use inv() + pow_static for negative exponents")
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mont_mul_f(f, result, base)
        e >>= 1
        if e:
            base = mont_mul_f(f, base, base)
    if result is None:
        return jnp.full_like(a, jnp.uint32(f.r_mod_p))  # a^0 = 1 (Montgomery)
    return result


def inv_f(f: Field, a):
    """Fermat inverse a^{p-2}, vectorized (reference field.rs:206-211 semantics).

    Square-and-multiply as a `lax.scan` over the 32 exponent bits: the
    unrolled chain (pow_static) traces ~2k primitives per call site, which
    measurably dominated cold-prove warm-up (jaxpr trace + MLIR lowering of
    the composition constants); the scan body traces once (~60 primitives)
    with the identical multiply count at runtime."""

    def step(carry, bit):
        result, base = carry
        result = jnp.where(bit, mont_mul_f(f, result, base), result)
        return (result, mont_mul_f(f, base, base)), None

    init = (jnp.full_like(a, jnp.uint32(f.r_mod_p)), a)
    (result, _), _ = jax.lax.scan(step, init, jnp.asarray(f._p_minus_2_bits))
    return result


def device_powers_f(f: Field, base: int, n: int) -> jnp.ndarray:
    """[1, base, base², …, base^{n-1}] in Montgomery form, built on device by
    log-doubling (log2(n) concats of mont_muls) — O(n log n) work but only
    O(log n) dispatches, so it scales to 2^24-point domains where a host-side
    sequential product would serialize."""
    assert n >= 1 and n & (n - 1) == 0
    arr = jnp.full((1,), jnp.uint32(f.r_mod_p))
    length = 1
    while length < n:
        step = jnp.uint32(f.host_to_mont(np.array([pow(base, length, f.p)], np.uint32))[0])
        arr = jnp.concatenate([arr, mont_mul_f(f, arr, step)], axis=0)
        length *= 2
    return arr


def powers_iota_f(f: Field, base: int, n: int, scale: int = 1) -> jnp.ndarray:
    """[scale·base^j for j < n] in Montgomery form, computed ELEMENTWISE from
    the index bits: base^j = Π_b (base^{2^b})^{j_b}. Unlike device_powers'
    concat chain, every output element depends only on its own index, so the
    result shards cleanly under GSPMD (each device materializes exactly its
    own block — the scaling prerequisite for 2^24 domain constants; the
    log-doubling concat would replicate or gather). log2(n) selects + mults
    per element, all fused by XLA into one elementwise kernel."""
    assert n >= 1 and n & (n - 1) == 0
    bits = max(n.bit_length() - 1, 1)
    j = jax.lax.broadcasted_iota(jnp.uint32, (n,), 0)
    acc = jnp.full(
        (n,), jnp.uint32(f.host_to_mont(np.array([scale % f.p], np.uint32))[0])
    )
    one = jnp.uint32(f.r_mod_p)
    for b in range(bits):
        step = jnp.uint32(
            f.host_to_mont(np.array([pow(base, 1 << b, f.p)], np.uint32))[0]
        )
        factor = jnp.where((j >> b) & 1, step, one)
        acc = mont_mul_f(f, acc, factor)
    return acc


# ---------------------------------------------------------------------------
# Module-level API: the protocol default field's ops (bound to FIELD101).
# Existing call sites — and the byte-exact stark-101 golden transcript —
# go through these; generic-field code paths pass a Field explicitly.
# ---------------------------------------------------------------------------

_mont_reduce = functools.partial(mont_reduce_f, FIELD101)
mont_mul = functools.partial(mont_mul_f, FIELD101)
to_mont = functools.partial(to_mont_f, FIELD101)
from_mont = functools.partial(from_mont_f, FIELD101)
add = functools.partial(add_f, FIELD101)
sub = functools.partial(sub_f, FIELD101)
neg = functools.partial(neg_f, FIELD101)
pow_static = functools.partial(pow_static_f, FIELD101)
inv = functools.partial(inv_f, FIELD101)
device_powers = functools.partial(device_powers_f, FIELD101)
powers_iota = functools.partial(powers_iota_f, FIELD101)


# ---------------------------------------------------------------------------
# Host-side exact helpers (Python ints — protocol constants, twiddles, tests)
# ---------------------------------------------------------------------------

def host_pow(base: int, e: int, modulus: int = P) -> int:
    return pow(base, e % (modulus - 1) if e >= 0 else e, modulus)


def multiplicative_order(x: int, modulus: int = P) -> int:
    """Exact multiplicative order of x in F_modulus^* (reference field.rs:45-49)."""
    return field_for(modulus).multiplicative_order(x)


def find_generator(modulus: int = P) -> int:
    """Smallest multiplicative generator of F_modulus^* (field.rs:52-86)."""
    return field_for(modulus).generator


def subgroup_generator(order: int) -> int:
    """Generator of the order-`order` subgroup of the PROTOCOL field, derived
    from GENERATOR=5 exactly as the reference does (prover.rs:48-49)."""
    return FIELD101.subgroup_generator(order)


def host_powers(base: int, count: int, start: int = 1) -> np.ndarray:
    return FIELD101.host_powers(base, count, start)


def host_to_mont(arr: np.ndarray) -> np.ndarray:
    return FIELD101.host_to_mont(arr)


def host_powers_pow2(base: int, n: int, scale: int = 1) -> np.ndarray:
    return FIELD101.host_powers_pow2(base, n, scale)


def host_vandermonde(bases: np.ndarray, n: int) -> np.ndarray:
    return FIELD101.host_vandermonde(bases, n)


def host_pow_vec(bases: np.ndarray, e: int) -> np.ndarray:
    return FIELD101.host_pow_vec(bases, e)


def host_inv_vec(a: np.ndarray) -> np.ndarray:
    return FIELD101.host_inv_vec(a)
