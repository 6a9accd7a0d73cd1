"""AIR (algebraic intermediate representation) framework + concrete AIRs.

The reference welds its three FibonacciSq constraints into the prover
(prover.rs:101-145) and duplicates them in the verifier (proof.rs:63-77).
Here an `Air` is a first-class pluggable object: it generates the witness
trace and declares an ordered list of constraints — `Boundary(step, value)`
and `Transition(numerator, exempt)` — from which the framework derives ALL
THREE consumers:

  * the device-side eval-form composition (batched inversions against
    precomputed vanishing denominators, no polynomial division) —
    prover.composition_eval;
  * the host-side exact point checks the Python verifier performs at each
    query — composition_at_point below;
  * the constraint bytecode the independent C++ verifier interprets
    (serialize_air below → native/zkstark_native.cpp).

Constraint numerators are written once as a function of an `ops` namespace
(mul/add/sub/const) plus accessors f(k) = f(g^k·x) and the domain point x.
The same function runs in three modes: vectorized Montgomery arrays on
device, exact Python ints mod p on the verifier host, and a recording tracer
that emits an RPN program for the native verifier — one source of truth for
the protocol math.

Reference semantics for FibonacciSq: prover.rs:32-39 builds a 1023-step trace
a[0]=1, a[1]=secret, a[i]=a[i-2]²+a[i-1]², then Lagrange-interpolates through
(g^i, a[i]) for i ≤ 1022 — an O(n³) CPU loop (polynomial.rs:337-383).

Vectorized replacement (SURVEY.md §7.1): the trace lives on the size-1024
subgroup ⟨g⟩ with the last point free. Since deg f ≤ 1022, the degree-1023
INTT coefficient must vanish; the INTT is linear in the unknown a[1023], so
one size-1024 INTT plus a rank-1 correction yields exactly the reference's
f_poly. Validated against the reference's own evaluation goldens
(prover.rs:73-78) and interpolation asserts (prover.rs:64-66).

Trace generation itself is an inherently sequential recurrence (a[i] depends
on a[i-1], a[i-2]); it is O(trace_len) scalar work, negligible next to the
O(n log n) device phases, and is done host-side with exact ints.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import jax.numpy as jnp
import numpy as np

from zkstark_tpu.field import fp
from zkstark_tpu.field.fp import FIELD101, Field
from zkstark_tpu import ntt


# ---------------------------------------------------------------------------
# Constraint objects
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Boundary:
    """c(x) = (f(x) − value) / (x − g^step): the trace equals `value` at
    trace step `step` (reference c0/c1, prover.rs:101-113)."""

    step: int
    value: int


@dataclass(frozen=True)
class Transition:
    """c(x) = numerator(ops, f, x) / Z(x) with the vanishing polynomial
    Z = (x^n − 1) / Π_{e ∈ exempt} (x − g^e): the recurrence `numerator`
    holds at every trace step except the `exempt` ones (reference c2,
    prover.rs:134-145).

    `numerator` is called as numerator(ops, f, x) where f(k) yields the
    shifted trace polynomial f(g^k·x) and ops supplies mul/add/sub/const.
    It must be a pure algebraic expression in those primitives (it runs on
    device arrays, host ints, and a recording tracer)."""

    numerator: Callable
    exempt: tuple


# ---------------------------------------------------------------------------
# Ops namespaces — the three evaluation modes of a constraint numerator
# ---------------------------------------------------------------------------


class _DeviceOps:
    """Vectorized Montgomery-form uint32 arrays (the prover's coset),
    bound to one Field descriptor."""

    def __init__(self, field: Field):
        self.field = field
        self.mul = functools.partial(fp.mont_mul_f, field)
        self.add = functools.partial(fp.add_f, field)
        self.sub = functools.partial(fp.sub_f, field)

    def const(self, v: int):
        # numpy scalar: a trace-safe literal, not a device constant
        return self.field.mont_scalar(v)


class _HostOps:
    """Exact Python ints mod p (the verifier's point checks)."""

    def __init__(self, p: int):
        self.p = p

    def mul(self, a, b):
        return a * b % self.p

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def const(self, v: int):
        return v % self.p


@functools.lru_cache(maxsize=None)
def device_ops(field: Field = FIELD101) -> _DeviceOps:
    return _DeviceOps(field)


@functools.lru_cache(maxsize=None)
def host_ops(p: int = fp.P) -> _HostOps:
    return _HostOps(p)


# default-field namespaces (backwards-compatible names)
DeviceOps = device_ops(FIELD101)
HostOps = host_ops(fp.P)


# RPN opcodes shared with native/zkstark_native.cpp (keep in sync)
OP_F, OP_X, OP_CONST, OP_ADD, OP_SUB, OP_MUL = range(6)


class _Node:
    """Expression node recorded by RecorderOps; serialized postfix."""

    __slots__ = ("op", "arg", "children")

    def __init__(self, op, arg=0, children=()):
        self.op = op
        self.arg = arg
        self.children = children


class RecorderOps:
    """Records the numerator as an expression tree → RPN program for the
    native C++ verifier (one more consumer of the same definition)."""

    def __init__(self, p: int = fp.P):
        self.p = p

    @staticmethod
    def mul(a, b):
        return _Node(OP_MUL, children=(a, b))

    @staticmethod
    def add(a, b):
        return _Node(OP_ADD, children=(a, b))

    @staticmethod
    def sub(a, b):
        return _Node(OP_SUB, children=(a, b))

    def const(self, v: int):
        return _Node(OP_CONST, v % self.p)


def numerator_program(numerator: Callable, shifts: tuple, p: int = fp.P) -> list:
    """[(op, arg), …] RPN encoding of a transition numerator."""
    root = numerator(
        RecorderOps(p),
        lambda k: _Node(OP_F, shifts.index(k)),
        _Node(OP_X),
    )
    prog = []

    def emit(node):
        for c in node.children:
            emit(c)
        prog.append((node.op, node.arg))

    emit(root)
    return prog


# ---------------------------------------------------------------------------
# Air base + concrete AIRs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Air:
    """A pluggable AIR: witness generation + ordered constraint list.

    Subclasses set `shifts` (which f(g^k·x) openings the constraints read;
    determines the trace openings per query and the query range) and
    implement trace() and constraints(). Frozen/fieldless so configs
    embedding an Air stay hashable (jit static args)."""

    shifts = (0,)
    name = "air"

    @property
    def max_shift(self) -> int:
        return max(self.shifts)

    def trace(self, trace_len: int, secret: int, p: int = fp.P) -> np.ndarray:
        raise NotImplementedError

    def constraints(self, cfg) -> tuple:
        raise NotImplementedError


def fibonacci_sq_trace(
    length: int = 1023, secret: int = 3141592, p: int = fp.P
) -> np.ndarray:
    """a[0]=1, a[1]=secret, a[i]=a[i-2]²+a[i-1]² over F_p (prover.rs:32-39)."""
    a = np.empty(length, dtype=np.uint32)
    prev2, prev1 = 1, secret % p
    a[0] = prev2
    if length > 1:
        a[1] = prev1
    for i in range(2, length):
        cur = (prev2 * prev2 + prev1 * prev1) % p
        a[i] = cur
        prev2, prev1 = prev1, cur
    return a


def _fib_sq_numerator(ops, f, x):
    """f(g²x) − f(gx)² − f(x)² (prover.rs:134-136)."""
    return ops.sub(ops.sub(f(2), ops.mul(f(1), f(1))), ops.mul(f(0), f(0)))


@dataclass(frozen=True)
class FibonacciSqAir(Air):
    """The reference's statement: knowledge of a[1] with
    a[i] = a[i-1]² + a[i-2]² and public a[0], a[trace_len−1]
    (prover.rs:32-39, proof.rs:63-77)."""

    shifts = (0, 1, 2)
    name = "fibonacci-sq"

    def trace(self, trace_len: int, secret: int, p: int = fp.P) -> np.ndarray:
        return fibonacci_sq_trace(trace_len, secret, p)

    def constraints(self, cfg) -> tuple:
        n = cfg.trace_domain
        return (
            Boundary(0, cfg.boundary_first),
            Boundary(cfg.trace_len - 1, cfg.boundary_last),
            Transition(_fib_sq_numerator, (n - 3, n - 2, n - 1)),
        )


def _fib_numerator(ops, f, x):
    return ops.sub(ops.sub(f(2), f(1)), f(0))


@dataclass(frozen=True)
class FibonacciAir(Air):
    """Plain additive Fibonacci (a[i] = a[i-1] + a[i-2]) — the second AIR
    proving the framework is pluggable: same boundary shape, different
    transition numerator, zero prover/verifier code changes."""

    shifts = (0, 1, 2)
    name = "fibonacci"

    def trace(self, trace_len: int, secret: int, p: int = fp.P) -> np.ndarray:
        a = np.empty(trace_len, dtype=np.uint32)
        prev2, prev1 = 1, secret % p
        a[0] = prev2
        if trace_len > 1:
            a[1] = prev1
        for i in range(2, trace_len):
            cur = (prev2 + prev1) % p
            a[i] = cur
            prev2, prev1 = prev1, cur
        return a

    def constraints(self, cfg) -> tuple:
        n = cfg.trace_domain
        return (
            Boundary(0, cfg.boundary_first),
            Boundary(cfg.trace_len - 1, cfg.boundary_last),
            Transition(_fib_numerator, (n - 3, n - 2, n - 1)),
        )


# MiMC-style round constant (any fixed value < p works; pinned for goldens)
SQUARE_CHAIN_C = 1234567891


def _square_chain_numerator(ops, f, x):
    """f(gx) − f(x)² − C: the iterated-squaring round. Exercises ops.const
    in a transition (neither Fibonacci AIR does), so the RPN OP_CONST path
    of the C++ verifier is covered by a real statement."""
    return ops.sub(ops.sub(f(1), ops.mul(f(0), f(0))), ops.const(SQUARE_CHAIN_C))


@dataclass(frozen=True)
class SquareChainAir(Air):
    """MiMC/VDF-style chain: knowledge of a[0] with a[i] = a[i-1]² + C and
    public output a[trace_len−1]. Unlike the Fibonacci AIRs the SECRET is
    the first trace element, so there is no boundary constraint on step 0 —
    only the output is pinned. Two shifts, one transition; same degree
    profile as the reference statement (cp deg ≤ n−2)."""

    shifts = (0, 1)
    name = "square-chain"

    def trace(self, trace_len: int, secret: int, p: int = fp.P) -> np.ndarray:
        a = np.empty(trace_len, dtype=np.uint32)
        cur = secret % p
        a[0] = cur
        for i in range(1, trace_len):
            cur = (cur * cur + SQUARE_CHAIN_C) % p
            a[i] = cur
        return a

    def constraints(self, cfg) -> tuple:
        n = cfg.trace_domain
        # transition holds at steps 0..trace_len−2 = g^0..g^{n−3}; exempt the
        # free interpolation endpoint (n−2) and the wrap point (n−1)
        return (
            Boundary(cfg.trace_len - 1, cfg.boundary_last),
            Transition(_square_chain_numerator, (n - 2, n - 1)),
        )


FIBONACCI_SQ = FibonacciSqAir()
FIBONACCI = FibonacciAir()
SQUARE_CHAIN = SquareChainAir()

AIRS = {a.name: a for a in (FIBONACCI_SQ, FIBONACCI, SQUARE_CHAIN)}


# ---------------------------------------------------------------------------
# Host-side point evaluation (the verifier's consumer)
# ---------------------------------------------------------------------------


def composition_at_point(cfg, x: int, f_vals: dict, alphas: list) -> int:
    """Σ αᵢ·cᵢ(x) with exact ints — the verifier's composition check value
    (proof.rs:63-77 generalised). f_vals maps shift k → opened f(g^k·x)."""
    p = cfg.field.p
    g = cfg.trace_generator
    n = cfg.trace_domain
    inv = lambda a: pow(a % p, p - 2, p)
    acc = 0
    for alpha, con in zip(alphas, cfg.constraints):
        if isinstance(con, Boundary):
            num = (f_vals[0] - con.value) % p
            den = (x - pow(g, con.step, p)) % p
        else:
            num = con.numerator(host_ops(p), lambda k: f_vals[k] % p, x % p)
            z = (pow(x, n, p) - 1) % p
            for e in con.exempt:
                z = z * inv(x - pow(g, e, p)) % p
            den = z
        acc = (acc + alpha * num % p * inv(den)) % p
    return acc


def serialize_air(cfg) -> np.ndarray:
    """Flat uint32 blob describing the constraint system for the native C++
    verifier (format documented in native/zkstark_native.cpp):

    [n_shifts, shifts…, n_constraints] then per constraint:
      Boundary:   [0, step, value]
      Transition: [1, n_exempt, exempt…, n_ops, (op, arg)…]
    """
    shifts = cfg.air.shifts
    words = [len(shifts), *shifts, len(cfg.constraints)]
    for con in cfg.constraints:
        if isinstance(con, Boundary):
            words += [0, con.step, con.value % cfg.field.p]
        else:
            prog = numerator_program(con.numerator, shifts, cfg.field.p)
            words += [1, len(con.exempt), *con.exempt, len(prog)]
            for op, arg in prog:
                words += [op, arg]
    return np.asarray(words, dtype=np.uint32)


# ---------------------------------------------------------------------------
# Trace interpolation (phase 1's INTT substitution for lagrange())
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _endpoint_basis(n: int, field: Field = FIELD101):
    """Constants for the missing-point trick at subgroup size n.

    v = INTT(e_{n-1}) has v[j] = n^{-1}·g^{-(n-1)j}; we need the full vector
    (Montgomery form) and 1/v[n-1] (to solve for the free trace value).
    HOST numpy, like every cached protocol constant: embeds at lowering with
    no device fetch, and can never be a leaked tracer."""
    p = field.p
    g = field.subgroup_generator(n)
    g_inv = pow(g, p - 2, p)
    n_inv = pow(n, p - 2, p)
    base = pow(g_inv, n - 1, p)
    v = (field.host_powers_pow2(base, n).astype(np.uint64) * n_inv % p).astype(
        np.uint32
    )
    v_last_inv = pow(int(v[n - 1]), p - 2, p)
    return (
        field.host_to_mont(v),
        np.uint32(field.host_to_mont(np.array([v_last_inv], dtype=np.uint32))[0]),
    )


def interpolate_trace(trace_mont, n: int, field: Field = FIELD101):
    """Coefficients (Montgomery form, natural order, degree ≤ n−2) of the unique
    poly through (g^i, trace[i]) for i < n−1 — the reference's lagrange()
    output (prover.rs:60-61) computed as one INTT + rank-1 correction.

    Last axis = the trace; leading axes are independent batch proofs (DP)."""
    assert trace_mont.shape[-1] == n - 1
    padded = jnp.concatenate(
        [trace_mont, jnp.zeros(trace_mont.shape[:-1] + (1,), dtype=jnp.uint32)],
        axis=-1,
    )
    c0 = ntt.intt(padded, ntt.inverse_plan(n, field))
    v, v_last_inv = _endpoint_basis(n, field)
    # choose the free endpoint a_{n-1} so that coefficient n−1 vanishes:
    #   c0[n−1] + a_{n-1}·v[n−1] = 0
    a_last = fp.mont_mul_f(field, fp.neg_f(field, c0[..., n - 1 : n]), v_last_inv)
    coeffs = fp.add_f(field, c0, fp.mont_mul_f(field, v, a_last))
    return coeffs
