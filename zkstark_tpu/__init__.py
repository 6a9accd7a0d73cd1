"""zkstark_tpu — a STARK proving framework in JAX/XLA/Pallas.

A from-scratch JAX redesign of the capabilities of the reference Rust
stark-101 prover (Crocodoctopus/zkstark): FibonacciSq trace → low-degree
extension → constraint composition → FRI → SHA-256 Merkle commitments →
Fiat-Shamir transcript, producing proofs that are byte-identical to the
reference's transcript while running every hot loop as vectorized device
programs (NTT instead of O(n³) Lagrange, evaluation-form constraints instead
of polynomial long division, batched hash kernels instead of scalar SHA-256).
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# The persistent XLA compilation cache: one setting. JAX reads
# JAX_COMPILATION_CACHE_DIR itself when it is set; otherwise the cache lives at
# a fixed path beside the package (a path that moves never hits).
DEFAULT_CACHE_DIR = _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..", ".jax_cache")
)


def compilation_cache_dir() -> str:
    """Point JAX's persistent compilation cache at its one directory and
    return that directory."""
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    _jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


compilation_cache_dir()
