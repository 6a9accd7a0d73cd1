"""Sharded large-domain NTT: the four-step transform with its transposes
pinned to a device mesh.

A flat radix-2 NTT sharded over a device mesh would cross the shard boundary
in its last log2(S) butterfly stages, costing one collective per stage. The
four-step factorization n = n1·n2 (SURVEY.md §2 TP row / §5 long-context,
`ntt.core.fourstep`) keeps every butterfly local to a row, so ALL inter-device
traffic collapses into its transposes, which XLA GSPMD lowers to `all_to_all`
collectives once each intermediate is constrained to the row sharding:

    1. transpose (n1, n2) → (n2, n1)                   [all_to_all]
    2. n2 independent row NTTs of size n1 (root ω^{n2})  [local]
    3. twiddle by ω^{j2·k1}                             [local]
    4. transpose → (n1, n2)                             [all_to_all]
    5. n1 independent row NTTs of size n2 (root ω^{n1})  [local]
    6. transpose → natural-order output                 [all_to_all]

The result is bit-identical to ntt.ntt() at any mesh size (shard-invariance
is tested on a virtual 8-device CPU mesh) — the annotate-and-let-XLA-insert-
collectives recipe, with no hand-written transport.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from zkstark_tpu.field import fp
from zkstark_tpu.field.fp import FIELD101, Field
from zkstark_tpu.ntt import core
from zkstark_tpu.parallel.mesh import row_sharding


def ntt_sixstep(
    x,
    n: int,
    root: int,
    mesh: Mesh | None = None,
    inverse: bool = False,
    field: Field = FIELD101,
):
    """Size-n transform of a flat Montgomery vector, natural order in/out,
    bit-identical to ntt.ntt / ntt.intt, sharded over `mesh` when given."""
    plan = core.make_plan(n, root, inverse, field)
    c = core.fourstep_constants(n, plan.w, plan.scale_mont, field)

    def constrain(arr):
        if mesh is None:
            return arr
        return jax.lax.with_sharding_constraint(arr, row_sharding(mesh, arr.ndim))

    return constrain(core.fourstep(x, c, field, constrain))


def coset_ntt_sixstep(
    coeffs, n: int, offset: int, mesh: Mesh | None = None, field: Field = FIELD101
):
    """Sharded equivalent of ntt.coset_ntt (LDE onto offset·⟨h⟩)."""
    k = coeffs.shape[-1]
    if k < n:
        coeffs = jnp.concatenate(
            [coeffs, jnp.zeros(n - k, dtype=jnp.uint32)], axis=-1
        )
    # powers_iota: elementwise offset^j — shards with the coeff vector
    # (device_powers' concat chain would force a replicated 4n-byte constant)
    scaled = fp.mont_mul_f(field, coeffs, fp.powers_iota_f(field, offset, n))
    return ntt_sixstep(
        scaled, n, field.subgroup_generator(n), mesh=mesh, field=field
    )
