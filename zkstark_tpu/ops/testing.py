"""Emulate Pallas kernel bodies as plain eager JAX functions (CPU CI).

Pallas `interpret=True` discharges a kernel into an XLA program that XLA:CPU
must compile first (minutes for an unrolled SHA-256 body). So the kernel
*body* runs eagerly here instead, over shim refs holding numpy arrays: a few
thousand dispatches per block, about a second. This executes the same
arithmetic the GPU compiler sees, and `emulate_pallas_grid` replays every
program of the PRODUCTION grid, so a block-striding or tail-mask bug produces
wrong bytes on the CPU.

While a body runs, the kernel module's `pl`, `plgpu` and `lax` names are
swapped for shims: `program_id`/`num_programs`/`ds`, masked `load`/`store`
on refs and `ref.at[...]` views, and a `fori_loop` that runs as a Python loop
— the Triton-route primitives the kernels use. Every operand is a whole-array
ref, as in the kernels' grid specs.
"""

from __future__ import annotations

import contextlib
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np


class _Ref:
    """One whole-array operand: numpy storage, jnp reads."""

    def __init__(self, arr):
        self.arr = np.array(arr)

    def __getitem__(self, idx):
        return jnp.asarray(self.arr[idx])

    @property
    def at(self):
        return _At(self)


class _At:
    def __init__(self, ref):
        self.ref = ref

    def __getitem__(self, idx):
        return _View(self.ref, idx if isinstance(idx, tuple) else (idx,))


class _View:
    def __init__(self, ref, idx):
        self.ref, self.idx = ref, idx


def _target(ref):
    return (ref.ref, ref.idx) if isinstance(ref, _View) else (ref, (Ellipsis,))


def _load(ref, mask=None, other=None, **_):
    base, idx = _target(ref)
    val = jnp.asarray(base.arr[idx])
    if mask is not None:
        # a block past the array's end reads only its in-bounds rows
        tail = mask.shape[0] - val.shape[0]
        val = jnp.pad(val, [(0, tail)] + [(0, 0)] * (val.ndim - 1))
        val = jnp.where(mask, val, jnp.asarray(0 if other is None else other, val.dtype))
    return val


def _store(ref, val, mask=None, **_):
    base, idx = _target(ref)
    region = base.arr[idx]
    val = np.asarray(val)[: region.shape[0]]
    if mask is not None:
        val = np.where(np.asarray(mask)[: region.shape[0]], val, region)
    base.arr[idx] = val


def _python_fori_loop(lower, upper, body, init):
    carry = init
    for i in range(int(lower), int(upper)):
        carry = body(i, carry)
    return carry


class _EagerLax:
    fori_loop = staticmethod(_python_fori_loop)

    def __getattr__(self, name):
        return getattr(jax.lax, name)


@contextlib.contextmanager
def _shims(kernel, grid_index, grid):
    fn = getattr(kernel, "func", kernel)  # unwrap functools.partial
    mod = sys.modules[fn.__module__]
    saved = {name: getattr(mod, name, None) for name in ("pl", "plgpu", "lax")}
    mod.pl = SimpleNamespace(
        program_id=lambda axis: grid_index[axis],
        num_programs=lambda axis: grid[axis],
        ds=lambda start, size: slice(int(start), int(start) + size),
    )
    mod.plgpu = SimpleNamespace(load=_load, store=_store)
    mod.lax = _EagerLax()
    try:
        yield
    finally:
        for name, val in saved.items():
            setattr(mod, name, val)


def emulate_kernel(kernel, out_shape, out_dtype, *arrays):
    """Run `kernel(*in_refs, out_ref)` as the only program of a 1-program
    grid over whole arrays; returns the output."""
    out = _Ref(np.zeros(out_shape, out_dtype))
    with _shims(kernel, (0,), (1,)):
        kernel(*[_Ref(x) for x in arrays], out)
    return jnp.asarray(out.arr)


def emulate_pallas_grid(kernel, spec: dict, *arrays):
    """Execute a pallas_call's grid with the PRODUCTION spec (the dict handed
    to pl.pallas_call: grid / out_shape, whole-array operands): every program
    runs its body eagerly against the same shared refs."""
    out_shape = spec["out_shape"]
    out = _Ref(np.zeros(out_shape.shape, dtype=out_shape.dtype))
    refs = [_Ref(a) for a in arrays]
    (programs,) = spec["grid"]
    for pid in range(programs):
        with _shims(kernel, (pid,), (programs,)):
            kernel(*refs, out)
    return out.arr
