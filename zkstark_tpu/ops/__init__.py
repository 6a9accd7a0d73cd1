"""Hand-written kernels and the one rule that routes to them.

The kernels here (ops/sha256_kernel.py: Pallas through Triton) compile for
NVIDIA GPUs only; each has a plain jnp twin that is the path everywhere else
and the reference its tests compare against. `gpu_kernels()` is the single
capability check: it is true when the arrays being traced live on a GPU —
the pinned default device if there is one (`prove(mesh=...)` pins the mesh's
first device), else the default backend. Interpret mode is never chosen
here: tests reach it by calling a kernel wrapper with `interpret=True`.
"""

from __future__ import annotations


def target_platform() -> str:
    """Platform of the device the traced arrays live on ("gpu", "cpu", …)."""
    import jax

    dev = jax.config.jax_default_device
    if dev is not None:
        return getattr(dev, "platform", dev)
    return jax.default_backend()


def gpu_kernels() -> bool:
    return target_platform() == "gpu"
