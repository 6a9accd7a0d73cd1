"""Device mesh configuration + multi-host bootstrap — kept separate from
protocol config so the same proof is byte-identical at any sharding
(SURVEY.md §5 config note).

The reference has no parallelism of any kind (SURVEY.md §2: single thread,
single process, no comms). Scaling here (SURVEY.md §5 distributed-comms row):
  * `make_mesh(n)` — a 1-D mesh over n devices whose one axis shards the
    evaluation domain. On a host whose cards are joined all to all (NVLink
    between the four H100s) every pair of devices exchanges at the same rate,
    so the mesh follows the algorithm alone and 1-D is the right shape;
  * `initialize_distributed()` — `jax.distributed.initialize` process
    bootstrap for multi-process runs, and `make_host_chip_mesh`, a 2-D
    (process, local device) mesh whose flattened product axis shards the
    domain, so contiguous blocks stay within one process before crossing
    processes;
  * `jax.sharding` annotations + XLA-inserted collectives (all_to_all for
    NTT transposes, all_gather for subtree roots, lowered to NCCL on GPUs) —
    never hand-written transport.

Everything below also works single-process: the standard JAX simulation
(`--xla_force_host_platform_device_count=N`) exercises the identical pjit
code path (SURVEY.md §4 multi-host-without-a-cluster).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DOMAIN_AXIS = "shards"
HOST_AXIS = "host"
CHIP_AXIS = "chip"

_initialized = False


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> int:
    """Multi-host bootstrap: `jax.distributed.initialize` (idempotent).

    With no arguments, reads the cluster environment (SLURM /
    JAX_COORDINATOR_ADDRESS…) exactly as JAX does natively; single-process
    runs (no coordinator anywhere) are left untouched. Returns the process
    count. Call before any other JAX API on every host of a slice.

    Ordering is load-bearing: the cluster-env check must happen BEFORE any
    call that initializes the XLA backends (`jax.process_count()` does!),
    because `jax.distributed.initialize` raises if a backend already exists.
    A cluster host whose env is set but whose backends are already up gets a
    clear error instead of the cryptic late RuntimeError."""
    global _initialized
    if _initialized:
        return jax.process_count()
    import os

    has_cluster_env = any(
        os.environ.get(k)
        for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
    )
    try:  # user (or a prior entry point) already ran jax.distributed.initialize
        from jax._src import distributed as _jd

        if getattr(_jd.global_state, "client", None) is not None:
            _initialized = True
            return jax.process_count()
    except (ImportError, AttributeError):  # pragma: no cover - jax internals
        pass
    if coordinator_address or num_processes or has_cluster_env:
        try:
            from jax._src import xla_bridge

            backends_up = xla_bridge.backends_are_initialized()
        except (ImportError, AttributeError):  # pragma: no cover - jax internals
            backends_up = False
        if backends_up:
            raise RuntimeError(
                "initialize_distributed: a cluster environment is set "
                "(JAX_COORDINATOR_ADDRESS) but the XLA backends are already "
                "initialized — call initialize_distributed() before any other "
                "JAX API (jax.devices, jax.process_count, any jit)"
            )
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    _initialized = True
    return jax.process_count()


def make_mesh(n_devices: int | None = None, backend: str | None = None) -> Mesh:
    """1-D mesh over the first n available devices (CPU-simulated in tests)."""
    devices = jax.devices(backend) if backend else jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)} "
                f"({[d.platform for d in devices[:3]]}…)"
            )
        devices = devices[:n_devices]
    return Mesh(devices, (DOMAIN_AXIS,))


def make_host_chip_mesh(
    n_hosts: int | None = None,
    chips_per_host: int | None = None,
    backend: str | None = None,
) -> Mesh:
    """('host', 'chip') 2-D mesh: rows = processes, columns = that process's
    local devices, in JAX's process-major device order — so a sharding over
    the flattened ('host','chip') product puts contiguous blocks on one
    process's devices first before crossing processes.

    Single-process: hosts×chips is carved out of the local device list
    (the CPU-simulation path used by tests and the scaling bench)."""
    devices = jax.devices(backend) if backend else jax.devices()
    if jax.process_count() > 1 and n_hosts is None:
        n_hosts = jax.process_count()
    n_hosts = n_hosts or 1
    chips_per_host = chips_per_host or len(devices) // n_hosts
    need = n_hosts * chips_per_host
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.array(devices[:need]).reshape(n_hosts, chips_per_host)
    return Mesh(grid, (HOST_AXIS, CHIP_AXIS))


def domain_spec(mesh: Mesh, ndim: int = 1) -> P:
    """PartitionSpec sharding the leading (domain) axis over ALL of the
    mesh's axes — 1-D ('shards',) and 2-D ('host','chip') meshes alike."""
    return P(tuple(mesh.axis_names), *([None] * (ndim - 1)))


def mesh_size(mesh: Mesh) -> int:
    """Total device count of the mesh (all axes)."""
    out = 1
    for s in mesh.shape.values():
        out *= s
    return out


def row_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Block-shard the leading axis over ALL mesh axes, replicate the rest
    (('host','chip') meshes flatten process-major)."""
    return NamedSharding(mesh, P(tuple(mesh.axis_names), *([None] * (ndim - 1))))


def vec_sharding(mesh: Mesh) -> NamedSharding:
    return row_sharding(mesh, 1)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
