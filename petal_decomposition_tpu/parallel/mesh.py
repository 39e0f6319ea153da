"""Device-mesh helpers for row-sharded fits.

The reference is strictly single-threaded, single-host (SURVEY §2.3: no
threads, no comm crates, sequential MKL).  Its scaling analogue here is
the one parallelism axis that applies to decomposition: shard the n×d
data matrix row-wise (samples) across a 1-D device mesh.  Every
sample-axis contraction (mean, Gram XᵀX, sketch XᵀΩ, projection QᵀX,
ICA's G·Xᵀ) then compiles to a local matmul plus one ``psum`` over the
interconnect (NCCL on GPUs) — inserted automatically by GSPMD from the
sharding annotations; no hand-written collectives.  The mesh is 1-D:
every card reaches every other at the same rate.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "row_sharding",
    "replicated_sharding",
    "shard_rows",
    "ROWS",
]

ROWS = "rows"


def make_mesh(n_devices: int | None = None, *, axis_name: str = ROWS,
              devices=None) -> Mesh:
    """A 1-D mesh over ``n_devices`` (default: all available devices).

    >>> from petal_decomposition_tpu.parallel import make_mesh
    >>> mesh = make_mesh(1)
    >>> mesh.axis_names, mesh.size
    (('rows',), 1)
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def row_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Shard the leading (sample) axis; replicate the rest."""
    axis = mesh.axis_names[0]
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_rows(x, mesh: Mesh):
    """Place ``x`` row-sharded on the mesh.  Requires the row count to be
    divisible by the mesh size; use :func:`shard_rows_padded` otherwise.

    On a mesh spanning multiple processes (multi-host), ``x`` must be
    the full global value on every process (host memory); each process
    contributes the rows its local devices own.

    >>> import numpy as np
    >>> from petal_decomposition_tpu.parallel import make_mesh, shard_rows
    >>> x = shard_rows(np.zeros((4, 3)), make_mesh(1))
    >>> x.shape, x.sharding.spec
    ((4, 3), PartitionSpec('rows', None))
    """
    sharding = row_sharding(mesh, np.ndim(x))
    if jax.process_count() > 1 and not sharding.is_fully_addressable:
        # A device-committed local array cannot be resharded across
        # processes; ship the host value and let each process slice out
        # its addressable shards.
        return jax.device_put(np.asarray(x), sharding)
    return jax.device_put(x, sharding)


def shard_rows_padded(x, mesh: Mesh):
    """Row-shard ``x``, zero-padding the sample axis up to a multiple of
    the mesh size.  Returns ``(sharded, n_valid)``; the distributed fit
    kernels mask the padded rows out of every reduction.

    >>> import numpy as np
    >>> from petal_decomposition_tpu.parallel.mesh import (
    ...     make_mesh, shard_rows_padded)
    >>> xs, n_valid = shard_rows_padded(np.ones((5, 2)), make_mesh(1))
    >>> xs.shape, n_valid  # mesh of 1: no padding needed
    ((5, 2), 5)
    """
    import jax.numpy as jnp

    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    multiprocess = jax.process_count() > 1
    xp = np if multiprocess else jnp  # keep host data host-side (see
    # shard_rows): a jnp.concatenate would commit to one local device
    if multiprocess:
        x = np.asarray(x)
    else:
        x = jnp.asarray(x)
    n = x.shape[0]
    pad = (-n) % n_dev
    if pad:
        x = xp.concatenate(
            [x, xp.zeros((pad,) + x.shape[1:], x.dtype)], axis=0
        )
    return shard_rows(x, mesh), n
