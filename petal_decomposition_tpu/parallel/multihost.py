"""Multi-host initialization helpers.

A mesh can span the devices of several hosts: each host runs the same
program, calls :func:`initialize` once before any jax use, and builds
the mesh from ``jax.devices()`` (which then lists the global device
set).  Collectives ride the intra-host links within a host and the
network across hosts — still with no code changes to the fit
pipelines, which only see sharding annotations.

The reference has no distributed analogue at all (SURVEY §2.3); the
restart story here is the serialization contract: a fit is one-shot, so
recovery = reload the last saved model (``save``/``load``) and re-run —
matching SURVEY §5's "restartable from serialized model state".
"""

from __future__ import annotations

import jax

__all__ = ["initialize", "is_multihost", "process_index"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize the JAX distributed runtime (idempotent wrapper over
    ``jax.distributed.initialize``).

    Error contract (round-2 review: a swallowed init failure makes a
    misconfigured coordinator indistinguishable from a single-process
    no-op):

    * "already initialized" → no-op (idempotence);
    * auto-detection mode (no arguments) finding no cluster → no-op
      (single-process is a valid configuration);
    * any failure with EXPLICIT arguments → re-raised: the caller asked
      for a cluster and did not get one.

    >>> from petal_decomposition_tpu.parallel import multihost
    >>> multihost.initialize()  # auto mode, no cluster: a no-op
    >>> multihost.is_multihost()
    False
    >>> multihost.process_index()
    0
    """
    explicit = any(
        a is not None
        for a in (coordinator_address, num_processes, process_id)
    )
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already initialized" in str(e).lower():
            return
        if explicit:
            raise
        # Auto mode: backends already up / no cluster — single process.
    except ValueError:
        if explicit:
            raise
        # Auto-detection found no cluster environment: single process.


def is_multihost() -> bool:
    """True when this process is part of a >1-process cluster (example
    under :func:`initialize`)."""
    return jax.process_count() > 1


def process_index() -> int:
    """This process's index in the cluster, 0 single-process (example
    under :func:`initialize`)."""
    return jax.process_index()
