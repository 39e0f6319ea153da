"""Profiling and per-fit observability.

The reference has no tracing/metrics at all (SURVEY §5: no logging or
timing anywhere; only the private ``FastIca.n_iter``).  The
equivalents here:

* :func:`trace` — context manager around ``jax.profiler`` emitting a
  Perfetto-compatible trace; every distributed fit phase is annotated
  with ``jax.named_scope`` so sketch / power-iter / qr / svd / ica-iter
  show up as named spans.
* ``FitStats`` — wall-clock + algorithm counters recorded on every
  model fit (exposed as ``model.last_fit_stats_``).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax

__all__ = ["trace", "FitStats", "record_fit"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace viewable in Perfetto/TensorBoard.

    >>> import tempfile, os, jax.numpy as jnp
    >>> with tempfile.TemporaryDirectory() as d:
    ...     with trace(d):
    ...         _ = (jnp.ones((8, 8)) @ jnp.ones((8, 8))).block_until_ready()
    ...     wrote = any(f for _, _, fs in os.walk(d) for f in fs)
    >>> wrote
    True
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class FitStats:
    """Metrics from the most recent fit (SURVEY §5 metrics row)."""

    wall_time_s: float = 0.0
    n_samples: int = 0
    n_features: int = 0
    n_iter: int | None = None  # FastICA iterations
    extra: dict = field(default_factory=dict)


@contextlib.contextmanager
def record_fit(model, n: int, d: int):
    """Time a fit and attach ``last_fit_stats_`` to the model.

    >>> class M: pass
    >>> m = M()
    >>> with record_fit(m, n=100, d=8) as stats:
    ...     stats.extra["note"] = "work happens here"
    >>> m.last_fit_stats_.n_samples, m.last_fit_stats_.n_features
    (100, 8)
    >>> m.last_fit_stats_.wall_time_s > 0
    True
    """
    t0 = time.perf_counter()
    stats = FitStats(n_samples=n, n_features=d)
    try:
        yield stats
    finally:
        stats.wall_time_s = time.perf_counter() - t0
        model.last_fit_stats_ = stats
