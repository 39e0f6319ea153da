"""Global configuration for the decomposition library.

The reference selects its native backend (MKL / Netlib / OpenBLAS /
Accelerate) at compile time via cargo features (ref: src/lib.rs:4-11,
Cargo.toml:28-39).  Here there is a single XLA backend; "backend
selection" becomes a runtime choice of *linalg implementation* and
*matmul precision*:

* ``linalg_backend``:
    - ``"auto"``   — per-dtype and per-placement dispatch
      (``ops/linalg.py``): on the CPU, LAPACK for f32 and the in-house
      Jacobi solvers for f64 (the 1e-10 parity band); off the CPU,
      QDWH-SVD for real SVDs and Jacobi or refined eigh for f64 eigh.
    - ``"jacobi"`` — always use the in-house Jacobi SVD / eigh.
    - ``"xla"``    — always use ``jnp.linalg`` lowerings.
    - ``"native"`` — the C++ host core (``native/``).
* ``matmul_precision``: passed to every ``jnp.dot`` in the compute path.
  ``"highest"`` keeps f32 matmuls in true f32 (a GPU's default f32 dot
  runs in TF32 and keeps about three decimal digits, far outside the
  1e-5 f32 parity band).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = ["config", "Config"]


@dataclass
class Config:
    linalg_backend: str = "auto"  # "auto" | "jacobi" | "xla" | "native"
    matmul_precision: str = "highest"
    # Max Jacobi sweeps before declaring non-convergence (LinalgError
    # analogue of LAPACK info != 0; ref: linalg.rs:84).
    jacobi_max_sweeps: int = 30
    # Check convergence and raise LinalgError on failure.  Disable inside
    # fully-jitted pipelines where host sync is undesirable.
    check_convergence: bool = True
    # "auto" backend: offload factorizations of problems at most this
    # many elements to the native host core when the active device is an
    # accelerator (tiny fits are launch-latency-bound there).  Default 0
    # (disabled): whether the offload wins on a GPU host is not
    # measured yet.
    host_offload_max_elements: int = 0
    # Complex-dtype fits/transforms on an accelerator default backend:
    # "auto" dispatches them to the host CPU device (the reference's
    # c32/c64 support runs on CPU/LAPACK); "default" leaves placement
    # alone.  Mesh fits are never redirected (an explicit device mesh
    # wins).
    complex_device: str = "auto"

    def validate(self) -> None:
        if self.linalg_backend not in ("auto", "jacobi", "xla", "native"):
            raise ValueError(f"unknown linalg backend: {self.linalg_backend}")
        if self.complex_device not in ("auto", "default"):
            raise ValueError(f"unknown complex_device: {self.complex_device}")

    def cache_key(self) -> tuple:
        """Hashable snapshot of the fields that alter traced programs.
        Jitted fit pipelines take this as a static argument so config
        changes retrace instead of silently reusing stale dispatch.
        (``check_convergence`` and ``host_offload_max_elements`` act
        outside traces — neither belongs here.)"""
        return (
            self.linalg_backend,
            self.matmul_precision,
            self.jacobi_max_sweeps,
        )


config = Config(
    linalg_backend=os.environ.get("PETAL_LINALG_BACKEND", "auto"),
)
config.validate()


def enable_x64() -> None:
    """Enable 64-bit JAX types (call before creating any arrays)."""
    import jax

    jax.config.update("jax_enable_x64", True)


if not os.environ.get("PETAL_NO_X64"):
    # The reference is an f64-first LAPACK library; mirror that default so
    # float64 numpy inputs are not silently truncated to f32.
    enable_x64()


_CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache() -> None:
    """Keep JAX's persistent compilation cache at a fixed place.

    The QDWH + refined-eigh f64 SVD route costs a long one-time XLA
    compile, and the reference's LAPACK backend has zero warm-up, so
    matching its usability means never paying a compile twice.  Where
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing; otherwise the cache is ``<checkout>/.jax_cache``.  A
    fixed path, because the path is part of the cache's key.  Runs at
    import unless ``PETAL_NO_COMPILE_CACHE`` is set.
    """
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            os.makedirs(_CHECKOUT_CACHE_DIR, exist_ok=True)
        except OSError:  # read-only install: run without a cache
            return
        jax.config.update("jax_compilation_cache_dir", _CHECKOUT_CACHE_DIR)
    # Cache every compile that costs ≥ 1 s — the tiny-probe compiles
    # stay out, every pipeline compile is captured.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


if not os.environ.get("PETAL_NO_COMPILE_CACHE"):
    enable_compilation_cache()
