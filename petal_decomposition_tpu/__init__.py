"""petal-decomposition-tpu: matrix decomposition in JAX.

A ground-up rebuild of the ``petal-decomposition`` Rust crate
(exact-SVD PCA, Halko randomized-SVD PCA, parallel FastICA) for JAX on
CPUs and NVIDIA GPUs: in-house QDWH and Jacobi factorizations stand in
for LAPACK where XLA's built-ins miss the reference's accuracy, XLA
collectives replace nothing (the reference is single-threaded) but
enable row-sharded fits over device meshes, and every fit is a pure
jittable function.

Public API mirrors the reference's (ref: src/lib.rs:17-18):

>>> from petal_decomposition_tpu import (
...     Pca, PcaBuilder,
...     RandomizedPca, RandomizedPcaBuilder,
...     FastIca, FastIcaBuilder,
...     DecompositionError,
... )
"""

from . import config as _config_module  # noqa: F401 — applies x64 default
from .config import config
from .errors import DecompositionError, InvalidInput, LinalgError
from .models.fast_ica import FastIca, FastIcaBuilder
from .models.pca import Pca, PcaBuilder
from .models.randomized_pca import RandomizedPca, RandomizedPcaBuilder
from .utils.serialize import load, save

__all__ = [
    "Pca",
    "PcaBuilder",
    "RandomizedPca",
    "RandomizedPcaBuilder",
    "FastIca",
    "FastIcaBuilder",
    "DecompositionError",
    "InvalidInput",
    "LinalgError",
    "config",
    "save",
    "load",
]

__version__ = "0.5.0"
