"""Row-sharded fits over device meshes (SURVEY §2.3's distributed design)."""

from .distributed import fast_ica_fit, pca_fit_gram, randomized_pca_fit
from .mesh import (
    ROWS,
    make_mesh,
    replicated_sharding,
    row_sharding,
    shard_rows,
)

__all__ = [
    "make_mesh",
    "shard_rows",
    "row_sharding",
    "replicated_sharding",
    "ROWS",
    "pca_fit_gram",
    "randomized_pca_fit",
    "fast_ica_fit",
]
