"""Adversarial shape/dtype sweep across all three models.

Robustness harness, not a benchmark: fits every model on shapes that
historically broke factorizations or dispatch (rank-deficient data,
single samples/features, odd dims, wide inputs, fewer rows than mesh
devices) and asserts finite outputs.  Run on a GPU
(`python benchmarks/shape_sweep.py`): the accelerator routes (QDWH-SVD,
refined eigh, CholeskyQR2) are the ones the CPU tests do not take by
default.  Pass ``--mesh`` to sweep the sharded paths instead (any
backend; on CPU set XLA_FLAGS=--xla_force_host_platform_device_count=8).
"""

from __future__ import annotations

# Repo-root import path for source checkouts, however this file is run
# (script, package import, or runpy without package context).
import os as _os
import sys as _sys

if not any(
    _os.path.isdir(_os.path.join(p, "petal_decomposition_tpu"))
    for p in _sys.path if p
):
    _sys.path.insert(
        0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    )
del _os, _sys
import sys
import time

import numpy as np

import petal_decomposition_tpu  # noqa: F401  (enables x64 before array creation)
from petal_decomposition_tpu import (
    FastIcaBuilder,
    PcaBuilder,
    RandomizedPcaBuilder,
)

CONFIGS = [
    # (n, d, k, rank)
    (50, 7, 3, None),        # tiny
    (100_000, 8, 4, None),   # very tall narrow
    (3000, 700, 16, None),   # f64 eigh past 384 (QDWH+refine)
    (200, 2000, 8, None),    # wide (transposed SVD)
    (5000, 64, 8, 2),        # exactly rank-deficient
    (1, 5, 1, None),         # single sample (centered panel == 0)
    (13, 7, 3, None),        # odd dims (pad/mask paths)
    (1000, 1, 1, None),      # single feature
]

MESH_CONFIGS = CONFIGS[:2] + CONFIGS[4:] + [
    (5, 16, 2, None),        # fewer rows than mesh devices
]


def _data(rng, n, d, dtype, rank):
    if rank is None or rank >= min(n, d):
        return rng.standard_normal((n, d)).astype(dtype)
    return (
        rng.standard_normal((n, rank)) @ rng.standard_normal((rank, d))
    ).astype(dtype)


def main() -> int:
    use_mesh = "--mesh" in sys.argv
    mesh = None
    if not use_mesh:
        import jax

        platform = jax.devices()[0].platform
        if platform != "gpu":
            raise SystemExit(f"needs a GPU; JAX found {platform}")
    if use_mesh:
        from petal_decomposition_tpu.parallel import make_mesh

        mesh = make_mesh()
        print(f"mesh: {mesh.devices.size} devices", flush=True)

    rng = np.random.default_rng(0)
    fails = []

    def check(tag, fn):
        t0 = time.perf_counter()
        try:
            fn()
            print(f"OK   {tag} ({time.perf_counter() - t0:.1f}s)",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — harness records all
            fails.append((tag, repr(e)))
            print(f"FAIL {tag}: {e!r}", flush=True)

    configs = MESH_CONFIGS if use_mesh else CONFIGS
    for dtype in (np.float32, np.float64):
        for (n, d, k, rank) in configs:
            x = _data(rng, n, d, dtype, rank)
            tag = f"{np.dtype(dtype).name} {n}x{d} k={k} rank={rank}"

            def run_pca(x=x, k=k):
                b = PcaBuilder(k)
                p = (b.mesh(mesh) if mesh is not None else b).build()
                y = np.asarray(p.fit_transform(x))
                assert np.all(np.isfinite(y)), "pca nonfinite"
                z = np.asarray(p.inverse_transform(p.transform(x)))
                assert np.all(np.isfinite(z)), "pca roundtrip nonfinite"

            def run_rpca(x=x, k=k):
                b = RandomizedPcaBuilder(k).seed(3)
                p = (b.mesh(mesh) if mesh is not None else b).build()
                y = np.asarray(p.fit_transform(x))
                assert np.all(np.isfinite(y)), "rpca nonfinite"

            def run_ica(x=x, k=min(k, 4)):
                b = FastIcaBuilder().seed(3).n_components(k)
                m = (b.mesh(mesh) if mesh is not None else b).build()
                y = np.asarray(m.fit_transform(x))
                assert np.all(np.isfinite(y)), "ica nonfinite"

            check("pca  " + tag, run_pca)
            check("rpca " + tag, run_rpca)
            check("ica  " + tag, run_ica)

    print(f"\nFAILURES: {len(fails)}", flush=True)
    for t, e in fails:
        print(" ", t, e[:200])
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
