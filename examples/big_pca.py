"""Example: large-scale randomized PCA on an accelerator.

Everything here is the DEFAULT dispatch — ``RandomizedPca(k).fit(x)``
picks, off the CPU, the Gram-accelerated range finder with fused
centering, exact Rayleigh–Ritz recovery against the data, and
matmul-only CholeskyQR2, while CPU runs keep the reference-faithful
direct Halko pipeline (pca.rs:665-718).

Run:  python examples/big_pca.py                        (a GPU)
      JAX_PLATFORMS=cpu python examples/big_pca.py      (reduced size)
"""

import os
import tempfile
import time

import numpy as np

import petal_decomposition_tpu  # noqa: F401  (x64 + cache config at import)
import jax

from petal_decomposition_tpu import RandomizedPca, RandomizedPcaBuilder, save, load
from petal_decomposition_tpu.parallel import make_mesh

on_cpu = jax.default_backend() == "cpu"
n, d, k = (200_000, 512, 16) if not on_cpu else (30_000, 256, 8)

rng = np.random.default_rng(0)
x = (rng.standard_normal((n, d)) @ np.diag(np.linspace(1, 8, d))).astype(
    np.float32
)
print(f"data: {n}x{d} f32 ({x.nbytes / 1e9:.2f} GB), k={k}")

# --- single device, default dispatch ---------------------------------
pca = RandomizedPca(k, seed=1_234_567_891_011_121_314)
pca.fit(x)  # first call pays the compile
t0 = time.perf_counter()
pca = RandomizedPca(k, seed=1_234_567_891_011_121_314)
pca.fit(x)
dt = time.perf_counter() - t0
print(f"fit: {dt * 1e3:.1f} ms (compiled)")
print("sigma head:", np.asarray(pca.singular_values_)[:4])
print("explained variance ratio:",
      np.round(np.asarray(pca.explained_variance_ratio()), 4)[:4])
print("fit stats:", pca.last_fit_stats_)

# --- the same fit, row-sharded over every local device ---------------
mesh = make_mesh()  # 1-D mesh over all local devices
sharded = RandomizedPcaBuilder(k).seed(1_234_567_891_011_121_314).mesh(
    mesh
).build()
sharded.fit(x)
s1 = np.asarray(pca.singular_values_)
s2 = np.asarray(sharded.singular_values_)
print(f"mesh({mesh.size} device(s)): sigma rel diff vs single device:",
      float(np.max(np.abs(s1 - s2) / s1)))

# --- out of core: the same fit from a stream of row blocks -----------
# fit_batched never holds more than a few blocks on device;
# an np.memmap input would stream from disk the same way.
streamed = RandomizedPca(k, seed=1_234_567_891_011_121_314)
streamed.fit_batched(
    (x[i : i + 16_384] for i in range(0, n, 16_384)), block_rows=32_768
)
s3 = np.asarray(streamed.singular_values_)
print("streamed (out-of-core) sigma rel diff vs in-core:",
      float(np.max(np.abs(s1 - s3) / s1)),
      "| blocks:", streamed.last_fit_stats_.extra["streamed_blocks"])

# --- persistence: a restored model transforms identically ------------
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "big_pca.npz")
    save(pca, path)
    restored = load(path)
y0 = np.asarray(pca.transform(x[:128]))
y1 = np.asarray(restored.transform(x[:128]))
print("save/load transform max |delta|:", float(np.max(np.abs(y0 - y1))))
