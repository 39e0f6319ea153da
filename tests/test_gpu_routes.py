"""The routes a GPU placement takes, exercised on the CPU.

``ops.linalg.effective_platform`` is the one switch every route choice
reads; patching it to ``"gpu"`` makes the CPU run the branches the card
runs (QDWH-SVD, refined eigh, the Gram finder with fused centering and
CholeskyQR2), which are then checked against numpy.  Shapes here are
used by no other test, so no jit cache entry traced on the CPU route
can stand in for them.
"""

import numpy as np
import pytest
import jax

from petal_decomposition_tpu import Pca, RandomizedPca
from petal_decomposition_tpu.models import pca as pca_mod
from petal_decomposition_tpu.ops import linalg as lin
from petal_decomposition_tpu.ops.jacobi import jacobi_svd, svd_route


@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(lin, "effective_platform", lambda: "gpu")


def _matrix(m, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)).astype(dtype)


def _svd_errs(u, s, vt, a):
    a64 = np.asarray(a, np.float64)
    s_ref = np.linalg.svd(a64, compute_uv=False)
    u, s, vt = (np.asarray(t, np.float64) for t in (u, s, vt))
    k = len(s_ref)
    rec = np.abs((u * s) @ vt - a64).max() / s_ref[0]
    sig = np.abs(s[:k] - s_ref).max() / s_ref[0]
    orth = np.abs(u[:, :k].T @ u[:, :k] - np.eye(k)).max()
    return rec, sig, orth


# Shapes that a retired single-block Jacobi kernel used to serve.
@pytest.mark.parametrize(
    "dtype,tol", [(np.float32, 2e-5), (np.float64, 1e-11)]
)
@pytest.mark.parametrize("shape", [(50, 8), (33, 7), (64, 64), (9, 30)])
def test_jacobi_svd_gpu_route(on_gpu, dtype, tol, shape):
    a = _matrix(*shape, dtype)
    assert svd_route(dtype, max(shape), min(shape)) == "qdwh"
    u, s, vt, off, _ = jacobi_svd(jax.numpy.asarray(a))
    assert float(off) == 0.0  # QDWH certificate: converged
    rec, sig, orth = _svd_errs(u, s, vt, a)
    assert max(rec, sig, orth) < tol


@pytest.mark.parametrize(
    "dtype,tol", [(np.float32, 2e-5), (np.float64, 1e-11)]
)
def test_svd_jit_cert_gpu_route(on_gpu, dtype, tol):
    a = _matrix(300, 41, dtype, seed=1)
    assert lin.svd_branch(dtype, 300, 41) == "qdwh"
    u, s, vt, off = jax.jit(lin.svd_jit_cert)(a)
    lin.check_certificate(off, np.dtype(dtype), 300, "svd")
    assert max(_svd_errs(u, s, vt, a)) < tol


@pytest.mark.parametrize(
    "dtype,n,route,tol",
    [
        (np.float32, 40, "xla", 1e-5),
        (np.float64, 40, "jacobi", 1e-12),
        (np.float64, 390, "refined", 1e-11),
    ],
)
def test_eigh_psd_jit_cert_gpu_route(on_gpu, dtype, n, route, tol):
    b = _matrix(2 * n, n, np.float64, seed=2)
    a = (b.T @ b).astype(dtype)  # PSD
    assert lin.eigh_route(dtype, n) == route
    w, v, off = jax.jit(lin.eigh_psd_jit_cert)(a)
    lin.check_certificate(off, np.dtype(dtype), n, "eigh")
    w_ref = np.linalg.eigvalsh(np.asarray(a, np.float64))
    w, v = np.asarray(w, np.float64), np.asarray(v, np.float64)
    assert np.abs(w - w_ref).max() / w_ref[-1] < tol
    resid = np.asarray(a, np.float64) @ v - v * w
    assert np.abs(resid).max() / w_ref[-1] < 10 * tol


def test_routes_by_platform(monkeypatch):
    """The CPU keeps LAPACK and the in-house f64 Jacobi; off the CPU,
    real SVDs take QDWH and large f64 eigh the refined route."""
    assert lin.svd_branch(np.float32, 100, 10) == "xla"
    assert lin.svd_branch(np.float64, 100, 10) == "jacobi"
    assert lin.svd_branch(np.float64, 4096, 512) == "qr+jacobi"
    assert lin.eigh_route(np.float64, 1000) == "jacobi"
    assert lin.eigh_route(np.float32, 1000) == "xla"
    monkeypatch.setattr(lin, "effective_platform", lambda: "gpu")
    assert lin.svd_branch(np.float32, 100, 10) == "qdwh"
    assert lin.svd_branch(np.complex64, 100, 10) == "jacobi"
    assert lin.eigh_route(np.float64, 385) == "refined"
    assert lin.eigh_route(np.float64, 384) == "jacobi"
    assert lin.eigh_route(np.complex128, 10) == "jacobi"


def _old_auto_prefers_gram(n, d):
    """The shape gate as the retired kernel's ``supports()`` spelled it
    (f32 off the CPU)."""
    def supports(m, k):
        if k < 2:
            return False
        k_pad = k + (k % 2)
        if m * max(k_pad, 128) > 400_000:
            return False
        return (3 * m * k_pad + 3 * k_pad * k_pad) * 4 <= 10 * 1024 * 1024

    if supports(n, d) or supports(d + (d % 2), d):
        return False
    return n >= 8 * d


@pytest.mark.parametrize(
    "shape,want",
    [
        ((8 * 632, 632), False),  # widest direct-SVD width
        ((8 * 633, 633), True),
        ((8 * 633 - 1, 633), False),  # not tall enough
        ((8, 1), True),  # a single column
        ((1_000_000, 4096), True),
        ((100_000, 256), False),
    ],
)
def test_auto_prefers_gram_bound(on_gpu, shape, want):
    x = jax.ShapeDtypeStruct(shape, np.float32)
    assert Pca._auto_prefers_gram(x) is want
    assert pca_mod._DIRECT_SVD_MAX_D == 632


def test_auto_prefers_gram_matches_retired_gate(on_gpu):
    for d in list(range(1, 40)) + list(range(600, 700)) + [1024, 4096]:
        for n in (d, 8 * d - 1, 8 * d, 700, 5000, 10**6):
            x = jax.ShapeDtypeStruct((n, d), np.float32)
            assert Pca._auto_prefers_gram(x) == _old_auto_prefers_gram(n, d)
    # Never off f32, never on the CPU.
    assert not Pca._auto_prefers_gram(
        jax.ShapeDtypeStruct((10**6, 4096), np.float64)
    )


def test_auto_prefers_gram_cpu():
    x = jax.ShapeDtypeStruct((10**6, 4096), np.float32)
    assert not Pca._auto_prefers_gram(x)


def test_randomized_fit_accelerator_route(monkeypatch):
    """At a size that takes the accelerator route (fused centering, the
    Gram finder, CholeskyQR2) the fit matches the CPU route's."""
    from petal_decomposition_tpu.parallel.distributed import (
        resolve_fit_routes,
    )

    rng = np.random.default_rng(5)
    n, d = 40_003, 128
    x = (rng.standard_normal((n, d)) * np.linspace(10, 0.1, d) + 0.3)
    x = x.astype(np.float32)
    cpu = RandomizedPca(8, seed=21).fit(x)
    monkeypatch.setattr(lin, "effective_platform", lambda: "gpu")
    routes = resolve_fit_routes(np.float32, n, d, 18)
    assert routes["range_finder"] == "gram"
    assert routes["gram_precision"] == "default"
    m = RandomizedPca(8, seed=21)
    assert m._resolve_normalizer(x) == "cholqr2"
    m.fit(x)
    s_cpu = np.asarray(cpu.singular_values_, np.float64)
    s_gpu = np.asarray(m.singular_values_, np.float64)
    assert np.abs(s_gpu - s_cpu).max() / s_cpu[0] < 1e-5
    cos = np.abs(np.sum(np.asarray(m.components_, np.float64)
                        * np.asarray(cpu.components_, np.float64), axis=1))
    np.testing.assert_allclose(cos, 1.0, atol=1e-4)


@pytest.mark.gpu
def test_routes_on_card(gpu_device):
    """On a real card the platform switch reads "gpu" and the real SVD
    route is QDWH."""
    del gpu_device
    assert lin.effective_platform() == "gpu"
    assert lin.svd_branch(np.float32, 1000, 64) == "qdwh"
    a = _matrix(2000, 64, np.float32, seed=3)
    u, s, vt = lin.svd(a)
    assert max(_svd_errs(u, s, vt, a)) < 2e-5
