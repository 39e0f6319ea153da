"""Sharded-vs-single-device equivalence on an 8-virtual-device CPU mesh.

The analogue of the reference's exact-vs-randomized equivalence
tests (SURVEY §4): a row-sharded fit must produce the same user-visible
outputs as the unsharded fit.
"""

import jax
import numpy as np
import pytest

from petal_decomposition_tpu import (
    FastIcaBuilder,
    Pca,
    PcaBuilder,
    RandomizedPcaBuilder,
)
from petal_decomposition_tpu.parallel import make_mesh, shard_rows

RNG_SEED = 1_234_567_891_011_121_314


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(8)


def test_mesh_has_eight_devices(mesh):
    assert mesh.devices.size == 8


def test_shard_rows_places_on_mesh(mesh):
    x = np.arange(64.0).reshape(16, 4)
    xs = shard_rows(x, mesh)
    assert len(xs.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(xs), x)


def test_pca_gram_sharded_matches_full_svd(mesh):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 24))

    ref = Pca(5).fit(x)
    sharded = PcaBuilder(5).mesh(mesh).build().fit(x)

    np.testing.assert_allclose(
        np.asarray(sharded.singular_values()),
        np.asarray(ref.singular_values()),
        rtol=1e-9,
    )
    # svd_flip makes signs deterministic → components must match exactly
    # (up to gram-path conditioning).
    np.testing.assert_allclose(
        np.asarray(sharded.components()),
        np.asarray(ref.components()),
        atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(sharded.explained_variance_ratio()),
        np.asarray(ref.explained_variance_ratio()),
        rtol=1e-9,
    )
    y_ref = np.asarray(ref.transform(x))
    y_sh = np.asarray(sharded.transform(x))
    np.testing.assert_allclose(y_sh, y_ref, atol=1e-7)


def test_pca_gram_fit_transform_matches(mesh):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((128, 16))
    y_sh = np.asarray(PcaBuilder(4).mesh(mesh).build().fit_transform(x))
    y_ref = np.asarray(Pca(4).fit_transform(x))
    np.testing.assert_allclose(y_sh, y_ref, atol=1e-7)


def test_pca_gram_solver_single_device_matches():
    """gram solver without a mesh: same algorithm, one device."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((100, 12))
    y_g = np.asarray(Pca(3, solver="gram").fit_transform(x))
    y_f = np.asarray(Pca(3, solver="full").fit_transform(x))
    np.testing.assert_allclose(y_g, y_f, atol=1e-8)


def test_randomized_pca_sharded_matches_unsharded(mesh):
    """Same key + cholqr2 normalizer on both paths → same results to
    numerical noise."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((512, 40))

    ref = (
        RandomizedPcaBuilder(6)
        .seed(RNG_SEED)
        .power_iteration_normalizer("cholqr2")
        .build()
    )
    ref.fit(x)
    sh = RandomizedPcaBuilder(6).seed(RNG_SEED).mesh(mesh).build()
    sh.fit(x)

    np.testing.assert_allclose(
        np.asarray(sh.singular_values()),
        np.asarray(ref.singular_values()),
        rtol=1e-8,
    )
    np.testing.assert_allclose(
        np.asarray(sh.components()),
        np.asarray(ref.components()),
        atol=1e-7,
    )


def test_randomized_pca_sharded_vs_exact_spectrum(mesh):
    """Sharded randomized fit recovers the exact top spectrum (the
    pca.rs:989-1027 equivalence pattern, on the mesh)."""
    rng = np.random.default_rng(4)
    u = rng.standard_normal((1024, 6))
    v = rng.standard_normal((6, 64))
    x = u @ np.diag([50, 40, 30, 20, 10, 5.0]) @ v
    x += 0.01 * rng.standard_normal(x.shape)

    sh = RandomizedPcaBuilder(6).seed(RNG_SEED).mesh(mesh).build().fit(x)
    exact = Pca(6).fit(x)
    np.testing.assert_allclose(
        np.asarray(sh.singular_values()),
        np.asarray(exact.singular_values()),
        rtol=1e-5,
    )


def test_fast_ica_sharded_recovers_sources(mesh):
    rng = np.random.default_rng(5)
    n = 4096
    s = np.stack(
        [rng.uniform(-1, 1, n), np.sign(rng.standard_normal(n))], axis=1
    )
    x = s @ np.array([[1.0, 0.5], [0.3, 1.0]])

    ica = FastIcaBuilder().seed(RNG_SEED).mesh(mesh).build()
    y = np.asarray(ica.fit_transform(x))
    corr = np.abs(np.corrcoef(y.T, s.T)[:2, 2:])
    assert np.all(corr.max(axis=1) > 0.95)
    assert ica.n_iter_ >= 1


def test_fast_ica_sharded_ns_decorrelation_matches_unsharded(mesh):
    """NS decorrelation inside the sharded pipeline (what
    ``decorrelation="auto"`` picks on accelerator meshes) — pure
    replicated k×k matmuls, so sharded ≡ unsharded on convergent
    sources."""
    rng = np.random.default_rng(8)
    n = 2048
    s = np.stack(
        [rng.uniform(-1, 1, n), np.sign(rng.standard_normal(n))], axis=1
    )
    x = s @ np.array([[1.0, 0.5], [0.3, 1.0]])

    ref = FastIcaBuilder().seed(RNG_SEED).decorrelation("ns").build()
    ref.fit(x)
    sh = (
        FastIcaBuilder().seed(RNG_SEED).decorrelation("ns").mesh(mesh)
        .build()
    )
    sh.fit(x)
    c1, c2 = np.asarray(ref.components()), np.asarray(sh.components())
    # Per-row sign alignment: the unsharded fit whitens via SVD, the
    # sharded pipeline via Gram/eigh — their sign conventions differ by
    # backend (observed under PETAL_LINALG_BACKEND=xla), and ICA
    # components are sign-indeterminate by nature.
    signs = np.sign(np.sum(c1 * c2, axis=1))[:, None]
    assert np.max(np.abs(c1 - c2 * signs)) < 1e-6


def test_fast_ica_sharded_matches_eigh_whitening_unsharded(mesh):
    """Mesh fit ≡ single-device fit with the same key and eigh whitening.

    Uses a convergent mixture (true independent sources): on
    non-convergent data the FastICA map is chaotic and any bitwise
    path difference between sharded/unsharded matmul orders amplifies
    arbitrarily — there is no fixed point to agree on.
    """
    rng = np.random.default_rng(6)
    n = 2048
    s = np.stack(
        [rng.uniform(-1, 1, n), np.sign(rng.standard_normal(n))], axis=1
    )
    x = s @ np.array([[1.0, 0.5], [0.3, 1.0]])

    ref = FastIcaBuilder().seed(RNG_SEED).whiten_solver("eigh").build()
    ref.fit(x)
    sh = FastIcaBuilder().seed(RNG_SEED).mesh(mesh).build()
    sh.fit(x)

    assert ref.n_iter_ == sh.n_iter_
    np.testing.assert_allclose(
        np.asarray(sh.components()),
        np.asarray(ref.components()),
        atol=1e-7,
    )


def test_uneven_rows_shard(mesh):
    """Row counts not divisible by the mesh size must still work."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((101, 12))
    y_sh = np.asarray(PcaBuilder(3).mesh(mesh).build().fit_transform(x))
    y_ref = np.asarray(Pca(3).fit_transform(x))
    np.testing.assert_allclose(y_sh, y_ref, atol=1e-7)


def test_pca_full_solver_mesh_matches_unsharded(mesh):
    """mesh + solver='full': padded rows must not pollute means, the
    SVD, or the fit_transform output length (round-1 advisor finding)."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((101, 12))  # 101 % 8 != 0 → zero-padding

    ref = Pca(3).fit(x)
    sharded = PcaBuilder(3).mesh(mesh).solver("full").build()
    y_sh = np.asarray(sharded.fit_transform(x))
    assert y_sh.shape == (101, 3)

    np.testing.assert_allclose(
        np.asarray(sharded.mean()), np.asarray(ref.mean()), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(sharded.singular_values()),
        np.asarray(ref.singular_values()),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(sharded.components()),
        np.asarray(ref.components()),
        atol=1e-9,
    )
    np.testing.assert_allclose(
        y_sh, np.asarray(ref.fit_transform(x)), atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(sharded.explained_variance_ratio()),
        np.asarray(ref.explained_variance_ratio()),
        rtol=1e-10,
    )


def test_pca_full_solver_mesh_without_centering(mesh):
    rng = np.random.default_rng(19)
    x = rng.standard_normal((50, 8)) + 1.0  # uneven over 8 devices? 50%8=2
    ref = PcaBuilder(2).centering(False).build().fit(x)
    sh = (
        PcaBuilder(2).centering(False).mesh(mesh).solver("full").build()
    ).fit(x)
    np.testing.assert_allclose(
        np.asarray(sh.singular_values()),
        np.asarray(ref.singular_values()),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(sh.components()), np.asarray(ref.components()), atol=1e-9
    )


def test_fast_ica_sharded_mixed_precision_matches_unsharded(mesh):
    """Mixed-precision (f32 iterate + f64 polish) mesh fit converges to
    the same f64 fixed point as the single-device mixed fit: the f32
    stage's psum reassociation may wiggle the trajectory by ~eps_f32,
    but the f64 polish contracts both onto the same attractor."""
    rng = np.random.default_rng(6)
    n = 2048
    s = np.stack(
        [rng.uniform(-1, 1, n), np.sign(rng.standard_normal(n))], axis=1
    )
    x = s @ np.array([[1.0, 0.5], [0.3, 1.0]])

    ref = (
        FastIcaBuilder().seed(RNG_SEED).whiten_solver("eigh")
        .tol(1e-10).iteration_precision("f32").build()
    )
    ref.fit(x)
    sh = (
        FastIcaBuilder().seed(RNG_SEED).mesh(mesh)
        .tol(1e-10).iteration_precision("f32").build()
    )
    sh.fit(x)
    assert 1 <= sh.n_iter_ <= 200
    np.testing.assert_allclose(
        np.asarray(sh.components()),
        np.asarray(ref.components()),
        atol=1e-7,
    )


def test_mesh_model_complex_transform_not_redirected(mesh):
    """transform/inverse_transform on a mesh-fitted model must not
    redirect complex inputs to the host (the fitted state lives on the
    mesh; review finding: cross-device jit error on accelerators)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((64, 6))
    pca = PcaBuilder(2).mesh(mesh).build()
    pca.fit(x)
    z = rng.standard_normal((5, 6)) + 1j * rng.standard_normal((5, 6))
    y = np.asarray(pca.transform(z))
    ref = (z - np.asarray(pca.mean())) @ np.asarray(pca.components()).conj().T
    np.testing.assert_allclose(y, ref, atol=1e-10)
    back = np.asarray(pca.inverse_transform(y))
    assert back.shape == z.shape and np.all(np.isfinite(back.real))
