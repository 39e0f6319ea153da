"""RandomizedPca tests — ports of the reference's tests (pca.rs:949-1041)."""

import jax.numpy as jnp
import numpy as np
import pytest

from petal_decomposition_tpu import (
    InvalidInput,
    Pca,
    RandomizedPca,
    RandomizedPcaBuilder,
)

RNG_SEED = 1_234_567_891_011_121_314  # ref: pca.rs:860


def test_randomized_pca_golden():
    """ref: pca.rs:950-970 — collinear matrix projects to ±5/0."""
    x = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]])
    pca = RandomizedPca.with_seed(1, RNG_SEED)
    assert pca.n_components() == 1

    pca.fit(x)
    y = np.asarray(pca.transform(x))
    assert abs(abs(y[0, 0]) - 5.0) < 1e-10
    assert abs(y[1, 0]) < 1e-10
    assert abs(abs(y[2, 0]) - 5.0) < 1e-10
    z = np.asarray(pca.inverse_transform(y))
    assert np.abs(z - x).max() < 1e-10

    pca = RandomizedPca(1)  # random seed
    y = np.asarray(pca.fit_transform(x))
    assert abs(abs(y[0, 0]) - 5.0) < 1e-10
    assert abs(y[1, 0]) < 1e-10
    assert abs(abs(y[2, 0]) - 5.0) < 1e-10


def test_randomized_pca_explained_variance_ratio():
    """ref: pca.rs:973-987."""
    x = np.array(
        [
            [-1.0, -1.0],
            [-2.0, -1.0],
            [-3.0, -2.0],
            [1.0, 1.0],
            [2.0, 1.0],
            [3.0, 2.0],
        ]
    )
    pca = RandomizedPca(2)
    pca.fit(x)
    ratio = np.asarray(pca.explained_variance_ratio())
    assert ratio[0] > 0.99244
    assert ratio[1] < 0.00756


def test_randomized_vs_exact_equivalence():
    """ref: pca.rs:989-1027 — 5% relative agreement on 100×80 Gaussian."""
    rng = np.random.default_rng(RNG_SEED % 2**63)
    x = rng.standard_normal((100, 80))

    pca = Pca(2)
    pca_rand = RandomizedPca.with_seed(2, RNG_SEED)
    pca.fit(x)
    pca_rand.fit(x)

    r_exact = np.asarray(pca.explained_variance_ratio())
    r_rand = np.asarray(pca_rand.explained_variance_ratio())
    np.testing.assert_allclose(r_rand, r_exact, rtol=0.05)

    s_exact = np.asarray(pca.singular_values())
    s_rand = np.asarray(pca_rand.singular_values())
    np.testing.assert_allclose(s_rand, s_exact, rtol=0.05)


@pytest.mark.parametrize("normalizer", ["lu", "qr", "cholqr2", "none"])
def test_power_iteration_normalizers(normalizer):
    """All normalizers recover a low-rank spectrum accurately."""
    rng = np.random.default_rng(9)
    # Low-rank + noise: randomized SVD should nail the top singular values
    u = rng.standard_normal((300, 4))
    v = rng.standard_normal((4, 50))
    x = u @ np.diag([100.0, 50.0, 20.0, 10.0]) @ v[:4]
    x += 0.01 * rng.standard_normal(x.shape)

    n_iters = 7 if normalizer != "none" else 2  # unnormalized overflows
    pca = RandomizedPcaBuilder(4).seed(RNG_SEED).power_iteration_normalizer(
        normalizer
    ).n_power_iters(n_iters).build()
    pca.fit(x)
    exact = Pca(4).fit(x)
    np.testing.assert_allclose(
        np.asarray(pca.singular_values()),
        np.asarray(exact.singular_values()),
        rtol=1e-6,
    )


def test_randomized_pca_deterministic_given_seed():
    x = np.random.default_rng(0).standard_normal((40, 20))
    y1 = np.asarray(RandomizedPca.with_seed(3, RNG_SEED).fit_transform(x))
    y2 = np.asarray(RandomizedPca.with_seed(3, RNG_SEED).fit_transform(x))
    np.testing.assert_array_equal(y1, y2)


def test_randomized_pca_successive_fits_advance_stream():
    """The RNG is stateful across fits, like the reference's PCG."""
    x = np.random.default_rng(0).standard_normal((40, 20))
    import jax

    pca = RandomizedPca.with_seed(3, RNG_SEED)
    pca.fit(x)
    k1 = np.asarray(jax.random.key_data(pca._key))
    pca.fit(x)
    k2 = np.asarray(jax.random.key_data(pca._key))
    assert not np.array_equal(k1, k2)


def test_randomized_pca_fit_transform_equals_fit_then_transform():
    x = np.random.default_rng(5).standard_normal((60, 12))
    pca1 = RandomizedPca.with_seed(4, RNG_SEED)
    y1 = np.asarray(pca1.fit_transform(x))
    pca2 = RandomizedPca.with_seed(4, RNG_SEED)
    pca2.fit(x)
    y2 = np.asarray(pca2.transform(x))
    assert np.abs(y1 - y2).max() < 1e-9


def test_randomized_pca_invalid_dims():
    with pytest.raises(InvalidInput):
        RandomizedPca(5).fit(np.zeros((3, 3)))


def test_randomized_pca_oversample_exceeds_dims():
    """k + 10 > min(m, n): oversampling must cap gracefully, like the
    reference's LU/QR shape flow (pca.rs:707-716)."""
    x = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]])
    pca = RandomizedPca.with_seed(2, RNG_SEED)
    pca.fit(x)
    assert np.asarray(pca.singular_values()).shape == (2,)


def test_randomized_pca_without_centering():
    x = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]])
    pca = RandomizedPcaBuilder(1).seed(RNG_SEED).centering(False).build()
    y = np.asarray(pca.fit_transform(x))
    assert abs(abs(y[0, 0]) - 0.0) < 1e-10
    assert abs(abs(y[1, 0]) - 5.0) < 1e-10
    assert abs(abs(y[2, 0]) - 10.0) < 1e-10


def test_randomized_pca_complex():
    """Complex support end-to-end (the reference is generic over c32/c64)."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((60, 12)) + 1j * rng.standard_normal((60, 12))
    pca = RandomizedPca.with_seed(3, RNG_SEED)
    y = np.asarray(pca.fit_transform(x))
    assert y.shape == (60, 3)
    assert np.all(np.isfinite(y))
    # fit+transform consistency
    pca2 = RandomizedPca.with_seed(3, RNG_SEED)
    pca2.fit(x)
    y2 = np.asarray(pca2.transform(x))
    assert np.abs(y - y2).max() < 1e-8
    # rank-3 reconstruction error bounded by sigma_4
    z = np.asarray(pca2.inverse_transform(y2))
    s_all = np.linalg.svd(x - x.mean(0), compute_uv=False)
    assert np.abs(z - x).max() <= s_all[3] * 2


def test_randomized_pca_empty_input():
    """0-row input with k > 0 violates the reference's every-dim ≥ k
    check (pca.rs:513-517) → InvalidInput; with k = 0 it fits cleanly
    via the mean_axis-None early return (pca.rs:519-528)."""
    from petal_decomposition_tpu import RandomizedPca

    x = np.zeros((0, 4))
    with pytest.raises(InvalidInput):
        RandomizedPca.with_seed(2, RNG_SEED).fit(x)
    y = np.asarray(RandomizedPca.with_seed(0, RNG_SEED).fit_transform(x))
    assert y.shape[0] == 0


def test_randomized_pca_single_sample():
    y = np.asarray(
        RandomizedPcaBuilder(1).seed(RNG_SEED).build().fit_transform(
            np.array([[1.0, 2.0, 3.0]])
        )
    )
    assert y.shape == (1, 1)
    assert np.all(np.isfinite(y))


def test_mixed_precision_finder_accuracy():
    """finder_precision='f32': sigma from the f64 projection matches the
    full-f64 pipeline to ~1e-9 relative — Rayleigh-Ritz recovery is
    quadratic in the finder's subspace error."""
    rng = np.random.default_rng(21)
    n, d, k = 2000, 96, 8
    # decaying spectrum, kappa ~ 1e4
    u, _ = np.linalg.qr(rng.standard_normal((n, d)))
    v, _ = np.linalg.qr(rng.standard_normal((d, d)))
    sv = np.logspace(0, -4, d)
    x = (u * sv) @ v.T + 0.5

    full = (
        RandomizedPcaBuilder(k).seed(RNG_SEED).finder_precision("full")
        .build().fit(x)
    )
    mixed = (
        RandomizedPcaBuilder(k).seed(RNG_SEED).finder_precision("f32")
        .build().fit(x)
    )
    sv_f = np.asarray(full.singular_values())
    sv_m = np.asarray(mixed.singular_values())
    assert np.abs(sv_m / sv_f - 1).max() < 1e-9
    # exact-vs-mixed sigma: the real accuracy statement
    exact = Pca(k).fit(x)
    sv_e = np.asarray(exact.singular_values())
    assert np.abs(sv_m / sv_e - 1).max() < 1e-9
    np.testing.assert_allclose(
        np.asarray(mixed.components()), np.asarray(full.components()),
        atol=5e-5,
    )


def test_mixed_precision_finder_golden():
    """The reference golden fixture passes with the f32 finder too."""
    x = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]])
    pca = RandomizedPca(1, seed=RNG_SEED, finder_precision="f32")
    y = np.asarray(pca.fit_transform(x))
    assert abs(abs(y[0, 0]) - 5.0) < 1e-8
    assert abs(y[1, 0]) < 1e-8
    assert abs(abs(y[2, 0]) - 5.0) < 1e-8


def test_randomized_pca_rank_deficient_channels():
    """Exactly rank-deficient data (3 sources observed on 6 channels,
    as in examples/unmix_signals.py): every normalizer must produce
    finite factors — the CholeskyQR2 path needs its escalating shift
    when the rank-deficient panel's Gram goes (numerically) indefinite.
    Regression for a round-2 NaN found driving the example on an
    accelerator."""
    rng = np.random.default_rng(0)
    n = 20_000
    t = np.linspace(0, 8, n)
    sources = np.stack(
        [np.sign(np.sin(3 * t)), 2 * (t % 1) - 1,
         np.sign(rng.standard_normal(n)) * rng.standard_normal(n) ** 2],
        axis=1,
    )
    x = sources @ rng.standard_normal((3, 6))
    for norm in ("lu", "qr", "cholqr2"):
        pca = (
            RandomizedPcaBuilder(3).seed(42)
            .power_iteration_normalizer(norm).build()
        )
        y = np.asarray(pca.fit_transform(x))
        evr = np.asarray(pca.explained_variance_ratio())
        assert np.all(np.isfinite(y)), norm
        assert np.all(np.isfinite(evr)), norm
        assert evr.sum() > 0.99  # rank 3 ⇒ 3 components explain ~all


def test_cholesky_qr2_rank_deficient_panel():
    """cholesky_qr2 on an exactly rank-deficient panel stays finite and
    orthonormalizes the range (null directions may come out ~zero —
    LAPACK QR's arbitrary-completion freedom)."""
    from petal_decomposition_tpu.ops.linalg import cholesky_qr2

    rng = np.random.default_rng(1)
    basis = rng.standard_normal((5000, 3))
    panel = basis @ rng.standard_normal((3, 6))  # rank 3, 6 columns
    q = np.asarray(cholesky_qr2(panel))
    assert np.all(np.isfinite(q))
    # The range of the panel is spanned: projecting the basis onto Q
    # loses nothing.
    proj = q @ (q.T @ basis)
    resid = np.linalg.norm(proj - basis) / np.linalg.norm(basis)
    assert resid < 1e-8


def test_randomized_pca_single_sample_all_orth_paths():
    """1-sample fit: centering makes the panel exactly zero; every
    orthonormalization (incl. CholeskyQR2's underflow-prone lift on
    emulated-f64 backends) must yield finite factors with σ = 0."""
    from petal_decomposition_tpu.parallel.distributed import (
        randomized_pca_fit,
    )
    from petal_decomposition_tpu.utils.rng import key_from_seed

    x = np.array([[1.0, 2.0, 3.0, 4.0, 5.0]])
    for fo in ("qr", "cholqr2"):
        st = randomized_pca_fit(
            jnp.asarray(x), key_from_seed(3), n_components=1,
            centering=True, n_oversamples=10, n_power_iters=2,
            normalizer="lu", fuse_centering=False, final_orth=fo,
        )
        for k in ("u", "sigma", "vt"):
            assert np.all(np.isfinite(np.asarray(st[k]))), (fo, k)
        np.testing.assert_allclose(np.asarray(st["sigma"]), 0.0)


def test_finder_precision_f32_ignored_for_complex():
    """Mixed finder mode is float64-only: casting complex data to f32
    would silently discard the imaginary half of the sketch (review
    finding).  An explicit "f32" on complex data must behave exactly
    like "full"."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((200, 10))
         + 1j * rng.standard_normal((200, 10))).astype(np.complex128)
    full = RandomizedPcaBuilder(3).seed(5).finder_precision("full").build()
    yf = np.asarray(full.fit_transform(x))
    mixed = RandomizedPcaBuilder(3).seed(5).finder_precision("f32").build()
    ym = np.asarray(mixed.fit_transform(x))
    np.testing.assert_allclose(ym, yf, atol=1e-10)
