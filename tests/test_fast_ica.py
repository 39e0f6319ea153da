"""FastIca tests — ports of the reference's tests (ica.rs:400-479),
including the golden numeric kernel tests with 8-decimal expectations."""

import numpy as np
import pytest

from petal_decomposition_tpu import FastIca, FastIcaBuilder, InvalidInput
from petal_decomposition_tpu.models.fast_ica import (
    ica_par,
    logcosh,
    symmetric_decorrelation,
)

RNG_SEED = 1_234_567_891_011_121_314  # ref: ica.rs:405


def test_fast_ica_fit_transform_consistency():
    """ref: ica.rs:407-420 — fit-then-transform equals fit_transform."""
    x = np.array([[0.0, 0.0], [1.0, 1.0], [1.0, -1.0]])
    ica = FastIca.with_seed(RNG_SEED)
    ica.fit(x)
    result_fit = np.asarray(ica.transform(x))
    n_iter_1 = ica.n_iter_

    ica2 = FastIca.with_seed(RNG_SEED)
    result_fit_transform = np.asarray(ica2.fit_transform(x))
    assert ica2.n_iter_ == n_iter_1

    np.testing.assert_allclose(
        result_fit, result_fit_transform, atol=1e-12
    )


def test_ica_par_single_iter_golden():
    """ref: ica.rs:435-444 — exact kernel golden values."""
    x = np.array([[-0.5, 0.5], [-0.3, 0.3]])
    w = np.array([[1.0, 2.0], [3.0, 4.0]])
    y, n = ica_par(x, 0.5, 1, w)
    y = np.asarray(y)
    assert abs(y[0, 0] - 0.51449576) < 1e-8
    assert abs(y[0, 1] - (-0.85749293)) < 1e-8
    assert abs(y[1, 0] - (-0.85749293)) < 1e-8
    assert abs(y[1, 1] - (-0.51449576)) < 1e-8
    assert n == 1


def test_ica_par_multi_iter_golden():
    """ref: ica.rs:447-456 — converges in exactly 6 iterations."""
    x = np.array([[1.0, -1.0], [0.0, 0.0]])
    w = np.array([[1.0, 2.0], [3.0, 4.0]])
    y, n = ica_par(x, 1e-4, 200, w)
    y = np.asarray(y)
    assert abs(y[0, 0] - (-0.00172682)) < 1e-8
    assert abs(y[0, 1] - 0.99999851) < 1e-8
    assert abs(y[1, 0] - 0.99999851) < 1e-8
    assert abs(y[1, 1] - 0.00172682) < 1e-8
    assert n == 6


def test_logcosh_golden():
    """ref: ica.rs:459-468."""
    x = np.array([[1.0, 2.0], [3.0, 4.0]])
    g, gp = logcosh(x)
    g, gp = np.asarray(g), np.asarray(gp)
    np.testing.assert_allclose(
        g,
        [[0.76159416, 0.96402758], [0.99505475, 0.99932930]],
        rtol=1e-8,
    )
    np.testing.assert_allclose(gp, [0.24531258, 0.00560349], rtol=1e-6)


def test_symmetric_decorrelation_golden():
    """ref: ica.rs:471-478."""
    x = np.array([[33.0, 24.0], [48.0, 57.0]])
    w = np.asarray(symmetric_decorrelation(x))
    np.testing.assert_allclose(
        w,
        [[0.96623494, -0.25766265], [0.25766265, 0.96623494]],
        rtol=1e-8,
    )


def test_symmetric_decorrelation_orthogonality():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 8))
    wd = np.asarray(symmetric_decorrelation(w))
    assert np.abs(wd @ wd.T - np.eye(8)).max() < 1e-10


def test_fast_ica_transform_wrong_cols():
    """ref: ica.rs:124-128."""
    x = np.array([[0.0, 0.0], [1.0, 1.0], [1.0, -1.0]])
    ica = FastIca.with_seed(RNG_SEED)
    ica.fit(x)
    with pytest.raises(InvalidInput):
        ica.transform(np.zeros((3, 5)))


def test_fast_ica_recovers_sources():
    """Statistical end-to-end check: unmix two independent non-Gaussian
    sources from a linear mixture."""
    rng = np.random.default_rng(7)
    n = 5000
    s = np.stack(
        [np.sign(rng.standard_normal(n)) * rng.standard_normal(n) ** 2,
         rng.uniform(-1, 1, n)],
        axis=1,
    )
    mixing = np.array([[1.0, 0.5], [0.4, 1.2]])
    x = s @ mixing.T
    ica = FastIca.with_seed(RNG_SEED)
    y = np.asarray(ica.fit_transform(x))
    # Each recovered component should correlate ~1 with one true source.
    corr = np.abs(np.corrcoef(y.T, s.T)[:2, 2:])
    best = corr.max(axis=1)
    assert np.all(best > 0.95)


@pytest.mark.parametrize("fun", ["logcosh", "exp", "cube"])
def test_fast_ica_contrast_functions(fun):
    """exp/cube are north-star extensions (SURVEY §5 config table)."""
    rng = np.random.default_rng(11)
    n = 2000
    s = np.stack(
        [rng.uniform(-1, 1, n), np.sign(rng.standard_normal(n))], axis=1
    )
    x = s @ np.array([[1.0, 0.3], [0.2, 1.0]])
    ica = FastIcaBuilder().seed(RNG_SEED).fun(fun).build()
    y = np.asarray(ica.fit_transform(x))
    assert y.shape == (n, 2)
    assert ica.n_iter_ >= 1


def test_fast_ica_whiten_solver_eigh():
    """Gram/eigh whitening (the sharded-fit solver) recovers sources."""
    rng = np.random.default_rng(13)
    n = 3000
    s = np.stack(
        [rng.uniform(-1, 1, n), np.sign(rng.standard_normal(n))], axis=1
    )
    x = s @ np.array([[1.0, 0.6], [0.1, 0.9]])
    ica = FastIcaBuilder().seed(RNG_SEED).whiten_solver("eigh").build()
    y = np.asarray(ica.fit_transform(x))
    corr = np.abs(np.corrcoef(y.T, s.T)[:2, 2:])
    assert np.all(corr.max(axis=1) > 0.95)


def test_fast_ica_more_features_than_samples():
    """n_features > n_samples: the reference has latent UB here (SURVEY
    C13); our whitening fills all columns and must produce finite
    results."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((5, 12))
    ica = FastIca.with_seed(RNG_SEED)
    y = np.asarray(ica.fit_transform(x))
    assert y.shape == (5, 5)  # k = min(n, d)
    assert np.all(np.isfinite(y))


def test_fast_ica_n_components_extension():
    """Explicit n_components (extension; ref pins k=min(n,d))."""
    rng = np.random.default_rng(23)
    n = 2000
    s = np.stack(
        [rng.uniform(-1, 1, n), np.sign(rng.standard_normal(n)),
         rng.standard_normal(n) ** 3],
        axis=1,
    )
    x = s @ rng.standard_normal((3, 6))  # 6 observed channels
    ica = FastIcaBuilder().seed(RNG_SEED).n_components(3).build()
    y = np.asarray(ica.fit_transform(x))
    assert y.shape == (n, 3)
    assert np.asarray(ica.components()).shape == (3, 6)

    with pytest.raises(InvalidInput):
        FastIcaBuilder().seed(1).n_components(10).build().fit(x)


def test_ns_decorrelation_matches_eigh():
    from petal_decomposition_tpu.models.fast_ica import (
        symmetric_decorrelation_ns,
    )

    rng = np.random.default_rng(31)
    w = rng.standard_normal((12, 12))
    a = np.asarray(symmetric_decorrelation(w))
    b = np.asarray(symmetric_decorrelation_ns(w))
    assert np.abs(a - b).max() < 1e-9
    assert np.abs(b @ b.T - np.eye(12)).max() < 1e-9


def test_fast_ica_ns_decorrelation_recovers_sources():
    rng = np.random.default_rng(37)
    n = 3000
    s = np.stack(
        [rng.uniform(-1, 1, n), np.sign(rng.standard_normal(n))], axis=1
    )
    x = s @ np.array([[1.0, 0.5], [0.2, 1.0]])
    ica = FastIcaBuilder().seed(RNG_SEED).decorrelation("ns").build()
    y = np.asarray(ica.fit_transform(x))
    corr = np.abs(np.corrcoef(y.T, s.T)[:2, 2:])
    assert np.all(corr.max(axis=1) > 0.95)


def test_decorrelation_auto_resolution():
    """``"auto"`` resolves eigh on CPU (reference parity) and ns on
    accelerators; explicit settings pass through."""
    from petal_decomposition_tpu.models.fast_ica import (
        resolve_decorrelation,
    )
    from petal_decomposition_tpu.ops.linalg import effective_platform

    assert resolve_decorrelation("eigh") == "eigh"
    assert resolve_decorrelation("ns") == "ns"
    expected = "eigh" if effective_platform() == "cpu" else "ns"
    assert resolve_decorrelation("auto") == expected

    with pytest.raises(ValueError, match="decorrelation"):
        FastIca(decorrelation="newton")


def test_fast_ica_ns_k_exceeds_data_rank():
    """The NS decorrelation must survive the rank-deficient in-loop
    update (k > rank(X) zeroes whitened channels): Newton–Schulz null
    directions amplify f.p. noise by ~1/√eps instead of eigh's clean
    pseudo-inverse zeros, and the projector certificate must still
    pass with finite output."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((5000, 2)) @ rng.standard_normal((2, 64)))
    for dtype in (np.float32, np.float64):
        ica = (
            FastIcaBuilder().seed(RNG_SEED).n_components(4)
            .decorrelation("ns").build()
        )
        y = np.asarray(ica.fit_transform(x.astype(dtype)))
        assert y.shape == (5000, 4)
        assert np.all(np.isfinite(y))
        assert np.all(np.isfinite(np.asarray(ica.components())))


def test_fast_ica_complex():
    """Complex inputs fit without crashing and behave consistently
    (the reference's FastIca is generic over c32/c64,
    lapack.rs:207-210, ica.rs:41-50)."""
    rng = np.random.default_rng(11)
    n = 400
    s = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    mix = rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3))
    x = (s ** 3) @ mix  # non-Gaussian complex sources, full rank
    ica = FastIca.with_seed(RNG_SEED)
    y = np.asarray(ica.fit_transform(x))
    assert y.shape == (n, 3)
    assert np.iscomplexobj(y)
    assert np.all(np.isfinite(y.real)) and np.all(np.isfinite(y.imag))

    ica2 = FastIca.with_seed(RNG_SEED)
    ica2.fit(x)
    y2 = np.asarray(ica2.transform(x))
    np.testing.assert_allclose(y, y2, atol=1e-10)
    assert ica2.n_iter_ == ica.n_iter_


def test_fast_ica_complex_rank_deficient_finite():
    """Numerically rank-deficient complex data must stay finite: the
    dead whitened direction is zeroed by the rank cutoff instead of
    amplifying roundoff (the reference NaNs here: unguarded 1/σ and
    1/√λ, ica.rs:198-200,371-374)."""
    rng = np.random.default_rng(11)
    n = 400
    s = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    mix = rng.standard_normal((2, 3)) + 1j * rng.standard_normal((2, 3))
    x = (s ** 3) @ mix  # rank 2 in 3 channels
    ica = FastIca(seed=RNG_SEED, max_iter=30)
    y = np.asarray(ica.fit_transform(x))
    assert y.shape == (n, 3)
    assert np.all(np.isfinite(y.real)) and np.all(np.isfinite(y.imag))


def test_symmetric_decorrelation_complex_orthonormal():
    """Complex decorrelation yields unitary rows (W·Wᴴ = I)."""
    rng = np.random.default_rng(13)
    w = rng.standard_normal((5, 5)) + 1j * rng.standard_normal((5, 5))
    d = np.asarray(symmetric_decorrelation(w))
    np.testing.assert_allclose(d @ d.conj().T, np.eye(5), atol=1e-10)


def test_fast_ica_empty_input():
    """0-row input fits gracefully (the reference early-returns,
    ica.rs:174-176; here the model stays consistently usable)."""
    x = np.zeros((0, 4))
    ica = FastIca.with_seed(RNG_SEED)
    y = np.asarray(ica.fit_transform(x))
    assert y.shape == (0, 0)
    assert np.asarray(ica.components()).shape == (0, 4)
    assert np.asarray(ica.mean()).shape == (4,)
    assert ica.n_iter_ == 0
    # The fitted (empty) model still transforms compatible inputs.
    out = np.asarray(ica.transform(np.ones((3, 4))))
    assert out.shape == (3, 0)


def test_fast_ica_zero_features():
    x = np.zeros((5, 0))
    y = np.asarray(FastIca.with_seed(RNG_SEED).fit_transform(x))
    assert y.shape == (5, 0)


def test_fast_ica_zero_components():
    x = np.arange(12.0).reshape(4, 3)
    ica = FastIcaBuilder().seed(RNG_SEED).n_components(0).build()
    y = np.asarray(ica.fit_transform(x))
    assert y.shape == (4, 0)
    np.testing.assert_allclose(
        np.asarray(ica.mean()), x.mean(axis=0), atol=1e-12
    )


def test_fast_ica_single_sample():
    """1×d input: k = 1, the iteration degenerates but must not crash."""
    x = np.array([[1.0, 2.0, 3.0]])
    ica = FastIca.with_seed(RNG_SEED)
    y = np.asarray(ica.fit_transform(x))
    assert y.shape == (1, 1)
    assert np.all(np.isfinite(y))


def _mixture(n=4000, seed=5):
    rng = np.random.default_rng(seed)
    s = np.stack(
        [rng.uniform(-1, 1, n), np.sign(rng.standard_normal(n))], axis=1
    )
    return (s @ np.array([[1.0, 0.5], [0.3, 1.0]])).astype(np.float64), s


def test_iteration_precision_mixed_matches_full():
    """f32-iterate + f64-polish converges to the same f64 fixed point
    as the reference-faithful full-precision iteration (same key, same
    basin); both satisfy the same tight f64 convergence criterion."""
    x, _ = _mixture()
    full = FastIca(
        seed=RNG_SEED, tol=1e-10, iteration_precision="full"
    ).fit(x)
    mixed = FastIca(
        seed=RNG_SEED, tol=1e-10, iteration_precision="f32"
    ).fit(x)
    assert 1 <= mixed.n_iter_ <= 200
    np.testing.assert_allclose(
        np.asarray(mixed.components()),
        np.asarray(full.components()),
        atol=1e-7,
    )


def test_iteration_precision_budget_cap():
    """Total iterations (f32 stage + f64 polish) never exceed max_iter;
    a non-convergent fit reports n_iter == max_iter (the reference's
    non-convergence contract, ica.rs:360).  Gaussian data has no
    independent non-Gaussian sources, so the iteration never settles."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2000, 4))
    ica = FastIca(
        seed=RNG_SEED, tol=1e-30, max_iter=7, iteration_precision="f32"
    ).fit(x)
    assert ica.n_iter_ == 7
    # Convergent data stops within budget on the f64 criterion (the
    # polish may even reach an exactly-stationary W, lim == 0.0).
    xm, _ = _mixture()
    ica = FastIca(
        seed=RNG_SEED, tol=1e-12, max_iter=50, iteration_precision="f32"
    ).fit(xm)
    assert 1 <= ica.n_iter_ <= 50


def test_iteration_precision_hands_off_when_w_is_stationary():
    """With many sources the reference functional (rows of the new W
    against columns of the old) never meets tol, so both fits run to
    max_iter; the ladder still leaves f32 once W stops moving and ends
    on the full-precision fixed point, not an f32-grade one."""
    rng = np.random.default_rng(11)
    k = 12
    q = np.linalg.qr(rng.standard_normal((k, k)))[0]
    x = rng.laplace(size=(20_000, k)) @ (q * rng.uniform(0.5, 2.0, k)).T
    full = FastIca(seed=RNG_SEED, iteration_precision="full").fit(x)
    mixed = FastIca(seed=RNG_SEED, iteration_precision="f32").fit(x)
    assert full.n_iter_ == mixed.n_iter_ == 200
    cf = np.asarray(full.components())
    cm = np.asarray(mixed.components())
    # Match rows up to sign and order (the stages' trajectories differ).
    cos = (cm / np.linalg.norm(cm, axis=1, keepdims=True)) @ (
        cf / np.linalg.norm(cf, axis=1, keepdims=True)
    ).T
    match = np.argmax(np.abs(cos), axis=1)
    assert sorted(match.tolist()) == list(range(k))
    sign = np.sign(cos[np.arange(k), match])[:, None]
    np.testing.assert_allclose(cm, sign * cf[match],
                               atol=1e-10 * np.abs(cf).max())


def test_iteration_precision_f32_data_unaffected():
    """float32 data iterates at its own dtype regardless of setting."""
    x, s = _mixture()
    x = x.astype(np.float32)
    a = FastIca(seed=RNG_SEED, iteration_precision="f32").fit_transform(x)
    b = FastIca(seed=RNG_SEED, iteration_precision="full").fit_transform(x)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=0)


def test_iteration_precision_validation():
    with pytest.raises(ValueError):
        FastIca(iteration_precision="bogus")
    with pytest.raises(ValueError):
        FastIcaBuilder().iteration_precision("bf16").build()


@pytest.mark.parametrize("fun", ["exp", "cube"])
def test_iteration_precision_other_contrasts(fun):
    """The mixed-precision stages share one loop body — every contrast
    converges to the full-precision fixed point (up to per-row sign:
    symmetric FastICA's W is sign-indeterminate — for odd contrasts −w
    is the same fixed point — and which sign a run lands on depends on
    the iterate trajectory, which differs across precision stages)."""
    x, s = _mixture(seed=9)
    full = np.asarray(FastIca(
        seed=RNG_SEED, tol=1e-9, fun=fun, iteration_precision="full"
    ).fit(x).components())
    mixed = np.asarray(FastIca(
        seed=RNG_SEED, tol=1e-9, fun=fun, iteration_precision="f32"
    ).fit(x).components())
    signs = np.sign(np.sum(mixed * full, axis=1, keepdims=True))
    np.testing.assert_allclose(signs * mixed, full, atol=1e-6)


def test_fast_ica_k_exceeds_data_rank():
    """k > rank(X): dead whitened channels are zeroed by the rank
    cutoff, the decorrelated W spans only rank(X) directions (W·Wᴴ is a
    projector, not I), and the fit must succeed with finite output —
    found by an accelerator shape sweep raising a spurious LinalgError."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((5000, 2)) @ rng.standard_normal((2, 64)))
    ica = FastIcaBuilder().seed(RNG_SEED).n_components(4).build()
    y = np.asarray(ica.fit_transform(x))
    assert y.shape == (5000, 4)
    assert np.all(np.isfinite(y))
    assert np.all(np.isfinite(np.asarray(ica.components())))


def test_whitening_cutoff_f32_large_n():
    """The rank cutoff must not scale linearly with sample count: an
    f32 fit with n=150k and a κ≈100 mixing matrix has a genuine
    whitened direction at σ ≈ 0.01·σmax, which a numpy-style
    σmax·eps·max(n,d) tolerance (= 0.018·σmax here) silently zeroes —
    losing a source (max-effort review finding)."""
    rng = np.random.default_rng(21)
    n = 150_000
    s = np.stack(
        [rng.uniform(-1, 1, n), np.sign(rng.standard_normal(n)),
         np.sign(rng.standard_normal(n)) * rng.standard_normal(n) ** 2],
        axis=1,
    )
    q1, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    q2, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    mixing = q1 @ np.diag([1.0, 1.0, 0.01]) @ q2  # kappa = 100
    x = (s @ mixing.T).astype(np.float32)
    ica = FastIca.with_seed(RNG_SEED)
    y = np.asarray(ica.fit_transform(x))
    corr = np.abs(np.corrcoef(y.T, s.T)[:3, 3:])
    assert np.all(corr.max(axis=1) > 0.9), corr.max(axis=1)


def test_whiten_solver_auto_matches_svd_on_cpu():
    """``whiten_solver="auto"`` resolves to the reference-faithful SVD
    whitening on CPU placements — bit-identical to an explicit "svd"."""
    x, _ = _mixture(seed=13)
    a = FastIca(seed=RNG_SEED, whiten_solver="auto").fit_transform(x)
    b = FastIca(seed=RNG_SEED, whiten_solver="svd").fit_transform(x)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        FastIca(whiten_solver="qr")


def _prewhitened(n=4000, d=3, seed=0):
    rng = np.random.default_rng(seed)
    s0 = rng.laplace(size=(n, d))
    x = s0 @ rng.normal(size=(d, d)).T
    xc = x - x.mean(0)
    u, _, _ = np.linalg.svd(xc, full_matrices=False)
    return u * np.sqrt(n), s0


def test_whiten_false_basic_contract():
    """whiten=False (SURVEY §5's promoted `whiten` parameter, sklearn
    semantics): no centering, components_ IS the unmixing W."""
    xw, s0 = _prewhitened()
    m = FastIcaBuilder().seed(5).whiten(False).build()
    y = np.asarray(m.fit_transform(xw))
    assert y.shape == xw.shape
    assert np.all(np.asarray(m.mean_) == 0)
    w = np.asarray(m.components_)
    # On whitened input the converged unmixing is orthonormal.
    assert np.max(np.abs(w @ w.T - np.eye(w.shape[0]))) < 1e-10
    # fit + transform == fit_transform (means are zero).
    m2 = FastIcaBuilder().seed(5).whiten(False).build().fit(xw)
    np.testing.assert_allclose(
        np.asarray(m2.transform(xw)), y, atol=1e-12
    )
    # Sources recovered.
    c = np.corrcoef(y.T, s0.T)[: w.shape[0], w.shape[0]:]
    assert np.all(np.sort(np.abs(c), axis=1)[:, -1] > 0.95)


def test_whiten_false_rejects_n_components():
    with pytest.raises(InvalidInput):
        FastIca(whiten=False, n_components=2)


def test_whiten_false_mesh_matches_single_device():
    from petal_decomposition_tpu.parallel.mesh import make_mesh

    xw, _ = _prewhitened(n=2048)
    single = FastIcaBuilder().seed(5).whiten(False).build().fit(xw)
    meshed = (
        FastIcaBuilder().seed(5).whiten(False).mesh(make_mesh(8)).build()
    ).fit(xw)
    assert single.n_iter_ == meshed.n_iter_
    np.testing.assert_allclose(
        np.asarray(meshed.components_),
        np.asarray(single.components_),
        atol=1e-12,
    )


def test_whiten_false_serializes():
    from petal_decomposition_tpu.utils.serialize import from_bytes, to_bytes

    xw, _ = _prewhitened(n=500)
    m = FastIcaBuilder().seed(5).whiten(False).build().fit(xw)
    m2 = from_bytes(to_bytes(m))
    assert m2._whiten is False
    np.testing.assert_allclose(
        np.asarray(m2.transform(xw[:9])), np.asarray(m.transform(xw[:9]))
    )


def test_whiten_false_rejects_empty_input():
    for shape in ((0, 4), (5, 0)):
        with pytest.raises(InvalidInput):
            FastIca(whiten=False).fit(np.zeros(shape))


def test_inverse_transform_round_trip():
    """sklearn-compatible extension: inverse_transform(transform(x)) ≈ x
    when k = d (exact pinv round-trip, independent of convergence)."""
    rng = np.random.default_rng(2)
    s0 = rng.laplace(size=(800, 3))
    x = s0 @ rng.normal(size=(3, 3)).T
    m = FastIca.with_seed(RNG_SEED).fit(x)
    xr = np.asarray(m.inverse_transform(m.transform(x)))
    np.testing.assert_allclose(xr, x, atol=1e-8)
    assert np.asarray(m.mixing_).shape == (3, 3)
    # mixing_ is the pinv of components_.
    np.testing.assert_allclose(
        np.asarray(m.mixing_),
        np.linalg.pinv(np.asarray(m.components_)),
        atol=1e-12,
    )
    # Wrong column count errors like the other inverse paths.
    with pytest.raises(InvalidInput):
        m.inverse_transform(np.zeros((4, 7)))
    # Unfitted model errors.
    with pytest.raises(InvalidInput):
        FastIca().inverse_transform(np.zeros((2, 3)))
