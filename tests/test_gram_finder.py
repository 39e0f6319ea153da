"""Gram-accelerated range finder with its moments and fused centering.

The gram finder builds the SAME subspace — range(X(XᵀX)ᑫΩ) — as the
reference's streaming power iteration (pca.rs:689-718) from a single
Gram pass; recovery (B = QᴴX) projects against the exact data, so σ
must agree with the direct path to working precision on CPU (where
matmul-precision flags are no-ops and both paths are exact f32/f64).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from petal_decomposition_tpu import RandomizedPca, RandomizedPcaBuilder
from petal_decomposition_tpu.parallel import make_mesh
from petal_decomposition_tpu.parallel.distributed import (
    _resolve_range_finder,
    randomized_pca_fit,
)
from petal_decomposition_tpu.utils.rng import key_from_seed

RNG_SEED = 1_234_567_891_011_121_314  # ref: pca.rs:860


def _data(n=3000, d=256, dtype=np.float32, offset=0.0):
    rng = np.random.default_rng(42)
    x = rng.standard_normal((n, d)) @ np.diag(np.linspace(1, 30, d))
    return (x + offset).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gram_matches_direct(dtype):
    x = _data(dtype=dtype)
    s_dir = np.asarray(
        RandomizedPca.with_seed(8, RNG_SEED).fit(x).singular_values_
    )
    m = RandomizedPca(8, seed=RNG_SEED, range_finder="gram")
    s_gram = np.asarray(m.fit(x).singular_values_)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert np.max(np.abs(s_dir - s_gram) / s_dir) < tol


def test_gram_transform_roundtrip():
    x = _data()
    m = RandomizedPca(6, seed=RNG_SEED, range_finder="gram").fit(x)
    y = np.asarray(m.transform(x))
    xr = np.asarray(m.inverse_transform(y))
    # Rank-6 reconstruction of a full-rank matrix: compare projections.
    y2 = np.asarray(m.transform(xr))
    assert np.allclose(y, y2, rtol=1e-4, atol=1e-3)


def test_gram_mean_dominated_guard():
    """r = n‖μ‖²/tr(Gc) ≫ threshold engages the explicitly-centered
    recompute; σ must stay at working precision."""
    x = _data(offset=1000.0)
    s_dir = np.asarray(
        RandomizedPca.with_seed(8, RNG_SEED).fit(x).singular_values_
    )
    m = RandomizedPca(
        8, seed=RNG_SEED, range_finder="gram", gram_precision="default"
    )
    s_gram = np.asarray(m.fit(x).singular_values_)
    assert np.max(np.abs(s_dir - s_gram) / s_dir) < 1e-4


def test_mean_dominated_total_variance():
    """total_variance is user-visible (explained-variance denominators):
    with fused centering the analytic ‖X‖² − n‖μ‖² subtraction loses
    ~(1+r) of the input grade at r = n‖μ‖²/‖Xc‖² and must be
    cancellation-guarded.  At offset=1000 (f32, r ≈ 3e3) the unguarded
    form errs at the ~0.1%+ level; the guard recomputes explicitly.
    Exercised at the pipeline level with fuse_centering=True — the
    accelerator configuration (CPU model fits keep explicit
    centering)."""
    import jax.numpy as jnp

    from petal_decomposition_tpu.parallel.distributed import (
        randomized_pca_fit,
    )
    from petal_decomposition_tpu.utils.rng import key_from_seed

    x = _data(offset=1000.0)
    tv_ref = ((x.astype(np.float64)
               - x.astype(np.float64).mean(0)) ** 2).sum()
    for rf in ("gram", "direct"):
        st = randomized_pca_fit(
            jnp.asarray(x), key_from_seed(RNG_SEED), n_components=8,
            normalizer="cholqr2", range_finder=rf,
            fuse_centering=True, cfg=("tv-guard", rf),
        )
        tv = float(st["total_variance"])
        assert abs(tv - tv_ref) / tv_ref < 1e-5, (rf, tv, tv_ref)


def test_gram_no_centering():
    x = _data()
    s_dir = np.asarray(
        RandomizedPcaBuilder(8).seed(RNG_SEED).centering(False).build()
        .fit(x).singular_values_
    )
    m = (
        RandomizedPcaBuilder(8).seed(RNG_SEED).centering(False)
        .range_finder("gram").build()
    )
    s_gram = np.asarray(m.fit(x).singular_values_)
    assert np.max(np.abs(s_dir - s_gram) / s_dir) < 1e-5


def test_gram_sharded_matches_unsharded():
    mesh = make_mesh(8)
    x = _data(n=2003)  # uneven rows exercise pad+mask
    m1 = RandomizedPca(8, seed=RNG_SEED, range_finder="gram").fit(x)
    m2 = (
        RandomizedPcaBuilder(8).seed(RNG_SEED).range_finder("gram")
        .mesh(mesh).build().fit(x)
    )
    s1 = np.asarray(m1.singular_values_)
    s2 = np.asarray(m2.singular_values_)
    assert np.max(np.abs(s1 - s2) / s1) < 1e-5
    c1, c2 = np.asarray(m1.components_), np.asarray(m2.components_)
    assert np.max(np.abs(np.abs(np.sum(c1 * c2, axis=1)) - 1)) < 1e-4


def test_gram_rejects_complex():
    x = _data().astype(np.complex64)
    m = RandomizedPca(4, seed=RNG_SEED, range_finder="gram")
    with pytest.raises(ValueError, match="real dtypes"):
        m.fit(x)


def test_auto_resolution():
    from petal_decomposition_tpu.ops.linalg import effective_platform

    if effective_platform() == "cpu":
        assert (
            _resolve_range_finder("auto", jnp.float32, 10**6, 1024, 42)
            == "direct"
        )
    # Complex never picks gram.
    assert (
        _resolve_range_finder("auto", jnp.complex64, 10**6, 1024, 42)
        == "direct"
    )
    # Forced gram on complex raises.
    with pytest.raises(ValueError):
        _resolve_range_finder("gram", jnp.complex64, 10**6, 1024, 42)
    # The full-precision f64 finder never picks gram (flop ratio
    # ~d/(3l) against it — see _resolve_range_finder's docstring)...
    assert (
        _resolve_range_finder(
            "auto", jnp.float64, 10**6, 1024, 42, full_f64=True
        )
        == "direct"
    )
    # ...but an explicit request is honored.
    assert (
        _resolve_range_finder(
            "gram", jnp.float64, 10**6, 1024, 42, full_f64=True
        )
        == "gram"
    )


def _flow_data(n, d, offset=0.0, seed=42):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) @ np.diag(np.linspace(1, 20, d))
    return (x + offset).astype(np.float32)


class TestFusedGramFlow:
    """The Gram finder's data flow in plain XLA: the raw Gram with the
    rank-1 centering correction fused in, the column sums and ‖X‖²
    beside the Gram pass, the mean-domination guard, padded rows."""

    def _fit(self, x, *, cfg, range_finder="gram", n_components=6, **kw):
        return randomized_pca_fit(
            jnp.asarray(x), key_from_seed(11),
            n_components=n_components,
            normalizer="cholqr2",
            range_finder=range_finder,
            gram_precision="default",
            cfg=cfg, **kw,
        )

    @pytest.mark.parametrize("offset", [0.0, 0.5])
    def test_matches_direct_path(self, offset):
        """The Gram flow reproduces the direct finder's σ/V to f32
        working precision (recovery projects against exact data), and
        its moments are exact-grade."""
        x = _flow_data(4200, 64, offset=offset)
        st = self._fit(x, cfg=("flow-gram", offset))
        st_dir = self._fit(x, range_finder="direct", cfg=("flow-dir", offset))
        s_g = np.asarray(st["sigma"])[:6]
        s_d = np.asarray(st_dir["sigma"])[:6]
        np.testing.assert_allclose(s_g, s_d, rtol=1e-4)
        # Principal axes agree up to sign (compare |cos| to stay robust
        # to near-degenerate pairs).
        v_g = np.asarray(st["vt"])[:6]
        v_d = np.asarray(st_dir["vt"])[:6]
        cos = np.abs(np.sum(v_g * v_d, axis=1))
        np.testing.assert_allclose(cos, 1.0, atol=5e-4)
        mu_ref = np.asarray(x).mean(axis=0, dtype=np.float64)
        np.testing.assert_allclose(np.asarray(st["means"]), mu_ref,
                                   rtol=1e-4, atol=1e-5)
        tv_ref = ((np.asarray(x, np.float64) - mu_ref) ** 2).sum()
        assert abs(float(st["total_variance"]) - tv_ref) / tv_ref < 1e-5

    def test_mean_dominated_guard(self):
        """Past the r-threshold the in-graph cond rebuilds the subspace
        operator from an explicitly centered copy — σ accuracy holds
        even when n·‖μ‖² swamps the centered energy."""
        x = _flow_data(4200, 64, offset=50.0)
        st = self._fit(x, cfg=("flow-guard",))
        s_g = np.asarray(st["sigma"])[:6]
        x64 = np.asarray(x, np.float64)
        s_ref = np.linalg.svd(x64 - x64.mean(0), compute_uv=False)[:6]
        np.testing.assert_allclose(s_g, s_ref, rtol=1e-3)

    def test_mesh_pipeline_uneven_rows(self):
        """The Gram flow on an 8-device mesh with uneven rows (padded,
        masked by n_valid): σ, means and total variance match the
        unsharded fit."""
        from petal_decomposition_tpu.parallel.mesh import shard_rows_padded

        mesh = make_mesh(8)
        x = _flow_data(32_999, 64, offset=0.4)
        st1 = self._fit(x, cfg=("flow-mesh-ref",))
        x_sh, n_true = shard_rows_padded(jnp.asarray(x), mesh)
        assert n_true != x_sh.shape[0]  # padding engaged
        st2 = self._fit(x_sh, cfg=("flow-mesh", mesh), n_valid=n_true)
        np.testing.assert_allclose(np.asarray(st2["sigma"])[:6],
                                   np.asarray(st1["sigma"])[:6], rtol=2e-4)
        np.testing.assert_allclose(np.asarray(st2["means"]),
                                   np.asarray(st1["means"]),
                                   rtol=1e-4, atol=1e-5)
        tv1, tv2 = float(st1["total_variance"]), float(st2["total_variance"])
        assert abs(tv2 - tv1) / tv1 < 1e-5

    def test_state_shapes_independent_of_fused_path(self):
        """State shapes do not depend on the finder or on centering:
        sigma/u/vt come out the same l-wide shape on every path."""
        x = _flow_data(4200, 64)
        st = self._fit(x, cfg=("flow-shape",))
        st_dir = self._fit(x, range_finder="direct", cfg=("flow-shape-d",))
        stn = self._fit(x, centering=False, cfg=("flow-shape-nc",))
        for name in ("sigma", "u", "vt"):
            assert st[name].shape == st_dir[name].shape
            assert stn[name].shape == st[name].shape
        assert st["sigma"].shape == (16,)
        assert np.all(np.asarray(stn["means"]) == 0)


def test_gram_f64_sigma_vs_reference():
    """f64 σ against the exact SVD: the Gram finder must not degrade
    the randomized pipeline's own truncation grade (the residual ~1e-9
    here is subspace truncation at q=7 on a κ=1e3 spectrum — shared by
    both finders)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3000, 128)) * np.geomspace(1.0, 1e-3, 128)
    x = x + 0.3
    s_ref = np.linalg.svd(x - x.mean(0), compute_uv=False)[:8]
    errs = {}
    for finder in ("direct", "gram"):
        m = RandomizedPca(8, seed=RNG_SEED, range_finder=finder).fit(x)
        s = np.asarray(m.singular_values_)
        errs[finder] = np.max(np.abs(s - s_ref) / s_ref)
    assert errs["gram"] < 1e-8
    assert errs["gram"] < 3 * errs["direct"] + 1e-12


def test_gram_rank_deficient():
    """Collinear data: the dead direction transforms to zeros and
    nothing NaNs."""
    x = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]], np.float64)
    m = RandomizedPca(2, seed=RNG_SEED, range_finder="gram",
                      n_power_iters=2)
    y = np.asarray(m.fit_transform(x))
    assert np.all(np.isfinite(y))
    s = np.asarray(m.singular_values_)
    assert abs(s[0] - np.sqrt(50.0)) < 1e-8  # rank-1: σ₁ = √50
    assert abs(s[1]) < 1e-6
    assert np.max(np.abs(np.abs(y[:, 0]) - [5.0, 0.0, 5.0])) < 1e-8
