"""``chip_smoke.py``: each phase's reference comparison at a tiny size on
the CPU, the plain references themselves, and the refusal to run
without a GPU."""

import pathlib
import sys

import numpy as np
import pytest
import jax

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

N, D, K = 40_000, 128, 8


@pytest.fixture(scope="module")
def flagship():
    x = cs.planted_matrix(N, D, K, 7)
    x_host = np.asarray(x)
    return x, x_host, cs.gram_reference(x_host, K, chunk=5000)


def test_planted_matrix_is_f32_with_a_gap(flagship):
    x, _, (ref_sigma, _) = flagship
    assert x.dtype == np.float32 and x.shape == (N, D)
    s = cs.planted_spectrum(D, K)
    assert s[K - 1] / s[K] == pytest.approx(10.0)
    assert ref_sigma[0] > ref_sigma[-1] > 0


def test_gram_reference_matches_svd():
    x = np.random.default_rng(0).standard_normal((500, 12)).astype(np.float32)
    sigma, rows = cs.gram_reference(x, 4, chunk=64)
    x64 = x.astype(np.float64)
    _, s, vt = np.linalg.svd(x64 - x64.mean(0), full_matrices=False)
    np.testing.assert_allclose(sigma, s[:4], rtol=1e-12)
    assert cs.subspace_sin(rows, vt[:4]) < 1e-10


def test_flagship_phase(flagship):
    x, _, (ref_sigma, ref_rows) = flagship
    rec = cs.phase_flagship(x, ref_sigma, ref_rows, k=K, reps=1)
    assert rec["ok"], rec
    assert rec["sigma_rel_err"] <= cs.F32_TOL
    assert rec["routes"]["range_finder"] == "direct"  # the CPU route
    assert rec["sigma"].shape[0] >= K


def test_flagship_phase_fails_on_wrong_reference(flagship):
    x, _, (ref_sigma, ref_rows) = flagship
    rec = cs.phase_flagship(x, ref_sigma * 1.001, ref_rows, k=K, reps=0)
    assert not rec["ok"]


def test_exact_phase():
    rec = cs.phase_exact(shape64=(200, 16), shape32=(5000, 32), k=4,
                         reps=1)
    assert rec["ok"], rec
    assert rec["f64"]["max_abs_err"] <= cs.F64_TOL


def test_exact_pca_reference_sign_convention():
    x = np.random.default_rng(1).standard_normal((30, 5))
    y = cs.exact_pca_reference(x, 3)
    piv = y[np.argmax(np.abs(y), axis=0), np.arange(3)]
    assert np.all(piv > 0)  # svd_flip: each column's largest entry > 0
    xc = x - x.mean(0)
    np.testing.assert_allclose(np.abs(y), np.abs(xc @ np.linalg.svd(
        xc, full_matrices=False)[2][:3].T), atol=1e-12)


def test_fastica_phase():
    rec = cs.phase_fastica(channels=8, samples=20_000,
                           two_source_samples=20_000)
    assert rec["ok"], rec
    assert rec["two_source"]["max_rel_err"] <= cs.ICA_F64_TOL
    assert rec["f64"]["amari"] <= cs.AMARI_TOL
    assert rec["f64"]["rows_rel_err_vs_reference"] <= cs.ICA_F64_TOL
    assert rec["f32"]["rows_rel_err_vs_reference"] <= cs.F32_TOL


def test_fastica_phase_gpu_routes_meet_f64_reference(monkeypatch):
    """Through the accelerator routes (Newton–Schulz decorrelation, the
    f32 → ds64 → f64 ladder for f64 data) the 64-channel fits run to
    max_iter, like the numpy reference, and still land on its rows."""
    from petal_decomposition_tpu.ops import linalg as lin

    monkeypatch.setattr(lin, "effective_platform", lambda: "gpu")
    rec = cs.phase_fastica(channels=16, samples=20_011,
                           two_source_samples=20_011)
    assert rec["ok"], rec
    assert rec["reference"]["n_iter"] == rec["reference"]["max_iter"]
    assert rec["f64"]["routes"]["iteration_precision"] == "f32"
    assert rec["f64"]["rows_rel_err_vs_reference"] <= cs.ICA_F64_TOL


def test_amari_and_row_matching():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((4, 4))
    perm = np.eye(4)[[2, 0, 3, 1]] * np.array([1.0, -2.0, 0.5, 3.0])
    assert cs.amari_index(perm) == 0.0
    assert cs.amari_index(perm @ a @ np.linalg.inv(a)) < 1e-12
    assert cs.amari_index(a) > 0.1
    rows = rng.standard_normal((3, 6))
    shuffled = -rows[[1, 2, 0]]
    assert cs.rows_match_err(shuffled, rows) < 1e-15
    assert cs.rows_match_err(rows[[0, 0, 1]], rows) == float("inf")


def test_fastica_reference_separates_two_sources():
    mix = cs.two_source_fixture(20_000)
    w, n_iter = cs.fastica_reference(mix, np.eye(2), tol=1e-10,
                                     max_iter=200)
    a = np.array([[1.0, 0.6], [0.4, 1.0]])
    assert cs.amari_index(w @ a) < 1e-2
    assert 1 <= n_iter <= 200


def test_streamed_phase(flagship):
    x, x_host, (ref_sigma, ref_rows) = flagship
    core = cs.phase_flagship(x, ref_sigma, ref_rows, k=K, reps=0)
    rec = cs.phase_streamed(x_host, core["sigma"], ref_sigma, k=K)
    assert rec["ok"], rec
    assert rec["routes"]["gram_precision"] == "highest"


def test_four_phase_on_cpu_mesh():
    x = cs.planted_matrix(40_000, 64, 4, 3)
    ref_sigma, ref_rows = cs.gram_reference(np.asarray(x), 4, chunk=8192)
    rec = cs.phase_four(x, ref_sigma, ref_rows, k=4)
    assert rec["ok"], rec
    assert sorted(rec["shards"]) == [d.id for d in jax.devices()[:4]]
    for name in ("randomized_pca", "pca", "fastica"):
        assert rec[name]["mesh_subspace_sin"] <= cs.F32_TOL


def test_four_phase_fails_on_wrong_reference():
    x = cs.planted_matrix(40_000, 64, 4, 3)
    ref_sigma, ref_rows = cs.gram_reference(np.asarray(x), 4, chunk=8192)
    rec = cs.phase_four(x, ref_sigma * 1.001, ref_rows, k=4)
    assert not rec["ok"]
    assert not rec["pca"]["ok"] and rec["fastica"]["ok"]


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


@pytest.mark.gpu
def test_phases_on_card(gpu_device):
    """The flagship and exact phases at reduced size on a real card,
    through the GPU routes."""
    del gpu_device
    x = cs.planted_matrix(200_000, 256, 16, 5)
    ref_sigma, ref_rows = cs.gram_reference(np.asarray(x), 16)
    rec = cs.phase_flagship(x, ref_sigma, ref_rows, k=16, reps=1)
    assert rec["ok"], rec
    assert rec["routes"]["range_finder"] == "gram"
    rec = cs.phase_exact(shape32=(20_000, 128), reps=1)
    assert rec["ok"], rec
