"""End-to-end smoke run of the library's fit paths on NVIDIA GPUs.

    python chip_smoke.py           # five phases on one GPU
    python chip_smoke.py --four    # row-sharded fits on four GPUs only

One process opens the card(s) once and drives the public API
(``RandomizedPca``, ``Pca``, ``FastIca``) on seeded data.  Each phase
prints one ``PHASE <name> {json}`` line: its result against a plain
numpy float64 reference (error, tolerance, matmul precision in force),
the first call's seconds (compilation included) and the steady-state
seconds (host clock around ``block_until_ready``), the device's peak
bytes in use so far, and the routes the fit resolved to.  The first
line is ``nvidia-smi``'s name and power limit of the card(s); the last
line is one JSON object, ``{"ok": true, "device": {...}}``.

Phases on one card:

1. flagship — ``RandomizedPca(32).fit`` on 1,000,000 × 1024 f32 with a
   planted spectrum (a 10× gap after component 32, so the randomized
   subspace is exact to working precision), against the f64 Gram's
   eigendecomposition: σ₁..₃₂ and the components' subspace at 1e-5.
2. exact — ``Pca(16).fit_transform`` on 1000 × 64 f64 against the numpy
   pipeline (center → SVD → svd_flip → U·σ) at max|Δ| ≤ 1e-10, and on
   100,000 × 256 f32 at 1e-5 relative.
3. fastica — 64 Laplace sources mixed into 64 channels × 100,000
   samples, at f32 and f64: the Amari index of the recovered unmixing,
   and the rows against a numpy f64 symmetric FastICA from the same
   initial W (1e-5 at f32, 1e-8 at f64; rows compared up to sign and
   order).  The reference's convergence functional pairs rows of the
   new W with columns of the old one and reaches 0 only at symmetric
   fixed points, so here every fit, the numpy one included, runs to
   ``max_iter`` while W itself stops moving.  The two-source fixture,
   which does converge, is checked the same way at 1e-8.
4. streamed — ``RandomizedPca(32).fit_batched`` over the flagship
   matrix in host row blocks: σ against phase 1 and the reference.
5. data_projection — the path a removed fused sketch kernel served
   (sketch pass plus column moments) is the flagship's own data-side
   recovery on plain XLA: this line repeats phase 1's time and error.

With ``--four``: ``RandomizedPca``, ``FastIca`` and ``Pca`` fitted with
``.mesh(make_mesh(4))`` on 4,000,000 × 1024 f32 with the flagship
spectrum (rows checked to sit on all four cards).  Each fit, on the
mesh and on card 0 alone, is compared with the f64 reference at 1e-5
(σ and subspace; for FastICA the row space of the unmixing, which is
the whitening's), and each sharded fit with its single-card twin.

The script exits non-zero, and prints no ``"ok"`` line, when JAX finds
no GPU or when any phase misses its tolerance.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

SEED = 1_234_567_891_011_121_314
K = 32
FLAGSHIP_ROWS, FLAGSHIP_COLS = 1_000_000, 1024
FOUR_ROWS = 4_000_000
EXACT64_SHAPE, EXACT32_SHAPE, EXACT_K = (1000, 64), (100_000, 256), 16
ICA_CHANNELS, ICA_SAMPLES = 64, 100_000
TWO_SOURCE_SAMPLES = 100_000

F32_TOL = 1e-5  # the f32 parity band, relative
F64_TOL = 1e-10  # the f64 parity band, absolute on fit_transform
ICA_F64_TOL = 1e-8
AMARI_TOL = 0.05


# -- data ---------------------------------------------------------------

def planted_spectrum(d: int, k: int, low: float = 3.0) -> np.ndarray:
    """Column scales: the top k fall geometrically from 10 to ``low``,
    the rest from 0.3 to 0.03 — a gap of ``low``/0.3 after component
    k."""
    top = 10.0 * (low / 10.0) ** (np.arange(k) / max(k - 1, 1))
    tail = 0.3 * 0.1 ** (np.arange(d - k) / max(d - k - 1, 1))
    return np.concatenate([top, tail])


def planted_matrix(n: int, d: int, k: int, seed: int, low: float = 3.0):
    """``(Z·diag(s))·Qᵀ + μ`` in f32, made on the default device: Z has
    unit-variance Laplace entries (non-Gaussian, so the top-k whitened
    directions are independent sources for FastICA too), s is
    :func:`planted_spectrum`, Q a random orthogonal basis and μ a random
    offset that exercises centering."""
    import jax
    import jax.numpy as jnp

    s = jnp.asarray(planted_spectrum(d, k, low), jnp.float32)

    @jax.jit
    def make(key):
        kz, kq, km = jax.random.split(key, 3)
        q, _ = jnp.linalg.qr(jax.random.normal(kq, (d, d), jnp.float32))
        z = jax.random.laplace(kz, (n, d), jnp.float32) * 2.0 ** -0.5
        mu = jax.random.normal(km, (d,), jnp.float32)
        x = jnp.dot(z * s, q.T, precision="highest") + mu
        return x.astype(jnp.float32)

    return make(jax.random.key(seed))


def gram_reference(x_host: np.ndarray, k: int, chunk: int = 65536):
    """Top-k σ (descending) and component rows of the centered data,
    from the float64 Gram and ``np.linalg.eigh`` — plain numpy."""
    n, d = x_host.shape
    mean = np.zeros(d)
    for i in range(0, n, chunk):
        mean += x_host[i:i + chunk].sum(axis=0, dtype=np.float64)
    mean /= n
    gram = np.zeros((d, d))
    for i in range(0, n, chunk):
        c = x_host[i:i + chunk].astype(np.float64) - mean
        gram += c.T @ c
    lam, vecs = np.linalg.eigh(gram)
    lam, vecs = lam[::-1][:k], vecs[:, ::-1][:, :k]
    return np.sqrt(np.maximum(lam, 0.0)), vecs.T


def sigma_rel_err(sigma, ref) -> float:
    sigma = np.asarray(sigma, np.float64)[: len(ref)]
    return float(np.max(np.abs(sigma - ref) / ref))


def subspace_sin(rows, ref_rows) -> float:
    """Sine of the largest principal angle between the row spaces of
    ``rows`` and ``ref_rows`` (both with orthonormal rows)."""
    rows = np.asarray(rows, np.float64)
    resid = rows - (rows @ ref_rows.T) @ ref_rows
    return float(np.linalg.norm(resid, 2))


def exact_pca_reference(x, k: int) -> np.ndarray:
    """The reference's exact fit_transform in numpy: center, thin SVD,
    svd_flip (each U column's first largest-|·| entry made
    non-negative, pca.rs:815-850), then U·σ."""
    xc = np.asarray(x, np.float64)
    xc = xc - xc.mean(axis=0)
    u, s, _ = np.linalg.svd(xc, full_matrices=False)
    piv = u[np.argmax(np.abs(u), axis=0), np.arange(u.shape[1])]
    u = u * np.where(piv < 0, -1.0, 1.0)
    return u[:, :k] * s[:k]


def ica_mixture(n: int, k: int, seed: int):
    """``(x, a)``: k unit-variance Laplace sources mixed by a random
    well-conditioned k×k matrix ``a`` into n samples, ``x = s·aᵀ``."""
    rng = np.random.default_rng(seed)
    src = rng.laplace(size=(n, k)) / np.sqrt(2.0)
    q, _ = np.linalg.qr(rng.standard_normal((k, k)))
    a = q * rng.uniform(0.5, 2.0, size=k)
    return src @ a.T, a


def amari_index(p) -> float:
    """Amari's distance of ``p = W·A`` from a scaled permutation: 0
    when the sources are separated exactly, ≤ 1 otherwise."""
    p = np.abs(np.asarray(p, np.float64))
    k = p.shape[0]
    rows = (p.sum(axis=1) / p.max(axis=1) - 1.0).sum()
    cols = (p.sum(axis=0) / p.max(axis=0) - 1.0).sum()
    return float((rows + cols) / (2.0 * k * (k - 1)))


def two_source_fixture(n: int = TWO_SOURCE_SAMPLES) -> np.ndarray:
    """A sine and a square wave mixed by [[1, .6], [.4, 1]]: the
    reference's two-source family, which converges in a few steps."""
    t = np.arange(n)
    src = np.stack(
        [np.sin(t * 0.01), np.sign(np.sin(t * 0.037 + 0.4))], axis=1
    )
    return src @ np.array([[1.0, 0.6], [0.4, 1.0]]).T


def _symdecorr(w):
    lam, e = np.linalg.eigh(w @ w.T)
    return (e / np.sqrt(lam)) @ e.T @ w


def fastica_reference(x, w_init, *, tol: float, max_iter: int,
                      signs=None):
    """The reference's symmetric FastICA (ica.rs:167-361) in numpy f64:
    whitening K = (U[:, :k]/σ[:k])ᵀ from the SVD of the centered Xᵀ,
    X₁ = K·Xᵀ·√n, the logcosh fixed point with symmetric decorrelation,
    and its convergence functional max_i ||row_i(W₁)·col_i(W)| − 1|.
    ``signs`` flips whitening basis columns (their sign is arbitrary in
    any SVD).  Returns ``(W·K, n_iter)``, the unmixing and the
    iterations run (``max_iter`` when the functional never met
    ``tol``)."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    xt = (x - x.mean(axis=0)).T
    k = min(xt.shape)
    u, s, _ = np.linalg.svd(xt, full_matrices=False)
    if signs is not None:
        u = u * signs
    kmat = (u[:, :k] / s[:k]).T
    x1 = kmat @ xt * np.sqrt(n)
    w = _symdecorr(np.asarray(w_init, np.float64))
    for it in range(max_iter):
        g = np.tanh(w @ x1)
        w1 = _symdecorr(g @ x1.T / n - (1.0 - g * g).mean(axis=1)[:, None] * w)
        lim = np.max(np.abs(np.abs(np.einsum("ij,ji->i", w1, w)) - 1.0))
        w = w1
        if lim < tol:
            return w @ kmat, it + 1
    return w @ kmat, max_iter


def rows_match_err(rows, ref_rows) -> float:
    """Largest relative difference between ``rows`` and ``ref_rows``
    after matching each row to its reference row up to sign and order
    (an unmixing is defined only up to both); ``inf`` when the matching
    is not one-to-one."""
    rows = np.asarray(rows, np.float64)
    ref_rows = np.asarray(ref_rows, np.float64)
    cos = (rows / np.linalg.norm(rows, axis=1, keepdims=True)) @ (
        ref_rows / np.linalg.norm(ref_rows, axis=1, keepdims=True)
    ).T
    match = np.argmax(np.abs(cos), axis=1)
    if len(set(match.tolist())) != len(match):
        return float("inf")
    sign = np.sign(cos[np.arange(len(match)), match])
    ref = ref_rows[match] * sign[:, None]
    return float(np.max(np.abs(rows - ref)) / np.max(np.abs(ref)))


# -- measurement --------------------------------------------------------

def timed(fn, reps: int):
    """``(result, first_s, steady_s)``: the first call (compilation
    included) and the median of ``reps`` more, each ended by
    ``block_until_ready`` on what ``fn`` returns."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, first, float(np.median(ts)) if ts else None


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def precision_in_force() -> dict:
    import jax

    from petal_decomposition_tpu.config import config

    return {
        "mdot": config.matmul_precision,
        "jax_default_matmul_precision":
            jax.config.jax_default_matmul_precision,
    }


def randomized_routes(model, n: int, d: int, dtype) -> dict:
    """The routes a single-device ``RandomizedPca.fit`` resolves to."""
    from petal_decomposition_tpu.ops.linalg import (
        effective_platform,
        svd_branch,
    )
    from petal_decomposition_tpu.parallel.distributed import (
        resolve_fit_routes,
    )

    l = min(model._n_components + model._n_oversamples, n, d)
    routes = resolve_fit_routes(
        dtype, n, d, l,
        finder_precision=model._finder_precision,
        range_finder=model._range_finder,
        gram_precision=model._gram_precision,
    )
    accel = effective_platform() != "cpu" and n * d >= (1 << 22)
    routes["fused_centering"] = accel
    routes["normalizer"] = model._resolve_normalizer(np.empty((0, 0)))
    routes["small_svd"] = f"{svd_branch(dtype, l, d)} ({l}x{d})"
    return routes


def _fit(model_factory, x):
    def run():
        m = model_factory()
        m.fit(x)
        return m

    return run


def _emit(name: str, record: dict) -> None:
    record["peak_bytes_in_use"] = peak_bytes()
    print(f"PHASE {name} {json.dumps(record, default=str)}", flush=True)


# -- phases -------------------------------------------------------------

def phase_flagship(x, ref_sigma, ref_rows, *, k: int = K, seed: int = SEED,
                   reps: int = 3) -> dict:
    """Phase 1: the in-core randomized fit against the f64 reference."""
    from petal_decomposition_tpu import RandomizedPca

    def make():
        return RandomizedPca(k, seed=seed)

    m, first, steady = timed(_fit(make, x), reps)
    err = sigma_rel_err(m.singular_values_, ref_sigma)
    sin = subspace_sin(m.components_, ref_rows)
    return {
        "ok": bool(err <= F32_TOL and sin <= F32_TOL),
        "sigma_rel_err": err, "subspace_sin": sin, "tol": F32_TOL,
        "precision": precision_in_force(),
        "first_call_s": first, "steady_s": steady,
        "routes": randomized_routes(make(), *x.shape, x.dtype),
        "sigma": np.asarray(m.singular_values_, np.float64),
    }


def phase_exact(*, shape64=EXACT64_SHAPE, shape32=EXACT32_SHAPE,
                k: int = EXACT_K, seed: int = SEED, reps: int = 3) -> dict:
    """Phase 2: exact ``Pca`` at f64 and f32 against numpy."""
    import jax

    from petal_decomposition_tpu import Pca
    from petal_decomposition_tpu.ops.linalg import svd_branch

    out = {"ok": True, "precision": precision_in_force()}
    x64 = np.random.default_rng(seed % 2**32).standard_normal(shape64)
    x32 = np.asarray(planted_matrix(*shape32, k, seed + 1))
    for name, x, tol, rel in (("f64", x64, F64_TOL, False),
                              ("f32", x32, F32_TOL, True)):
        y, first, steady = timed(lambda: Pca(k).fit_transform(x), reps)
        ref = exact_pca_reference(x, k)
        err = float(np.max(np.abs(np.asarray(y, np.float64) - ref)))
        if rel:
            err /= float(np.max(np.abs(ref)))
        gram = Pca._auto_prefers_gram(jax.ShapeDtypeStruct(x.shape, x.dtype))
        out[name] = {
            "shape": list(x.shape),
            "max_rel_err" if rel else "max_abs_err": err, "tol": tol,
            "first_call_s": first, "steady_s": steady,
            "route": "gram" if gram else svd_branch(x.dtype, *x.shape),
        }
        out["ok"] &= bool(err <= tol)
    return out


def phase_fastica(*, channels: int = ICA_CHANNELS, samples: int = ICA_SAMPLES,
                  two_source_samples: int = TWO_SOURCE_SAMPLES,
                  seed: int = SEED, reps: int = 1) -> dict:
    """Phase 3: FastICA at f32 and f64 — separation (Amari index) and
    rows against the numpy f64 reference from the same initial W — and
    the two-source fixture against the same reference."""
    import jax
    import jax.numpy as jnp

    from petal_decomposition_tpu import FastIcaBuilder
    from petal_decomposition_tpu.models.fast_ica import (
        resolve_decorrelation,
        resolve_iteration_precision,
    )
    from petal_decomposition_tpu.ops.linalg import (
        effective_platform,
        eigh_route,
        svd_branch,
    )
    from petal_decomposition_tpu.utils import rng as rng_util

    def initial_w(k):
        # The fit's initial W: the second half of the model key's first
        # split.
        _, sub = jax.random.split(rng_util.key_from_seed(seed))
        return np.asarray(rng_util.normal(sub, (k, k), jnp.float64))

    max_iter = 200
    out = {"ok": True, "precision": precision_in_force()}
    x64, a = ica_mixture(samples, channels, seed % 2**32)
    t0 = time.perf_counter()
    ref_rows, ref_iter = fastica_reference(
        x64, initial_w(channels), tol=1e-4, max_iter=max_iter
    )
    out["reference"] = {"n_iter": ref_iter, "max_iter": max_iter,
                        "seconds": time.perf_counter() - t0}
    for name, x, tol in (("f32", x64.astype(np.float32), F32_TOL),
                         ("f64", x64, ICA_F64_TOL)):
        def fit():
            return FastIcaBuilder().seed(seed).build().fit(x)

        m, first, steady = timed(lambda: fit(), reps)
        amari = amari_index(np.asarray(m.components_, np.float64) @ a)
        rows_err = rows_match_err(m.components_, ref_rows)
        whiten = "eigh" if (x.dtype == np.float64
                            and effective_platform() != "cpu") else "svd"
        out[name] = {
            "amari": amari, "amari_tol": AMARI_TOL,
            "rows_rel_err_vs_reference": rows_err, "tol": tol,
            "n_iter": m.n_iter_,
            "first_call_s": first, "steady_s": steady,
            "routes": {
                "decorrelation": resolve_decorrelation("auto"),
                "iteration_precision":
                    resolve_iteration_precision("auto", x.dtype),
                "whitening": whiten + " " + (
                    eigh_route(x.dtype, channels) if whiten == "eigh"
                    else svd_branch(x.dtype, channels, samples)),
                "initial_decorrelation_eigh":
                    eigh_route(x.dtype, channels),
            },
        }
        out["ok"] &= bool(amari <= AMARI_TOL and rows_err <= tol)

    mix = two_source_fixture(two_source_samples)
    conv = FastIcaBuilder().seed(seed).build().fit(mix)
    tight, first, steady = timed(
        lambda: FastIcaBuilder().seed(seed).tol(1e-12).build().fit(mix), 0
    )
    errs = [
        rows_match_err(
            tight.components_,
            fastica_reference(mix, initial_w(2), tol=1e-12, max_iter=200,
                              signs=np.array(sg))[0],
        )
        for sg in ((1, 1), (1, -1), (-1, 1), (-1, -1))
    ]
    err = min(errs)
    out["two_source"] = {
        "n_iter_default_tol": conv.n_iter_, "n_iter_tol_1e-12":
            tight.n_iter_, "max_rel_err": err, "tol": ICA_F64_TOL,
        "first_call_s": first,
    }
    out["ok"] &= bool(err <= ICA_F64_TOL)
    return out


def phase_streamed(x_host, sigma_in_core, ref_sigma, *, k: int = K,
                   seed: int = SEED, reps: int = 1) -> dict:
    """Phase 4: the streamed fit from host row blocks."""
    from petal_decomposition_tpu import RandomizedPca
    from petal_decomposition_tpu.models.streaming import (
        _DEFAULT_BLOCK_ROWS,
        _resolve_stream_precision,
    )

    def run():
        return RandomizedPca(k, seed=seed).fit_batched(x_host)

    m, first, steady = timed(run, reps)
    vs_core = sigma_rel_err(m.singular_values_, sigma_in_core[:k])
    vs_ref = sigma_rel_err(m.singular_values_, ref_sigma)
    return {
        "ok": bool(vs_core <= F32_TOL and vs_ref <= F32_TOL),
        "sigma_rel_err_vs_in_core": vs_core,
        "sigma_rel_err_vs_reference": vs_ref, "tol": F32_TOL,
        "precision": precision_in_force(),
        "first_call_s": first, "steady_s": steady,
        "routes": {
            "gram_precision": _resolve_stream_precision("auto"),
            "block_rows": _DEFAULT_BLOCK_ROWS,
        },
    }


def phase_four(x, ref_sigma, ref_rows, *, k: int = K, seed: int = SEED,
               reps: int = 1) -> dict:
    """Row-sharded fits on a four-device mesh and the same fits on
    device 0 alone, each against the f64 reference, and each sharded
    fit against its single-device twin."""
    import jax

    from petal_decomposition_tpu import (
        FastIcaBuilder,
        PcaBuilder,
        RandomizedPcaBuilder,
    )
    from petal_decomposition_tpu.parallel import make_mesh
    from petal_decomposition_tpu.parallel.mesh import row_sharding

    mesh = make_mesh(4)
    x_sh = jax.device_put(x, row_sharding(mesh))
    shards = {s.device.id: s.data.shape for s in x_sh.addressable_shards}
    rows_each = x.shape[0] // 4
    spread = len(shards) == 4 and all(
        shape == (rows_each, x.shape[1]) for shape in shards.values()
    )
    out = {"ok": spread, "shards": shards, "precision": precision_in_force()}

    builders = {
        "randomized_pca": lambda: RandomizedPcaBuilder(k).seed(seed),
        "pca": lambda: PcaBuilder(k),
        # Eigh whitening, as on the mesh: the default SVD whitening of a
        # 4M×1024 f32 matrix runs out of memory on one card.
        "fastica": lambda: FastIcaBuilder().seed(seed).n_components(k)
        .whiten_solver("eigh"),
    }
    for name, builder in builders.items():
        single, s_first, s_steady = timed(
            _fit(lambda: builder().build(), x), reps
        )
        sharded, m_first, m_steady = timed(
            _fit(lambda: builder().mesh(mesh).build(), x_sh), reps
        )
        y = sharded.transform(x_sh)
        y_devices = sorted(s.device.id for s in y.addressable_shards)
        rec = {
            "single_first_call_s": s_first, "single_steady_s": s_steady,
            "mesh_first_call_s": m_first, "mesh_steady_s": m_steady,
            "transform_devices": y_devices, "tol": F32_TOL,
        }
        errs = []
        for where, m in (("single", single), ("mesh", sharded)):
            rows = np.asarray(m.components_, np.float64)
            if name == "fastica":
                # The unmixing's row space is the whitening's: the top-k
                # principal subspace.
                rec[f"{where}_n_iter"] = m.n_iter_
                rows = np.linalg.qr(rows.T)[0].T
            else:
                rec[f"{where}_sigma_rel_err"] = sigma_rel_err(
                    m.singular_values_, ref_sigma
                )
                errs.append(rec[f"{where}_sigma_rel_err"])
            rec[f"{where}_subspace_sin"] = subspace_sin(rows, ref_rows)
            errs.append(rec[f"{where}_subspace_sin"])
        if name == "fastica":
            rec["mesh_vs_single_rows"] = rows_match_err(
                sharded.components_, single.components_
            )
            errs.append(rec["mesh_vs_single_rows"])
        else:
            rec["mesh_vs_single_sigma"] = sigma_rel_err(
                sharded.singular_values_,
                np.asarray(single.singular_values_, np.float64),
            )
            errs.append(rec["mesh_vs_single_sigma"])
        rec["ok"] = bool(len(set(y_devices)) == 4 and max(errs) <= F32_TOL)
        out[name] = rec
        out["ok"] &= rec["ok"]
    return out


# -- driver -------------------------------------------------------------

def card_line() -> str:
    """``nvidia-smi``'s name and power limit, read by a child process
    that stays off JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return "; ".join(line.strip() for line in r.stdout.splitlines())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four", action="store_true",
        help="run only the row-sharded fits on four GPUs",
    )
    args = parser.parse_args(argv)

    import petal_decomposition_tpu  # noqa: F401 — first: enables x64
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform} devices",
              file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"--four needs 4 GPUs, found {len(devices)}", file=sys.stderr)
        return 2
    print(f"CARD {card_line()}", flush=True)

    ok = True
    rows = FOUR_ROWS if args.four else FLAGSHIP_ROWS
    x = planted_matrix(rows, FLAGSHIP_COLS, K, SEED)
    x_host = np.asarray(x)
    t0 = time.perf_counter()
    ref_sigma, ref_rows = gram_reference(x_host, K)
    ref_s = time.perf_counter() - t0
    if args.four:
        del x_host
        rec = phase_four(x, ref_sigma, ref_rows)
        rec["reference_s"] = ref_s
        _emit("four", rec)
        ok &= rec["ok"]
    else:
        rec = phase_flagship(x, ref_sigma, ref_rows)
        rec["reference_s"] = ref_s
        sigma_in_core = rec.pop("sigma")
        _emit("flagship", rec)
        ok &= rec["ok"]
        flagship = rec

        rec = phase_exact()
        _emit("exact", rec)
        ok &= rec["ok"]

        rec = phase_fastica()
        _emit("fastica", rec)
        ok &= rec["ok"]

        rec = phase_streamed(x_host, sigma_in_core, ref_sigma)
        _emit("streamed", rec)
        ok &= rec["ok"]

        # The removed fused sketch kernel served the data-side recovery,
        # which is now the flagship's own path: no second fit.
        _emit("data_projection", {
            "ok": flagship["ok"], "same_fit_as": "flagship",
            "sigma_rel_err": flagship["sigma_rel_err"],
            "subspace_sin": flagship["subspace_sin"],
            "steady_s": flagship["steady_s"],
        })

    if not ok:
        print("FAILED: a phase missed its tolerance", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
