"""Benchmark driver: flagship RandomizedPca fit on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

The reference publishes no benchmark numbers (BASELINE.md), so
``vs_baseline`` is the speedup of the GPU fit over the same Halko
pipeline run with numpy/BLAS on the host CPU at the same size.

Measurement notes:

* The envelope numbers (achieved TFLOP/s of a bf16 matmul chain, GB/s
  of a streaming pass) come from N-iteration jitted ``fori_loop``
  chains with 2N−N differencing, so per-call dispatch cancels.  No
  share of a peak is reported: the H100's peak table belongs to the
  benchmark.
* The flagship fit uses the DEFAULT dispatch (``range_finder="auto"``
  → Gram finder off the CPU, data-side recovery), and the
  default-constructor path (``RandomizedPca(32).fit``) is measured
  alongside it.
* The f64 FastICA contract is explicit: the mixed-precision iterate
  runs its iterations at the f32-stage rate and finishes with a short
  f64 polish; both stage rates are reported separately plus an
  end-to-end fit at the reference tolerance (1e-4).

Needs a GPU: it exits non-zero when JAX finds none.
"""

from __future__ import annotations

import functools
import json
import time

import numpy as np


def _emit(value, vs_baseline, detail: dict) -> None:
    result = {
        "metric": f"randomized_pca_fit_{N_ROWS // 1000}kx{N_COLS}_f32",
        "value": value,
        "unit": "ms",
        "vs_baseline": vs_baseline,
        "detail": detail,
    }
    print(json.dumps(result), flush=True)


N_ROWS = 1_000_000
N_COLS = 1024
K = 32
OVERSAMPLES = 10
POWER_ITERS = 2


def _flush(r):
    import jax

    jax.block_until_ready(r)


def _timed(fn, *args, reps: int = 5) -> float:
    """Min over reps of the host clock around ``block_until_ready``."""
    r = fn(*args)
    _flush(r)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r = fn(*args)
        _flush(r)
        ts.append(time.perf_counter() - t0)
    return float(np.min(ts))


def _dispatch_overhead_s() -> float:
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: x + 1.0)
    x = jnp.zeros((8, 128), jnp.float32)
    return _timed(f, x, reps=5)


def _envelope() -> dict:
    """Compact measured ceilings: a bf16 matmul chain and a streaming
    pass."""
    import jax
    import jax.numpy as jnp

    out = {}

    # bf16 8192³ matmul chain, 2N−N differencing.
    b = (
        jax.random.normal(jax.random.key(0), (8192, 8192), jnp.float32)
        / 90.5
    ).astype(jnp.bfloat16)

    @functools.partial(jax.jit, static_argnames=("iters",))
    def chain(c, b, *, iters):
        return jax.lax.fori_loop(
            0, iters, lambda _, c: jnp.dot(c, b, precision="default"), c
        )

    t1 = _timed(functools.partial(chain, iters=6), b, b)
    t2 = _timed(functools.partial(chain, iters=12), b, b)
    dt = max(t2 - t1, 1e-9) / 6
    tf = 2 * 8192**3 / dt / 1e12
    out["matmul_bf16_8192"] = {"tflops": round(tf, 1)}

    # Memory: streaming power-iteration chain at precision=highest.
    x = jax.random.normal(
        jax.random.key(1), (N_ROWS, N_COLS), jnp.float32
    )

    @functools.partial(jax.jit, static_argnames=("iters",))
    def stream(w, x, *, iters):
        def body(_, w):
            y = jnp.maximum(
                jnp.dot(x, w, precision="highest"), jnp.float32(-1e30)
            )
            return jnp.dot(x.T, y, precision="highest") / N_ROWS

        return jax.lax.fori_loop(0, iters, body, w)

    w = jax.random.normal(
        jax.random.key(2), (N_COLS, K + OVERSAMPLES), jnp.float32
    )
    t1 = _timed(functools.partial(stream, iters=4), w, x)
    t2 = _timed(functools.partial(stream, iters=8), w, x)
    dt = max(t2 - t1, 1e-9) / 4
    gbps = 2 * N_ROWS * N_COLS * 4 / dt / 1e9
    out["hbm_stream_2pass"] = {"gbps": round(gbps, 1)}
    del x
    return out


def _flagship(dispatch_s: float) -> dict:
    import jax
    import jax.numpy as jnp

    from petal_decomposition_tpu import RandomizedPca
    from petal_decomposition_tpu.config import config
    from petal_decomposition_tpu.parallel.distributed import (
        randomized_pca_fit,
    )
    from petal_decomposition_tpu.utils.rng import key_from_seed

    x = jax.random.normal(
        jax.random.key(0), (N_ROWS, N_COLS), jnp.float32
    )
    key = key_from_seed(1_234_567_891_011_121_314)

    def pipeline():
        # No internal sync: _timed's block_until_ready is the one wait.
        st = randomized_pca_fit(
            x, key, n_components=K, centering=True,
            n_oversamples=OVERSAMPLES, n_power_iters=POWER_ITERS,
            normalizer="cholqr2", range_finder="auto",
            cfg=config.cache_key(),
        )
        # Touching u keeps its thin-U pass in the measured program
        # (sigma alone would let XLA DCE it, flattering the number).
        return st["sigma"] + st["u"][0, :1]

    fit_s = _timed(pipeline)

    # Default-constructor path (q=7; the gram finder makes the extra
    # power iterations d×d-cheap).
    m = RandomizedPca(K, seed=1_234_567_891_011_121_314)
    m.fit(x)  # compile + warm

    # fit() alone is the comparable unit: its convergence-certificate
    # fetch syncs the device queue.
    def api():
        m2 = RandomizedPca(K, seed=1_234_567_891_011_121_314)
        m2.fit(x)

    api()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        api()
        ts.append(time.perf_counter() - t0)
    api_s = float(np.min(ts))

    detail = {
        "pipeline_auto_ms": round(fit_s * 1e3, 1),
        "api_default_fit_ms": round(api_s * 1e3, 1),
        "dispatch_corrected_ms": round(
            (fit_s - dispatch_s) * 1e3, 1
        ),
    }
    del x
    return fit_s, detail


def _compute_showcase(dispatch_s: float) -> dict:
    """Compute-bound fit: 250k×8192 k=32 via the Gram finder — the
    d²-deep Gram contraction (33.6 Tflop) dominates."""
    import jax
    import jax.numpy as jnp

    from petal_decomposition_tpu.config import config
    from petal_decomposition_tpu.parallel.distributed import (
        randomized_pca_fit,
    )
    from petal_decomposition_tpu.utils.rng import key_from_seed

    n, d, k = 250_000, 8192, 32
    x = jax.random.normal(jax.random.key(3), (n, d), jnp.float32)
    key = key_from_seed(1_234_567_891_011_121_314)

    def run():
        return randomized_pca_fit(
            x, key, n_components=k, centering=True,
            n_oversamples=OVERSAMPLES, n_power_iters=2,
            normalizer="cholqr2", range_finder="gram",
            cfg=config.cache_key(),
        )["sigma"]

    dt = _timed(run, reps=3)
    flops = 2 * n * d * d  # the Gram alone; recovery adds ~2%
    out = {
        "ms": round(dt * 1e3, 1),
        "gram_tflops": round(flops / dt / 1e12, 1),
        "gram_tflops_dispatch_corrected": round(
            flops / (dt - dispatch_s) / 1e12, 1
        ),
    }
    del x
    return out


NS_D = 4096
NS_BLOCK = 65536
NS_BLOCKS = 16  # 16 x 65536 = 1,048,576 rows
NS_K = 32


def _north_star(dispatch_s: float) -> dict:
    """The literal BASELINE.md metric: RandomizedPca fit 1M×4096 f32
    k=32 — via the streamed Gram path (``gram_precision="default"``;
    the reference needs the whole matrix in host RAM, pca.rs:195-231).

    Three numbers, as achieved Gram TFLOP/s:

    * ``full_fit_device_fed`` — the COMPLETE fit (16-block streamed
      accumulation as one fori_loop over device-resident blocks +
      re-centering + the randomized Gram solve), one raw wall
      measurement, no differencing: the end-to-end rate when block
      delivery keeps up with compute.
    * ``per_block_dispatch_rng_fed`` — the same accumulation fed one
      dispatched block at a time with device-RNG data (the exact
      per-block program ``fit_batched`` runs), raw and with the
      measured RNG-generation wall differenced out.
    * ``host_ingest`` — the measured H2D envelope and a real 2-block
      ``fit_batched`` from host memory, whose streaming rate is
      checked against that envelope.

    Plus σ parity: the real streamed fit vs the in-core gram-finder
    fit on identical data at the same seed.
    """
    import jax
    import jax.numpy as jnp

    from petal_decomposition_tpu.models import streaming
    from petal_decomposition_tpu.utils.rng import key_from_seed

    seed = 1_234_567_891_011_121_314
    n = NS_BLOCKS * NS_BLOCK
    gram_flops = 2.0 * n * NS_D * NS_D
    out = {"rows": n, "d": NS_D, "k": NS_K,
           "gram_precision": "default (TF32 on the GPU)"}

    def gen_block(i: int):
        return jax.random.normal(
            jax.random.fold_in(jax.random.key(0), i),
            (NS_BLOCK, NS_D), jnp.float32,
        )

    shift = jnp.zeros((NS_D,), jnp.float64)

    @functools.partial(jax.jit, static_argnames=("iters",))
    def accum_loop(x2, *, iters):
        """The streamed accumulation as ONE dispatch: rotating halves
        of ``x2`` are exactly a block's situation after fit_batched's
        H2D copy lands."""
        carry0 = (
            jnp.zeros((NS_D, NS_D), jnp.float32),  # default-grade carry
            jnp.zeros((NS_D,), jnp.float64),
            jnp.zeros((), jnp.float64),
        )

        def body(i, carry):
            blk = jax.lax.dynamic_slice(
                x2, ((i % 2) * NS_BLOCK, 0), (NS_BLOCK, NS_D)
            )
            return streaming._accum_step(
                carry, blk, shift, NS_BLOCK, precision="default"
            )

        return jax.lax.fori_loop(0, iters, body, carry0)

    x2 = jnp.concatenate([gen_block(0), gen_block(1)], axis=0)
    _flush(x2)

    def full_fit():
        carry = accum_loop(x2, iters=NS_BLOCKS)
        means, gc, tv, r = streaming._finalize_centered(
            *carry, shift, float(n)
        )
        m = streaming.StreamMoments(
            means.astype(jnp.float32), gc, tv, r, n_samples=n,
            n_blocks=NS_BLOCKS, dtype=jnp.dtype(jnp.float32),
        )
        sigma, vt, off = streaming.randomized_pca_from_gram(
            m, key_from_seed(seed), n_components=NS_K,
            n_oversamples=10, n_power_iters=7,
        )
        return sigma

    fit_s = _timed(full_fit, reps=3)
    # Accumulation alone (same warm cache) to split accum vs solve.
    accum_s = _timed(lambda: accum_loop(x2, iters=NS_BLOCKS), reps=3)
    out["full_fit_device_fed"] = {
        "wall_s": round(fit_s, 3),
        "accum_wall_s": round(accum_s, 3),
        "solve_and_finalize_wall_s": round(fit_s - accum_s, 3),
        "gram_tflops": round(gram_flops / fit_s / 1e12, 1),
        "sigma_top4": [float(s) for s in np.asarray(full_fit())[:4]],
        "sigma_note": (
            "rotates TWO blocks 8x each (HBM-residency stand-in), so "
            "sigma here is not comparable to true-1M-sample sigma; "
            "parity is checked below on real data"
        ),
    }

    # Per-block dispatch with device-RNG feed (fit_batched's program).
    def rng_only():
        o = None
        for i in range(NS_BLOCKS):
            o = gen_block(i)
        return o

    rng_s = _timed(rng_only, reps=2)

    def per_block():
        carry = (
            jnp.zeros((NS_D, NS_D), jnp.float32),
            jnp.zeros((NS_D,), jnp.float64),
            jnp.zeros((), jnp.float64),
        )
        for i in range(NS_BLOCKS):
            carry = streaming._accum_step(
                carry, gen_block(i), shift, NS_BLOCK, precision="default"
            )
        return carry[0]

    pb_s = _timed(per_block, reps=2)
    out["per_block_dispatch_rng_fed"] = {
        "accum_wall_s": round(pb_s, 3),
        "rng_only_wall_s": round(rng_s, 3),
        "gram_tflops": round(gram_flops / pb_s / 1e12, 1),
        "gram_tflops_rng_differenced": round(
            gram_flops / max(pb_s - rng_s, 1e-9) / 1e12, 1
        ),
    }
    del x2

    # Host ingest: H2D envelope + a real fit_batched vs it, on two
    # small blocks (512 MiB total).
    from petal_decomposition_tpu import RandomizedPca

    ing_rows = 16384
    blk_host = np.ones((ing_rows, NS_D), np.float32)
    _flush(jax.device_put(blk_host))
    t0 = time.perf_counter()
    _flush(jax.device_put(blk_host))
    h2d_gbps = blk_host.nbytes / (time.perf_counter() - t0) / 1e9

    rng = np.random.default_rng(0)
    x_host = rng.standard_normal((2 * ing_rows, NS_D), dtype=np.float32)
    fit = RandomizedPca(NS_K, seed=seed, gram_precision="default")
    t0 = time.perf_counter()
    fit.fit_batched(x_host, block_rows=ing_rows)
    ingest_s = time.perf_counter() - t0
    stream_gbps = x_host.nbytes / ingest_s / 1e9
    out["host_ingest"] = {
        "h2d_envelope_gbps": round(h2d_gbps, 3),
        "fit_gigabytes": round(x_host.nbytes / 2**30, 2),
        "fit_wall_s": round(ingest_s, 2),
        "fit_stream_gbps": round(stream_gbps, 3),
        "pct_of_h2d_envelope": round(stream_gbps / h2d_gbps * 100, 1),
    }

    # σ parity: the real streamed fits vs the in-core gram-finder fit
    # on identical data at the same seed — both the explicit "default"
    # grade above and the out-of-box "auto" (= "highest" for streams).
    auto_fit = RandomizedPca(NS_K, seed=seed)  # gram_precision="auto"
    auto_fit.fit_batched(x_host, block_rows=ing_rows)
    ic = RandomizedPca(NS_K, seed=seed, range_finder="gram")
    ic.fit(x_host)
    s_st = np.asarray(fit.singular_values_)
    s_auto = np.asarray(auto_fit.singular_values_)
    s_ic = np.asarray(ic.singular_values_)
    out["sigma_rel_streamed_auto_vs_in_core"] = float(
        np.max(np.abs(s_auto - s_ic) / s_ic)
    )
    out["sigma_rel_streamed_vs_in_core"] = float(
        np.max(np.abs(s_st - s_ic) / s_ic)
    )
    out["sigma_parity_note"] = (
        "comparator is the in-core gram-finder fit (data-side "
        "recovery); it bounds stream-vs-core agreement, not each "
        "grade's accuracy (benchmarks/gram_grade_study.py measures "
        "that)"
    )
    del x_host
    return out


ICA_K = 64
ICA_N = 100_000
ICA_ITERS = 50


def _ica_rates() -> dict:
    """FastICA iteration rates + the explicit f64 mixed contract."""
    import jax
    import jax.numpy as jnp

    from petal_decomposition_tpu.models.fast_ica import (
        _ica_par_core,
        resolve_decorrelation,
    )

    # The API default: decorrelation="auto" → Newton–Schulz on
    # accelerators, eigh on CPU.
    decorr = resolve_decorrelation("auto")
    out = {"decorrelation": decorr}
    x32 = jax.random.normal(
        jax.random.key(1), (ICA_K, ICA_N), jnp.float32
    )
    w32 = jax.random.normal(jax.random.key(2), (ICA_K, ICA_K), jnp.float32)

    def run32():
        w, _, _ = _ica_par_core(
            x32, jnp.asarray(1e-12, jnp.float32), ICA_ITERS, w32, "logcosh",
            decorrelation=decorr,
        )
        np.asarray(w).ravel()[:1]

    run32()
    t0 = time.perf_counter()
    run32()
    out["f32_iters_per_sec"] = round(
        ICA_ITERS / (time.perf_counter() - t0), 1
    )

    # f64 contract: the mixed iterate ("auto") runs its iterations in
    # the f32 stage and finishes with an f64 polish.  Stage-1
    # rate is MEASURED on the mixed path itself (downcast pass +
    # while_loop overhead included), not assumed equal to the f32 run.
    x64 = x32.astype(jnp.float64)
    w64 = w32.astype(jnp.float64)

    def run_stage1():
        # Non-convergent Gaussian data at the f32 floor: every
        # iteration of the budget runs in stage 1.
        w, _, n_iter = _ica_par_core(
            x64, jnp.asarray(1e-30, jnp.float64), ICA_ITERS, w64,
            "logcosh", precision="f32", decorrelation=decorr,
        )
        np.asarray(w).ravel()[:1]

    run_stage1()
    t0 = time.perf_counter()
    run_stage1()
    out["f64_mixed_stage1_iters_per_sec"] = round(
        ICA_ITERS / (time.perf_counter() - t0), 1
    )

    def run_polish():
        w, _, _ = _ica_par_core(
            x64, jnp.asarray(1e-30, jnp.float64), 10, w64, "logcosh",
            precision="full", decorrelation=decorr,
        )
        np.asarray(w).ravel()[:1]

    run_polish()
    t0 = time.perf_counter()
    run_polish()
    out["f64_polish_iters_per_sec"] = round(
        10 / (time.perf_counter() - t0), 1
    )

    # Stage-2 rate: the ds64 middle stage (hi/lo-split f32 gemms
    # carried in f64, ops/splitmm.py) that runs between the f32 stage
    # floor (1e-5) and the true-f64 certification steps.  Measured on
    # the stage body in a fori loop (the while_loop stages can't be
    # pinned to an iteration count through _ica_par_core).
    from petal_decomposition_tpu.models.fast_ica import (
        _contrast_sums,
        symmetric_decorrelation,
        symmetric_decorrelation_ns,
    )
    from petal_decomposition_tpu.ops import splitmm

    decorr_fn = (
        symmetric_decorrelation_ns if decorr == "ns"
        else symmetric_decorrelation
    )

    @functools.partial(jax.jit, static_argnames=("iters",))
    def loop_ds64(x, w, iters: int):
        xh, xl = splitmm.split_f64(x)

        def step(_, carry):
            w, _ = carry
            wx32 = splitmm.mm_split_f32(w, xh, xl)
            g, gsum = _contrast_sums("logcosh", wx32,
                                     sum_dtype=jnp.float64)
            gx = splitmm.mm_split_chunked_f64(g, xh, xl)
            upd = gx / ICA_N - (gsum / ICA_N)[:, None] * w
            w1 = decorr_fn(upd)
            lim = jnp.max(
                jnp.abs(jnp.abs(jnp.einsum("ij,ji->i", w1, w)) - 1.0)
            )
            return w1, lim

        f64inf = jnp.asarray(jnp.inf, jnp.float64)
        return jax.lax.fori_loop(0, iters, step, (w, f64inf))

    def run_ds64():
        w, _ = loop_ds64(x64, w64, iters=ICA_ITERS)
        np.asarray(w).ravel()[:1]

    run_ds64()
    t0 = time.perf_counter()
    run_ds64()
    out["f64_mixed_ds64_iters_per_sec"] = round(
        ICA_ITERS / (time.perf_counter() - t0), 1
    )

    # End-to-end mixed fit at the reference tolerance and cap
    # (tol=1e-4, max_iter=200, ica.rs:216).  The reference's
    # convergence functional pairs rows of the NEW W with columns of
    # the OLD W (ica.rs:344-354 — deliberately ported, golden-tested at
    # its 6-iteration fixture): on generic data it rarely reaches 1e-4,
    # so the representative end-to-end cost is the full 200-iteration
    # budget — identical behavior to the reference, surfaced via
    # ``n_iter == max_iter``.
    rng = np.random.default_rng(5)
    src64 = jnp.asarray(
        rng.laplace(size=(ICA_K, ICA_N)) / np.sqrt(2.0), jnp.float64
    )

    def run_mixed():
        w, lim, n_iter = _ica_par_core(
            src64, jnp.asarray(1e-4, jnp.float64), 200, w64, "logcosh",
            precision="f32", decorrelation=decorr,
        )
        np.asarray(w).ravel()[:1]
        return int(n_iter)

    n_iter = run_mixed()
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        n_iter = run_mixed()
        ts.append(time.perf_counter() - t0)
    out["f64_mixed_fit_tol1e4_cap200"] = {
        "seconds": round(float(np.min(ts)), 3),
        "n_iter": n_iter,
        "converged": n_iter < 200,
        "full_f64_equivalent_seconds": round(
            n_iter / max(out["f64_polish_iters_per_sec"], 1e-9), 1
        ),
    }

    # A fixture that DOES converge, end-to-end through the public API:
    # the reference's two-source family (ica.rs:446-456 converges the
    # golden 2×2 in 6 iterations; this is the same shape scaled to a
    # real sample count — sine + square sources, measured 3 iterations
    # at the reference tolerance).  Witnesses on-chip convergence
    # behavior, not just throughput: the generic-Gaussian fixture above
    # legitimately caps at 200 (the reference functional rarely reaches
    # 1e-4 on data with no independent non-Gaussian sources).
    from petal_decomposition_tpu import FastIca

    t = np.arange(ICA_N)
    src = np.stack(
        [np.sin(t * 0.01), np.sign(np.sin(t * 0.037 + 0.4))], axis=1
    )
    mix = src @ np.array([[1.0, 0.6], [0.4, 1.0]]).T

    def run_two_source():
        m = FastIca.with_seed(1_234_567_891_011_121_314)
        m.fit(mix)  # fit syncs via its convergence certificate
        return m.n_iter_

    n2 = run_two_source()
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        n2 = run_two_source()
        ts.append(time.perf_counter() - t0)
    out["two_source_unmix_100k_f64"] = {
        "seconds": round(float(np.min(ts)), 3),
        "n_iter": n2,
        "converged": n2 < 200,
    }
    return out


def _cpu_baseline_seconds() -> float:
    """Same Halko pipeline in numpy/BLAS on the host at the REAL
    1M-row size (measured, not extrapolated)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N_ROWS, N_COLS)).astype(np.float32)
    l = K + OVERSAMPLES

    t0 = time.perf_counter()
    mu = x.mean(axis=0)
    xc = x - mu
    omega = rng.standard_normal((N_COLS, l)).astype(np.float32)
    q = xc @ omega
    for _ in range(POWER_ITERS):
        q, _ = np.linalg.qr(q)
        q = xc.T @ q
        q, _ = np.linalg.qr(q)
        q = xc @ q
    q, _ = np.linalg.qr(q)
    b = q.T @ xc
    u_b, s, vt = np.linalg.svd(b, full_matrices=False)
    _ = q @ u_b
    return time.perf_counter() - t0


def _ica_cpu_baseline_iters_per_sec() -> float:
    rng = np.random.default_rng(0)
    x1 = rng.standard_normal((ICA_K, ICA_N)).astype(np.float32)
    iters = 5

    def run_once() -> float:
        w = rng.standard_normal((ICA_K, ICA_K)).astype(np.float32)
        t0 = time.perf_counter()
        for _ in range(iters):
            wx = w @ x1
            g = np.tanh(wx)
            g_wtx = (1 - g * g).mean(axis=1)
            w1 = (g @ x1.T) / ICA_N - g_wtx[:, None] * w
            lam, e = np.linalg.eigh(w1 @ w1.T)
            w = (e / np.sqrt(np.maximum(lam, 1e-30))) @ e.T @ w1
        return time.perf_counter() - t0

    dt = float(np.median([run_once() for _ in range(3)]))
    return iters / dt


def main() -> None:
    import petal_decomposition_tpu  # noqa: F401 — first: enables x64
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform}")
    detail = {"device": dev.device_kind}
    dispatch_s = _dispatch_overhead_s()
    detail["dispatch_overhead_ms"] = round(dispatch_s * 1e3, 2)
    fit_s, detail["flagship"] = _flagship(dispatch_s)
    cpu_s = _cpu_baseline_seconds()
    detail["cpu_baseline_measured_full_size_ms"] = round(cpu_s * 1e3, 1)
    detail["north_star_1Mx4096"] = _north_star(dispatch_s)
    detail["envelope_measured"] = _envelope()
    detail["compute_showcase_250kx8192_gram"] = _compute_showcase(
        dispatch_s
    )
    ica = _ica_rates()
    ica["cpu_baseline_iters_per_sec"] = round(
        _ica_cpu_baseline_iters_per_sec(), 1
    )
    detail["fastica_64x100k"] = ica
    _emit(round(fit_s * 1e3, 3), round(cpu_s / fit_s, 2), detail)


if __name__ == "__main__":
    main()
