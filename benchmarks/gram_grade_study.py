"""Streamed-Gram precision grades on an ADVERSARIAL spectrum.

Measures the σ gap of every ``gram_precision`` grade against the
``"highest"`` accumulation on data built to stress the Gram route (on
the GPU, ``"default"`` and ``"high"`` run f32 dots in TF32):

* condition number κ(X) ≈ 1e3 (log-spaced column scales 30 → 0.03, so
  the k=32 head spans the upper decades and the tail sits ~1e6 below
  λmax in the Gram);
* mean-dominated (column offsets ~10× the top scale — the regime the
  in-core ``_GRAM_GUARD_RMAX`` exists for; the streamed shift
  accumulation must keep the residual ratio r ≪ 1 here).

Blocks are generated on device (the grade question is arithmetic, not
transport).  Shapes: the literal north-star 16 × 65536 × 4096.

A grade may become the streamed f32 ``"auto"`` only if it holds the
1e-5 f32 parity band on THIS spectrum.  Needs a GPU.

Run:  python benchmarks/gram_grade_study.py [--blocks N] [--smoke]
Writes benchmarks/GRAM_GRADE.json.
"""

from __future__ import annotations

# Repo-root import path for source checkouts, however this file is run.
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
import argparse
import functools
import json
import os
import time

import petal_decomposition_tpu  # noqa: F401  (x64 + platform config first)
import numpy as np
import jax
import jax.numpy as jnp

from petal_decomposition_tpu.models import streaming
from petal_decomposition_tpu.utils.rng import key_from_seed

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 1_234_567_891_011_121_314

D = 4096
K = 32
BLOCK = 65536
KAPPA = 1e3
MEAN_SCALE = 10.0  # column offsets vs the largest column scale


def _flush(x) -> None:
    np.asarray(jax.device_get(jnp.ravel(x)[:1]))


@functools.partial(jax.jit, static_argnames=())
def _scales():
    # Column scales decaying log-spaced across the first 2k columns so
    # the REPORTED k=32 head itself spans the kappa decades (a decay
    # spread over all of d would leave the head nearly flat — benign),
    # then flat at the floor: kappa(X) ~ KAPPA and lambda-ratios up to
    # KAPPA^2 ~ 1e6 inside the Gram.
    top = 30.0
    head = min(2 * K, D)
    return jnp.concatenate([
        jnp.logspace(
            np.log10(top), np.log10(top / KAPPA), head, dtype=jnp.float32
        ),
        jnp.full((D - head,), top / KAPPA, jnp.float32),
    ])


def _gen_block(i: int):
    k = jax.random.fold_in(jax.random.key(7), i)
    b = jax.random.normal(k, (BLOCK, D), jnp.float32)
    means = MEAN_SCALE * 30.0 * jnp.sin(
        jnp.arange(D, dtype=jnp.float32) * 0.37
    )
    return b * _scales()[None, :] + means[None, :]


def _gram_carry_dtype(precision: str):
    from petal_decomposition_tpu.ops.linalg import effective_platform

    return (
        jnp.float32
        if precision == "default" and effective_platform() != "cpu"
        else jnp.float64
    )


def run_precision(n_blocks: int, precision: str) -> dict:
    n = n_blocks * BLOCK
    # The real stream's shift: the first block's column mean (f64).
    shift = jnp.mean(_gen_block(0), axis=0, dtype=jnp.float64)
    accum = functools.partial(streaming._accum_step, precision=precision)

    def run():
        carry = (
            jnp.zeros((D, D), _gram_carry_dtype(precision)),
            jnp.zeros((D,), jnp.float64),
            jnp.zeros((), jnp.float64),
        )
        for i in range(n_blocks):
            carry = accum(carry, _gen_block(i), shift, BLOCK)
        _flush(carry[0])
        return carry

    carry = run()  # compile + warm
    t0 = time.perf_counter()
    carry = run()
    wall = time.perf_counter() - t0

    means, gc, tv, r = streaming._finalize_centered(*carry, shift, float(n))
    m = streaming.StreamMoments(
        means.astype(jnp.float32), gc, tv, r, n_samples=n,
        n_blocks=n_blocks, dtype=jnp.dtype(jnp.float32),
    )
    sigma, vt, off = streaming.randomized_pca_from_gram(
        m, key_from_seed(SEED), n_components=K, n_oversamples=10,
        n_power_iters=7,
    )
    return {
        "accum_wall_s": round(wall, 3),
        "shift_ratio_r": float(r),
        "sigma": np.asarray(sigma)[:K],
        "means_head": np.asarray(means)[:4].astype(float).tolist(),
    }


def main() -> None:
    global D, BLOCK
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    if args.smoke:
        D, BLOCK = 64, 2048

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform}")
    out = {
        "config": (
            f"{args.blocks}x{BLOCK}x{D} f32, kappa~{KAPPA:g}, "
            f"mean-dominated x{MEAN_SCALE:g}, k={K}"
        ),
        "device": dev.device_kind,
    }
    results = {}
    for precision in ("default", "high", "highest"):
        results[precision] = run_precision(args.blocks, precision)
    ref = results["highest"]["sigma"]
    for precision in ("default", "high"):
        s = results[precision]["sigma"]
        results[precision]["sigma_rel_vs_highest_top32"] = float(
            np.max(np.abs(s - ref) / ref)
        )
    for p, rres in results.items():
        rres["sigma_top4"] = [float(v) for v in rres.pop("sigma")[:4]]
    # keep highest's full head for the record
    out["results"] = results
    out["kappa_observed_top_vs_32nd"] = float(
        ref[0] / ref[K - 1]
    )

    with open(os.path.join(HERE, "GRAM_GRADE.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
