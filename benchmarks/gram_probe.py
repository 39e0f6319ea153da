"""Gram grades and the Gram-path fits against a float64 reference, on
one GPU.

    python benchmarks/gram_probe.py                   # both parts
    python benchmarks/gram_probe.py --part flagship   # part 1 only
    python benchmarks/gram_probe.py --smoke           # tiny, any device

Part 1, the in-core flagship (1,000,000 × 1024 f32 with
``chip_smoke.py``'s planted spectrum): the centered Gram at each matmul
grade — ``precision`` ``default``/``high``/``highest``, the dot
algorithms TF32×3 and BF16×3/×6/×9, and ``ops.centered.gram_acc64``
(f32 row chunks summed in float64) — with the median seconds of the
Gram and its float64 centering (the column means are computed once,
outside the timed program) and the relative error of σ₁..₃₂ after a
float64 eigh, against the numpy float64 reference
(``chip_smoke.gram_reference``).

Part 2, 4,000,000 × 1024 on one card: the ``highest`` and acc64 Grams
again, then ``RandomizedPca(32)``, ``Pca(32)`` and
``FastIca(n_components=32)`` with each whitening solver, against the
same reference (FastICA: the row space of the unmixing, which is the
whitening's).  A fit that fails, e.g. for want of device memory, is
recorded with its error and the probe goes on.

Prints one ``PROBE {json}`` line per measurement and appends the same
to ``chiprun_out/gram_probe.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import petal_decomposition_tpu  # noqa: E402,F401  (x64 first)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from petal_decomposition_tpu.ops.centered import gram_acc64  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "gram_probe.jsonl")
PRESETS = jax.lax.DotAlgorithmPreset
GRADES = {
    "default": "default",
    "high": "high",
    "highest": "highest",
    "TF32_TF32_F32_X3": PRESETS.TF32_TF32_F32_X3,
    "BF16_BF16_F32_X3": PRESETS.BF16_BF16_F32_X3,
    "BF16_BF16_F32_X6": PRESETS.BF16_BF16_F32_X6,
    "BF16_BF16_F32_X9": PRESETS.BF16_BF16_F32_X9,
}


def emit(rec: dict) -> None:
    line = json.dumps(rec, default=str)
    print("PROBE", line, flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def median_time(fn, reps: int = 5):
    out = jax.block_until_ready(fn())  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def centered_gram_at(grade):
    """The fused centered Gram ``XᵀX − n·μμᵀ`` with ``XᵀX`` at
    ``grade``, centered in float64 with the given means."""

    @jax.jit
    def run(x, mu):
        n = x.shape[0]
        if grade == "acc64":
            g = gram_acc64(x)
        else:
            g = jnp.dot(x.T, x, precision=grade).astype(jnp.float64)
        return g - n * jnp.outer(mu, mu)

    return run


def sigma_of_gram(g, k: int):
    lam = jnp.linalg.eigh(g)[0][::-1][:k]
    return np.sqrt(np.maximum(np.asarray(lam, np.float64), 0.0))


def gram_grades(x, ref_sigma, k: int, grades, label: str) -> None:
    mu = jax.block_until_ready(jnp.mean(x, axis=0, dtype=jnp.float64))
    for name in grades:
        run = centered_gram_at("acc64" if name == "acc64" else GRADES[name])
        g, secs = median_time(lambda: run(x, mu))
        emit({"part": label, "gram": name, "steady_s": secs,
              "sigma_rel_err": cs.sigma_rel_err(sigma_of_gram(g, k),
                                                ref_sigma)})


def fits(x, ref_sigma, ref_rows, k: int, seed: int, label: str) -> None:
    from petal_decomposition_tpu import FastIcaBuilder, Pca, RandomizedPca

    models = {
        "randomized_pca": lambda: RandomizedPca(k, seed=seed),
        "pca": lambda: Pca(k),
        "fastica_eigh": lambda: FastIcaBuilder().seed(seed).n_components(k)
        .whiten_solver("eigh").build(),
        "fastica_svd": lambda: FastIcaBuilder().seed(seed).n_components(k)
        .build(),
    }
    for name, make in models.items():
        rec = {"part": label, "fit": name}
        try:
            m, first, steady = cs.timed(cs._fit(make, x), 1)
        except Exception as e:  # recorded: the probe maps what fails
            rec["error"] = f"{type(e).__name__}: {str(e)[:400]}"
            emit(rec)
            continue
        rows = np.asarray(m.components_, np.float64)
        if name.startswith("fastica"):
            rec["n_iter"] = m.n_iter_
            rows = np.linalg.qr(rows.T)[0].T
        else:
            rec["sigma_rel_err"] = cs.sigma_rel_err(m.singular_values_,
                                                    ref_sigma)
        rec.update(subspace_sin=cs.subspace_sin(rows, ref_rows),
                   first_call_s=first, steady_s=steady,
                   peak_bytes_in_use=cs.peak_bytes())
        emit(rec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes (any device), for checking the probe")
    ap.add_argument("--part", choices=("all", "flagship"), default="all",
                    help="'flagship': only the 1M-row Gram grades")
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.smoke:
        print(f"needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        return 2
    if args.smoke:
        parts = [("smoke", 40_000, 128, 8, list(GRADES)[:3] + ["acc64"])]
    else:
        emit({"card": cs.card_line(), "device": dev.device_kind})
        parts = [
            ("flagship_1M", 1_000_000, 1024, cs.K, list(GRADES) + ["acc64"]),
            ("single_card_4M", 4_000_000, 1024, cs.K, ["highest", "acc64"]),
        ][: 1 if args.part == "flagship" else 2]
    for label, n, d, k, grades in parts:
        x = cs.planted_matrix(n, d, k, cs.SEED)
        ref_sigma, ref_rows = cs.gram_reference(np.asarray(x), k)
        gram_grades(x, ref_sigma, k, grades, label)
        if label != "flagship_1M":
            fits(x, ref_sigma, ref_rows, k, cs.SEED, label)
        del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
