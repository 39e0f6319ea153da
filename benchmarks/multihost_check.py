"""Two-process multi-host validation (SURVEY §2.3 comm-backend row).

Spawns two local processes that form a JAX distributed cluster over a
localhost coordinator (CPU backend, 4 virtual devices each → one 8-way
global mesh spanning both processes), runs a row-sharded
``RandomizedPca`` fit whose psums ride the cross-process comm layer,
and asserts the result equals a single-process unsharded fit.  This is
the multi-host analogue a single machine can execute: the collective
path is identical (GSPMD psum over a multi-process mesh); only the
transport differs.

Run directly:  ``python benchmarks/multihost_check.py``
(writes benchmarks/MULTIHOST.json from process 0).
"""

from __future__ import annotations

# Repo-root import path for source checkouts, however this file is run
# (script, package import, or runpy without package context).
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
import json
import os
import subprocess
import sys

N, D, K = 4096, 64, 6
SEED = 1_234_567_891_011_121_314

_CHILD = r"""
import os, sys, json
import numpy as np

port, pid = sys.argv[1], int(sys.argv[2])

import jax

jax.config.update("jax_platforms", "cpu")  # a CPU cluster, even on a GPU host

import petal_decomposition_tpu as pd  # x64 + config before any arrays
from petal_decomposition_tpu.parallel import multihost

multihost.initialize(
    coordinator_address=f"localhost:{port}",
    num_processes=2,
    process_id=pid,
)
import jax

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

from petal_decomposition_tpu import RandomizedPca, RandomizedPcaBuilder
from petal_decomposition_tpu.parallel import make_mesh

N, D, K, SEED = %d, %d, %d, %d
rng = np.random.default_rng(0)
x = (rng.standard_normal((N, D)) @ np.diag(np.linspace(1, 9, D))).astype(
    np.float32
)

mesh = make_mesh()  # all 8 global devices, spanning both processes
m = RandomizedPcaBuilder(K).seed(SEED).mesh(mesh).build()
m.fit(x)
s_mesh = np.asarray(m.singular_values_)
c_mesh = np.asarray(m.components_)

# Single-process reference on local devices only (no mesh).
m1 = RandomizedPca(K, seed=SEED)
m1.fit(x)
s_one = np.asarray(m1.singular_values_)
c_one = np.asarray(m1.components_)

rel = float(np.max(np.abs(s_mesh - s_one) / s_one))
align = float(np.min(np.abs(np.sum(c_mesh * c_one, axis=1))))

# -- streamed multi-host fits: each process feeds its LOCAL rows ------
from petal_decomposition_tpu import Pca

x64 = x.astype(np.float64)
half = N // 2
x_loc = x64[:half] if pid == 0 else x64[half:]
BR = 512  # same block_rows both sides -> same provisional shift

st_mh = Pca(K, mesh=mesh).fit_batched(
    [x_loc[:1100], x_loc[1100:]], block_rows=BR
)
st_1p = Pca(K).fit_batched(x64, block_rows=BR)
s_st = float(np.max(np.abs(
    np.asarray(st_mh.singular_values_) - np.asarray(st_1p.singular_values_)
) / np.asarray(st_1p.singular_values_)))

r_mh = RandomizedPca(K, seed=SEED, mesh=mesh).fit_batched(
    x_loc, block_rows=BR
)
r_1p = RandomizedPca(K, seed=SEED).fit_batched(x64, block_rows=BR)
s_rst = float(np.max(np.abs(
    np.asarray(r_mh.singular_values_) - np.asarray(r_1p.singular_values_)
) / np.asarray(r_1p.singular_values_)))

# Collective partial_fit: both processes call in lockstep.
pf = Pca(K, mesh=mesh)
pf.partial_fit(x_loc[:700], block_rows=BR)
pf.partial_fit(x_loc[700:], block_rows=BR)
s_pf = float(np.max(np.abs(
    np.asarray(pf.singular_values_) - np.asarray(st_1p.singular_values_)
) / np.asarray(st_1p.singular_values_)))
assert pf.last_fit_stats_.extra["partial_fit_calls"] == 2

# Negative path: per-process dtype mismatch must be a defined error on
# EVERY process (the consensus allgather is symmetric, so both raise —
# no deadlock), not silently different-precision state.
from petal_decomposition_tpu.errors import InvalidInput

x_mismatch = x_loc.astype(np.float32) if pid == 0 else x_loc
try:
    Pca(K, mesh=mesh).fit_batched(x_mismatch, block_rows=BR)
    dtype_mismatch_rejected = False
except InvalidInput as e:
    dtype_mismatch_rejected = "dtype" in str(e)

ok = (
    rel < 1e-4 and align > 1 - 1e-4
    and s_st < 1e-9 and s_rst < 1e-9 and s_pf < 1e-9
    and dtype_mismatch_rejected
)
out = {
    "process_count": jax.process_count(),
    "global_devices": len(jax.devices()),
    "local_devices": len(jax.local_devices()),
    "sigma_rel_diff_vs_single_process": rel,
    "component_alignment_min": align,
    "streamed_exact_sigma_rel_diff": s_st,
    "streamed_randomized_sigma_rel_diff": s_rst,
    "streamed_partial_fit_sigma_rel_diff": s_pf,
    "dtype_mismatch_rejected": bool(dtype_mismatch_rejected),
    "ok": bool(ok),
}
print(f"[proc {pid}] " + json.dumps(out), flush=True)
if pid == 0:
    with open(sys.argv[3], "w") as f:
        json.dump(out, f, indent=1)
sys.exit(0 if ok else 1)
""" % (N, D, K, SEED)


def run(out_path: str | None = None) -> dict:
    import socket

    with socket.socket() as s:  # grab a free port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    if out_path is None:
        out_path = os.path.join(here, "MULTIHOST.json")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        .replace("--xla_force_host_platform_device_count=8", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()
    ppath = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(here)] + ppath
    )
    # jax.distributed must run before backend init: no JAX env leakage.
    env.pop("JAX_NUM_CPU_DEVICES", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(port), str(pid), out_path],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    logs = []
    codes = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            logs.append(out)
            codes.append(p.returncode)
    finally:
        # A failed/renegade child must not orphan its sibling (a child
        # stuck in jax.distributed.initialize holds the coordinator
        # port and blocks every later run).
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(codes):
        raise RuntimeError(
            "multihost check failed:\n" + "\n----\n".join(logs)
        )
    with open(out_path) as f:
        result = json.load(f)
    result["logs"] = [log.strip().splitlines()[-1] for log in logs]
    return result


if __name__ == "__main__":
    print(json.dumps(run(), indent=1))
