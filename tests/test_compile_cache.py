"""Where the package keeps JAX's persistent compilation cache.

Each case imports the package in a fresh interpreter, because the cache
is configured once, at import.
"""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def _cache_dir_after_import(env_overrides: dict) -> str:
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "PETAL_NO_COMPILE_CACHE")}
    env.update(env_overrides)
    code = (
        "import petal_decomposition_tpu, jax; "
        "print(repr(jax.config.jax_compilation_cache_dir))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    return eval(out.stdout.strip().splitlines()[-1])


def test_env_var_wins(tmp_path):
    """With ``JAX_COMPILATION_CACHE_DIR`` set, the package sets no
    directory of its own."""
    want = str(tmp_path / "cache")
    assert _cache_dir_after_import({"JAX_COMPILATION_CACHE_DIR": want}) == want


def test_default_is_checkout_dir():
    got = _cache_dir_after_import({})
    assert pathlib.Path(got) == REPO / ".jax_cache"
    assert (REPO / ".jax_cache").is_dir()
    # Built at run time, never committed.
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


def test_opt_out():
    assert _cache_dir_after_import({"PETAL_NO_COMPILE_CACHE": "1"}) is None

