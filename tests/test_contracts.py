"""Edge contracts added in round 3: complex-on-mesh, multihost init
errors, compilation-cache config."""

import numpy as np
import pytest
import jax

from petal_decomposition_tpu import (
    FastIca,
    InvalidInput,
    Pca,
    RandomizedPca,
)
from petal_decomposition_tpu.models._common import (
    _check_mesh_complex_platforms,
)
from petal_decomposition_tpu.parallel import make_mesh, multihost


def test_complex_cpu_mesh_fits_work():
    """An all-CPU mesh keeps full complex support (the defined,
    supported mesh-complex configuration)."""
    mesh = make_mesh(8)
    rng = np.random.default_rng(0)
    x = (
        rng.standard_normal((64, 8)) + 1j * rng.standard_normal((64, 8))
    ).astype(np.complex128)
    m = Pca(2, mesh=mesh).fit(x)
    assert np.asarray(m.components_).shape == (2, 8)


def test_complex_accelerator_mesh_raises():
    with pytest.raises(InvalidInput, match="accelerator mesh"):
        _check_mesh_complex_platforms({"gpu"}, np.complex64)
    with pytest.raises(InvalidInput, match="accelerator mesh"):
        _check_mesh_complex_platforms({"cpu", "gpu"}, np.complex128)
    # Real dtypes and CPU meshes pass.
    _check_mesh_complex_platforms({"gpu"}, np.float32)
    _check_mesh_complex_platforms({"cpu"}, np.complex128)


@pytest.mark.parametrize("model_cls", [Pca, RandomizedPca, FastIca])
def test_mesh_guard_wired_into_models(model_cls, monkeypatch):
    """Every model's mesh fit path consults the contract check."""
    calls = []
    from petal_decomposition_tpu.models import _common

    orig = _common.check_mesh_complex

    def spy(mesh, dtype):
        calls.append(dtype)
        return orig(mesh, dtype)

    monkeypatch.setattr(_common, "check_mesh_complex", spy)
    mesh = make_mesh(8)
    x = np.random.default_rng(1).standard_normal((64, 8))
    kwargs = {"mesh": mesh}
    model = (
        model_cls(mesh=mesh) if model_cls is FastIca
        else model_cls(2, **kwargs)
    )
    model.fit(x)
    assert len(calls) == 1


def test_multihost_explicit_failure_raises():
    """A misconfigured explicit coordinator must raise, not silently
    fall back to single-process (round-2 weak #6)."""
    if jax.process_count() > 1:
        pytest.skip("already in a multiprocess run")
    with pytest.raises(Exception):
        multihost.initialize(
            coordinator_address="localhost:1",  # nothing listens here
            num_processes=2,
            process_id=5,  # out of range → immediate ValueError
        )


def test_compilation_cache_configured():
    """The package sets its cache at import (tests/test_compile_cache.py
    covers where); the test session opts out, so CPU test compiles stay
    out of the checkout's cache."""
    import importlib
    import os

    cfg = importlib.import_module("petal_decomposition_tpu.config")
    assert os.environ.get("PETAL_NO_COMPILE_CACHE")
    assert jax.config.jax_compilation_cache_dir is None
    assert os.path.basename(cfg._CHECKOUT_CACHE_DIR) == ".jax_cache"
