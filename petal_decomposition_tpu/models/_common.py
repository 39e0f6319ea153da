"""Shared model plumbing: transform helpers and input validation.

Ports of the private free functions at pca.rs:720-811 plus the dimension
checks each model performs (pca.rs:199-204, 736-741, 798-803).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..errors import InvalidInput
from ..ops.linalg import mdot

__all__ = [
    "as_matrix",
    "check_min_dims",
    "check_mesh_complex",
    "transform",
    "transform_with_u",
    "inverse_transform",
]


def _check_mesh_complex_platforms(platforms: set[str], dtype) -> None:
    """Raise for complex dtypes on a mesh containing accelerator
    devices (factored out for direct unit testing — the CPU test
    environment cannot construct an accelerator mesh)."""
    if not jnp.issubdtype(jnp.result_type(dtype), jnp.complexfloating):
        return
    accel = platforms - {"cpu"}
    if accel:
        raise InvalidInput(
            "complex fits on an accelerator mesh are unsupported: "
            "complex fits run on the host (the reference's complex "
            "backend), and mesh fits are never host-redirected. "
            "Drop .mesh(...) to use the host-redirected complex path "
            "(the reference's own c32/c64 backend is host LAPACK, "
            "lapack.rs:207-210), or build the mesh from CPU devices. "
            f"Mesh platforms: {sorted(platforms)}."
        )


def check_mesh_complex(mesh, dtype) -> None:
    """The complex-on-mesh contract: complex fits require either no
    mesh (→ host redirect) or an all-CPU mesh; an accelerator mesh
    raises ``InvalidInput`` up front instead of walking into a
    compile that effectively never returns."""
    if mesh is None:
        return
    platforms = {d.platform for d in mesh.devices.flat}
    _check_mesh_complex_platforms(platforms, dtype)


def complex_host_ctx(x, dtype=None):
    """``(ctx, x)``: dispatch complex computations to the host CPU when
    the default backend is an accelerator.

    The reference's complex support runs on CPU LAPACK
    (lapack.rs:207-210 instantiates c32/c64), so complex fits and
    transforms transparently run host-side instead of requiring the
    user to set ``JAX_PLATFORMS=cpu``.  Whether they should run on the
    GPU through cuSOLVER instead is open (ROADMAP §B).  Returns a context
    manager that makes CPU the default device plus ``x`` committed
    there.  The dtype decision uses ``jnp.result_type`` (``dtype`` when
    given) — never ``jnp.asarray`` — so the raw (numpy) input is
    inspected and re-homed *without ever touching the accelerator*.
    No-op on CPU backends, for real dtypes, or with
    ``config.complex_device='default'``.
    """
    import contextlib

    import jax

    from ..config import config
    from ..ops.linalg import effective_platform

    decide = jnp.dtype(dtype) if dtype is not None else jnp.result_type(x)
    if (
        config.complex_device == "auto"
        and jnp.issubdtype(decide, jnp.complexfloating)
        and effective_platform() != "cpu"
    ):
        from ..utils.rng import host_cpu_device

        dev = host_cpu_device()
        if dev is None:  # no CPU platform registered
            return contextlib.nullcontext(), x
        return jax.default_device(dev), jax.device_put(x, dev)
    return contextlib.nullcontext(), x


def as_matrix(x) -> jnp.ndarray:
    """Coerce input to a 2-D floating/complex jax array.  Complex inputs
    on an accelerator backend are homed on the host CPU *before* any
    device placement (see :func:`complex_host_ctx`)."""
    if jnp.issubdtype(jnp.result_type(x), jnp.complexfloating):
        _, x = complex_host_ctx(x)
    x = jnp.asarray(x)
    if x.ndim != 2:
        raise InvalidInput(f"expected a 2-dimensional matrix, got {x.ndim}-d")
    if jnp.issubdtype(x.dtype, jnp.integer) or x.dtype == jnp.bool_:
        x = x.astype(jnp.float64)
    return x


def check_min_dims(x, n_components: int) -> None:
    """Every dimension must be at least n_components (ref: pca.rs:199-204)."""
    if any(dim < n_components for dim in x.shape):
        raise InvalidInput(
            f"every dimension should be at least {n_components}"
        )


def check_fitted(components) -> None:
    if components is None:
        raise InvalidInput("model has not been fitted")


def run_host_redirected_fit(model, x, fit_impl):
    """Run ``fit_impl(x)`` under the complex→host redirect with the
    model's PRNG key co-located on the host, restoring the key to the
    default device afterwards — **also on error** (a key left committed
    to the CPU would silently drag the next real-dtype fit's jit onto
    the host).  No-op wrapper for real dtypes."""
    import jax

    ctx, x2 = complex_host_ctx(x)
    if x2 is x:  # not redirected
        with ctx:
            return fit_impl(x2)
    try:
        with ctx:
            model._key = colocate(model._key, x2)
            return fit_impl(x2)
    finally:
        model._key = jax.device_put(model._key, jax.devices()[0])


def real_dtype(dtype):
    """The real dtype matching ``dtype`` — computed from the dtype
    alone (``jnp.real(x).dtype`` materializes the full real part of a
    complex array just to read its dtype)."""
    dtype = jnp.dtype(dtype)
    if jnp.issubdtype(dtype, jnp.complexfloating):
        return jnp.float32 if dtype == jnp.complex64 else jnp.float64
    return dtype


def colocate(arr, ref):
    """Place ``arr`` on ``ref``'s (single) device.

    The complex→host redirect moves the data to the CPU; a PRNG key
    (or other small model state) left on the accelerator would drag
    every eager op on it — and its transfer into the CPU-jitted fit —
    back and forth across the host link."""
    import jax

    if isinstance(ref, jax.Array) and isinstance(arr, jax.Array):
        devs = list(ref.devices())
        if len(devs) == 1:
            return jax.device_put(arr, devs[0])
    return arr


def _maybe_host_ctx(x, dtype, mesh):
    """Complex→host redirect, unless the model was fitted over an
    explicit device mesh — mesh state (components/means) lives on the
    mesh's devices, and mixing a host-committed input with it would
    raise a cross-device jit error; mesh models keep the fit-path
    semantics ('an explicit mesh wins: never redirected')."""
    import contextlib

    if mesh is not None:
        return contextlib.nullcontext(), x
    return complex_host_ctx(x, dtype=dtype)


def transform(x, components, means, centering: bool, mesh=None):
    """Project onto the fitted components: ``(x - μ)·Wᵀ``
    (ref: pca.rs:726-750)."""
    check_fitted(components)
    if x.shape[1] != means.shape[0]:
        raise InvalidInput(f"# of columns should be {means.shape[0]}")
    target = jnp.promote_types(x.dtype, components.dtype)
    ctx, x = _maybe_host_ctx(x, target, mesh)
    with ctx:
        # Accelerator-committed model state (e.g. from a fit on a
        # device_put input) must follow the redirected input to the
        # host, or the op raises an incompatible-devices error.
        components = colocate(components, x)
        means = colocate(means, x)
        x = x.astype(target)
        if centering:
            x = x - means
        # Deliberate deviation for complex inputs: the reference uses a
        # plain transpose (``x.dot(&components.t())``, pca.rs:745), under
        # which fit_transform ≠ fit+transform for complex data.  The
        # conjugate transpose is the mathematically-correct projection
        # (identical for real data, which is all the reference tests).
        return mdot(x, components.conj().T)


def transform_with_u(u, singular, n_components: int):
    """Projected data straight from the SVD: ``U[:, :k]·diag(σ[:k])``
    (ref: pca.rs:758-779)."""
    k = n_components
    return u[:, :k] * singular[:k].astype(u.dtype)[None, :]


def inverse_transform(y, components, means, centering: bool, mesh=None):
    """Back-project to the original space: ``y·W + μ``
    (ref: pca.rs:788-811)."""
    check_fitted(components)
    y = as_matrix(y)
    if y.shape[1] != components.shape[0]:
        raise InvalidInput(f"# of columns should be {components.shape[0]}")
    target = jnp.promote_types(y.dtype, components.dtype)
    ctx, y = _maybe_host_ctx(y, target, mesh)
    with ctx:
        components = colocate(components, y)
        means = colocate(means, y)
        out = mdot(y.astype(target), components)
        if centering:
            out = out + means
        return out
