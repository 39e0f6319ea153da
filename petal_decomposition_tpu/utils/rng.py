"""Seed handling.

The reference seeds a PCG generator from a ``u128`` via big-endian bytes
(ref: pca.rs:357, ica.rs:76) and draws Gaussians through the ziggurat
``StandardNormal`` (ref: pca.rs:701-705, ica.rs:210-214).  Bit-exact
stream reproduction is impractical and unnecessary (randomized paths are
verified statistically per the reference's own tests, pca.rs:989-1027);
what we preserve is the *contract*: a 128-bit seed deterministically
selects the stream, and successive fits on one model advance the stream.

JAX's counter-based threefry keys replace the PCG state.  A u128 seed is
folded into a key from its four 32-bit limbs so the full seed width
participates.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["key_from_seed", "random_seed", "normal"]

_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1


def host_cpu_device():
    """The first host CPU device, or ``None`` when no CPU platform is
    registered.  Shared by the key builder below and the complex→host
    redirect (`models._common.complex_host_ctx`)."""
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return None


def _host_ctx():
    """Default-device context for eager key arithmetic.

    Key construction/splitting are tiny uint32 ops; running them on the
    host keeps them off the accelerator entirely, so building a model
    compiles and launches nothing on the device.  Threefry is
    bit-deterministic across platforms, and jitted fits receive the key
    by plain transfer."""
    import contextlib

    cpu = host_cpu_device()
    if cpu is None:
        return contextlib.nullcontext()
    return jax.default_device(cpu)


def key_from_seed(seed: int) -> jax.Array:
    """Build a PRNG key from an arbitrary-width integer seed (u128 in the
    reference API, ref: pca.rs:356-359)."""
    seed = int(seed)
    with _host_ctx():
        # Fold in 32-bit limbs: jax.random.key only accepts int64-range
        # seeds, while the reference API takes a full u128.
        key = jax.random.key(seed & _MASK32)
        rest = seed >> 32
        while rest:
            key = jax.random.fold_in(key, rest & _MASK32)
            rest >>= 32
    return key


def random_seed() -> int:
    """A randomly-generated 128-bit seed (analogue of ``rand::rng().random()``
    at pca.rs:343, ica.rs:63)."""
    import secrets

    return secrets.randbits(128)


def normal(key: jax.Array, shape, dtype) -> jax.Array:
    """Standard-normal draws in the requested (real) dtype.

    Complex dtypes draw real and imaginary parts as in the reference,
    where complex models sample a real ``StandardNormal`` and widen
    (pca.rs:701-705: ``A::Real`` sample converted ``r.into()`` — i.e. the
    imaginary part is zero).  We mirror that: complex models get real
    Gaussian test matrices with zero imaginary part.
    """
    dtype = jnp.dtype(dtype)
    if jnp.issubdtype(dtype, jnp.complexfloating):
        real_dtype = jnp.float32 if dtype == jnp.complex64 else jnp.float64
        return jax.random.normal(key, shape, real_dtype).astype(dtype)
    return jax.random.normal(key, shape, dtype)
