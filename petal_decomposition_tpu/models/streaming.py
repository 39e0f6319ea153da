"""Out-of-core (streamed) fits: data larger than device memory.

The reference requires the whole n×d matrix materialized in host RAM
before any fit starts (``inner_fit`` takes a full ``ArrayBase``,
pca.rs:195-231, 509-550) — its scaling ceiling is one machine's memory.
On an accelerator the binding resource is device memory (80 GB on an
H100): a 10M×4096 f32 matrix is 160 GB and can never reside on the
device at once.  The answer is a single-pass streamed fit: row blocks flow
host→device on a prefetch worker thread (block production, H2D DMA,
and the accumulation matmul pipeline three-deep — see
:func:`_device_prefetch`), and the chip accumulates exactly what every
Gram-path fit consumes — the d×d Gram, the column sums, and ‖X‖²_F.
Nothing larger than ``block_rows × d`` plus d×d ever exists in HBM, so
the fittable n is unbounded.

Numerical contract (single pass, shifted accumulation):

* The Gram is accumulated about a provisional shift μ̂ (the first
  block's column mean), so the final rank-1 re-centering subtracts
  ``n·δδᵀ`` with ``δ = μ − μ̂ ≈ 0`` instead of ``n·μμᵀ`` — the
  catastrophic-cancellation mode of naive uncentered accumulation
  (the reason the in-core paths carry mean-domination guards,
  ``distributed._GRAM_GUARD_RMAX``) is structurally avoided for
  statistically stationary streams.  The residual shift ratio
  ``r = n·‖δ‖² / tr(Gc)`` is reported in
  ``last_fit_stats_.extra["mean_shift_ratio"]``; r ≪ 1 certifies the
  cancellation-free regime.
* Cross-block accumulation runs in float64 (the per-block d×d add is
  trivially cheap next to the block matmul on CPU), so accumulation
  error is independent of the number of blocks; the factorization then
  runs at the data dtype.  Exception: the explicit
  ``gram_precision="default"`` (TF32 on the GPU) mode on accelerators
  carries the Gram in f32 — uniform with its product grade (moment
  vectors stay f64 across blocks everywhere).
* Singular values are read off the Gram (σ = √λ), squaring the
  condition number: f64 streams keep ~1e-9-grade σ, f32 streams are
  Gram-grade (~1e-5·κ(X)² relative).  This matches the accuracy
  contract of the in-core ``solver="gram"`` path; the streamed
  randomized fit additionally reconstructs the in-core finder's exact
  recovery from G's l×l algebra
  (``ops.gram_recovery.randomized_gram_recovery``), so it matches
  the in-core gram-finder fit to roundoff at the same seed.
* Sign convention: with no thin-U available (U would be n×k for an
  unbounded n), components are sign-fixed by their own largest-|·|
  entry (first occurrence wins ties, made positive) instead of the
  U-based ``svd_flip`` (pca.rs:815-850).  Documented deviation:
  streamed and in-core fits may differ by a per-component ±1.

FastICA streams in TWO passes (``FastIca.fit_batched``): the iteration
itself must not re-read the n×d stream up to ``max_iter`` times, but it
never needs to — ``ica_par`` runs on the *whitened* matrix X₁ (k × n),
which for k ≪ d fits HBM at any n that matters (64 sources × 10M
samples f32 is 2.5 GB).  Pass 1 accumulates the d×d Gram + moments
(exactly :func:`accumulate_moments`) and yields the whitening K; pass 2
streams ``X₁ = K·(X − μ)ᵀ·√n`` into a device-resident k×n buffer block
by block; then the in-core ``ica_par`` runs unchanged.  The input must
be re-iterable (a 2-D array-like, a sequence of blocks, or a zero-arg
callable returning the stream); the k×n buffer must fit device memory
(checked — the error states the bound).  On a single-process mesh the
buffer column-shards over the devices (per-device footprint ÷
mesh.size) and the iteration's sample reductions psum, like the
in-core mesh fit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import config
from ..errors import InvalidInput
from ..ops import linalg as _linalg
from ..ops.gram_recovery import (
    flip_components as _flip_components,
    randomized_gram_recovery as _randomized_solve,
)
from ..ops.linalg import eigh_psd_jit_cert, mdot

__all__ = [
    "accumulate_moments",
    "exact_pca_from_gram",
    "randomized_pca_from_gram",
    "StreamMoments",
]

# 64k rows keeps a d=4096 f32 block at 1 GB and a d=1024 one at 256 MB —
# deep enough that the block matmul amortizes dispatch, small enough to
# double-buffer comfortably in device memory.
_DEFAULT_BLOCK_ROWS = 65536


@partial(jax.jit, donate_argnums=(0,), static_argnames=("precision",))
def _accum_step(carry, block, shift, n_valid, *, precision):
    """One streamed block: masked shift, Gram + first/second moments.

    ``carry`` (donated — the d×d accumulator is updated in place) holds
    ``(g, s, sq)``: ``s``/``sq`` float64, ``g`` float64 or — for the
    explicit ``"default"`` Gram grade on accelerators — float32 (see the
    module docstring).  ``n_valid`` is a dynamic scalar: the final
    partial block is zero-padded to the uniform block shape and masked
    here, so the whole stream compiles exactly one step program.
    """
    from ..parallel.distributed import _gram_of

    g, s, sq = carry
    rows = (jnp.arange(block.shape[0]) < n_valid)[:, None]
    xb = jnp.where(rows, block - shift.astype(block.dtype), 0)
    # _gram_of owns the precision contract (the same arithmetic as the
    # in-core Gram finder and its guard rating).
    g = g + _gram_of(xb, precision).astype(g.dtype)
    # Per-block moments at the block dtype, f64 across blocks — but
    # ONLY for the "default" Gram grade on accelerators, the same gate
    # as the f32 Gram carry in ``_accumulate_chunks`` (~1e-6 relative
    # per block, exact f64 across blocks — below that grade's own
    # error).  "high"/"highest" keep the full f64 per-block reductions
    # their grade promises; CPU keeps f64 always.
    from ..ops.linalg import effective_platform

    moment_dtype = (
        jnp.float32
        if (precision == "default"
            and xb.dtype == jnp.float32
            and effective_platform() != "cpu")
        else s.dtype
    )
    s = s + jnp.sum(xb, axis=0, dtype=moment_dtype).astype(s.dtype)
    sq = sq + jnp.sum(xb * xb, dtype=moment_dtype).astype(sq.dtype)
    return g, s, sq


@jax.jit
def _finalize_centered(g, s, sq, shift, n):
    """Re-center the shifted accumulators: means, centered Gram, total
    variance, and the residual shift ratio r = n‖δ‖²/tr(Gc)."""
    delta = s / n
    means = shift + delta
    gc = g - n * jnp.outer(delta, delta)
    dsq = n * jnp.sum(delta * delta)
    tv = jnp.maximum(sq - dsq, 0)
    r = dsq / jnp.maximum(jnp.trace(gc), jnp.asarray(1e-300, gc.dtype))
    return means, gc, tv, r


class StreamMoments:
    """Result of one accumulation pass over a stream."""

    def __init__(self, means, gram, total_variance, shift_ratio,
                 n_samples: int, n_blocks: int, dtype, solve_mesh=None,
                 precision: str = "highest"):
        self.precision = precision
        self.means = means  # (d,) data dtype
        self.gram = gram  # (d, d) float64, centered when requested
        self.total_variance = total_variance  # f64 scalar
        self.shift_ratio = shift_ratio  # f64 scalar
        self.n_samples = n_samples
        self.n_blocks = n_blocks
        self.dtype = dtype
        # Mesh for the factorization trace: the fit's mesh for a
        # single-process stream, None for a multi-host one (the folded
        # moments are identical on every process, so the d-sized solve
        # runs replicated instead of as a cross-host GSPMD program).
        self.solve_mesh = solve_mesh


def _coerce_block(b, dtype):
    """``(block, stream_dtype)``; ``b`` must be non-empty — zero-row
    blocks are skipped by the caller *before* coercion so they can
    never pin the stream dtype (an empty f32 buffer at the head of an
    otherwise-f64 generator must not downgrade the stream)."""
    if np.issubdtype(b.dtype, np.complexfloating):
        raise InvalidInput(
            "streamed fits support real dtypes only (complex fits "
            "are host-redirected and in-core; DESIGN.md §1)"
        )
    if dtype is None:
        # First block decides the stream dtype (as_matrix rules:
        # integers/bools promote to float64).
        dtype = (
            np.dtype(np.float64)
            if not np.issubdtype(b.dtype, np.floating)
            else b.dtype
        )
    elif b.dtype != dtype and not np.can_cast(b.dtype, dtype,
                                              casting="safe"):
        # A single-pass stream cannot re-promote what it already
        # consumed (the in-core fit sees all data at once and uses
        # result_type); silently downcasting f64 blocks into an f32
        # stream would void the accuracy contract, so reject.
        raise InvalidInput(
            f"block dtype {b.dtype} does not safely cast to the "
            f"stream dtype {np.dtype(dtype)} (fixed by the first "
            "block); cast the stream to one dtype up front"
        )
    return b.astype(dtype, copy=False), dtype


def _check_block_rows(block_rows: int) -> None:
    if block_rows <= 0:
        raise InvalidInput("block_rows must be positive")


def _iter_input_blocks(data, step: int):
    """A 2-D array(-like) streams as host-side row-slice views at the
    resolved chunk size — slices flow copy-free through the
    re-buffering (this is what makes ``fit_batched(np.memmap(...))``
    stream from disk without materializing in host RAM); anything else
    is iterated as user-provided blocks."""
    if hasattr(data, "ndim") and getattr(data, "ndim", None) == 2:
        n = data.shape[0]
        for i in range(0, max(n, 1), step):
            yield data[i : i + step]
        return
    yield from data


def _uniform_chunks(blocks, block_rows: int, *, pad_tail: bool = True,
                    dtype_hint=None, tail_multiple: int | None = None):
    """Re-buffer arbitrary-size input blocks into uniform
    ``block_rows``-row chunks, so the whole stream hits ONE compiled
    step.  Yields ``(chunk, n_valid)``; the final partial chunk is
    zero-padded to the uniform shape when ``pad_tail`` (the
    accumulation path masks it), or yielded at its true size otherwise
    (the transform path has no one-program constraint).
    ``tail_multiple`` (with ``pad_tail``) pads the final partial chunk
    only up to the next multiple of that value instead of the full
    ``block_rows`` — the mesh-sharded ICA fill uses ``mesh.size`` so
    the whitened buffer carries at most mesh.size−1 dead columns
    rather than up to a whole block (at the cost of one extra compiled
    fill shape, like ``pad_tail=False``).  ``dtype_hint``
    continues an existing stream's dtype (``partial_fit`` across
    calls) under the same safe-cast rule as within one stream."""
    _check_block_rows(block_rows)
    buf: list[np.ndarray] = []
    have = 0
    dtype = dtype_hint
    d = None
    for b in blocks:
        b = np.asarray(b)
        if b.ndim != 2:
            raise InvalidInput(
                f"expected 2-dimensional blocks, got {b.ndim}-d"
            )
        if b.shape[0] == 0:
            continue
        b, dtype = _coerce_block(b, dtype)
        if d is None:
            d = b.shape[1]
        elif b.shape[1] != d:
            raise InvalidInput(
                f"inconsistent block widths: expected {d}, got {b.shape[1]}"
            )
        buf.append(b)
        have += b.shape[0]
        while have >= block_rows:
            joined = buf[0] if len(buf) == 1 else np.concatenate(buf)
            yield joined[:block_rows], block_rows
            rest = joined[block_rows:]
            buf = [rest] if rest.shape[0] else []
            have = rest.shape[0]
    if have:
        joined = buf[0] if len(buf) == 1 else np.concatenate(buf)
        if not pad_tail:
            yield joined, have
            return
        target = (
            block_rows
            if tail_multiple is None
            else -(-have // tail_multiple) * tail_multiple
        )
        pad = np.zeros((target - have, joined.shape[1]), joined.dtype)
        yield np.concatenate([joined, pad]), have


def _mesh_spans_processes(mesh) -> bool:
    if mesh is None:
        return False
    return len({d.process_index for d in mesh.devices.flat}) > 1


def _prefetch_depth() -> int:
    """Host→device transfers kept in flight ahead of the consumer.
    ``PETAL_STREAM_PREFETCH=0`` disables the worker thread entirely
    (synchronous puts — the debugging fallback)."""
    import os

    return int(os.environ.get("PETAL_STREAM_PREFETCH", "2"))


def _device_prefetch(chunks, put):
    """Pipeline the whole host side of a stream behind device compute.

    A worker thread pulls ``(chunk, n_valid)`` host pairs from
    ``chunks`` — which includes every upstream host cost: the user's
    generator, ``np.memmap`` page-ins, and ``_uniform_chunks``
    re-buffering — and issues the (async) ``put`` H2D copy, keeping up
    to ``_prefetch_depth()`` transfers in flight.  The consumer
    receives ``(device_chunk, n_valid, width)`` triples and only ever
    dispatches device work, so block production, H2D transfer, and the
    accumulation matmul run as a three-stage pipeline; steady-state
    throughput is max(host, H2D, compute) instead of their sum.
    (Measured: the depth-1 same-thread prefetch this replaces left the
    1M×4096 streamed accumulation ~40% idle — NORTH_STAR.json
    envelope_1m, 0.432 s end-to-end vs 0.264 s device-fed.)

    Error contract: an exception anywhere on the host side (malformed
    block, raising user generator) is re-raised here, in stream order —
    chunks before it are already accumulated, exactly like the
    synchronous loop.  If the CONSUMER abandons the generator (its own
    error), the worker is signalled to stop and drained, so no thread
    or queue slot leaks.
    """
    depth = _prefetch_depth()
    if depth <= 0:
        for chunk, n_valid in chunks:
            yield put(chunk), n_valid, chunk.shape[1]
        return

    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _DONE = object()

    def _offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for chunk, n_valid in chunks:
                if not _offer((put(chunk), n_valid, chunk.shape[1])):
                    return
            _offer(_DONE)
        except BaseException as e:  # noqa: BLE001 — re-raised downstream
            _offer(e)

    t = threading.Thread(
        target=worker, name="petal-stream-prefetch", daemon=True
    )
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while True:  # unblock a worker mid-_offer
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)


class _StreamState:
    """Accumulator over uniform chunks — used once per ``fit_batched``
    and persistently (on the model) by ``partial_fit``.

    A mesh spanning multiple processes switches the stream to
    *multi-host* mode: every process feeds its own local blocks, the
    accumulators live on local devices (no per-chunk cross-host
    traffic), and one collective fold sums the per-process moments at
    finalize time (:func:`_fold_process_moments`) — the streamed
    analogue of the in-core sharded fits' psum.  The d-sized solve then
    runs replicated (identical inputs → identical state on every
    process)."""

    def __init__(self, block_rows: int, mesh):
        self.block_rows = block_rows
        self.multihost = _mesh_spans_processes(mesh)
        # Chunk placement: row-sharded over a single-process mesh;
        # local-device in multi-host mode (each process owns its rows).
        self.put_mesh = None if self.multihost else mesh
        self.carry = None  # (g, s, sq) float64 device arrays
        self.shift = None  # device (d,) float64
        self.n = 0
        self.n_blocks = 0
        self.calls = 0
        self.d = None
        self.dtype = None
        self.precision = None  # resolved gram grade (first chunk fixes it)


def _put_fns(mesh):
    if mesh is not None:
        from ..parallel.mesh import replicated_sharding, row_sharding

        return (
            partial(jax.device_put, device=row_sharding(mesh)),
            partial(jax.device_put, device=replicated_sharding(mesh)),
        )
    return jax.device_put, jax.device_put


def _resolve_block_rows(block_rows: int | None, mesh) -> int:
    if block_rows is None:
        block_rows = _DEFAULT_BLOCK_ROWS
    _check_block_rows(block_rows)
    if mesh is not None and not _mesh_spans_processes(mesh):
        block_rows = -(-block_rows // mesh.size) * mesh.size
    return block_rows


def _multihost_prologue(st: _StreamState, chunks, centering: bool):
    """Multi-host stream setup: peek the first local chunk, agree on
    the feature width and ONE provisional shift across processes (the
    shifted-accumulation algebra needs a common shift so the fold can
    simply sum the per-process moments), and hand the peeked chunk
    back.  Collective — every process must reach it, which is why an
    empty local stream is an error rather than a silent no-op (a
    process that never joins the allgather deadlocks the others)."""
    import itertools

    from jax.experimental import multihost_utils

    first = next(iter(chunks), None)
    if first is None:
        raise InvalidInput(
            "multi-host streams require at least one block on every "
            "process (collective shift consensus)"
        )
    chunk, n_valid = first
    # Width AND dtype must agree across processes: the folded f64
    # moments would sum fine either way, but st.dtype is what the
    # final factorization/state run at — a per-process mismatch would
    # silently install f32 state on one process and f64 on another.
    dtype_code = np.dtype(chunk.dtype).num
    dims = multihost_utils.process_allgather(
        np.asarray([chunk.shape[1], dtype_code], np.int64)
    )
    if not (dims == dims[0]).all():
        # np.dtype.num codes are gathered (a dtype itself cannot ride
        # an allgather); report them raw plus this process's name.
        raise InvalidInput(
            "inconsistent block widths or dtypes across processes: "
            + ", ".join(
                f"proc {i}: d={int(w)}, dtype_code={int(c)}"
                for i, (w, c) in enumerate(dims)
            )
            + f" (this process: {np.dtype(chunk.dtype).name})"
        )
    cand = (
        np.asarray(chunk[:n_valid]).mean(axis=0, dtype=np.float64)
        if centering
        else np.zeros((chunk.shape[1],), np.float64)
    )
    shifts = multihost_utils.process_allgather(cand)
    # Process 0's candidate — any consistent choice works; a
    # representative one is what kills the re-centering cancellation.
    st.shift = jax.device_put(shifts[0])
    return itertools.chain([first], chunks)


def _fold_process_moments(g, s, sq, n: int, n_blocks: int):
    """Sum the per-process ``(g, s, sq, n, n_blocks)`` across the
    cluster.  The gather is one collective per stream finalize (d×d f64
    per process); the host-side sum is ordered by process index, so
    every process computes bitwise-identical totals and the downstream
    solve replicates exactly."""
    from jax.experimental import multihost_utils

    gs = multihost_utils.process_allgather(np.asarray(g))
    ss = multihost_utils.process_allgather(np.asarray(s))
    sqs = multihost_utils.process_allgather(np.asarray(sq))
    ns = multihost_utils.process_allgather(
        np.asarray([n, n_blocks], np.int64)
    )
    return (
        jnp.asarray(gs.sum(axis=0)),
        jnp.asarray(ss.sum(axis=0)),
        jnp.asarray(sqs.sum(axis=0)),
        int(ns[:, 0].sum()),
        int(ns[:, 1].sum()),
    )


def _resolve_stream_precision(setting: str) -> str:
    """Resolve ``"auto"``: ``"highest"`` for every dtype and platform.

    A streamed solve reads σ off the Gram at first order, so the Gram
    must carry the 1e-5 f32 band.  On the H100 ``"high"`` and
    ``"default"`` run f32 dots in TF32: at the 1M×1024 f32 flagship
    stream (H100 80GB HBM3, power limit 700 W) ``"high"`` measured
    3.0e-5 relative σ against an f64 reference while ``"highest"``
    (true f32) passes.  The flagship stream moves 4.1 GB from the host
    against a ~40 ms ``"highest"`` Gram, so the copy should bound it
    rather than the grade; no trace has shown that yet.  Explicit
    grades pass through untouched."""
    return "highest" if setting == "auto" else setting


def _init_stream_carry(st: _StreamState, chunk, n_valid: int,
                       centering: bool, precision: str, put_repl) -> None:
    """First-chunk setup: fix the stream's width/dtype, the resolved
    gram grade, the provisional shift (multi-host consensus may pre-set
    it), and the accumulator dtypes."""
    st.d = chunk.shape[1]
    st.dtype = chunk.dtype
    st.precision = precision = _resolve_stream_precision(precision)
    if st.shift is None:
        # Provisional shift: the first chunk's column mean.  Any
        # shift works (the finalize re-centers exactly); a
        # representative one is what kills the cancellation.
        shift = (
            chunk[:n_valid].mean(axis=0, dtype=np.float64)
            if centering
            else np.zeros((st.d,), np.float64)
        )
        st.shift = put_repl(shift)
    # Gram carry at the product grade: for the explicit "default"
    # mode on accelerators the f64 inter-block add buys nothing (the
    # one-pass product error dwarfs the √B·eps_f32 ≈ 8e-7 of B=160
    # f32 adds); "high"/"highest" keep the f64 carry their grade
    # promises.
    from ..ops.linalg import effective_platform

    g_dtype = (
        np.float32
        if (precision == "default"
            and np.dtype(st.dtype) == np.float32
            and effective_platform() != "cpu")
        else np.float64
    )
    st.carry = (
        put_repl(np.zeros((st.d, st.d), g_dtype)),
        put_repl(np.zeros((st.d,), np.float64)),
        put_repl(np.zeros((), np.float64)),
    )


def _accumulate_chunks(st: _StreamState, chunks, centering: bool,
                       precision: str = "highest") -> None:
    """Fold ``(chunk, n_valid)`` pairs into ``st``.  All host-side work
    (block production, re-buffering, H2D) runs on the
    :func:`_device_prefetch` worker, ≥2 transfers in flight, while this
    loop only dispatches the (async) ``_accum_step`` — so the stream
    runs at max(host, H2D, compute), not their sum."""
    import itertools

    put_block, put_repl = _put_fns(st.put_mesh)
    it = iter(chunks)
    if st.carry is None:
        first = next(it, None)
        if first is None:
            return
        _init_stream_carry(
            st, first[0], first[1], centering, precision, put_repl
        )
        it = itertools.chain([first], it)
    # The grade is a property of the STREAM (fixed at the first chunk,
    # reused by every later partial_fit call on the same state).
    precision = st.precision
    for dev, n_valid, width in _device_prefetch(it, put_block):
        if width != st.d:
            raise InvalidInput(
                f"inconsistent block widths: expected {st.d}, "
                f"got {width}"
            )
        st.carry = _accum_step(
            st.carry, dev, st.shift, n_valid, precision=precision
        )
        st.n += n_valid
        st.n_blocks += 1


def _check_shift_ratio(m: "StreamMoments") -> None:
    """Mean-nonstationarity guard (the streamed κ/mean-domination
    analogue of the in-core ``_GRAM_GUARD_RMAX`` recompute).

    The shifted accumulation re-centers by subtracting ``n·δδᵀ`` with
    ``δ = μ − μ̂`` (μ̂ = the first block's mean).  For statistically
    stationary streams r = n·‖δ‖²/tr(Gc) ≈ 0 and every grade holds; a
    stream whose mean DRIFTS (e.g. data sorted by a feature) can push r
    past the grade's rating, where the subtraction cancels
    catastrophically and σ silently fall below grade.  The in-core fits
    recompute with explicit centering when their guard trips
    (distributed.py); a single-pass stream cannot re-read the data, so
    the honest move is to fail loudly — before any model state mutates
    — with the workarounds named.
    """
    from ..errors import LinalgError
    from ..parallel.distributed import _GRAM_GUARD_RMAX

    rmax = _GRAM_GUARD_RMAX[m.precision]
    r = float(m.shift_ratio)
    if r > rmax:
        raise LinalgError(
            f"streamed re-centering is mean-nonstationary beyond the "
            f"gram_precision={m.precision!r} rating (shift ratio "
            f"r={r:.3g} > {rmax:g}): sigma would fall below the "
            "documented grade. Shuffle the stream, raise "
            "gram_precision, or fit() in core"
        )


def _moments_from_state(st: _StreamState, centering: bool) -> StreamMoments:
    g, s, sq = st.carry
    n, n_blocks = st.n, st.n_blocks
    if st.multihost:
        g, s, sq, n, n_blocks = _fold_process_moments(
            g, s, sq, n, n_blocks
        )
    if centering:
        means64, gc, tv, r = _finalize_centered(
            g, s, sq, st.shift, float(n)
        )
        means = means64.astype(st.dtype)
    else:
        means = jnp.zeros((st.d,), st.dtype)
        # Fresh copies, NOT aliases: partial_fit keeps st.carry alive
        # and the next call's _accum_step DONATES it — state installed
        # on the model must never share those buffers (a donated alias
        # turns a previously fitted model's total_variance/gram into a
        # deleted array).
        gc, tv = g.copy(), sq.copy()
        r = jnp.zeros((), jnp.float64)
    m = StreamMoments(
        means, gc, tv, r, n_samples=n, n_blocks=n_blocks,
        dtype=jnp.dtype(st.dtype),
        solve_mesh=st.put_mesh,
        precision=st.precision,
    )
    _check_shift_ratio(m)
    return m


def accumulate_moments(blocks, *, centering: bool = True,
                       block_rows: int | None = None,
                       precision: str = "highest",
                       mesh=None) -> StreamMoments:
    """One streamed pass: (centered) Gram + moments of the whole stream.

    ``blocks`` is an iterable of 2-D row blocks (numpy arrays, lists, or
    anything ``np.asarray`` accepts — e.g. batches read from disk), or a
    single 2-D array-like sliced host-side (``np.memmap`` streams from
    disk without ever materializing in RAM).  With a single-process
    ``mesh``, every chunk is row-sharded across it and the accumulators
    replicate — the reductions compile to local matmuls + one psum, the
    same GSPMD mapping as the in-core sharded fits.  With a mesh
    spanning processes, every process feeds its own local blocks and
    one collective fold sums the per-process moments at the end
    (see :class:`_StreamState`); the call is collective — all processes
    must make it, each with at least one block.

    ``precision`` is the Gram grade (``"auto"`` | ``"default"`` |
    ``"high"`` | ``"highest"``): ``"auto"`` resolves against the
    stream's dtype at the first chunk
    (:func:`_resolve_stream_precision`).

    >>> import numpy as np
    >>> from petal_decomposition_tpu.models.streaming import (
    ...     accumulate_moments)
    >>> x = np.arange(8.0).reshape(4, 2)
    >>> m = accumulate_moments([x[:2], x[2:]], block_rows=2)
    >>> m.n_samples, m.n_blocks
    (4, 2)
    >>> np.asarray(m.means).tolist()  # column means
    [3.0, 4.0]
    >>> xc = x - x.mean(0)
    >>> bool(np.allclose(np.asarray(m.gram), xc.T @ xc))
    True
    >>> float(m.total_variance) == float((xc ** 2).sum())
    True
    """
    block_rows = _resolve_block_rows(block_rows, mesh)
    st = _StreamState(block_rows, mesh)
    chunks = _uniform_chunks(
        _iter_input_blocks(blocks, block_rows), block_rows
    )
    if st.multihost:
        chunks = _multihost_prologue(st, chunks, centering)
    _accumulate_chunks(st, chunks, centering, precision)
    if st.carry is None:
        raise InvalidInput("empty stream: no data blocks")
    return _moments_from_state(st, centering)


def _mesh_key(mesh) -> tuple:
    """jit cache-key suffix: the mesh joins the key so mesh and
    single-device traces never alias."""
    return () if mesh is None else (mesh,)


@partial(jax.jit, static_argnames=("cfg",))
def _exact_solve(gc, cfg=None):
    lam, v, off = eigh_psd_jit_cert(gc)  # ascending
    sigma = jnp.sqrt(jnp.maximum(lam[::-1], 0))
    vt = _flip_components(v[:, ::-1].T)
    return sigma, vt, off


def exact_pca_from_gram(m: StreamMoments, mesh=None):
    """Exact-PCA factors from accumulated moments: ``(sigma, vt, off)``
    descending, at the stream dtype (the covariance eigenproblem of
    ``pca_fit_gram`` without the data-dependent thin-U).

    >>> import numpy as np
    >>> from petal_decomposition_tpu.models.streaming import (
    ...     accumulate_moments, exact_pca_from_gram)
    >>> x = np.random.default_rng(0).standard_normal((200, 4))
    >>> sigma, vt, off = exact_pca_from_gram(accumulate_moments([x]))
    >>> s_ref = np.linalg.svd(x - x.mean(0), compute_uv=False)
    >>> bool(np.max(np.abs(np.asarray(sigma) - s_ref) / s_ref) < 1e-9)
    True
    >>> vt.shape
    (4, 4)
    """
    return _exact_solve(
        m.gram.astype(m.dtype), cfg=config.cache_key() + _mesh_key(mesh)
    )


def randomized_pca_from_gram(m: StreamMoments, key, *, n_components: int,
                             n_oversamples: int, n_power_iters: int,
                             mesh=None):
    """Randomized factors from accumulated moments: the Gram range
    finder's subspace iteration (``ops.gram_recovery.gram_subspace``) plus
    the in-core pipeline's exact recovery reconstructed from the l×l
    algebra of G (see ``_randomized_solve`` — streamed σ match the
    in-core gram-finder fit to ~1e-15 f64 at the same seed).
    Returns ``(sigma, vt, off)`` with ``l`` components.

    >>> import numpy as np
    >>> from petal_decomposition_tpu.models.streaming import (
    ...     accumulate_moments, randomized_pca_from_gram)
    >>> from petal_decomposition_tpu.utils.rng import key_from_seed
    >>> x = np.random.default_rng(1).standard_normal((300, 6))
    >>> sigma, vt, off = randomized_pca_from_gram(
    ...     accumulate_moments([x]), key_from_seed(7),
    ...     n_components=2, n_oversamples=4, n_power_iters=4)
    >>> sigma.shape, vt.shape  # l = 2 + 4 oversamples = d: full rank
    ((6,), (6, 6))
    >>> s_ref = np.linalg.svd(x - x.mean(0), compute_uv=False)
    >>> bool(abs(float(sigma[0]) - s_ref[0]) / s_ref[0] < 1e-9)
    True
    """
    from ..utils import rng as rng_util

    d = m.gram.shape[0]
    l = min(n_components + n_oversamples, m.n_samples, d)
    omega = rng_util.normal(key, (d, l), m.dtype)
    return _randomized_solve(
        m.gram.astype(m.dtype), omega,
        n_power_iters=n_power_iters,
        cfg=config.cache_key() + _mesh_key(mesh),
    )


def _check_stream_solver(model) -> None:
    """Streamed fits read σ off the Gram (κ² accuracy) — an explicit
    ``solver="full"`` asked for the thin-SVD accuracy contract, which a
    single-pass stream cannot deliver.  Reject instead of silently
    downgrading what the user pinned."""
    if getattr(model, "_solver", None) == "full":
        raise InvalidInput(
            "streamed fits are Gram-grade (sigma through the covariance "
            "eigenproblem, kappa^2 sensitivity); solver='full' cannot be "
            "honored in one pass - use solver='gram' or 'auto', or fit() "
            "in core"
        )


def stream_fit_exact(model, blocks, *, block_rows: int | None = None):
    """Shared implementation of ``Pca.fit_batched``."""
    import time

    from ..utils.profiling import FitStats

    _check_stream_solver(model)
    model._stream = None  # a full fit restarts any partial_fit stream
    t0 = time.perf_counter()
    m = accumulate_moments(
        blocks, centering=model._centering, block_rows=block_rows,
        mesh=model._mesh,
    )
    _solve_exact(model, m)
    _install_stats(model, m, t0, FitStats)
    return model


def _stream_gram_precision(model) -> str:
    """Gram-grade setting of the streamed pass for a model (possibly
    still ``"auto"`` — resolved against the stream's dtype at the first
    chunk, :func:`_resolve_stream_precision`).

    ``RandomizedPca(gram_precision=...)``: unlike the in-core Gram
    *range finder* (whose one-pass default is quadratically absorbed by
    the exact-data recovery), the streamed solve reads σ off G's l×l
    algebra, so Gram error lands in σ at first order — which is why
    ``"auto"`` resolves to ``"highest"`` (see
    :func:`_resolve_stream_precision`).  Every grade is protected by
    the mean-nonstationarity guard (:func:`_check_shift_ratio`).
    Models without the knob (``Pca`` — σ² read straight off G) always
    accumulate at ``"highest"``.
    """
    return getattr(model, "_gram_precision", "auto")


def stream_fit_randomized(model, blocks, *, block_rows: int | None = None):
    """Shared implementation of ``RandomizedPca.fit_batched``."""
    import time

    from ..utils.profiling import FitStats

    model._stream = None  # a full fit restarts any partial_fit stream
    t0 = time.perf_counter()
    m = accumulate_moments(
        blocks, centering=model._centering, block_rows=block_rows,
        mesh=model._mesh, precision=_stream_gram_precision(model),
    )
    _solve_randomized(model, m)
    _install_stats(model, m, t0, FitStats)
    return model


def _check_stream_dims(m: StreamMoments, k: int) -> None:
    """Every dimension must be at least n_components (pca.rs:199-204);
    for a stream, n is known only after the pass."""
    if m.gram.shape[0] < k or m.n_samples < k:
        raise InvalidInput(f"every dimension should be at least {k}")


def _solve_exact(model, m: StreamMoments) -> None:
    _check_stream_dims(m, model._n_components)
    sigma, vt, off = exact_pca_from_gram(m, mesh=m.solve_mesh)
    # Certificate before mutation: a failed refit must leave a
    # previously fitted model untouched.
    _linalg.check_certificate(
        off, sigma.dtype, m.gram.shape[0], "eigendecomposition"
    )
    k_full = min(m.n_samples, m.gram.shape[0])
    _install_state(model, m, sigma[:k_full], vt, model._n_components)


def _solve_randomized(model, m: StreamMoments) -> None:
    _check_stream_dims(m, model._n_components)
    # Same stateful-RNG contract as fit(): successive (partial) fits
    # consume successive subkeys (ref: the PCG advances across fits).
    model._key, subkey = jax.random.split(model._key)
    sigma, vt, off = randomized_pca_from_gram(
        m, subkey, n_components=model._n_components,
        n_oversamples=model._n_oversamples,
        n_power_iters=model._n_power_iters,
        mesh=m.solve_mesh,
    )
    _linalg.check_certificate(
        off, sigma.dtype, m.gram.shape[0], "eigendecomposition"
    )
    _install_state(model, m, sigma, vt, model._n_components)


def _install_state(model, m: StreamMoments, sigma, vt, k: int) -> None:
    model._components = vt[:k, :]
    model._means = m.means
    model._singular = sigma[:k]
    model._singular_full = sigma
    model._total_variance = m.total_variance.astype(sigma.dtype)
    model._n_samples = m.n_samples


def _install_stats(model, m: StreamMoments, t0: float, FitStats) -> None:
    import time

    stats = FitStats(
        wall_time_s=time.perf_counter() - t0,
        n_samples=m.n_samples,
        n_features=int(m.gram.shape[0]),
    )
    stats.extra["streamed_blocks"] = m.n_blocks
    stats.extra["mean_shift_ratio"] = float(m.shift_ratio)
    model.last_fit_stats_ = stats


def transform_batched(model, blocks, *, block_rows: int | None = None):
    """Project a stream block-by-block with the fitted model; returns
    the stacked (n, k) host array.  Re-buffers to uniform chunks so the
    projection compiles once."""
    if block_rows is None:
        block_rows = _DEFAULT_BLOCK_ROWS
    _check_block_rows(block_rows)
    outs = []
    seen = False
    for chunk, n_valid in _uniform_chunks(
        _iter_input_blocks(blocks, block_rows), block_rows,
        pad_tail=False,
    ):
        seen = True
        y = model.transform(chunk)
        outs.append(np.asarray(y[:n_valid]))
    if not seen:
        raise InvalidInput("empty stream: no data blocks")
    return np.concatenate(outs, axis=0)


def partial_fit_step(model, x_block, *, block_rows: int | None,
                     solve) -> None:
    """Shared ``partial_fit`` implementation: accumulate one more block
    into the model's persistent stream state, then re-finalize and
    re-solve so the model is consistently fitted after every call
    (sklearn ``IncrementalPCA`` semantics).  The re-solve is d-sized
    (l×l / d×d eigensolves), so per-call cost is one block pass plus a
    small factorization.

    Retry safety: this call's chunks are materialized and validated
    BEFORE anything is accumulated, so a malformed block (or a raising
    user generator) leaves the stream untouched.  Zero new rows on an
    existing SINGLE-PROCESS stream is a no-op (no PRNG subkey is
    consumed, the fitted state and stats are unchanged); in multi-host
    mode the call is collective, so a zero-new-rows call still joins
    the fold and re-solve — consuming a subkey on every process
    equally.  If the SOLVE fails, the accumulated rows legitimately
    remain in the stream (the model itself is untouched); the next
    successful call includes them."""
    import time

    from ..utils.profiling import FitStats

    t0 = time.perf_counter()
    _check_stream_solver(model)
    st = getattr(model, "_stream", None)
    if st is None:
        st = _StreamState(
            _resolve_block_rows(block_rows, model._mesh), model._mesh
        )
        model._stream = st
    elif (
        block_rows is not None
        and _resolve_block_rows(block_rows, model._mesh) != st.block_rows
    ):
        raise InvalidInput(
            f"block_rows is fixed at {st.block_rows} by the first "
            "partial_fit call (one compiled step per stream)"
        )

    chunks = list(_uniform_chunks(
        _iter_input_blocks(x_block, st.block_rows), st.block_rows,
        dtype_hint=st.dtype,
    ))
    if not chunks and st.carry is not None and not st.multihost:
        # Nothing new: no-op.  Single-process only — a multi-host
        # partial_fit is collective (every process joins the fold
        # below), so it proceeds to re-solve even with zero new rows.
        return
    if st.multihost and st.carry is None:
        chunks = list(
            _multihost_prologue(st, iter(chunks), model._centering)
        )
    _accumulate_chunks(
        st, chunks, model._centering, _stream_gram_precision(model)
    )
    if st.carry is None:
        raise InvalidInput("empty stream: no data blocks")
    st.calls += 1
    m = _moments_from_state(st, model._centering)
    solve(model, m)
    _install_stats(model, m, t0, FitStats)
    model.last_fit_stats_.extra["partial_fit_calls"] = st.calls


# -- streamed FastICA (two passes) -------------------------------------


def _reiterable_factory(data, step: int):
    """A zero-arg factory over ``data``'s blocks, for algorithms that
    need TWO passes.  2-D array-likes re-slice, sequences re-iterate,
    callables re-invoke; a one-shot iterator cannot replay and is
    rejected with the workaround spelled out."""
    if hasattr(data, "ndim") and getattr(data, "ndim", None) == 2:
        return lambda: _iter_input_blocks(data, step)
    if callable(data):
        return data
    try:
        one_shot = iter(data) is data
    except TypeError as e:
        raise InvalidInput(
            f"expected a 2-D array-like, a sequence of blocks, or a "
            f"callable returning the block stream; got {type(data).__name__}"
        ) from e
    if one_shot:
        raise InvalidInput(
            "streamed FastICA reads the data twice (moments pass, then "
            "the whitened-fill pass) but got a one-shot iterator; pass "
            "a 2-D array-like (e.g. np.memmap), a list of blocks, or a "
            "zero-arg callable returning a fresh iterator"
        )
    return lambda: iter(data)


def _hbm_bytes_limit() -> int | None:
    """The accelerator's memory budget for the whitened buffer.  Env
    ``PETAL_STREAM_ICA_HBM_BYTES`` overrides (also how tests pin the
    error path); on backends that expose no ``bytes_limit`` (CPU —
    where host RAM is the working bound) the check is skipped."""
    import os

    env = os.environ.get("PETAL_STREAM_ICA_HBM_BYTES")
    if env:
        return int(env)
    try:
        stats = jax.local_devices()[0].memory_stats()
        if stats and stats.get("bytes_limit"):
            return int(stats["bytes_limit"])
    except Exception:
        pass
    return None


def _check_ica_buffer_budget(k: int, n: int, dtype,
                             n_devices: int = 1) -> None:
    """The fit keeps X₁ (k×n) resident plus ~3 k×n iteration
    temporaries (W·X₁, g(W·X₁), and the update's read of X₁ᵀ).  On a
    mesh the buffer is column-sharded, so the per-device footprint
    divides by the device count."""
    limit = _hbm_bytes_limit()
    if limit is None:
        return
    need = 4 * k * n * jnp.dtype(dtype).itemsize // n_devices
    if need > limit:
        per_dev = f" per device (mesh of {n_devices})" if n_devices > 1 else ""
        raise InvalidInput(
            f"streamed FastICA keeps the whitened k x n matrix on "
            f"device: {k} x {n} {jnp.dtype(dtype).name} needs "
            f"~{need / 2**30:.1f} GiB{per_dev} (4 k n itemsize) but the "
            f"device reports {limit / 2**30:.1f} GiB; reduce "
            f"n_components or the sample count, or shard over a larger "
            f"mesh"
        )


@partial(jax.jit, donate_argnums=(0,))
def _fill_whitened(buf, block, kmat, means, offset, scale):
    """Write ``K·(block − μ)ᵀ·scale`` into ``buf[:, offset:]`` in place
    (donated).  ``offset`` is a device scalar so every full-size block
    reuses one compiled program."""
    y = mdot(kmat, (block - means.astype(block.dtype)).T) * scale
    return jax.lax.dynamic_update_slice(
        buf, y.astype(buf.dtype), (jnp.zeros((), offset.dtype), offset)
    )


@partial(jax.jit, donate_argnums=(0,))
def _fill_transposed(buf, block, offset):
    """``whiten=False`` fill: the raw transposed block."""
    return jax.lax.dynamic_update_slice(
        buf,
        block.T.astype(buf.dtype),
        (jnp.zeros((), offset.dtype), offset),
    )


def _fill_pass(factory, block_rows: int, n: int, d: int, dtype,
               fill_chunk, *, pad_tail: bool = False,
               tail_multiple: int | None = None,
               put=None) -> None:
    """Second streamed pass: feed every chunk through
    ``fill_chunk(device_chunk, col_offset, n_valid)``, validating that
    the stream replayed identically to pass 1.  Host-side work and H2D
    run on the :func:`_device_prefetch` worker (the same pipeline as
    pass 1's accumulator) while this loop only dispatches fills.

    ``pad_tail=False`` yields the tail at its true size (at most two
    compiled fill shapes); ``pad_tail=True`` pads the final partial
    chunk to ``tail_multiple`` (mesh-aligned sharding; the callback
    masks via ``n_valid``) or to full ``block_rows`` height when
    ``tail_multiple`` is None.  ``put`` overrides the device placement
    (e.g. row-sharded on a mesh)."""
    put = jax.device_put if put is None else put
    filled = 0
    chunks = _uniform_chunks(
        _iter_input_blocks(factory(), block_rows), block_rows,
        pad_tail=pad_tail, dtype_hint=dtype, tail_multiple=tail_multiple,
    )
    for dev, n_valid, width in _device_prefetch(chunks, put):
        if width != d:
            raise InvalidInput(
                f"stream changed between passes: expected {d} columns, "
                f"got {width}"
            )
        if filled + n_valid > n:
            raise InvalidInput(
                "stream changed between passes: more rows on the second "
                f"pass than the {n} accumulated on the first"
            )
        fill_chunk(dev, filled, n_valid)
        filled += n_valid
    if filled != n:
        raise InvalidInput(
            f"stream changed between passes: {filled} rows on the "
            f"second pass vs {n} on the first"
        )


def stream_fit_fast_ica(model, data, *, block_rows: int | None = None):
    """Shared implementation of ``FastIca.fit_batched`` (two passes;
    module docstring has the scheme).  Matches the in-core
    ``whiten_solver="eigh"`` fit at the same key: pass 1's f64 shifted
    Gram IS the in-core whitening Gram, the key-split order is
    identical, and ``ica_par`` runs on the same X₁ up to accumulation
    roundoff."""
    import time

    from ..utils.profiling import FitStats
    from . import fast_ica as fi

    mesh = model._mesh
    if _mesh_spans_processes(mesh):
        raise InvalidInput(
            "streamed FastICA supports single-process meshes only "
            "(the whitened k x n buffer is device-resident; a "
            "multi-host column sharding would need per-process "
            "column feeds)"
        )
    if model._whiten and model._whiten_solver == "svd":
        # Same contract as _check_stream_solver: an explicit "svd"
        # pinned thin-SVD whitening (κ sensitivity); the stream only
        # has the Gram (κ²).  Reject rather than silently downgrade.
        # ("auto" resolves to the Gram/eigh route here by definition.)
        raise InvalidInput(
            "streamed FastICA whitens from the accumulated Gram "
            "(eigh, kappa^2 sensitivity); whiten_solver='svd' cannot "
            "be honored in a stream - use 'eigh' or 'auto', or fit() "
            "in core"
        )
    t0 = time.perf_counter()
    block_rows = _resolve_block_rows(block_rows, mesh)
    factory = _reiterable_factory(data, block_rows)

    if not model._whiten:
        if mesh is not None:
            raise InvalidInput(
                "whiten=False streamed fits are single-device (the "
                "square d x d unmixing leaves nothing to shard over "
                "sources); drop the mesh"
            )
        return _stream_fit_no_whiten(
            model, factory, block_rows, t0, FitStats, fi
        )

    m = accumulate_moments(
        factory(), centering=True, block_rows=block_rows, mesh=mesh
    )
    n, d = m.n_samples, int(m.gram.shape[0])
    k = min(n, d)
    if model._n_components is not None:
        if model._n_components > k:
            raise InvalidInput(f"n_components should be at most {k}")
        k = model._n_components
    if k == 0:  # n_components=0: mirror the in-core degenerate fit
        model._components = jnp.zeros((0, d), m.dtype)
        model._means = m.means
        model._n_iter = 0
        _install_stats(model, m, t0, FitStats)
        return model

    kmat, _sigma, off = fi.whitening_from_gram(
        m.gram.astype(m.dtype), k, max(n, d)
    )
    _linalg.check_certificate(off, m.dtype, d, "eigendecomposition")

    model._key, subkey = jax.random.split(model._key)
    from ..utils import rng as rng_util

    w_init = rng_util.normal(subkey, (k, k), m.dtype)
    ica_kwargs = dict(
        fun=model._fun,
        decorrelation=fi.resolve_decorrelation(model._decorrelation),
        precision=fi.resolve_iteration_precision(
            model._iteration_precision, m.dtype
        ),
    )
    if mesh is not None:
        w, n_iter, buf_cols = _ica_mesh_fill_and_iterate(
            model, factory, block_rows, m, k, kmat, w_init, mesh,
            fi, ica_kwargs,
        )
    else:
        buf_cols = n
        _check_ica_buffer_budget(k, n, m.dtype)
        buf = jnp.zeros((k, n), m.dtype)
        scale = jnp.asarray(np.sqrt(n), m.dtype)
        means_dev = jax.device_put(m.means)
        kmat_dev = kmat

        def fill_chunk(dev, offset, _n_valid):
            nonlocal buf
            buf = _fill_whitened(
                buf, dev, kmat_dev, means_dev,
                jnp.asarray(offset, jnp.int32), scale,
            )

        _fill_pass(factory, block_rows, n, d, m.dtype, fill_chunk)
        w, n_iter = fi.ica_par(
            buf, model._tol, model._max_iter, w_init, **ica_kwargs
        )
    fi.check_decorrelation(w)
    model._components = mdot(w, kmat)
    model._means = m.means
    model._n_iter = n_iter
    _install_stats(model, m, t0, FitStats)
    model.last_fit_stats_.n_iter = n_iter
    model.last_fit_stats_.extra["whitened_buffer_cols"] = buf_cols
    return model


@partial(jax.jit, donate_argnums=(0,))
def _fill_whitened_masked(buf, block, kmat, means, offset, scale, n_valid):
    """Mesh-path fill: padded (invalid) rows of the chunk are zeroed so
    their columns land as zeros — matching the buffer's column padding
    that ``_ica_par_core``'s ``n_valid`` masks out of every statistic."""
    rows = (jnp.arange(block.shape[0]) < n_valid)[:, None]
    xb = jnp.where(rows, block - means.astype(block.dtype), 0)
    y = mdot(kmat, xb.T) * scale
    return jax.lax.dynamic_update_slice(
        buf, y.astype(buf.dtype), (jnp.zeros((), offset.dtype), offset)
    )


def _ica_mesh_fill_and_iterate(model, factory, block_rows: int, m, k: int,
                               kmat, w_init, mesh, fi, ica_kwargs):
    """Single-process-mesh streamed ICA: the whitened buffer is
    column-sharded over the mesh (per-device footprint ÷ mesh.size —
    the k×n HBM bound scales with the mesh), chunks arrive row-sharded
    (the tail chunk pads only to the next ``mesh.size`` multiple, so
    the buffer carries at most mesh.size−1 dead columns instead of up
    to a whole block), and the unchanged ``_ica_par_core`` runs with
    ``n_valid`` masking the padded tail columns — GSPMD turns its
    sample-axis reductions into psums exactly like the in-core mesh
    fit."""
    from jax.sharding import NamedSharding, PartitionSpec

    from ..config import config as _cfg
    from ..parallel.mesh import replicated_sharding, row_sharding

    n, d = m.n_samples, int(m.gram.shape[0])
    # Full chunks stay block_rows tall (one compiled fill); only the
    # tail pads, and only to the next mesh.size multiple.
    full = (n // block_rows) * block_rows
    tail = n - full
    n_pad = full + (-(-tail // mesh.size) * mesh.size if tail else 0)
    _check_ica_buffer_budget(k, n_pad, m.dtype, mesh.size)

    col_sh = NamedSharding(mesh, PartitionSpec(None, mesh.axis_names[0]))
    buf = jax.device_put(jnp.zeros((k, n_pad), m.dtype), col_sh)
    scale = jnp.asarray(np.sqrt(n), m.dtype)
    put_repl = partial(jax.device_put, device=replicated_sharding(mesh))
    put_rows = partial(jax.device_put, device=row_sharding(mesh))
    kmat_r = put_repl(kmat)
    means_r = put_repl(m.means)

    def fill_chunk(dev, offset, n_valid):
        # Offsets stay block-aligned: every chunk but the (shorter,
        # mesh-multiple) tail is exactly block_rows tall.
        nonlocal buf
        buf = _fill_whitened_masked(
            buf, dev, kmat_r, means_r,
            jnp.asarray(offset, jnp.int32), scale,
            jnp.asarray(n_valid, jnp.int32),
        )

    _fill_pass(factory, block_rows, n, d, m.dtype, fill_chunk,
               pad_tail=True, tail_multiple=mesh.size, put=put_rows)

    w, _, n_iter = fi._ica_par_core(
        buf, jnp.asarray(model._tol, m.dtype), int(model._max_iter),
        w_init, ica_kwargs["fun"],
        n_valid=n if n != n_pad else None,
        decorrelation=ica_kwargs["decorrelation"],
        precision=ica_kwargs["precision"],
        cfg=_cfg.cache_key() + (mesh,),
    )
    return w, int(n_iter), n_pad


def _stream_fit_no_whiten(model, factory, block_rows: int, t0,
                          FitStats, fi):
    """``whiten=False`` streamed fit: the data is certified pre-centered
    and pre-whitened, so pass 1 only measures the stream's extent (no
    Gram) and pass 2 fills the d×n transposed buffer ``ica_par`` runs
    on."""
    n = 0
    d = None
    dtype = None
    n_blocks = 0
    for chunk, n_valid in _uniform_chunks(
        _iter_input_blocks(factory(), block_rows), block_rows,
        pad_tail=False,
    ):
        if d is None:
            d, dtype = chunk.shape[1], chunk.dtype
        n += n_valid
        n_blocks += 1
    if d is None:
        raise InvalidInput("empty stream: no data blocks")
    if n == 0 or d == 0:
        raise InvalidInput(
            "whiten=False requires non-empty data (the square "
            "d x d unmixing W is undefined for empty input)"
        )
    _check_ica_buffer_budget(d, n, dtype)

    buf = jnp.zeros((d, n), dtype)

    def fill_chunk(dev, offset, _n_valid):
        nonlocal buf
        buf = _fill_transposed(buf, dev, jnp.asarray(offset, jnp.int32))

    _fill_pass(factory, block_rows, n, d, dtype, fill_chunk)

    model._key, subkey = jax.random.split(model._key)
    from ..utils import rng as rng_util

    w_init = rng_util.normal(subkey, (d, d), dtype)
    w, n_iter = fi.ica_par(
        buf, model._tol, model._max_iter, w_init, fun=model._fun,
        decorrelation=fi.resolve_decorrelation(model._decorrelation),
        precision=fi.resolve_iteration_precision(
            model._iteration_precision, dtype
        ),
    )
    fi.check_decorrelation(w)
    model._components = w
    model._means = jnp.zeros((d,), jnp.asarray(buf).real.dtype)
    model._n_iter = n_iter
    stats = FitStats(
        wall_time_s=__import__("time").perf_counter() - t0,
        n_samples=n, n_features=d,
    )
    stats.n_iter = n_iter
    stats.extra["streamed_blocks"] = n_blocks
    model.last_fit_stats_ = stats
    return model
