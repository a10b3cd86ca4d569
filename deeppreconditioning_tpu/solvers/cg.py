"""Conjugate gradient and preconditioned CG as compiled XLA loops.

Numeric contract = reference cg.py (uibk/deep_preconditioning/cg.py:15-90):
  * stopping criterion is the *squared* relative residual
    ``(r.r) / (b.b) < rtol`` with default rtol = 1e-8, max 1024 iterations;
  * the preconditioner is applied as a matvec ``z = M @ r`` with
    ``M = L L^T ~ A^{-1}`` (cg.py:81) — matrix-free here: any callable;
  * identical update order: Ap, rz, alpha = rz/(Ap.p), x, r, z, beta, p.

Shape: the loop is a ``lax.while_loop`` with every dot product an
on-device reduction — zero host synchronization until the result is
fetched.  The matvec/apply callables take their operator data as an
explicit pytree argument ``matvec(a_data, x)`` so solvers compile once per
*shape*, not once per matrix: a benchmark sweep over hundreds of matrices
hits one cached executable.  In the distributed path the matvec closes
over a shard_map SpMV and dots become psums (parallel/pcg.py); this module
is mesh-agnostic.

Precision: every contraction in the iteration (``_dot``, ``_dots``,
``dense_matvec``) asks for HIGHEST — a float32 product with no precision
set may run in TF32 on the GPU, which keeps about three decimal digits
and would stall the 1e-8 stopping rule.

The reference seeds its initial residual check with ``z`` instead of ``r``
(cg.py:66) — an upstream quirk we do not reproduce; we check ``r`` both
before and inside the loop, which only matters for systems already
converged at x0.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp


_HIGHEST = jax.lax.Precision.HIGHEST


def _dot(u: jax.Array, v: jax.Array) -> jax.Array:
    return jnp.dot(u, v, precision=_HIGHEST)


def _dots(u: jax.Array, v: jax.Array) -> jax.Array:
    """Per-case dot products of two (B, n) stacks."""
    return jnp.einsum("bn,bn->b", u, v, precision=_HIGHEST)


class CGResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array  # int32 scalar
    residual: jax.Array  # final (r.r)/(b.b)


def identity_apply(m_data: Any, r: jax.Array) -> jax.Array:
    """Vanilla 'preconditioner' (test.py:70-72): z = r."""
    del m_data
    return r


def dense_matvec(a: jax.Array, x: jax.Array) -> jax.Array:
    return jnp.matmul(a, x, precision=_HIGHEST)


def ell_matvec(a, x: jax.Array) -> jax.Array:
    """Matvec for sparse/ell.py ELLMatrix operands."""
    return a.matvec(x)


@partial(
    jax.jit,
    static_argnames=("matvec", "apply_m", "max_iter", "check_every"),
)
def preconditioned_conjugate_gradient(
    matvec: Callable[[Any, jax.Array], jax.Array],
    a_data: Any,
    b: jax.Array,
    apply_m: Callable[[Any, jax.Array], jax.Array] = identity_apply,
    m_data: Any = None,
    rtol: float = 1e-8,
    max_iter: int = 1024,
    check_every: int = 64,
) -> CGResult:
    """Solve A x = b with PCG; preconditioner as matvec (cg.py:50-90).

    Loop structure is chunked: a fixed-trip ``fori_loop`` of
    ``check_every`` *masked* iterations per chunk, with the
    data-dependent convergence check only in the outer ``while_loop``,
    whose condition costs a device-to-host round trip per evaluation.
    Masked updates freeze the state after convergence, so iteration
    counts and results are identical to the per-iteration-check loop.
    """
    x = jnp.zeros_like(b)
    r = b - matvec(a_data, x)
    z = apply_m(m_data, r)
    p = z
    bb = _dot(b, b)
    bb = jnp.where(bb == 0, 1.0, bb)

    def masked_iter(state):
        x, r, z, p, k, done = state
        frozen = jnp.logical_or(done, k >= max_iter)
        ap = matvec(a_data, p)
        rz = _dot(r, z)
        denom = _dot(ap, p)
        alpha = jnp.where(frozen, 0.0, rz / denom)
        x = x + alpha * p
        r_new = jnp.where(frozen, r, r - alpha * ap)
        z_new = jnp.where(frozen, z, apply_m(m_data, r_new))
        beta = jnp.where(frozen, 0.0, _dot(r_new, z_new) / rz)
        p = jnp.where(frozen, p, z_new + beta * p)
        k = jnp.where(frozen, k, k + 1)
        done = jnp.logical_or(done, _dot(r_new, r_new) / bb < rtol)
        return (x, r_new, z_new, p, k, done)

    def chunk(state):
        return jax.lax.fori_loop(
            0, check_every, lambda i, s: masked_iter(s), state
        )

    def cond(state):
        *_, k, done = state
        return jnp.logical_and(jnp.logical_not(done), k < max_iter)

    init_done = _dot(r, r) / bb < rtol
    state = (x, r, z, p, jnp.int32(0), init_done)
    x, r, z, p, k, done = jax.lax.while_loop(cond, chunk, state)
    return CGResult(x=x, iterations=k, residual=_dot(r, r) / bb)


@partial(
    jax.jit,
    static_argnames=("matvec", "apply_m", "max_iter", "check_every"),
)
def batched_preconditioned_conjugate_gradient(
    matvec: Callable[[Any, jax.Array], jax.Array],
    a_data: Any,
    b: jax.Array,
    apply_m: Callable[[Any, jax.Array], jax.Array] = identity_apply,
    m_data: Any = None,
    rtol: float = 1e-8,
    max_iter: int = 1024,
    check_every: int = 8,
) -> CGResult:
    """Solve B independent systems A_i x_i = b_i in ONE compiled dispatch.

    The reference benchmarks 100 same-shape cases one solve at a time
    (test.py:119-155), which pins every case to a per-dispatch floor
    regardless of iteration count.  Batching the whole test split into a
    single while_loop amortizes that floor across the batch: per-iteration work is (B, n)-shaped, every CG scalar is a
    per-case ``einsum('bn,bn->b')`` reduction, and convergence is tracked
    per case with masked updates (converged cases freeze, so per-case
    iteration counts are identical to the per-case solver's; the batch
    runs until all cases are done).

    Args:
        matvec: batched SpMV ``(a_data, x(B,n)) -> (B,n)``.
        a_data: stacked operator pytree (leading batch dim).
        b: (B, n) stacked right-hand sides.
        apply_m: batched preconditioner apply ``(m_data, r(B,n)) -> (B,n)``.

    Returns CGResult with x (B, n), iterations (B,) int32, residual (B,).
    """
    dots = _dots
    x = jnp.zeros_like(b)
    r = b - matvec(a_data, x)
    z = apply_m(m_data, r)
    p = z
    bb = dots(b, b)
    bb = jnp.where(bb == 0, 1.0, bb)

    def masked_iter(state):
        x, r, z, p, k, done = state
        frozen = jnp.logical_or(done, k >= max_iter)  # (B,)
        fz = frozen[:, None]
        ap = matvec(a_data, p)
        rz = dots(r, z)
        denom = dots(ap, p)
        alpha = jnp.where(frozen, 0.0, rz / denom)
        x = x + alpha[:, None] * p
        r_new = jnp.where(fz, r, r - alpha[:, None] * ap)
        z_new = jnp.where(fz, z, apply_m(m_data, r_new))
        beta = jnp.where(frozen, 0.0, dots(r_new, z_new) / rz)
        p = jnp.where(fz, p, z_new + beta[:, None] * p)
        k = jnp.where(frozen, k, k + 1)
        done = jnp.logical_or(done, dots(r_new, r_new) / bb < rtol)
        return (x, r_new, z_new, p, k, done)

    def chunk(state):
        return jax.lax.fori_loop(
            0, check_every, lambda i, s: masked_iter(s), state
        )

    def cond(state):
        *_, k, done = state
        return jnp.any(jnp.logical_and(jnp.logical_not(done), k < max_iter))

    init_done = dots(r, r) / bb < rtol
    k0 = jnp.zeros(b.shape[0], jnp.int32)
    state = (x, r, z, p, k0, init_done)
    x, r, z, p, k, done = jax.lax.while_loop(cond, chunk, state)
    return CGResult(x=x, iterations=k, residual=dots(r, r) / bb)


@partial(
    jax.jit,
    static_argnames=("matvec", "apply_m", "max_iter", "trips"),
)
def batched_pcg_fixed_trips(
    matvec: Callable[[Any, jax.Array], jax.Array],
    a_data: Any,
    b: jax.Array,
    apply_m: Callable[[Any, jax.Array], jax.Array] = identity_apply,
    m_data: Any = None,
    rtol: float = 1e-8,
    max_iter: int = 1024,
    trips: int = 8,
) -> CGResult:
    """Batched PCG with a FIXED trip count — no data-dependent while.

    Same masked per-case semantics as
    ``batched_preconditioned_conjugate_gradient`` (identical per-case
    iteration counts and solutions when ``trips`` covers the slowest
    case), but the loop is a fixed ``fori_loop`` with no data-dependent
    while condition (one device-to-host round trip per evaluation): the
    benchmark warm-up measures the needed trips once (untimed, like
    compilation) and the timed dispatch runs conditionals-free.
    Convergence is still verified post-hoc via the returned residuals —
    a case that fails to converge within ``trips`` reports
    iterations == trips and residual >= rtol.
    """
    dots = _dots
    x = jnp.zeros_like(b)
    r = b - matvec(a_data, x)
    z = apply_m(m_data, r)
    p = z
    bb = dots(b, b)
    bb = jnp.where(bb == 0, 1.0, bb)

    def masked_iter(_, state):
        x, r, z, p, k, done = state
        frozen = jnp.logical_or(done, k >= max_iter)  # (B,)
        fz = frozen[:, None]
        ap = matvec(a_data, p)
        rz = dots(r, z)
        denom = dots(ap, p)
        alpha = jnp.where(frozen, 0.0, rz / denom)
        x = x + alpha[:, None] * p
        r_new = jnp.where(fz, r, r - alpha[:, None] * ap)
        z_new = jnp.where(fz, z, apply_m(m_data, r_new))
        beta = jnp.where(frozen, 0.0, dots(r_new, z_new) / rz)
        p = jnp.where(fz, p, z_new + beta[:, None] * p)
        k = jnp.where(frozen, k, k + 1)
        done = jnp.logical_or(done, dots(r_new, r_new) / bb < rtol)
        return (x, r_new, z_new, p, k, done)

    init_done = dots(r, r) / bb < rtol
    k0 = jnp.zeros(b.shape[0], jnp.int32)
    state = (x, r, z, p, k0, init_done)
    x, r, z, p, k, done = jax.lax.fori_loop(
        0, trips, masked_iter, state
    )
    return CGResult(x=x, iterations=k, residual=dots(r, r) / bb)


@partial(jax.jit,
         static_argnames=("matvec", "apply_m", "max_iter", "trips"))
def pcg_fixed_trips(
    matvec: Callable[[Any, jax.Array], jax.Array],
    a_data: Any,
    b: jax.Array,
    apply_m: Callable[[Any, jax.Array], jax.Array] = identity_apply,
    m_data: Any = None,
    rtol: float = 1e-8,
    max_iter: int = 1024,
    trips: int = 8,
) -> CGResult:
    """Single-system fixed-trip PCG — flat (n,) twin of
    ``batched_pcg_fixed_trips``.

    Exists because wrapping a single large system as a B=1 batch adds a
    (1, n) leading dim to every shifted-slice factor apply.  Same
    masked-freeze semantics, so
    iteration counts and convergence flags match the while-loop solver
    when ``trips`` covers the solve.
    """
    x = jnp.zeros_like(b)
    r = b - matvec(a_data, x)
    z = apply_m(m_data, r)
    p = z
    bb = _dot(b, b)
    bb = jnp.where(bb == 0, 1.0, bb)

    def masked_iter(_, state):
        x, r, z, p, k, done = state
        frozen = jnp.logical_or(done, k >= max_iter)
        ap = matvec(a_data, p)
        rz = _dot(r, z)
        denom = _dot(ap, p)
        alpha = jnp.where(frozen, 0.0, rz / denom)
        x = x + alpha * p
        r_new = jnp.where(frozen, r, r - alpha * ap)
        z_new = jnp.where(frozen, z, apply_m(m_data, r_new))
        beta = jnp.where(frozen, 0.0,
                         _dot(r_new, z_new) / rz)
        p = jnp.where(frozen, p, z_new + beta * p)
        k = jnp.where(frozen, k, k + 1)
        done = jnp.logical_or(done, _dot(r_new, r_new) / bb < rtol)
        return (x, r_new, z_new, p, k, done)

    init_done = _dot(r, r) / bb < rtol
    state = (x, r, z, p, jnp.int32(0), init_done)
    x, r, z, p, k, done = jax.lax.fori_loop(
        0, trips, masked_iter, state
    )
    return CGResult(x=x, iterations=k, residual=_dot(r, r) / bb)


@partial(jax.jit,
         static_argnames=("matvec", "apply_m", "max_iter", "trips"))
def pcg_sequence_fixed_trips(
    matvec: Callable[[Any, jax.Array], jax.Array],
    a_data: Any,
    b_seq: jax.Array,  # (k, n) rhs sequence, solved in order
    apply_m: Callable[[Any, jax.Array], jax.Array] = identity_apply,
    m_data: Any = None,
    rtol: float = 1e-8,
    max_iter: int = 1024,
    trips: int = 8,
):
    """K sequential solves of ONE operator (multi-RHS / time-stepping
    protocol) in a single dispatch.

    The reference's production shape: the pressure operator is reused
    across every PIMPLE corrector of a time step while the rhs evolves
    (newInterFoam.C:145-148, pEqn.H:43-49) — the preconditioner setup
    amortizes over the sequence.  Implemented as a ``lax.scan`` over
    the rhs stack with the flat fixed-trip solver body (each solve
    starts from x0 = 0, matching the reference's cg.py:58 cold start).

    Returns (x_seq (k, n), iterations (k,), residuals (k,)).
    """
    def one(carry, b_t):
        res = pcg_fixed_trips(
            matvec, a_data, b_t, apply_m, m_data,
            rtol=rtol, max_iter=max_iter, trips=trips,
        )
        return carry, (res.x, res.iterations, res.residual)

    _, (xs, its, ress) = jax.lax.scan(one, 0, b_seq)
    return xs, its, ress


def conjugate_gradient(
    matvec: Callable[[Any, jax.Array], jax.Array],
    a_data: Any,
    b: jax.Array,
    rtol: float = 1e-8,
    max_iter: int = 1024,
) -> CGResult:
    """Plain CG (cg.py:20-47) — PCG with the identity preconditioner."""
    return preconditioned_conjugate_gradient(
        matvec, a_data, b, identity_apply, None, rtol=rtol, max_iter=max_iter
    )


def benchmark_cg(matrix, right_hand_side, preconditioner=None):
    """scipy-CG benchmark wrapper — behavioral port of the reference
    ``benchmark_cg`` (uibk/deep_preconditioning/utils.py:46-76): scipy
    defaults, maxiter=512, iteration count via callback.

    Returns (duration_seconds, iterations, info).
    """
    import time as _time

    from scipy.sparse.linalg import cg as _scipy_cg

    iterations = 0

    def _callback(_):
        nonlocal iterations
        iterations += 1

    start_time = _time.perf_counter()
    _, info = _scipy_cg(
        matrix,
        right_hand_side,
        maxiter=512,
        M=preconditioner,
        callback=_callback,
    )
    duration = _time.perf_counter() - start_time
    return duration, iterations, info


@partial(jax.jit, static_argnames=("matvec", "apply_m", "max_iter"))
def pcg_with_history(
    matvec: Callable[[Any, jax.Array], jax.Array],
    a_data: Any,
    b: jax.Array,
    apply_m: Callable[[Any, jax.Array], jax.Array] = identity_apply,
    m_data: Any = None,
    rtol: float = 1e-8,
    max_iter: int = 1024,
):
    """PCG via lax.scan returning the full relative-residual curve.

    Fixed trip count with masked updates (XLA-friendly); history[i] is the
    squared relative residual *after* i+1 iterations, held at the final
    value once converged.  Used for residual-curve parity checks against
    the reference protocol (BASELINE.md).
    """
    x = jnp.zeros_like(b)
    r = b - matvec(a_data, x)
    z = apply_m(m_data, r)
    p = z
    bb = _dot(b, b)
    bb = jnp.where(bb == 0, 1.0, bb)

    def step(state, _):
        x, r, z, p, k, done = state
        ap = matvec(a_data, p)
        rz = _dot(r, z)
        denom = _dot(ap, p)
        alpha = jnp.where(done, 0.0, rz / denom)
        x = x + alpha * p
        r_new = jnp.where(done, r, r - alpha * ap)
        z_new = jnp.where(done, z, apply_m(m_data, r_new))
        beta = jnp.where(done, 0.0, _dot(r_new, z_new) / rz)
        p = jnp.where(done, p, z_new + beta * p)
        res = _dot(r_new, r_new) / bb
        k = jnp.where(done, k, k + 1)
        done = jnp.logical_or(done, res < rtol)
        return (x, r_new, z_new, p, k, done), res

    init_done = _dot(r, r) / bb < rtol
    (x, r, z, p, k, done), history = jax.lax.scan(
        step, (x, r, z, p, jnp.int32(0), init_done), None, length=max_iter
    )
    return CGResult(x=x, iterations=k, residual=_dot(r, r) / bb), history
