"""Training losses and quality metrics for learned preconditioners.

Functional ports of the reference's four loss candidates
(uibk/deep_preconditioning/metrics.py:13-100) over the framework's batched
containers.  Sparse inputs arrive as (values, rows, cols, valid) bundles —
the batched output of models/precond_net.py — or as BatchedCOO; densified
paths pad n to a fixed multiple so the batched matmuls tile cleanly.

All functions are jit/vmap/grad-safe.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from deeppreconditioning_tpu.sparse.coo import BatchedCOO, batched_coo_matvec

# HIGHEST: a float32 contraction with no precision set may run in TF32 on
# the GPU (about three decimal digits)
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def scatter_tril_dense(
    values: jax.Array,  # (B, nnz_pad)
    rows: jax.Array,  # (B, nnz_pad)
    cols: jax.Array,
    valid: jax.Array,
    n: int,
) -> jax.Array:
    """Scatter batched sparse tril values into dense (B, n, n).

    Sites outside [0, n) (the conv dilation can step off the matrix) and
    padded sites are dropped.
    """
    ok = valid & (rows < n) & (cols < n) & (rows >= 0) & (cols >= 0)
    vals = jnp.where(ok, values, 0.0)
    r = jnp.clip(rows, 0, n - 1)
    c = jnp.clip(cols, 0, n - 1)

    def scatter_one(v, r, c):
        return jnp.zeros((n, n), v.dtype).at[r, c].add(v)

    return jax.vmap(scatter_one)(vals, r, c)


def symmetrize_tril(a_tril: jax.Array) -> jax.Array:
    """(B, n, n) tril -> full symmetric A (metrics.py:47-48)."""
    return a_tril + jnp.tril(a_tril, -1).transpose(0, 2, 1)


def inverse_loss(
    systems_tril_dense: jax.Array,  # (B, n, n) lower-triangular A part
    l_dense: jax.Array,  # (B, n, n) lower-triangular factor L
) -> jax.Array:
    """Mean Frobenius distance of (L L^T) A from the identity.

    The training objective of the reference (train.py:59; metrics.py:34-55):
    densify, M = L L^T, A = tril + strict-tril^T, mean_b ||M A - I||_F.
    """
    m = _einsum("bij,bkj->bik", l_dense, l_dense)
    a = symmetrize_tril(systems_tril_dense)
    ma = _einsum("bij,bjk->bik", m, a)
    n = a.shape[-1]
    eye = jnp.eye(n, dtype=a.dtype)[None]
    return jnp.sqrt(jnp.sum((ma - eye) ** 2, axis=(1, 2))).mean()


def frobenius_loss(
    l_coo: BatchedCOO,
    solutions: jax.Array,  # (B, n)
    right_hand_sides: jax.Array,  # (B, n)
) -> jax.Array:
    """Fully-sparse loss ||L (L^T x) - b||_2 summed over the batch.

    Port of metrics.py:13-31 (two sparse matvecs, no densification) — the
    scalable objective for large n.
    """
    interim = batched_coo_matvec(l_coo, solutions, transpose=True)
    interim = batched_coo_matvec(l_coo, interim, transpose=False)
    return jnp.linalg.norm(interim - right_hand_sides, axis=1).sum()


def hutchinson_trace(
    key: jax.Array,
    systems_tril_dense: jax.Array,
    l_dense: jax.Array,
) -> jax.Array:
    """Stochastic ||(L L^T - A) v|| estimate (metrics.py:58-77)."""
    a = symmetrize_tril(systems_tril_dense)
    b, n, _ = a.shape
    v = jax.random.normal(key, (b, n), a.dtype)
    lv = _einsum("bij,bj->bi", l_dense,
                    _einsum("bji,bj->bi", l_dense, v))
    av = _einsum("bij,bj->bi", a, v)
    return jnp.linalg.norm(lv - av, axis=1).mean()


def condition_loss(
    systems_tril_dense: jax.Array,
    l_dense: jax.Array,
) -> jax.Array:
    """Mean condition number of M A via singular values (metrics.py:80-100)."""
    m = _einsum("bij,bkj->bik", l_dense, l_dense)
    a = symmetrize_tril(systems_tril_dense)
    ma = _einsum("bij,bjk->bik", m, a)
    sigmas = jnp.linalg.svd(ma, compute_uv=False)
    return (sigmas.max(axis=1) / sigmas.min(axis=1)).mean()


def pcg_residual_loss(
    systems_tril_dense: jax.Array,  # (B, n, n) lower-triangular A part
    m_dense: jax.Array,  # (B, n, n) dense SPD preconditioner M ~= A^-1
    right_hand_sides: jax.Array,  # (B, n)
    k_steps: int = 16,
    floor: float = 1e-12,
) -> jax.Array:
    """Mean log squared relative residual after ``k_steps`` of PCG.

    A differentiable proxy for the *deployed* metric — the CG iteration
    count under the reference's stopping rule ``r.r/b.b < 1e-8``
    (cg.py:15-20) — obtained by unrolling k fixed PCG steps (the exact
    update order of cg.py:70-87) and taking ``log(r_k.r_k / b.b)``.
    Minimizing it maximizes the per-iteration residual contraction of
    M A, which the spectral-surrogate losses (inverse/kaporin) only
    bound.  The log keeps gradients balanced across samples whose
    residuals span decades; ``floor`` guards the log once a sample
    converges to f32 noise within k steps.

    All operands live in the dataset's scaled space (unit-diagonal
    A~) — iteration counts there track the raw-system counts used by
    the benchmark (similarity transform; bench/suite._reconstruct).
    """
    a = symmetrize_tril(systems_tril_dense)
    b = right_hand_sides
    bb = jnp.maximum(jnp.sum(b * b, axis=1), 1e-30)

    def body(state, _):
        x, r, z, p = state
        ap = _einsum("bij,bj->bi", a, p)
        rz = jnp.sum(r * z, axis=1)
        denom = jnp.sum(ap * p, axis=1)
        alpha = rz / jnp.where(denom == 0, 1.0, denom)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        z = _einsum("bij,bj->bi", m_dense, r)
        beta = jnp.sum(r * z, axis=1) / jnp.where(rz == 0, 1.0, rz)
        p = z + beta[:, None] * p
        return (x, r, z, p), None

    r0 = b  # x0 = 0
    z0 = _einsum("bij,bj->bi", m_dense, r0)
    state = (jnp.zeros_like(b), r0, z0, z0)
    (x, r, z, p), _ = jax.lax.scan(body, state, None, length=k_steps)
    res = jnp.sum(r * r, axis=1) / bb
    return jnp.log(jnp.maximum(res, floor)).mean()


def kaporin_loss(
    systems_tril_dense: jax.Array,  # (B, n, n) lower-triangular A part
    l_dense: jax.Array,  # (B, n, n) lower-triangular factor L
    eps: float = 1e-30,
) -> jax.Array:
    """Log Kaporin condition number of L^T A L (framework extension).

    Kaporin (1994): CG iteration count is bounded through
    K = (trace(B)/n) / det(B)^(1/n) with B = L^T A L; K = 1 iff B = I.
    For triangular L, det(B) = det(A) * (prod_j L_jj)^2, so

        log K = log(trace(L^T A L) / n) - (2/n) sum_j log L_jj + const(A)

    — fully differentiable with *no* eigen/svd decomposition (contrast
    condition_loss, metrics.py:80-100) and no n^3 determinant: the trace
    is sum(L * (A L)).  This is the objective FSAI minimizes exactly over
    a fixed pattern (ops/fsai.py), making it the natural fine-tuning loss
    for learned factors.  The constant (1/n) log det(A) is dropped: it
    shifts the loss per sample but not the gradient.
    """
    a = symmetrize_tril(systems_tril_dense)
    n = a.shape[-1]
    al = _einsum("bij,bjk->bik", a, l_dense)
    trace = jnp.sum(l_dense * al, axis=(1, 2))
    diag = jnp.diagonal(l_dense, axis1=1, axis2=2)
    logdet_term = jnp.sum(
        jnp.log(jnp.maximum(jnp.abs(diag), eps)), axis=1
    )
    return (
        jnp.log(jnp.maximum(trace / n, eps)) - (2.0 / n) * logdet_term
    ).mean()
