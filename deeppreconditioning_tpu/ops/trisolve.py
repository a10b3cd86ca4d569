"""Sparse triangular solve via level scheduling — the data-parallel apply
path for factored preconditioners (z = L^-T L^-1 r).

The reference never tri-solves (it applies preconditioners as matvecs,
cg.py:81), but a real IC/learned-factor pipeline needs it.  Sequential
forward substitution is hostile to any accelerator; the standard answer
(cf. PAPERS.md: parallel sparse triangular solve literature) is *level
scheduling*: rows are grouped into levels such that every row in a level
depends only on rows in earlier levels, so each level is one data-parallel
wave.  For FVM/Poisson-like patterns the level count is O(grid diameter),
not O(n).

Host side (`build_tri_schedule`): topological levelization of the
dependency DAG + repack of each level's rows into a padded ELL block —
static shapes throughout, one `lax.scan` over levels on device.

Device side (`tri_solve_lower` / `tri_solve_upper`): per level,
``x[rows] = (b[rows] - sum_k vals * x[cols]) / diag`` — a gather,
a row-sum, and a scatter per wave.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from deeppreconditioning_tpu.utils import struct


@struct.dataclass
class TriSchedule:
    """Level-scheduled lower-triangular matrix, padded for lax.scan.

    Shapes: n_levels x rows_pad (level membership) and
    n_levels x rows_pad x k (off-diagonal ELL entries).

    Attributes:
        rows: int32 (L, R) — row index per slot; sentinel n_pad.
        cols: int32 (L, R, K) — column indices of strictly-lower entries;
            sentinel n_pad (gathers a trailing zero).
        vals: (L, R, K) — matching values.
        diag: (L, R) — diagonal entry per row (1 in padding).
        n: static true dimension; n_pad = padded x length.
    """

    rows: jax.Array
    cols: jax.Array
    vals: jax.Array
    diag: jax.Array
    n: int = struct.field(pytree_node=False)
    n_pad: int = struct.field(pytree_node=False)

    @property
    def n_levels(self) -> int:
        return self.rows.shape[0]


def compute_levels(l_csr: sp.csr_matrix) -> np.ndarray:
    """level[i] = longest dependency chain ending at row i (host; native
    C++ when libdptpu.so is built)."""
    from deeppreconditioning_tpu import native

    n = l_csr.shape[0]
    indptr, indices = l_csr.indptr, l_csr.indices
    if native.available() and n:
        return native.levels(indptr.astype(np.int64), indices)
    levels = np.zeros(n, np.int32)
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        deps = indices[lo:hi]
        deps = deps[deps < i]
        if deps.size:
            levels[i] = levels[deps].max() + 1
    return levels


def _round_up(n: int, m: int) -> int:
    return ((max(n, 1) + m - 1) // m) * m


def build_tri_schedule(l_factor: sp.spmatrix,
                       n_pad: int | None = None,
                       level_bucket: int = 8,
                       row_bucket: int = 64) -> TriSchedule:
    """Build the padded level schedule for a lower-triangular factor.

    Level count and per-level row count are rounded up to buckets so that
    schedules for same-family matrices share shapes and hit one compiled
    solver executable across a benchmark sweep.
    """
    csr = sp.tril(l_factor.tocsr(), format="csr")
    n = csr.shape[0]
    if n_pad is None:
        n_pad = ((n + 7) // 8) * 8
    levels = compute_levels(csr)
    n_levels_true = int(levels.max()) + 1 if n else 1

    diag_all = csr.diagonal()
    assert (diag_all != 0).all(), "singular triangular factor"

    level_sizes = np.bincount(levels, minlength=n_levels_true)
    rows_pad = _round_up(int(level_sizes.max()), row_bucket)
    n_levels = _round_up(n_levels_true, level_bucket)

    # vectorized packing: sort rows by (level, row); slot = rank in level
    order = np.lexsort((np.arange(n), levels))
    level_of = levels[order]
    starts = np.zeros(n_levels_true + 1, np.int64)
    np.cumsum(level_sizes, out=starts[1:])
    slot_of = np.arange(n) - starts[level_of]

    strict = sp.tril(csr, k=-1).tocsr()
    from deeppreconditioning_tpu.sparse.ell import csr_to_ell_arrays

    ecols, evals = csr_to_ell_arrays(strict, n, sentinel=n_pad)
    k = ecols.shape[1]

    rows = np.full((n_levels, rows_pad), n_pad, np.int32)
    cols = np.full((n_levels, rows_pad, k), n_pad, np.int32)
    vals = np.zeros((n_levels, rows_pad, k), np.float64)
    diag = np.ones((n_levels, rows_pad), np.float64)

    rows[level_of, slot_of] = order
    diag[level_of, slot_of] = diag_all[order]
    cols[level_of, slot_of] = ecols[order]
    vals[level_of, slot_of] = evals[order]

    return TriSchedule(
        rows=jnp.asarray(rows),
        cols=jnp.asarray(cols),
        vals=jnp.asarray(vals),
        diag=jnp.asarray(diag),
        n=n,
        n_pad=n_pad,
    )


def tri_solve_lower(schedule: TriSchedule, b: jax.Array) -> jax.Array:
    """Solve L x = b.  b has shape (n_pad,); returns x (n_pad,)."""
    dtype = b.dtype
    x0 = jnp.zeros((schedule.n_pad + 1,), dtype)
    b_ext = jnp.concatenate([b, jnp.zeros((1,), dtype)])

    def wave(x, level):
        rows, cols, vals, diag = level
        acc = jnp.sum(vals.astype(dtype) * x[cols], axis=1)
        xi = (b_ext[rows] - acc) / diag.astype(dtype)
        x = x.at[rows].set(xi)  # sentinel rows write slot n_pad (dropped)
        return x, None

    x, _ = jax.lax.scan(
        wave, x0,
        (schedule.rows, schedule.cols, schedule.vals, schedule.diag),
    )
    return x[:-1]


def transpose_schedule(l_factor: sp.spmatrix,
                       n_pad: int | None = None) -> TriSchedule:
    """Schedule for solving L^T x = b, built as a *lower*-triangular
    schedule of the permuted problem.

    L^T is upper triangular; reversing both row and column order turns it
    back into a lower-triangular system, so one kernel serves both sweeps.
    """
    csr = sp.tril(l_factor.tocsr(), format="csr")
    n = csr.shape[0]
    perm = np.arange(n)[::-1]
    ut = csr.T.tocsr()
    flipped = ut[perm][:, perm].tocsr()
    return build_tri_schedule(flipped, n_pad=n_pad)


def tri_solve_upper_from_flipped(schedule: TriSchedule,
                                 b: jax.Array) -> jax.Array:
    """Solve L^T x = b using the flipped schedule from
    ``transpose_schedule``.  Handles the index reversal on device."""
    n, n_pad = schedule.n, schedule.n_pad
    idx = jnp.arange(n_pad)
    rev = jnp.where(idx < n, n - 1 - idx, idx)  # reverse first n entries
    b_flipped = b[rev]
    y = tri_solve_lower(schedule, b_flipped)
    return y[rev]


def ic_apply(lower: TriSchedule, upper_flipped: TriSchedule,
             r: jax.Array) -> jax.Array:
    """z = L^-T (L^-1 r) — the factored-preconditioner apply."""
    y = tri_solve_lower(lower, r)
    return tri_solve_upper_from_flipped(upper_flipped, y)


# ---------------------------------------------------------------------------
# Neumann / Jacobi-sweep triangular apply — the latency-free alternative.
#
# Level scheduling is exact but pays one sequential wave per level; on
# latency-sensitive paths (small systems, or distributed sweeps across
# shards) a fixed number of Jacobi sweeps on the triangular system is
# preferable: y_{k+1} = D^-1 (r - (L - D) y_k).  For lower-triangular L
# this is a *finite* iteration — it converges exactly in n_levels sweeps
# — and truncating at K < n_levels yields the order-K Neumann-series
# approximation of L^-1.  Every sweep is one SpMV: fixed trip count, no
# data-dependent control flow (SURVEY.md §2.4 item 4's
# "block-Jacobi sweeps" strategy).

@struct.dataclass
class TriNeumann:
    """Strictly-lower part + inverse diagonal of L in ELL form."""

    cols: jax.Array  # (n_pad, k) strictly-lower column indices
    vals: jax.Array  # (n_pad, k)
    inv_diag: jax.Array  # (n_pad,)
    sweeps: int = struct.field(pytree_node=False)
    n: int = struct.field(pytree_node=False)


def build_tri_neumann(l_factor: sp.spmatrix, sweeps: int,
                      n_pad: int | None = None,
                      k_bucket: int = 4) -> TriNeumann:
    """Prepare the Neumann apply operator for a lower-tri factor.

    The ELL width is rounded up to ``k_bucket`` so same-family factors
    share shapes and hit one compiled apply across a benchmark sweep."""
    csr = sp.tril(l_factor.tocsr(), format="csr")
    n = csr.shape[0]
    if n_pad is None:
        n_pad = ((n + 7) // 8) * 8
    diag = csr.diagonal()
    strict = sp.tril(csr, k=-1).tocsr()
    from deeppreconditioning_tpu.sparse.ell import csr_to_ell_arrays

    cols, vals = csr_to_ell_arrays(strict, n_pad, sentinel=n_pad)
    k = cols.shape[1]
    k_pad = _round_up(k, k_bucket)
    if k_pad != k:
        cols = np.concatenate(
            [cols, np.full((n_pad, k_pad - k), n_pad, cols.dtype)],
            axis=1,
        )
        vals = np.concatenate(
            [vals, np.zeros((n_pad, k_pad - k), vals.dtype)], axis=1
        )
    inv_diag = np.zeros(n_pad)
    inv_diag[:n] = 1.0 / diag
    return TriNeumann(
        cols=jnp.asarray(cols),
        vals=jnp.asarray(vals),
        inv_diag=jnp.asarray(inv_diag),
        sweeps=sweeps,
        n=n,
    )


def _strict_lower_matvec(op: TriNeumann, y: jax.Array) -> jax.Array:
    y_ext = jnp.concatenate([y, jnp.zeros((1,), y.dtype)])
    return jnp.sum(op.vals.astype(y.dtype) * y_ext[op.cols], axis=1)


def neumann_lower_solve(op: TriNeumann, r: jax.Array) -> jax.Array:
    """y ~ L^-1 r via `sweeps` Jacobi sweeps (exact once sweeps >=
    number of dependency levels)."""
    inv_d = op.inv_diag.astype(r.dtype)
    y = inv_d * r

    def sweep(_, y):
        return inv_d * (r - _strict_lower_matvec(op, y))

    return jax.lax.fori_loop(0, op.sweeps, sweep, y)


def neumann_ic_apply(op: TriNeumann, r: jax.Array) -> jax.Array:
    """z = G^T (G r) with G ~ L^-1 (SPD by construction, so PCG-safe
    even when truncated)."""
    y = neumann_lower_solve(op, r)
    # transpose solve: y ~ L^-T via sweeps with the transposed operator
    # (gather-based transpose matvec: scatter-add of vals at cols)
    inv_d = op.inv_diag.astype(r.dtype)

    def strict_upper_matvec(y):
        contrib = op.vals.astype(y.dtype) * y[:, None]
        out = jnp.zeros((y.shape[0] + 1,), y.dtype)
        out = out.at[op.cols].add(contrib)
        return out[:-1]

    z = inv_d * y

    def sweep(_, z):
        return inv_d * (y - strict_upper_matvec(z))

    return jax.lax.fori_loop(0, op.sweeps, sweep, z)
